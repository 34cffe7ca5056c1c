"""Test configuration: run on a virtual 8-device CPU mesh.

Tests run on the CPU unless JAX_PLATFORMS names another platform; the
GPU-marked tests (`pytest -m gpu`) need `JAX_PLATFORMS=cuda`. The config
update makes the choice hold even if a plugin imported JAX first.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
platforms = os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", platforms)
jax.config.update("jax_enable_x64", False)
