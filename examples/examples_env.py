"""Shared example setup: run on CPU unless R4W_DEVICE=accelerator.

Import this first in every example; it must run before JAX's backend
initializes.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

if os.environ.get("R4W_DEVICE", "cpu").lower() != "accelerator":
    import jax

    try:
        jax.config.update("jax_platforms", "cpu")
    except Exception:
        pass
