"""Multi-chip Monte-Carlo BER sweep over a device mesh.

Run with a virtual mesh:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python examples/05_multichip_ber.py
On a multi-GPU host the same code shards over the real cards.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np

import examples_env  # noqa: F401
from r4w_tpu import parallel
from r4w_tpu.waveforms import lora

mesh = parallel.make_mesh(("dp",))
print(f"mesh: {dict(mesh.shape)} over {mesh.devices.size} device(s)")

p = lora.LoRaParams(sf=7)
payload = jnp.arange(24)
snrs = jnp.linspace(-22.0, -4.0, 7)
t0 = time.time()
ber = parallel.ber_sweep(
    lambda pl, k, s: lora.loopback_ber(p, pl, k, s),
    payload, snrs_db=snrs, n_lanes=64, mesh=mesh,
)
dt = time.time() - t0
print(f"64 lanes x 7 SNRs in {dt:.1f}s")
for s, b in zip(np.asarray(snrs), np.asarray(ber)):
    bar = "#" * int(50 * float(b) / 0.5)
    print(f"  {s:+6.1f} dB  BER {float(b):.4f} {bar}")
