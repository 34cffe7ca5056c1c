"""Radar + applied-sensing tour: pulse-Doppler detection, DF bearing
triangulation, and a vibration-health check — three catalog families in
one runnable script (reference workshop/ advanced-track role).

Run: python examples/10_radar_and_sensing.py
"""

import numpy as np

import examples_env  # noqa: F401  (CPU unless R4W_DEVICE=accelerator)
import jax.numpy as jnp

from r4w_tpu.ops import instruments, radar_sonar, sensing

# --- 1. pulse-Doppler radar: find a moving target --------------------
n_pulses, n_range = 32, 256
rng = np.random.default_rng(0)
chirp = np.exp(1j * np.pi * 0.5 * 16 * (np.arange(16) / 16) ** 2)
cube = 0.02 * (rng.standard_normal((n_pulses, n_range))
               + 1j * rng.standard_normal((n_pulses, n_range)))
for p in range(n_pulses):
    cube[p, 100:116] += chirp * np.exp(2j * np.pi * 0.15 * p)
rd, det = radar_sonar.range_doppler_detect(
    jnp.asarray(cube.astype(np.complex64)), jnp.asarray(
        chirp.astype(np.complex64)))
k = np.unravel_index(int(np.argmax(np.asarray(rd))), rd.shape)
print(f"pulse-Doppler: target at range bin {k[1]} "
      f"(true 100), Doppler bin {k[0] - 16:+d} "
      f"({np.asarray(det).sum()} CFAR detections)")
assert abs(k[1] - 100) <= 1

# --- 2. direction finding: two stations triangulate an emitter -------
stations = np.array([[0.0, 0.0], [2000.0, 0.0], [0.0, 2000.0]])
emitter = np.array([700.0, 1200.0])
bearings = [float(np.rad2deg(np.arctan2(*(emitter - s))))
            for s in stations]
pos = np.asarray(instruments.triangulate_bearings(stations, bearings))
err = np.linalg.norm(pos - emitter)
print(f"DF triangulation: emitter at ({pos[0]:.0f}, {pos[1]:.0f}) m, "
      f"error {err:.1f} m")
assert err < 10.0

# --- 3. machine health: bearing-defect band energy -------------------
fs = 10_000.0
t = np.arange(40_000) / fs
impacts = (np.sin(2 * np.pi * 87 * t) > 0.99).astype(float)
ring = np.sin(2 * np.pi * 3000 * np.arange(64) / fs) \
    * np.exp(-np.arange(64) / 10)
vib = np.convolve(impacts, ring)[: t.shape[0]] \
    + 0.05 * rng.standard_normal(t.shape[0])
health = sensing.bearing_health_bands(
    jnp.asarray(vib.astype(np.float32)), fs, bpfo_hz=87.0,
    bpfi_hz=117.0)
print(f"vibration health: BPFO band {float(health['bpfo']):.1f}x "
      f"background, BPFI {float(health['bpfi']):.1f}x "
      f"-> outer-race defect detected")
assert float(health["bpfo"]) > 3 * float(health["bpfi"])
print("sensing tour OK")
