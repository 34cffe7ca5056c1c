"""Build a receive chain from registry blocks — the pipeline-wizard
workflow (reference GUI views/pipeline_wizard.rs) driven from code.

A QPSK burst with carrier offset and noise is recovered using only
blocks looked up by name from the 523-entry catalog:
signal_source → awgn_channel → afc → feedforward_agc →
constellation_receiver.

Run: python examples/09_block_pipeline.py
"""

import numpy as np

import examples_env  # noqa: F401  (CPU unless R4W_DEVICE=accelerator)
import jax
import jax.numpy as jnp

from r4w_tpu.registry import default_registry

reg = default_registry()
print(f"{len(reg.list())} blocks in the registry; using 5 of them\n")

# --- TX: QPSK symbols from the shared constellation table ------------
table_fn = reg.create("constellation_encoder")
table = table_fn("qpsk")
rng = np.random.default_rng(0)
idx = rng.integers(0, 4, 2000)
symbol_map = reg.create("symbol_mapping")
tx = symbol_map(idx, table)

# --- channel: frequency offset + AWGN --------------------------------
fs = 100_000.0
freq_shift = reg.create("frequency_shift")
shifted, _ = freq_shift(tx, 250.0, fs)
awgn = reg.create("awgn_channel")
rx = awgn(jax.random.key(1), shifted, 20.0)

# --- RX chain, every stage a registry block --------------------------
# blind CFO from the 4th power (modulation-stripped), then correct
cfo = reg.create("cfo_estimator")
f_est = float(cfo(rx, fs, order=4))
print(f"blind CFO estimate: {f_est:+.1f} Hz (true +250.0)")
corrected, _ = freq_shift(rx, -f_est, fs)

agc = reg.create("feedforward_agc")
leveled = agc(corrected, target=1.0)

# residual phase/frequency: decision-directed carrier recovery
crec = reg.create("carrier_recovery")
locked, _ = crec(leveled, order=4, bw=0.05)
# the Mth-power loop locks the constellation onto the axes; the QPSK
# table lives on the diagonals -> rotate by pi/4 to the table frame
locked = locked * np.exp(1j * np.pi / 4).astype(np.complex64)

crx = reg.create("constellation_receiver")
settle = 500
got_idx, evm, margin = crx(locked[settle:], table)
print(f"EVM after CFO+AGC+carrier recovery: {float(evm):.3f}")

# constant pi/2 lock ambiguity: best of 4 phase hypotheses
want = idx[settle:]
best = max(
    np.mean(np.asarray(crx(locked[settle:] * np.exp(1j * k * np.pi / 2),
                           table)[0]) == want)
    for k in range(4))
print(f"symbol accuracy (best of 4 phase hypotheses): {best:.3f}")
assert best > 0.95
print("pipeline OK")
