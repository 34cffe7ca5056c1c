"""Basic modulation: create waveforms from the factory and roundtrip.

(workshop/getting_started/basic_modulation equivalent.)
Run: python examples/01_basic_modulation.py
"""

import numpy as np

import examples_env  # noqa: F401  (CPU unless R4W_DEVICE=accelerator)
from r4w_tpu import create_waveform, list_waveforms

message = b"Hello, r4w_tpu!"

print(f"{len(list_waveforms())} waveforms available\n")
for name in ["BPSK", "QPSK", "16-QAM", "LoRa-SF7"]:
    wf = create_waveform(name, 125_000.0)
    tx = wf.modulate(message)
    result = wf.demodulate(tx)
    decoded = bytes(np.asarray(result.bits[: len(message)]).astype(np.uint8))
    print(f"{name:10s} {tx.shape[-1]:6d} samples  "
          f"decoded={'OK' if decoded == message else decoded!r}")
