#!/usr/bin/env python
"""Full LoRa SF7-SF12 Monte-Carlo BER sweep on one card (acceptance
target: < 60 s compute). Prints one JSON line.
"""

import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    from r4w_tpu.waveforms import lora

    snrs = jnp.asarray(np.arange(-26.0, -2.0, 2.0), jnp.float32)  # 12 pts
    n_payload = 16  # symbols per trial
    results = {}
    compile_s = 0.0
    compute_s = 0.0
    for sf in range(7, 13):
        p = lora.LoRaParams(sf=sf)
        lanes = max(4, 512 >> (sf - 7))  # keep sample volume ~constant
        payload = jnp.arange(n_payload) % p.chips_per_symbol
        keys = jax.random.split(jax.random.key(sf), lanes)

        @jax.jit
        def grid(keys, snrs):
            f = lambda k, s: lora.loopback_ber(p, payload, k, s)
            return jax.vmap(lambda k: jax.vmap(lambda s: f(k, s))(snrs)
                            )(keys).mean(0)

        t0 = time.perf_counter()
        ber = jax.device_get(grid(keys, snrs))  # compile + run
        t1 = time.perf_counter()
        ber = jax.device_get(grid(keys, snrs))  # warm run
        t2 = time.perf_counter()
        compile_s += t1 - t0 - (t2 - t1)
        compute_s += t2 - t1
        results[f"sf{sf}"] = {
            "lanes": lanes,
            "waterfall_snr_db": float(snrs[int(np.argmax(
                np.asarray(ber) < 0.01))]) if np.any(
                np.asarray(ber) < 0.01) else None,
            "ber": [round(float(b), 5) for b in np.asarray(ber)],
        }
    print(json.dumps({
        "metric": "lora_sf7_sf12_ber_sweep",
        "compute_s": round(compute_s, 2),
        "compile_s": round(max(compile_s, 0.0), 1),
        "target_s": 60.0,
        "pass": compute_s < 60.0,
        "device": str(jax.devices()[0]),
        "per_sf": results,
    }))


if __name__ == "__main__":
    main()
