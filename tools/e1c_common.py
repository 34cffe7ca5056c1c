"""Shared E1C scenario capture for the acceptance gates.

Both tools/e1c_gate.py and tools/e1c_tracking.py replay the reference's
`e1c_8prn_60s_cn34_orbital.yaml` for K code periods; generation is the
expensive step. bench.py runs both gates in ONE child process, so a
module-level memo lets the second gate reuse the first one's capture
and acquisition.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

_MEMO: dict = {}


def e1c_capture(yaml_path: str, periods: int):
    """(cfg, rx_device, prns, waves, acq, timings) for the scenario —
    generated + acquired once per (yaml, periods) per process."""
    key = (os.path.abspath(yaml_path), int(periods))
    if key in _MEMO:
        return _MEMO[key]

    from r4w_tpu.gnss import acquisition, scenario

    t0 = time.time()
    cfg = scenario.load_scenario_yaml(yaml_path)
    gen = scenario.GnssScenario(cfg)
    fs = cfg.sample_rate
    n_per = int(round(fs * 4092 / 1.023e6))
    # device-resident generation: no host round trip.
    # block_size stays 1<<18 so the per-block PRNG sequence — and
    # hence the exact noise realization the gate numbers were
    # validated on — is unchanged.
    rx = gen.generate_device(periods * n_per / fs,
                             block_size=1 << 18)[: periods * n_per]
    rx.block_until_ready()
    gen_s = time.time() - t0

    present = [s.prn for s in cfg.satellites]
    absent = [p for p in (9, 30, 44) if p not in present][:2]
    prns = present + absent
    waves = [scenario._spread_waveform(
        scenario.SatelliteConfig(signal="GalileoE1C", prn=p))
        for p in prns]
    codes = acquisition.sampled_code_bank(
        waves, scenario.CHIP_RATE * scenario.SUBCHIP, fs, n_per,
        n_subphases=4)
    cfg_a = acquisition.PcpsConfig(
        doppler_max_hz=5000.0, doppler_step_hz=125.0, threshold=1.0,
        coherent_periods=periods)
    t1 = time.time()
    acq = acquisition.acquire(rx, codes, prns, fs, cfg_a)
    acquire_s = time.time() - t1

    out = (cfg, rx, prns, len(present), waves, acq,
           {"gen_s": round(gen_s, 1), "acquire_s": round(acquire_s, 1)})
    _MEMO[key] = out
    return out
