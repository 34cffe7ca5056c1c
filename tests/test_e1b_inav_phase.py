"""End-to-end E1B I/NAV decode off the E1C pilot loop (VERDICT r4 #5).

Small 2-SV dual-component scenario (the 8-SV C/N0-34 version runs on
the GPU inside tools/e1c_tracking.py): generate E1C pilot + E1B data
with real I/NAV pages, acquire + refine the pilots, run the long
dual-channel pass, decode pages, check CRC-24Q AND data content.
"""

from __future__ import annotations

import numpy as np
import pytest

from r4w_tpu.gnss import scenario as sc

pytestmark = pytest.mark.slow


def test_two_sv_dual_component_pages_decode():
    from tools.e1c_tracking import e1b_inav_phase

    sats = tuple(sc.SatelliteConfig(signal="GalileoE1C", prn=p,
                                    cn0_dbhz=45.0, doppler_hz=d,
                                    range_m=r)
                 for p, d, r in ((3, 250.0, 21e6), (7, -410.0, 23e6)))
    cfg = sc.ScenarioConfig(satellites=sats, sample_rate=4.092e6,
                            duration_s=1.0, seed=11)
    out = e1b_inav_phase(cfg, periods=50, duration_s=3.3)
    assert out["pass"], out
    assert out["svs_pages_ok"] == 2
    for sv in out["per_sv"]:
        assert sv["pages_crc_ok"] >= 1
        # decoded content must equal the overlaid truth, not just CRC
        assert sv["pages_data_match"] == sv["pages_crc_ok"]
