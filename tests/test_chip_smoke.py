"""chip_smoke.py without a GPU, and each phase's comparison at small
sizes on the CPU (the script itself runs them at full size on a card)."""

import functools
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def _ok_line(stdout: str) -> bool:
    return any('"ok": true' in line for line in stdout.splitlines())


def test_no_gpu_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert not _ok_line(proc.stdout)
    assert "no GPU" in proc.stderr


def test_alone_without_the_repository_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert not _ok_line(proc.stdout)


SMALL = {
    "device": dict(n=1 << 12),
    "lora_link": dict(lanes=8, ref_lanes=4, lanes_sf12=2, n_bytes=8),
    "fir": dict(n=1 << 12),
    "viterbi": dict(lanes=4, n_info=96),
    "cli": dict(runs=cs.CLI_RUNS[:1]),
    "sweep": dict(names=["BPSK", "CW", "AM-Broadcast", "LoRa-SF7"]),
}


@pytest.mark.parametrize("name", list(SMALL))
def test_phase_small_on_cpu(name):
    fn = dict(cs.PHASES)[name]
    res = fn(**SMALL[name])
    json.dumps(res)  # one JSON line per phase
    assert res["comparison"] and "tolerance" in res


@pytest.mark.parametrize("name", ["AM-Broadcast", "FM-Broadcast", "NBFM",
                                  "ADS-B"])
def test_sweep_holds_analog_and_adsb_to_the_payload(name):
    """Analog audio and ADS-B return the payload at their sweep rates
    (FM from its second byte: the discriminator consumes the first)."""
    res = cs.phase_sweep(names=[name])
    assert res["payload_returned"] == 1 and res["no_data"] == []


def test_sweep_fails_on_a_shifted_payload(monkeypatch):
    monkeypatch.setattr(cs, "FIRST_BYTE_CONSUMED", set())
    with pytest.raises(cs.SmokeFailure, match="NBFM"):
        cs.phase_sweep(names=["NBFM"])


def test_gnss_phase_gates_on_fix_error(monkeypatch):
    import tools.gps_pvt_fix as tool

    good = {"value": 24.8, "pass": True, "acquired": 6, "decoded": 6,
            "of": 6, "gen_s": 1.0, "acquire_s": 2.0, "track_s": 3.0}
    monkeypatch.setattr(tool, "main_decoded", lambda: dict(good))
    res = cs.phase_gnss()
    assert res["fix_error_m"] == 24.8 and res["decoded"] == "6/6"
    monkeypatch.setattr(tool, "main_decoded",
                        lambda: dict(good, value=51.0, **{"pass": False}))
    with pytest.raises(cs.SmokeFailure):
        cs.phase_gnss()


FOUR_CARD_SMALL = {
    "sharded_ber": dict(lanes=16, chunk=8, n_bytes=4),
    "sharded_pcps": dict(n_prn=8),
    "sharded_scenario": dict(n_sv=8, n_blk=2048),
}


@pytest.mark.parametrize("name", list(FOUR_CARD_SMALL))
def test_sharded_phase_on_cpu_mesh(name):
    """The four-card comparisons on the test session's virtual CPU mesh
    (one device per mesh slot)."""
    res = dict(cs.FOUR_CARD_PHASES)[name](**FOUR_CARD_SMALL[name])
    assert res["devices"] >= 2 and "tolerance" in res


def _powers(winner, runner_up, n=8):
    p = np.full((1, n), 1.0)
    p[0, 0], p[0, 1] = winner, runner_up
    return p


@pytest.mark.parametrize("lib, runner_up, ok", [
    (0, 10.0, True),        # agrees
    (1, 100.0 - 1e-3, True),   # disagrees at a near-tie
    (1, 50.0, False),       # disagrees away from a tie
])
def test_compare_symbols_near_ties(lib, runner_up, ok):
    powers = _powers(100.0, runner_up)
    call = functools.partial(cs.compare_symbols, np.asarray([lib]), powers,
                             min_agree=0.0)
    if ok:
        assert call()["mismatches"] == int(lib != 0)
    else:
        with pytest.raises(cs.SmokeFailure):
            call()


@pytest.mark.parametrize("compare, args", [
    (cs.compare_rel, (np.ones(4) * 1.001, np.ones(4), 1e-5, "rel")),
    (cs.compare_rel, (np.ones(3), np.ones(4), 1e-5, "shape")),
    (cs.compare_rel, (np.full(4, np.nan), np.ones(4), 1e-5, "nan")),
    (cs.compare_equal, (np.arange(4), np.arange(4) + 1, "equal")),
])
def test_comparisons_raise_on_failure(compare, args):
    with pytest.raises(cs.SmokeFailure):
        compare(*args)


def test_reference_symbol_powers_find_chirp_symbols():
    """The float64 reference decodes noiseless LoRa symbols itself."""
    from r4w_tpu.waveforms import lora
    from r4w_tpu.waveforms.lora import chirp

    p = lora.LoRaParams(sf=7)
    syms = np.asarray([0, 1, 64, 127])
    x = np.asarray(chirp.symbol_chirps(p, syms)).reshape(-1)
    powers = cs.ref_lora_symbol_powers(x, 7, p.bw_hz)
    np.testing.assert_array_equal(np.argmax(powers, -1), syms)


def test_phases_import_neither_yaml_nor_matplotlib():
    """The card machine is sure to have only JAX, numpy, scipy and a few
    test packages: the smoke path must not import yaml or matplotlib."""
    code = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('yaml', 'matplotlib'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import chip_smoke as cs
import tools.gps_pvt_fix
cs.phase_device(n=1024)
cs.phase_fir(n=1 << 12)
cs.phase_viterbi(lanes=2, n_info=40)
cs.phase_cli(runs=cs.CLI_RUNS[:1])
cs.phase_sweep(names=['BPSK', 'LoRa-SF7', 'GPS-L1CA'])
print('CLEAN')
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert "CLEAN" in proc.stdout, proc.stderr[-2000:]
