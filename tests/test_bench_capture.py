"""bench.py's headline: GPU results only, compact, and no number at all
when the run found no GPU."""

import json
import os
import signal
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402

GPU = {"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
       "device_count": 1, "card": "NVIDIA H100 80GB HBM3, 700.00 W"}


def _last_json_line(text: str):
    for line in reversed(text.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    return None


def test_headline_builder_degraded_and_ok():
    run = bench.Run()
    out, ok = run.headline()
    assert out["metric"] == "fft1024_throughput"
    assert out["degraded"] and out["vs_baseline"] is None
    assert out["value"] is None and not ok
    # a CPU result is never a headline number
    run.results["fft1024"] = {"Msps": 900.0, "platform": "cpu",
                              "device_kind": "cpu", "device_count": 1}
    out, ok = run.headline()
    assert not ok and out["value"] is None and "msps" not in out["extra"]
    run.results["fft1024"] = {"Msps": 11000.0, **GPU}
    out, ok = run.headline()
    assert ok and out["value"] == 11000.0
    assert abs(out["vs_baseline"] - 11000.0 / 371.0) < 0.1
    assert out["extra"]["device"] == GPU


def _full_suite_results():
    """A synthetic run with every bench present (made-up values)."""
    vals = {n: {"Msps": 1000.0 + i, **GPU} for i, n in enumerate(
        ("fft1024", "fft256", "fft2048", "fft4096", "fir32", "fir128",
         "rotator", "cmul", "bpsk_mod", "pcps_corr", "channel_awgn",
         "lora_sf7_demod", "viterbi_info_bits", "udp_rx"))}
    vals.update({
        "pcps_gcorr": {"Gcorr_s": 2.5, "grid": "50 x 41 x 1023", **GPU},
        "lora_sweep": {"compute_s": 0.5, "target_s": 60.0, "pass": True,
                       "waterfall_snr_db": {f"sf{s}": -2.0 * s
                                            for s in range(7, 13)}, **GPU},
        "gps_pvt_fix": {"error_m": 31.7, "pass": True, "acquired": "6/6",
                        "gen_s": 4.2, "acquire_s": 47.6, **GPU},
        "dual_pvt": {"error_m": 23.1, "pass": True, **GPU},
        "glonass_track": {"tracked": "6/6", **GPU},
        "e1c_gate": {"acquired": "8/8", "false_alarms": 0, **GPU},
        "e1c_tracking": {"tracked": "8/8", "e1b_pages_ok": "8/8", **GPU},
        "device_sweep": {"ok": 50, "total": 50, "failures": [], **GPU},
    })
    return vals


def test_headline_fits_driver_tail_window_full_suite():
    """The full-suite headline stays inside the tail window and carries
    the gates; the degraded one (no GPU fft1024) carries no number."""
    run = bench.Run()
    run.results.update(_full_suite_results())
    out, ok = run.headline()
    line = json.dumps(out)
    assert ok
    assert len(line) < 1500, f"headline {len(line)}B overflows tail window"
    assert out["value"] == 1000.0
    gates = out["extra"]["gates"]
    assert gates["e1c_acq"] == "8/8" and gates["e1c_trk"] == "8/8"
    assert gates["pvt_err_m"] == 31.7 and gates["sweep"] == "50/50"
    assert gates["dual_pvt_m"] == 23.1 and gates["e1b"] == "8/8"
    assert out["extra"]["msps"]["cmul"] == 1007
    assert out["extra"]["record"] == "chiprun_out/bench_record.json"

    run2 = bench.Run()
    run2.results.update(_full_suite_results())
    del run2.results["fft1024"]
    out, ok = run2.headline()
    assert not ok and out["degraded"] is True and out["value"] is None
    assert "msps" not in out["extra"] and "gates" not in out["extra"]
    assert len(json.dumps(out)) < 1500


def test_headline_shrink_guard_never_overflows():
    """Even a pathological suite (many entries, long device strings)
    serializes under the hard cap — extras are dropped first."""
    run = bench.Run()
    long_gpu = {**GPU, "card": GPU["card"] + " " + "x" * 120}
    run.results["fft1024"] = {"Msps": 12464.3, **long_gpu}
    for i in range(40):
        run.results[f"synthetic_bench_with_a_long_name_{i:02d}"] = {
            "Msps": 1234.5, **GPU}
        run.results[f"erroring_bench_with_a_long_name_{i:02d}"] = {
            "error": "Boom: " + "y" * 120}
    out, ok = run.headline()
    assert ok and len(json.dumps(out)) <= bench.HEADLINE_MAX_BYTES


def test_no_gpu_exits_nonzero_without_numbers(tmp_path):
    """Without a GPU the child refuses to run: exit 1, a degraded
    headline with no value, and no record written."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               R4W_BENCH_RECORD_PATH=str(tmp_path / "record.json"))
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "bench.py"),
                           "--quick"], cwd=ROOT, env=env, timeout=300,
                          capture_output=True, text=True)
    assert proc.returncode == 1
    rec = _last_json_line(proc.stdout)
    assert rec is not None, proc.stdout[-500:]
    assert rec["degraded"] is True and rec["value"] is None
    assert "no GPU" in rec["extra"]["reason"]
    assert "Msps" not in proc.stdout
    assert not (tmp_path / "record.json").exists()


# bench.py with its child replaced by a stub that answers the benches in
# ANSWERS and then hangs, as a wedged device run would.
_STUB_MAIN = """
import sys, time
sys.path.insert(0, {root!r})
import bench

ANSWERS = {answers!r}


class StubChild:
    def result(self, name, timeout_s):
        if name in ANSWERS:
            return dict(ANSWERS[name], bench=name)
        print("# stub: hanging in " + name, file=sys.stderr, flush=True)
        time.sleep(600)

    run = result

    def kill(self):
        pass

    close = kill


bench._Child = StubChild
raise SystemExit(bench.main())
"""


@pytest.mark.parametrize("answers, value, rc", [
    ({"device": GPU, "fft1024": {"Msps": 12345.0, **GPU}}, 12345.0, 0),
    ({}, None, 1),
], ids=["after_fft1024", "before_device"])
def test_sigterm_mid_run_still_emits_parseable_record(tmp_path, answers,
                                                      value, rc):
    """SIGTERM mid-run: bench.py still prints one parseable headline,
    built from what completed (no number unless fft1024 ran on a GPU),
    and the record holds every GPU result so far."""
    record = tmp_path / "record.json"
    env = dict(os.environ, R4W_BENCH_RECORD_PATH=str(record))
    proc = subprocess.Popen(
        [sys.executable, "-c", _STUB_MAIN.format(root=ROOT, answers=answers)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        for line in proc.stderr:
            if "# stub: hanging" in line:
                break
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        proc.kill()
    assert proc.returncode == rc
    heads = [ln for ln in out.splitlines() if ln.startswith("{")]
    assert len(heads) == 1, out
    rec = json.loads(heads[0])
    assert rec["metric"] == "fft1024_throughput" and rec["value"] == value
    if value is None:
        assert rec["degraded"] is True and rec["vs_baseline"] is None
        assert not record.exists()
    else:
        assert rec["extra"]["device"] == GPU
        saved = json.loads(record.read_text())
        assert saved["results"]["fft1024"]["Msps"] == value
