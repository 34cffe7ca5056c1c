"""Benchmark suite on one GPU (mirrors the reference's criterion
benches, crates/r4w-core/benches/).

    python bench.py [--quick]

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"} where
the headline metric is FFT-1024 throughput vs the reference's
published 371 Msamples/s (README.md:92, MEASURABLE_OBJECTIVES.md:27).
The line stays under HEADLINE_MAX_BYTES (tests/test_bench_capture.py):
`extra.msps` carries integer throughput digests and `extra.gates` the
receiver gate numbers; the full suite — per-bench wall times and
`vs_gnuradio` ratios against the reference's GNU Radio baselines
(benches/gnuradio_comparison.rs:41-66) — is written to BENCH_RECORD.

Device work runs in ONE child process at a time, driven over a line
protocol by this parent, which never imports JAX (a JAX process
reserves most of the card's memory). Each bench has a watchdog; a hung
bench is recorded as an error and the child restarted. Every result
names the platform, device kind, device count and the card's power
limit. Without a GPU the child refuses to run, the headline carries no
number and the exit code is 1. The record is rewritten after every
result, and SIGTERM, SIGINT or interpreter exit still print the
headline once, built from whatever has completed.

Each benchmark is ONE jit containing a fori_loop with a serial data
dependency, synced by fetching a float32 scalar.
"""

from __future__ import annotations

import atexit
import functools
import json
import os
import signal
import sys
import time

BASELINE_FFT1024_MSPS = 371.0

# GNU Radio baselines from gnuradio_comparison.rs:41-66 (Msamples/s)
GR_BASELINES = {
    "fft1024": 50.0, "fft4096": 12.0, "fir32": 80.0, "fir128": 25.0,
    "rotator": 100.0, "cmul": 200.0, "bpsk_mod": 20.0,
}


# --------------------------------------------------------------------
# Individual benchmarks (run inside the child process). Each returns a
# dict; throughput benches report {"Msps": ...}.
# --------------------------------------------------------------------

def _timed_scalar(fn, *args):
    """Run fn once to compile and warm, then time it; fn must return an
    f32 scalar. Host numpy args move to the device once, before timing,
    so the timed runs measure the device work. Best of 3 timed runs."""
    import jax
    import numpy as np

    args = [jax.device_put(a) if isinstance(a, np.ndarray) else a
            for a in args]
    s = jax.device_get(fn(*args))  # compile + warm; syncs transfers too
    if not np.isfinite(s):
        raise FloatingPointError("benchmark produced non-finite output")
    dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        s = jax.device_get(fn(*args))
        dt = min(dt, time.perf_counter() - t0)
    if not np.isfinite(s):
        raise FloatingPointError("benchmark produced non-finite output")
    return dt


def bench_fft1024():
    import jax
    import jax.lax as lax
    import jax.numpy as jnp
    import numpy as np

    n = 1024
    batch = 384
    iters = 8192
    rng = np.random.default_rng(0)
    re = rng.standard_normal((batch, n), dtype=np.float32)
    im = rng.standard_normal((batch, n), dtype=np.float32)
    scale = np.float32(1.0 / np.sqrt(n))  # unitary: chained FFTs stay bounded

    @jax.jit
    def run(re, im):
        v = lax.complex(re, im)

        def body(i, v):
            return jnp.fft.fft(v, axis=-1) * scale

        v = lax.fori_loop(0, iters, body, v)
        return jnp.sum(v.real**2 + v.imag**2)

    dt = _timed_scalar(run, re, im)
    return {"Msps": round(batch * n * iters / dt / 1e6, 1)}


def _bench_fft(n: int, batch: int, iters: int, seed: int):
    """Shared chained-FFT throughput core."""
    import jax
    import jax.lax as lax
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.default_rng(seed)
    re = rng.standard_normal((batch, n), dtype=np.float32)
    im = rng.standard_normal((batch, n), dtype=np.float32)
    scale = np.float32(1.0 / np.sqrt(n))

    @jax.jit
    def run(re, im):
        v = lax.complex(re, im)

        def body(i, v):
            return jnp.fft.fft(v, axis=-1) * scale

        v = lax.fori_loop(0, iters, body, v)
        return jnp.sum(v.real**2 + v.imag**2)

    dt = _timed_scalar(run, re, im)
    return {"Msps": round(batch * n * iters / dt / 1e6, 1)}


def bench_fft256():
    """FFT-256 (reference publishes 645 Msps, MEASURABLE_OBJECTIVES:26)."""
    return _bench_fft(256, 4096, 8192, 7)


def bench_fft2048():
    """FFT-2048 (reference publishes 179 Msps, README.md:94)."""
    return _bench_fft(2048, 128, 8192, 8)


def bench_fft4096():
    """FFT-4096 (gnuradio_comparison baseline 12 Msps, README 330 Msps)."""
    return _bench_fft(4096, 256, 4096, 1)


def bench_udp_rx():
    """Loopback UDP IQ ingest through the native C++ receiver thread +
    lock-free ring (benchmark/receiver.rs role, §3.4 distributed path).
    Pure host-side: measures the wire→ring→numpy path, no device."""
    import threading
    import numpy as np

    from r4w_tpu.net import UdpSink

    try:
        from r4w_tpu.native import NativeUdpReceiver

        rx = NativeUdpReceiver(port=0, ring_samples=1 << 22)
        path = "native"
    except Exception:  # noqa: BLE001 — fall back to the Python source
        from r4w_tpu.net import UdpConfig, UdpSource

        rx = None
        src = UdpSource(UdpConfig(host="127.0.0.1", port=0,
                                  timeout_s=0.1))
        path = "python"

    port = rx.port if rx is not None else src.port
    chunk_len = 8000
    chunk = (np.exp(2j * np.pi * 0.01 * np.arange(chunk_len))
             .astype(np.complex64))
    # ONE sink for all ladder trials: a fresh sink restarts its
    # sequence counter at 0, which the receiver counts as a gap and
    # pollutes the recorded seq_gaps of later trials
    sink = UdpSink("127.0.0.1", port)

    def trial(rate_msps: float, secs: float = 2.0):
        """Paced sender at rate_msps (the reference's benchmark paces
        at the waveform sample rate); returns (got, sent, elapsed)."""
        n_chunks = int(rate_msps * 1e6 * secs / chunk_len)
        period = chunk_len / (rate_msps * 1e6)
        done = {"flag": False}

        def sender():
            t_next = time.perf_counter()
            for _ in range(n_chunks):
                sink.send(chunk)
                t_next += period
                delay = t_next - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
            done["flag"] = True

        th = threading.Thread(target=sender, daemon=True)
        t0 = time.perf_counter()
        th.start()
        got, idle_until = 0, None
        while time.perf_counter() < t0 + secs + 10.0:
            batch = (rx.read(1 << 16) if rx is not None
                     else src.recv_batch(64))
            got += len(batch)
            if done["flag"] and len(batch) == 0:
                # linger briefly: data may still be in flight
                idle_until = idle_until or time.perf_counter() + 0.3
                if time.perf_counter() > idle_until:
                    break
            else:
                idle_until = None
        return got, n_chunks * chunk_len, time.perf_counter() - t0

    # descending rate ladder: report the highest rate sustained with
    # >= 99% delivery (packet pacing is the reference's methodology)
    def gaps():
        return int(rx.stats["seq_gaps"] if rx is not None
                   else src.packets_dropped)

    result = None
    for rate in (200.0, 100.0, 50.0, 25.0, 12.0, 6.0):
        g0 = gaps()
        got, total, dt = trial(rate)
        pct = 100.0 * got / total
        result = {"Msps": round(got / dt / 1e6, 1), "path": path,
                  "offered_msps": rate,
                  "received_pct": round(pct, 1),
                  "seq_gaps": gaps() - g0}
        if pct >= 99.0:
            break
    sink.close()
    if rx is not None:
        rx.close()
    else:
        src.close()
    return result


def bench_e1c_gate():
    """Galileo E1C 8-PRN C/N0-34 acceptance (BASELINE north star):
    generate the reference's orbital scenario for 200 ms and re-acquire
    every PRN with the production PCPS + sub-sample-slewed alignment
    refine; two absent PRNs as false-alarm control (tools/e1c_gate.py)."""
    import os
    import sys as _sys

    _sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tools.e1c_gate import main as gate_main

    out = gate_main(periods=50)
    if out.get("skipped"):
        return {"skipped": out["skipped"]}
    return {
        "acquired": f"{out['value']}/{out['of']}",
        "false_alarms": out["false_alarms"],
        "worst_present_metric": min(
            r["metric"] for r in out["per_prn"] if r["present"]),
        "best_absent_metric": max(
            r["metric"] for r in out["per_prn"] if not r["present"]),
        "gen_s": out["gen_s"],
        "acquire_s": out["acquire_s"],
    }


def bench_gps_pvt_fix():
    """GPS L1 C/A IQ→PVT end-to-end fix, decoded-ephemeris mode
    (VERDICT r4 #2): scenario with real LNAV → acquisition → DLL/PLL
    tracking → frame sync → SF1-3 clock+ephemeris decode → transmit
    times from decoded TOW (no supplied milliseconds) → solved
    position (tools/gps_pvt_fix.py; gate err < 50 m, 6/6 decoded)."""
    import os
    import sys as _sys

    _sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tools.gps_pvt_fix import main as pvt_main

    out = pvt_main()
    return {"error_m": out["value"], "pass": out["pass"],
            "mode": out.get("mode", "decoded_ephemeris"),
            "acquired": f"{out['acquired']}/{out['of']}",
            "decoded": f"{out.get('decoded', '?')}/{out['of']}",
            "clock_bias_m": out["clock_bias_m"],
            "gen_s": out["gen_s"], "acquire_s": out["acquire_s"],
            "track_s": out.get("track_s", 0.0)}


def bench_dual_pvt():
    """Dual-constellation GPS+Galileo joint IQ→PVT (r5 flagship): one
    scenario carries 5 GPS L1 C/A + 5 Galileo E1B SVs; both front ends
    run on the same samples, decode LNAV SF1-3 and I/NAV words 1-5,
    and the joint solve carries an inter-system clock-bias state
    (tools/dual_pvt.py; gate err < 60 m, 10/10 decoded)."""
    import os
    import sys as _sys

    _sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tools.dual_pvt import main as dual_main

    out = dual_main()
    return {"error_m": out["value"], "pass": out["pass"],
            "mode": out["mode"],
            "acquired": f"{out['acquired']}/{out['of']}",
            "decoded": f"{out['decoded']}/{out['of']}",
            "gps_only_m": (out.get("gps_only") or {}).get("error_m"),
            "galileo_only_m": (out.get("galileo_only")
                               or {}).get("error_m"),
            "isb_m": (out.get("joint") or {}).get("isb_m"),
            "speed_mps": (out.get("velocity") or {}).get("speed_mps"),
            "gen_s": out["gen_s"], "acquire_s": out["acquire_s"],
            "track_s": out["track_s"]}


def bench_glonass_track():
    """GLONASS L1OF FDMA acceptance (r5, third constellation): 6 SVs
    on k·562.5 kHz channels sharing ONE 511-chip m-sequence at the
    true 0.511 Mchip/s — exact integer-phase mixdown → PCPS per
    channel → production Costas DLL/PLL → 20 ms PRBS nav-bit recovery
    (tools/glonass_track.py; gate 6/6 channels, bit match ≥ 0.98)."""
    import os
    import sys as _sys

    _sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tools.glonass_track import main as glo_main

    out = glo_main()
    worst = (min((c["bit_match"] for c in out["per_ch"]), default=0.0)
             if out["per_ch"] else 0.0)
    return {"tracked": f"{out['value']}/{out['of']}",
            "pass": out["pass"], "cn0_dbhz": out["cn0_dbhz"],
            "worst_bit_match": worst,
            "max_dop_err_hz": max((abs(c["dop_err_hz"])
                                   for c in out["per_ch"]), default=None),
            "gen_s": out["gen_s"], "acquire_s": out["acquire_s"],
            "track_s": out["track_s"]}


def bench_e1c_tracking():
    """Galileo E1C acquisition→tracking handoff: 8 DLL/PLL channels
    seeded from the PCPS states hold lock across the C/N0-34 scenario
    (tools/e1c_tracking.py; gate >= 6/8 tracked, C/N0 within 6 dB)."""
    import os
    import sys as _sys

    _sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tools.e1c_tracking import main as trk_main

    out = trk_main(periods=50)
    if out.get("skipped"):
        return {"skipped": out["skipped"]}
    res = {"tracked": f"{out['value']}/{out['of']}",
           "acquired": out["acquired"],
           "cn0_mean_dbhz": out["cn0_mean_dbhz"],
           "gen_s": out["gen_s"], "acquire_s": out["acquire_s"],
           "track_s": out["track_s"]}
    e1b = out.get("e1b")
    if isinstance(e1b, dict) and "svs_pages_ok" in e1b:
        res["e1b_pages_ok"] = f"{e1b['svs_pages_ok']}/{e1b['of']}"
        res["e1b_pass"] = e1b["pass"]
    elif isinstance(e1b, dict):
        res["e1b_error"] = e1b.get("error", "?")[:80]
    return res


def bench_lora_sf7_demod():
    """Chained chirp-synthesize → dechirp-FFT-argmax demod loop."""
    import jax
    import jax.lax as lax
    import jax.numpy as jnp
    import numpy as np

    from r4w_tpu.waveforms import lora
    from r4w_tpu.waveforms.lora import chirp as chirp_mod

    p = lora.LoRaParams(sf=7)
    lanes, n_sym, iters = 8, 512, 512
    rng = np.random.default_rng(2)
    syms0 = rng.integers(0, 128, (lanes, n_sym)).astype(np.int32)

    @jax.jit
    def run(syms):
        def body(i, s):
            iq = chirp_mod.symbol_chirps(p, s).reshape(lanes, -1)
            out, _, _ = lora.demodulate_symbols(p, iq)
            return out

        s = lax.fori_loop(0, iters, body, syms)
        return jnp.sum(s).astype(jnp.float32)

    dt = _timed_scalar(run, syms0)
    sps = lanes * n_sym * p.samples_per_symbol * iters / dt
    return {"Msps": round(sps / 1e6, 1)}


def bench_fir(n_taps: int):
    """Production FIR path, ops.filters.fir_apply (gnuradio_comparison
    FIR32 80 M / FIR128 25 M)."""
    import jax
    import jax.lax as lax
    import jax.numpy as jnp
    import numpy as np

    from r4w_tpu.ops import filters as F

    n, iters = 1 << 16, 2048
    rng = np.random.default_rng(2)
    x = rng.standard_normal(n, dtype=np.float32)
    taps = jnp.asarray(rng.standard_normal(n_taps, np.float32) / n_taps)

    @jax.jit
    def run(x):
        def body(i, v):
            return F.fir_apply(taps, v) * 0.999

        v = lax.fori_loop(0, iters, body, x)
        return jnp.sum(v * v)

    dt = _timed_scalar(run, x)
    return {"Msps": round(n * iters / dt / 1e6, 1)}


def bench_rotator():
    """Complex oscillator mix (gnuradio_comparison rotator 100 M)."""
    import jax
    import jax.lax as lax
    import jax.numpy as jnp
    import numpy as np

    from r4w_tpu.core.hostio import cis

    n, iters = 1 << 16, 131072
    rng = np.random.default_rng(3)
    re = rng.standard_normal(n, dtype=np.float32)
    im = rng.standard_normal(n, dtype=np.float32)

    @jax.jit
    def run(re, im):
        v = lax.complex(re, im)

        def body(i, v):
            ph = 0.001 * (jnp.arange(n, dtype=jnp.float32) + i)
            return v * cis(ph)

        v = lax.fori_loop(0, iters, body, v)
        return jnp.sum(v.real**2 + v.imag**2)

    dt = _timed_scalar(run, re, im)
    return {"Msps": round(n * iters / dt / 1e6, 1)}


def bench_cmul():
    """Elementwise complex multiply (gnuradio_comparison cmul 200 M)."""
    import jax
    import jax.lax as lax
    import jax.numpy as jnp
    import numpy as np

    n, iters = 1 << 16, 1 << 20
    rng = np.random.default_rng(4)
    re = rng.standard_normal(n, dtype=np.float32)
    im = rng.standard_normal(n, dtype=np.float32)
    cr = rng.standard_normal(n, dtype=np.float32) * 0.01
    ci = rng.standard_normal(n, dtype=np.float32) * 0.01

    @jax.jit
    def run(re, im, cr, ci):
        v = lax.complex(re, im)
        c = lax.complex(cr, ci)
        norm = jnp.asarray(1.0, jnp.float32)

        def body(i, carry):
            v, norm = carry
            v = v * c * (1.0 + 1e-6 * norm)  # serial dependency
            return v, norm

        v, _ = lax.fori_loop(0, iters, body, (v, norm))
        return jnp.sum(v.real**2 + v.imag**2)

    dt = _timed_scalar(run, re, im, cr, ci)
    return {"Msps": round(n * iters / dt / 1e6, 1)}


def bench_bpsk_mod():
    """BPSK modulation bits->IQ (gnuradio_comparison BPSK mod 20 M)."""
    import jax
    import jax.lax as lax
    import jax.numpy as jnp
    import numpy as np

    from r4w_tpu.waveforms.linear_mod import (
        linear_modulate, psk_constellation, psk_value_to_index)

    n_bits, iters = 1 << 20, 16384
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, n_bits).astype(np.int32)
    con = jnp.asarray(psk_constellation(2))
    v2i = jnp.asarray(psk_value_to_index(2))

    @jax.jit
    def run(bits, con):
        def body(i, b):
            iq = linear_modulate(b, con, v2i, 1, sps=1)
            return jnp.abs(
                (iq.real < 0).astype(jnp.int32) - (1 - b)
            )  # decisions feed next iter (serial dep)

        b = lax.fori_loop(0, iters, body, bits)
        return jnp.sum(b).astype(jnp.float32)

    dt = _timed_scalar(run, bits, con)
    return {"Msps": round(n_bits * iters / dt / 1e6, 1)}


def bench_viterbi():
    """K=7 rate-1/2 soft Viterbi decode throughput (info Mbit/s)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from r4w_tpu.fec.convolutional import conv_encode, viterbi_decode

    n_info, lanes = 2048, 4096
    rng = np.random.default_rng(6)
    bits = rng.integers(0, 2, (lanes, n_info)).astype(np.int32)
    coded = np.asarray(conv_encode(jnp.asarray(bits)))
    soft = (1.0 - 2.0 * coded).astype(np.float32)

    @jax.jit
    def run(soft):
        dec = viterbi_decode(soft, soft=True)
        return jnp.sum(dec).astype(jnp.float32)

    dt = _timed_scalar(run, soft)
    return {"Msps": round(lanes * n_info / dt / 1e6, 1)}


def bench_pcps():
    """GPS C/A PCPS acquisition correlator throughput via the production
    acquisition.pcps_grid path (Mcorr/s = PRNs x Doppler x phases / s)."""
    import jax
    import jax.lax as lax
    import jax.numpy as jnp
    import numpy as np

    from r4w_tpu.gnss import acquisition, prn

    fs = 2_046_000.0
    n_prn = 8
    codes = np.stack([
        np.repeat(prn.gps_ca_code(p + 1), 2).astype(np.float32)
        for p in range(n_prn)
    ])  # (P, 2046) at 2 samples/chip
    cfg = acquisition.PcpsConfig(doppler_max_hz=5000.0,
                                 doppler_step_hz=250.0,
                                 coherent_periods=2)
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(4092) + 1j * rng.standard_normal(4092)
         ).astype(np.complex64)
    xd = jnp.asarray(x)
    codes_d = jnp.asarray(codes)

    iters = 16

    @jax.jit
    def run(xd):
        def body(i, carry):
            x, acc = carry
            grid = acquisition.pcps_grid(x, codes_d, fs, cfg)
            s = jnp.sum(grid)
            return x * (1.0 + 1e-12 * s), acc + s

        _, acc = lax.fori_loop(0, iters, body,
                               (xd, jnp.asarray(0.0, jnp.float32)))
        return acc.astype(jnp.float32)

    dt = _timed_scalar(run, xd)
    n_dopp = int(2 * cfg.doppler_max_hz / cfg.doppler_step_hz) + 1
    cells = iters * n_prn * n_dopp * 2046
    return {"Msps": round(cells / dt / 1e6, 1)}


def bench_channel():
    """AWGN channel apply throughput (channel.rs:667).

    Headline Msps uses the default threefry key (the production
    default — counter-based, splittable, reproducible across
    backends); the same channel code is ALSO timed with an RBG key
    (jax.random.key(impl="rbg")), since the bench is bound by random
    number generation and the key impl is the caller's choice on the
    identical awgn() path."""
    import jax
    import jax.lax as lax
    import jax.numpy as jnp
    import numpy as np

    from r4w_tpu.channel import awgn

    n, iters = 1 << 18, 16384
    rng = np.random.default_rng(8)
    re = rng.standard_normal(n, dtype=np.float32)
    im = rng.standard_normal(n, dtype=np.float32)

    @jax.jit
    def run(re, im, key):
        v = lax.complex(re, im)

        def body(i, carry):
            v, key = carry
            key, sub = jax.random.split(key)
            # renormalize the 1.01x per-iteration power growth (20 dB
            # SNR noise adds 1% power): 1.01^16384 overflows f32; one
            # extra multiply is noise next to the per-sample threefry
            v = awgn(sub, v, 20.0) * np.float32(1.0 / np.sqrt(1.01))
            return v, key

        v, _ = lax.fori_loop(0, iters, body, (v, key))
        return jnp.sum(v.real**2 + v.imag**2)

    dt = _timed_scalar(run, re, im, jax.random.key(0))
    out = {"Msps": round(n * iters / dt / 1e6, 1)}
    try:
        dt2 = _timed_scalar(run, re, im, jax.random.key(0, impl="rbg"))
        out["Msps_rbg"] = round(n * iters / dt2 / 1e6, 1)
    except Exception as e:  # noqa: BLE001 — rbg is an optional extra
        out["rbg_error"] = f"{type(e).__name__}"[:40]
    return out


def bench_lora_sweep():
    """Full LoRa SF7-SF12 Monte-Carlo BER sweep (acceptance target:
    < 60 s compute on one card). Returns compute seconds (excluding
    compile) and per-SF waterfall SNRs."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from r4w_tpu.waveforms import lora

    snrs = jnp.asarray(np.arange(-26.0, -2.0, 2.0), jnp.float32)  # 12 pts
    n_payload = 16
    waterfalls = {}
    compute_s = 0.0
    for sf in range(7, 13):
        p = lora.LoRaParams(sf=sf)
        lanes = max(4, 512 >> (sf - 7))
        payload = jnp.arange(n_payload) % p.chips_per_symbol
        keys = jax.random.split(jax.random.key(sf), lanes)

        @jax.jit
        def grid(keys, snrs, p=p, payload=payload):
            f = lambda k, s: lora.loopback_ber(p, payload, k, s)
            return jax.vmap(lambda k: jax.vmap(lambda s: f(k, s))(snrs)
                            )(keys).mean(0)

        ber = jax.device_get(grid(keys, snrs))  # compile + run
        t0 = time.perf_counter()
        ber = jax.device_get(grid(keys, snrs))  # warm run
        compute_s += time.perf_counter() - t0
        ber = np.asarray(ber)
        waterfalls[f"sf{sf}"] = (
            float(snrs[int(np.argmax(ber < 0.01))])
            if np.any(ber < 0.01) else None)
    return {"compute_s": round(compute_s, 2), "target_s": 60.0,
            "pass": compute_s < 60.0, "waterfall_snr_db": waterfalls}


def bench_pcps_gcorr():
    """Big-grid PCPS throughput in Gcorr/s (50-slot code bank x 41
    Doppler x 1023 lags, power-of-two FFT via the two-period trick).
    The bank holds the 32 distinct GPS C/A codes with 18 slots repeated
    (C/A defines only PRN 1-32) — FLOP count and throughput are
    unaffected by the repetition."""
    import jax
    import jax.lax as lax
    import jax.numpy as jnp
    import numpy as np

    from r4w_tpu.gnss import prn

    fs = 1.023e6
    n = 1023
    prns = [1 + (p % 32) for p in range(50)]
    n_dopp = 41
    iters = 1024
    codes = np.stack([np.asarray(prn.gps_ca_code(p))
                      for p in prns]).astype(np.float32)
    codesj = jnp.asarray(codes)
    nfft = 4096
    rng = np.random.default_rng(0)
    re = rng.standard_normal((2 * n,), dtype=np.float32)
    im = rng.standard_normal((2 * n,), dtype=np.float32)
    dops = jnp.arange(n_dopp, dtype=jnp.float32) * 250.0 - 5000.0
    t = jnp.arange(2 * n, dtype=jnp.float32) / fs

    @jax.jit
    def run(re, im):
        x0 = lax.complex(re, im)
        ang = -2.0 * np.pi * dops[:, None] * t[None, :]
        carriers = lax.complex(jnp.cos(ang), jnp.sin(ang))  # (D, N)
        code_fft = jnp.conj(jnp.fft.fft(codesj.astype(jnp.complex64),
                                        nfft, axis=-1))  # (K, NF)

        def body(i, x):
            mixed = x[None, :] * carriers
            mf = jnp.fft.fft(mixed, nfft, axis=-1)
            surf = jnp.fft.ifft(mf[None] * code_fft[:, None, :],
                                axis=-1)[..., :n]
            pw = surf.real**2 + surf.imag**2
            peak = jnp.max(pw)
            # non-degenerate serial dependency: 0.0*peak could be
            # algebraically eliminated, dead-coding the whole loop body
            return x * (1.0 + 1e-12 * peak)

        x = lax.fori_loop(0, iters, body, x0)
        return jnp.sum(x.real**2 + x.imag**2)

    dt = _timed_scalar(run, re, im)
    cells = len(prns) * n_dopp * n * iters
    return {"Gcorr_s": round(cells / dt / 1e9, 2),
            "grid": (f"{len(prns)}-slot bank (32 distinct C/A) x "
                     f"{n_dopp} Doppler x {n} lags")}


def bench_device_sweep():
    """On-device waveform sweep: modulate -> host -> demodulate for every
    factory waveform (the chip_smoke.py sweep phase checks payloads)."""
    import jax.numpy as jnp
    import numpy as np

    from r4w_tpu.waveforms import create_waveform, list_waveforms

    names = sorted(list_waveforms())
    t0 = time.perf_counter()
    ok, failures = 0, []
    for name in names:
        try:
            wf = create_waveform(name, 48000.0)
            iq = np.asarray(wf.modulate(b"device-sweep"))
            wf.demodulate(jnp.asarray(iq))
            ok += 1
        except Exception as e:  # noqa: BLE001 — count, report, go on
            failures.append(f"{name}: {type(e).__name__}"[:60])
    return {"ok": ok, "total": len(names), "failures": failures[:10],
            "elapsed_s": round(time.perf_counter() - t0, 1)}


BENCHES = {
    "fft1024": bench_fft1024,
    "fft256": bench_fft256,
    "fft2048": bench_fft2048,
    "fft4096": bench_fft4096,
    "fir32": lambda: bench_fir(32),
    "fir128": lambda: bench_fir(128),
    "rotator": bench_rotator,
    "cmul": bench_cmul,
    "bpsk_mod": bench_bpsk_mod,
    "viterbi_info_bits": bench_viterbi,
    "pcps_corr": bench_pcps,
    "channel_awgn": bench_channel,
    "lora_sf7_demod": bench_lora_sf7_demod,
    "udp_rx": bench_udp_rx,
    "lora_sweep": bench_lora_sweep,
    "pcps_gcorr": bench_pcps_gcorr,
    "e1c_gate": bench_e1c_gate,
    "gps_pvt_fix": bench_gps_pvt_fix,
    "dual_pvt": bench_dual_pvt,
    "glonass_track": bench_glonass_track,
    "e1c_tracking": bench_e1c_tracking,
    "device_sweep": bench_device_sweep,
}

ORDER = list(BENCHES)

# per-bench watchdogs (s): a bench that has not answered by then is
# recorded as hung and the child restarted
BUDGETS = {
    "lora_sweep": 600.0,
    "device_sweep": 1200.0,
    "e1c_gate": 900.0,
    "gps_pvt_fix": 900.0,
    "dual_pvt": 1200.0,
    "glonass_track": 900.0,
    "e1c_tracking": 900.0,
}
DEFAULT_BUDGET = 300.0

_HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_RECORD = os.environ.get(
    "R4W_BENCH_RECORD_PATH",
    os.path.join(_HERE, "chiprun_out", "bench_record.json"))
HEADLINE_MAX_BYTES = 1400


# --------------------------------------------------------------------
# Child process: line protocol — read a bench name on stdin, run it,
# print ONE JSON line {"bench", device fields, ...result} on stdout.
# --------------------------------------------------------------------

def card_info() -> str:
    """'name, power.limit' of the visible cards, as nvidia-smi says."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return "; ".join(ln.strip() for ln in out.splitlines() if ln.strip())


def child_main():
    import jax

    from r4w_tpu import compile_cache

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(json.dumps({"bench": "device", "error":
                          f"no GPU: JAX found {devices[0].platform}"}),
              flush=True)
        return 1
    compile_cache.configure()
    device = {"platform": devices[0].platform,
              "device_kind": devices[0].device_kind,
              "device_count": len(devices), "card": card_info()}
    print(json.dumps({"bench": "device", **device}), flush=True)
    for line in sys.stdin:
        name = line.strip()
        if not name:
            continue
        if name == "quit":
            break
        t0 = time.perf_counter()
        try:
            res = dict(BENCHES[name]())
        except Exception as e:  # noqa: BLE001 — report, don't die
            res = {"error": f"{type(e).__name__}: {e}"[:160]}
        res.update(device, bench=name,
                   wall_s=round(time.perf_counter() - t0, 1))
        print(json.dumps(res), flush=True)
    return 0


# --------------------------------------------------------------------
# Parent process: drives one child at a time, never imports JAX.
# --------------------------------------------------------------------

class _Child:
    def __init__(self):
        import queue
        import subprocess
        import threading

        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, bufsize=1)
        self.q = queue.Queue()

        def reader():
            for ln in self.proc.stdout:
                self.q.put(ln)
            self.q.put(None)

        threading.Thread(target=reader, daemon=True).start()

    def result(self, name: str, timeout_s: float):
        """The child's JSON line for `name`, or None on hang/death."""
        import queue

        deadline = time.time() + timeout_s
        while True:
            try:
                ln = self.q.get(timeout=max(0.1, deadline - time.time()))
            except queue.Empty:
                return None
            if ln is None:
                return None
            try:
                res = json.loads(ln)
            except json.JSONDecodeError:
                continue  # stray warning line
            if isinstance(res, dict) and res.get("bench") == name:
                return res

    def run(self, name: str, timeout_s: float):
        try:
            self.proc.stdin.write(name + "\n")
            self.proc.stdin.flush()
        except (BrokenPipeError, OSError):
            return None
        return self.result(name, timeout_s)

    def close(self):
        try:
            self.proc.stdin.write("quit\n")
            self.proc.stdin.flush()
            self.proc.wait(timeout=30)
        except Exception:  # noqa: BLE001 — closing a dead child
            pass
        self.kill()

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=10)


class Run:
    """Results of one suite run and the headline built from them."""

    def __init__(self):
        self.device = None   # the child's device record, once it answers
        self.results = {}
        self.child = None    # the live child, killed on a signal
        self.emitted = False

    def record(self, name, res):
        self.results[name] = res
        shown = {k: v for k, v in res.items() if k != "bench"}
        print(f"# {name}: {json.dumps(shown)}", file=sys.stderr, flush=True)
        if self.device is not None:  # only a GPU run writes a record
            self.write_record()

    def gates(self):
        """Compact receiver-gate digest for the headline."""
        def ok(name):
            res = self.results.get(name)
            return res if isinstance(res, dict) and "error" not in res \
                else None

        g = {}
        for name, key, field in (
                ("e1c_gate", "e1c_acq", "acquired"),
                ("e1c_tracking", "e1c_trk", "tracked"),
                ("e1c_tracking", "e1b", "e1b_pages_ok"),
                ("gps_pvt_fix", "pvt_err_m", "error_m"),
                ("dual_pvt", "dual_pvt_m", "error_m"),
                ("glonass_track", "glo", "tracked"),
                ("lora_sweep", "lora_sweep_s", "compute_s"),
                ("pcps_gcorr", "pcps_gcorr", "Gcorr_s")):
            res = ok(name)
            if res and field in res:
                g[key] = res[field]
        sweep = ok("device_sweep")
        if sweep and "ok" in sweep:
            g["sweep"] = f"{sweep['ok']}/{sweep['total']}"
        return g

    def headline(self):
        """(headline dict, ok). ok only when fft1024 ran on a GPU; a run
        without one carries no number at all."""
        fft = self.results.get("fft1024", {})
        ok = "Msps" in fft and fft.get("platform") == "gpu"
        errors = sorted(n for n, r in self.results.items()
                        if isinstance(r, dict) and "error" in r)[:8]
        if not ok:
            reason = ((self.results.get("device") or {}).get("error")
                      or "fft1024 did not complete on a GPU")
            out = {"metric": "fft1024_throughput", "value": None,
                   "unit": "Msamples/s", "vs_baseline": None,
                   "degraded": True, "extra": {"reason": reason[:200]}}
            if errors:
                out["extra"]["errors"] = errors
            return out, False
        msps = {n: int(round(r["Msps"])) for n, r in self.results.items()
                if isinstance(r, dict) and "Msps" in r and n != "fft1024"}
        out = {"metric": "fft1024_throughput", "value": fft["Msps"],
               "unit": "Msamples/s",
               "vs_baseline": round(fft["Msps"] / BASELINE_FFT1024_MSPS, 2),
               "extra": {"device": {k: fft.get(k) for k in (
                   "platform", "device_kind", "device_count", "card")},
                   "msps": msps, "gates": self.gates(),
                   "record": os.path.relpath(BENCH_RECORD, _HERE)}}
        if errors:
            out["extra"]["errors"] = errors
        for victim in ("msps", "gates", "errors"):
            if len(json.dumps(out)) <= HEADLINE_MAX_BYTES:
                break
            out["extra"].pop(victim, None)
        return out, True

    def write_record(self):
        results = {}
        for name, res in self.results.items():
            entry = {k: v for k, v in res.items() if k != "bench"}
            if "Msps" in entry and name in GR_BASELINES:
                entry["vs_gnuradio"] = round(
                    entry["Msps"] / GR_BASELINES[name], 1)
            results[name] = entry
        os.makedirs(os.path.dirname(BENCH_RECORD), exist_ok=True)
        tmp = f"{BENCH_RECORD}.tmp"
        with open(tmp, "w") as f:
            json.dump({"device": self.device, "results": results}, f,
                      indent=1)
        os.replace(tmp, BENCH_RECORD)

    def emit(self) -> int:
        """Print the headline line, once; the exit code for it."""
        if self.emitted:
            return 1
        self.emitted = True
        out, ok = self.headline()
        print(json.dumps(out), flush=True)
        return 0 if ok else 1


def _on_signal(run: Run, signum, frame):  # noqa: ARG001 — signal handler
    # `timeout` signals the process and then its group: handle one
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, signal.SIG_IGN)
    print(f"# signal {signum}: emitting the partial record",
          file=sys.stderr, flush=True)
    if run.child is not None:
        run.child.kill()
    os._exit(run.emit())


def run_suite(run: Run, order) -> None:
    run.child = _Child()
    try:
        dev = run.child.result("device", DEFAULT_BUDGET)
        if dev and "error" not in dev:
            run.device = dev
        run.record("device", dev or {"error": "child did not start"})
        if run.device is None:
            return
        for name in order:
            res = run.child.run(name, BUDGETS.get(name, DEFAULT_BUDGET))
            if res is None:
                run.record(name, {"error": "watchdog timeout"})
                run.child.close()
                run.child = _Child()
                dev = run.child.result("device", DEFAULT_BUDGET)
                if not dev or "error" in dev:
                    return
                continue
            run.record(name, res)
    finally:
        run.child.close()


def main():
    run = Run()
    handler = functools.partial(_on_signal, run)
    signal.signal(signal.SIGTERM, handler)
    signal.signal(signal.SIGINT, handler)
    atexit.register(run.emit)
    run_suite(run, ORDER[:3] if "--quick" in sys.argv else ORDER)
    return run.emit()


if __name__ == "__main__":
    raise SystemExit(child_main() if "--child" in sys.argv else main())
