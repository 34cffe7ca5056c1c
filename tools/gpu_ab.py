#!/usr/bin/env python
"""Time the alternatives behind the library's lowering choices on a GPU.

    python tools/gpu_ab.py [--out chiprun_out/gpu_ab.jsonl] [BENCH ...]

Prints one JSON line per measurement (median of 5 warm calls, waited
for on the device; `compile_s` is the first call) for each BENCH named,
or all of them:

* fir:      dense FIR as shifted multiply-adds vs lax.conv at HIGHEST,
            K = 16-256, 2^12-2^22 complex samples, and K = 32, 128 over
            batches of short lanes (4096 x 1024, 256 x 16384);
* decim:    decimating FIR K=64 by 4 and 8: strided shift-add, strided
            conv, and filter-then-discard;
* chirp:    LoRa symbol chirps by gather vs one-hot matmul, SF7-SF10;
* demod:    LoRa SF7 demodulate_symbols at (4096 x 95, 128);
* pcps:     PCPS fft_mode "exact" vs "pow2" at the E1C grid;
* viterbi:  K=7 soft decode, CUDA kernel vs the lax.scan, 4096 x 2048.

Exits non-zero without a GPU. Results name the card and its power limit.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _first_call(fn, *args) -> float:
    """Seconds of the first call: compilation plus one run."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0


def _median_time(fn, *args, reps: int = 5) -> float:
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def bench_fir(emit):
    import jax
    import jax.lax as lax
    import jax.numpy as jnp
    import numpy as np

    from r4w_tpu.ops import filters as F

    def conv(x, taps, stride):
        k = taps.shape[0]
        out = lax.conv_general_dilated(
            x.reshape(-1, 1, x.shape[-1]), taps[::-1].reshape(1, 1, k),
            window_strides=(stride,), padding="VALID",
            dimension_numbers=("NCH", "OIH", "NCH"),
            precision=lax.Precision.HIGHEST)
        return out.reshape(*x.shape[:-1], -1)

    forms = {"shift_add": F._conv_valid_shift_add, "conv": conv}
    n = 1 << 22
    rng = np.random.default_rng(0)
    planes = jax.device_put(rng.standard_normal((2, n + 255), np.float32))
    for m in (1 << 12, 1 << 16, 1 << 20, n):
        for k in (16, 32, 64, 128, 256):
            taps = jnp.asarray(rng.standard_normal(k).astype(np.float32))
            x = planes[:, : m + k - 1]
            for name, f in forms.items():
                fn = jax.jit(functools.partial(f, stride=1))
                emit({"bench": "fir", "taps": k, "samples": m, "form": name,
                      "compile_s": _first_call(fn, x, taps),
                      "s": _median_time(fn, x, taps)})
    for lanes, m in ((4096, 1024), (256, 16384)):
        for k in (32, 128):
            taps = jnp.asarray(rng.standard_normal(k).astype(np.float32))
            x = jax.device_put(rng.standard_normal(
                (2, lanes, m + k - 1)).astype(np.float32))
            for name, f in forms.items():
                fn = jax.jit(functools.partial(f, stride=1))
                emit({"bench": "fir", "taps": k, "lanes": lanes,
                      "samples": m, "form": name,
                      "compile_s": _first_call(fn, x, taps),
                      "s": _median_time(fn, x, taps)})
    taps = jnp.asarray(rng.standard_normal(64).astype(np.float32))
    x = planes[:, : n + 63]
    for factor in (4, 8):
        for name, f in forms.items():
            strided = jax.jit(functools.partial(f, stride=factor))
            discard = jax.jit(lambda x, t, f=f, m=factor: f(x, t, 1)[..., ::m])
            emit({"bench": "decim", "taps": 64, "factor": factor,
                  "form": f"{name}_strided",
                  "s": _median_time(strided, x, taps)})
            emit({"bench": "decim", "taps": 64, "factor": factor,
                  "form": f"{name}_then_discard",
                  "s": _median_time(discard, x, taps)})


def _one_hot_chirps(p, syms):
    """The one-hot-matmul form of symbol_chirps (the library keeps the
    gather): up[(n+s) % N] = up[n]·up[s]·exp(j2πns/N) as four real
    matmuls against a DFT-phase matrix."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from r4w_tpu.waveforms.lora import chirp

    n = p.samples_per_symbol
    up = chirp.base_upchirp(p)
    k = jnp.arange(n, dtype=jnp.int32)
    ang = (2.0 * np.pi / n) * ((k[:, None] * k[None, :]) % n).astype(
        jnp.float32)
    wr, wi = jnp.cos(ang), jnp.sin(ang)
    oh = jax.nn.one_hot(syms % n, n, dtype=jnp.float32)
    tone = jax.lax.complex(oh @ wr, oh @ wi)
    up_s = jax.lax.complex(oh @ up.real, oh @ up.imag)
    return tone * up_s[..., None] * up


def bench_chirp(emit):
    import jax
    import numpy as np

    from r4w_tpu.waveforms import lora
    from r4w_tpu.waveforms.lora import chirp

    rng = np.random.default_rng(1)
    for sf in (7, 8, 9, 10):
        p = lora.LoRaParams(sf=sf)
        syms = jax.device_put(rng.integers(0, 1 << sf, (64, 64)).astype(
            np.int32))
        ref = None
        for method, f, prec in (
                ("gather", chirp.symbol_chirps, None),
                ("one_hot", _one_hot_chirps, "highest"),
                ("one_hot", _one_hot_chirps, None)):
            fn = jax.jit(functools.partial(f, p))
            with jax.default_matmul_precision(prec):
                s = _median_time(fn, syms)
                out = np.asarray(fn(syms))
            ref = out if ref is None else ref
            emit({"bench": "chirp", "sf": sf, "symbols": 64 * 64,
                  "method": method, "precision": prec or "default",
                  "s": s, "max_abs_vs_gather": float(
                      np.max(np.abs(out - ref)))})


def bench_demod(emit):
    import jax
    import numpy as np

    from r4w_tpu.waveforms import lora

    p = lora.LoRaParams(sf=7)
    rng = np.random.default_rng(2)
    shape = (4096 * 95, 128)
    x = jax.device_put((rng.standard_normal(shape)
                        + 1j * rng.standard_normal(shape)).astype(
                            np.complex64))
    fn = jax.jit(lambda x: lora.demodulate_symbols(p, x)[0])
    emit({"bench": "demod", "shape": list(shape),
          "s": _median_time(fn, x)})


def bench_pcps(emit):
    import jax
    import numpy as np

    from r4w_tpu.gnss import acquisition

    fs, l, periods, prns, sub = 5e6, 20000, 50, 10, 4
    rng = np.random.default_rng(3)
    codes = jax.device_put(
        rng.choice([-1.0, 1.0], (prns, sub, l)).astype(np.float32))
    x = jax.device_put((rng.standard_normal(periods * l)
                        + 1j * rng.standard_normal(periods * l)).astype(
                            np.complex64))
    for mode in ("exact", "pow2"):
        cfg = acquisition.PcpsConfig(doppler_max_hz=5000.0,
                                     doppler_step_hz=125.0,
                                     coherent_periods=periods,
                                     fft_mode=mode)
        fn = jax.jit(lambda x, c, cfg=cfg: acquisition.pcps_grid(x, c, fs,
                                                                 cfg))
        emit({"bench": "pcps", "fft_mode": mode, "prns": prns,
              "subphases": sub, "code_samples": l, "periods": periods,
              "doppler_bins": 81, "s": _median_time(fn, x, codes, reps=3)})


def bench_viterbi(emit):
    import jax
    import numpy as np

    from r4w_tpu.fec import convolutional as C
    from r4w_tpu.kernels import cuda

    t0 = time.perf_counter()
    cuda.load()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(4)
    lanes, n_info = 4096, 2048
    bits = rng.integers(0, 2, (lanes, n_info)).astype(np.int32)
    coded = np.asarray(C.conv_encode(bits))
    soft = jax.device_put(((1.0 - 2.0 * coded) + 0.5 * rng.standard_normal(
        coded.shape)).astype(np.float32))
    kernel = jax.jit(lambda s: C.viterbi_decode(s, soft=True))
    scan = jax.jit(lambda s: C.viterbi_decode_scan(s, soft=True))
    got = np.asarray(kernel(soft))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(scan(soft))
        scan_s = _median_time(scan, soft)
    code_of = C._code_table(7, (0o171, 0o133))
    rx = soft.reshape(lanes, -1, 2)
    fwd = jax.jit(lambda r: cuda.viterbi_forward(r, code_of))
    emit({"bench": "viterbi", "lanes": lanes, "info_bits": n_info,
          "build_s": build_s, "kernel_s": _median_time(kernel, soft),
          "forward_s": _median_time(fwd, rx), "scan_s": scan_s,
          "differ": int(np.sum(got != want))})


def main() -> int:
    import jax

    if jax.devices()[0].platform != "gpu":
        print("no GPU", file=sys.stderr)
        return 1
    from r4w_tpu import compile_cache

    compile_cache.configure()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    out_path = (sys.argv[sys.argv.index("--out") + 1]
                if "--out" in sys.argv else None)
    out = open(out_path, "a") if out_path else None

    def emit(rec):
        line = json.dumps({**rec, "card": card})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    benches = {"viterbi": bench_viterbi, "fir": bench_fir,
               "chirp": bench_chirp, "demod": bench_demod,
               "pcps": bench_pcps}
    names = [a for a in sys.argv[1:] if a in benches] or list(benches)
    failed = 0
    for bench in (benches[n] for n in names):
        try:
            bench(emit)
        except Exception as e:  # noqa: BLE001 - report and go on
            failed += 1
            emit({"bench": bench.__name__, "error": f"{type(e).__name__}: "
                                                   f"{e}"[:2000]})
    if out:
        out.close()
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
