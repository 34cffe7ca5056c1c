#!/usr/bin/env python3
"""On-card smoke test: the library's main path on one NVIDIA GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded paths only

Phases (one card): device, lora_link, fir, viterbi, gnss, cli, sweep.
Each runs through the library's public API at a real size, compares
with a plain reference (numpy float64, or JAX at HIGHEST matmul
precision) and prints one JSON line with its seconds, the comparison,
its tolerance, the card and the matmul precision in force. Any failure
raises, so the script exits non-zero. The line before the last names
the card and its power limit (nvidia-smi); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

With no GPU visible the script exits non-zero before any phase, and it
needs the repository beside it. Everything runs in this one process:
a JAX process reserves most of the card's memory at start-up.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

SNRS_DB = tuple(float(s) for s in range(-16, 0, 2))  # -16 ... -2 dB
NEAR_TIE = 1e-3  # relative gap between the two largest symbol powers


class SmokeFailure(AssertionError):
    """A phase's comparison failed."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card() -> str:
    """'name, power.limit' of every visible card, as nvidia-smi says."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return "; ".join(line.strip() for line in out.splitlines()
                     if line.strip())


# ----------------------------------------------------------------------
# Plain references (numpy, float64) and comparison helpers
# ----------------------------------------------------------------------

def ref_lora_symbol_powers(rx, sf: int, bw_hz: float):
    """|FFT(rx · downchirp)|² per symbol in float64: (..., S, 2^sf)."""
    import numpy as np

    n = 1 << sf
    t = np.arange(n, dtype=np.float64) / bw_hz
    slope = bw_hz * bw_hz / n
    down = np.exp(2j * np.pi * (bw_hz / 2.0 * t - slope / 2.0 * t * t))
    x = np.asarray(rx).astype(np.complex128)
    x = x[..., : x.shape[-1] // n * n].reshape(*x.shape[:-1], -1, n)
    return np.abs(np.fft.fft(x * down, axis=-1)) ** 2


def compare_symbols(lib_syms, ref_powers, min_agree: float = 0.999):
    """Hard decisions against the float64 reference: agreement of at
    least `min_agree`, and every mismatch at a near-tie (the two largest
    reference powers within NEAR_TIE of each other)."""
    import numpy as np

    lib_syms = np.asarray(lib_syms)
    ref_syms = np.argmax(ref_powers, axis=-1)
    top2 = np.sort(np.partition(ref_powers, -2, axis=-1)[..., -2:], -1)
    gap = (top2[..., 1] - top2[..., 0]) / np.maximum(top2[..., 1], 1e-300)
    mismatch = lib_syms != ref_syms
    near = gap < NEAR_TIE
    agree = 1.0 - float(mismatch.mean())
    check(agree >= min_agree, f"symbol agreement {agree:.6f} < {min_agree}")
    check(not (mismatch & ~near).any(),
          f"{int((mismatch & ~near).sum())} mismatches away from a tie")
    return {"symbols": int(mismatch.size), "agree": agree,
            "mismatches": int(mismatch.sum()),
            "near_ties": int(near.sum()),
            "comparison": "argmax vs numpy float64 dechirp-FFT",
            "tolerance": (f">= {min_agree} agree; mismatches only where the "
                          f"top two powers differ by < {NEAR_TIE} relative")}


def compare_rel(got, want, rel: float, what: str):
    """max|got - want| <= rel · max|want|."""
    import numpy as np

    got = np.asarray(got)
    want = np.asarray(want)
    check(got.shape == want.shape, f"{what}: shape {got.shape} vs "
                                   f"{want.shape}")
    check(bool(np.isfinite(got).all()), f"{what}: non-finite output")
    scale = float(np.max(np.abs(want)))
    err = float(np.max(np.abs(got - want)))
    check(err <= rel * scale, f"{what}: max err {err:.3e} > {rel:g} x "
                              f"{scale:.3e}")
    return {"max_err": err, "scale": scale}


def compare_equal(got, want, what: str):
    import numpy as np

    got = np.asarray(got)
    want = np.asarray(want)
    check(got.shape == want.shape, f"{what}: shape {got.shape} vs "
                                   f"{want.shape}")
    diff = int(np.sum(got != want))
    check(diff == 0, f"{what}: {diff} of {got.size} differ")
    return {"differ": diff}


def _timed(fn, *args) -> float:
    """Seconds of one call, waited for on the device."""
    t0 = time.perf_counter()
    fn(*args).block_until_ready()
    return time.perf_counter() - t0


# ----------------------------------------------------------------------
# One-card phases. Sizes are arguments so the tests can run each phase
# small on the CPU; main() runs them at the sizes given here.
# ----------------------------------------------------------------------

def phase_device(n: int = 1 << 24):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from r4w_tpu import compile_cache

    dev = jax.devices()[0]
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(n, np.float32)
         + 1j * rng.standard_normal(n, np.float32)).astype(np.complex64)
    on_dev = jnp.asarray(x)
    back = np.asarray(on_dev)
    stats = dev.memory_stats() or {}
    return {"device_kind": dev.device_kind, "count": len(jax.devices()),
            "compile_cache": compile_cache.configure(),
            "bytes_limit": stats.get("bytes_limit"),
            "roundtrip_samples": n,
            **compare_equal(back.view(np.uint32), x.view(np.uint32),
                            "complex64 host->device->host"),
            "comparison": "jnp.asarray/np.asarray complex64 round trip",
            "tolerance": "bit-exact"}


def phase_lora_link(lanes: int = 4096, ref_lanes: int = 512,
                    lanes_sf12: int = 512, n_bytes: int = 64,
                    seed: int = 0):
    import jax
    import numpy as np

    from r4w_tpu import create_waveform, parallel
    from r4w_tpu.channel import awgn
    from r4w_tpu.waveforms import lora

    msg = bytes(np.random.default_rng(seed).integers(0, 256, n_bytes,
                                                     dtype=np.uint8))
    wf = create_waveform("LoRa-SF7", 125e3)
    rx = awgn(jax.random.key(seed), wf.modulate(msg), SNRS_DB[-1])
    got = bytes(np.asarray(wf.demodulate(rx).bits[:n_bytes]).astype(
        np.uint8))
    check(got == msg, "LoRa-SF7 waveform did not return the payload")

    payload = np.frombuffer(msg, np.uint8).astype(np.int32)
    snrs = np.asarray(SNRS_DB, np.float32)
    p7 = lora.LoRaParams(sf=7)
    ber7 = functools.partial(lora.loopback_ber, p7)
    keys = jax.random.split(jax.random.key(seed), lanes)
    grid = np.asarray(parallel.monte_carlo_ber(
        functools.partial(ber7, payload), keys, snrs))
    mean = np.asarray(parallel.ber_sweep(ber7, payload, snrs,
                                         n_lanes=lanes, seed=seed))
    check(grid.shape == (lanes, len(snrs)), f"BER grid {grid.shape}")
    check(bool(np.isfinite(grid).all()), "non-finite BER")
    check(np.allclose(mean, grid.mean(0), rtol=1e-5, atol=1e-7),
          "ber_sweep mean != mean of the per-lane grid")
    check(not grid[:, -1].any(),
          f"SF7 BER at {SNRS_DB[-1]} dB nonzero in "
          f"{int((grid[:, -1] > 0).sum())} lanes")

    # hard decisions on the same keys against the float64 reference
    @jax.jit
    def lane_symbols(keys, snrs):
        tx = lora.modulate(p7, payload, include_preamble=False)

        def one(k, s):
            y = awgn(k, tx, s)
            return y, lora.demodulate_symbols(p7, y)[0]

        return jax.vmap(lambda k: jax.vmap(lambda s: one(k, s))(snrs))(keys)

    y, syms = lane_symbols(keys[:ref_lanes], snrs)
    powers = ref_lora_symbol_powers(np.asarray(y), 7, p7.bw_hz)
    cmp = compare_symbols(syms, powers)

    p12 = lora.LoRaParams(sf=12)
    mean12 = np.asarray(parallel.ber_sweep(
        functools.partial(lora.loopback_ber, p12), payload, snrs,
        n_lanes=lanes_sf12, seed=seed + 1))
    check(bool(np.isfinite(mean12).all()), "non-finite SF12 BER")
    check(mean12[-1] == 0.0, f"SF12 BER at {SNRS_DB[-1]} dB = {mean12[-1]}")
    return {"lanes": lanes, "snrs_db": list(SNRS_DB),
            "ber_sf7": [float(b) for b in mean],
            "ber_sf12": [float(b) for b in mean12],
            "lanes_sf12": lanes_sf12, "ref_lanes": ref_lanes, **cmp}


def phase_fir(n: int = 1 << 22, seed: int = 0):
    import jax
    import numpy as np
    import scipy.signal

    from r4w_tpu.ops import filters

    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    xd = jax.device_put(x)
    x64 = x.astype(np.complex128)
    rel = 1e-5
    errs = {}
    for k in (32, 128):
        taps = filters.design_lowpass(k, 20e3, 125e3)
        y, _ = jax.jit(filters.fir_filter)(taps, xd)
        want = np.convolve(x64, taps.astype(np.float64))[:n]
        errs[f"fir{k}"] = compare_rel(y, want, rel, f"fir K={k}")["max_err"]
    taps = filters.design_lowpass(64, 10e3, 125e3)
    for factor in (4, 8):
        y, _ = jax.jit(filters.decimating_fir, static_argnums=2)(
            taps, xd, factor)
        want = scipy.signal.lfilter(taps.astype(np.float64), 1.0,
                                    x64)[::factor]
        errs[f"decim64_by{factor}"] = compare_rel(
            y, want, rel, f"decimating K=64 /{factor}")["max_err"]
    return {"samples": n, "max_err": errs,
            "comparison": "np.convolve / scipy.signal.lfilter in float64",
            "tolerance": (f"max err <= {rel:g} x max|y|: float32 "
                          "accumulation over <= 128 taps")}


def phase_viterbi(lanes: int = 4096, n_info: int = 2048, seed: int = 0):
    import jax
    import numpy as np

    from r4w_tpu.fec.convolutional import (conv_encode, viterbi_decode,
                                           viterbi_decode_scan)

    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (lanes, n_info)).astype(np.int32)
    coded = np.asarray(conv_encode(bits))
    decode = jax.jit(lambda s: viterbi_decode(s, soft=True))
    scan = jax.jit(lambda s: viterbi_decode_scan(s, soft=True))
    out = {"lanes": lanes, "info_bits": n_info}
    for sigma in (0.5, 0.3):
        soft = jax.device_put(
            ((1.0 - 2.0 * coded)
             + sigma * rng.standard_normal(coded.shape)).astype(np.float32))
        got = decode(soft).block_until_ready()
        with jax.default_matmul_precision("highest"):
            want = scan(soft).block_until_ready()
        compare_equal(got, want, f"decisions at sigma={sigma}")
        if sigma == 0.3:
            compare_equal(got, bits, "decoded bits at sigma=0.3")
        out[f"bit_errors_sigma{sigma}"] = int(np.sum(np.asarray(got)
                                                     != bits))
    # steady-state time of each decoder, best of 3 (compiled above)
    for name, fn, prec in (("decode_s", decode, None),
                           ("scan_s", scan, "highest")):
        with jax.default_matmul_precision(prec):
            out[name] = min(_timed(fn, soft) for _ in range(3))
    out.update(comparison="viterbi_decode vs viterbi_decode_scan at "
                          "HIGHEST, and vs the sent bits at sigma=0.3",
               tolerance="bit-identical")
    return out


def phase_gnss():
    sys.path.insert(0, ROOT)
    from tools.gps_pvt_fix import main_decoded

    res = main_decoded()
    check(res["value"] < 50.0, f"GPS fix error {res['value']} m >= 50 m")
    check(bool(res["pass"]), f"GPS receiver gate failed: {res}")
    return {"fix_error_m": res["value"],
            "acquired": f"{res['acquired']}/{res['of']}",
            "decoded": f"{res['decoded']}/{res['of']}",
            "gen_s": res["gen_s"], "acquire_s": res["acquire_s"],
            "track_s": res["track_s"],
            "comparison": "position fix vs scenario truth",
            "tolerance": "< 50 m"}


CLI_RUNS = (
    ["simulate", "-w", "QPSK", "--snr", "12", "-m", "over the air"],
    ["simulate", "-w", "LoRa", "--snr", "0", "-m", "over the air"],
)


def phase_cli(runs=CLI_RUNS):
    from r4w_tpu import cli

    out = {}
    for argv in runs:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(list(argv))
        text = buf.getvalue()
        msg = argv[argv.index("-m") + 1].encode()
        check(f"received:  {msg.hex()}" in text and "match:     YES" in text,
              f"cli {' '.join(argv)} did not decode the message:\n{text}")
        out[argv[2]] = "match"
    return {**out, "comparison": "decoded message vs sent",
            "tolerance": "exact"}


# The sweep runs every waveform at 48 kHz, except those whose signal
# does not fit in it: each of these runs at a rate its receivers use.
SWEEP_RATE_HZ = {
    "ADS-B": 2_000_000.0,       # 1 Mbit/s pulse pairs: 2 samples per bit
    "FM-Broadcast": 240_000.0,  # 75 kHz deviation needs > 150 kHz
}
# An FM discriminator differences adjacent samples: its output is one
# sample shorter, and returns the payload from its second byte on.
FIRST_BYTE_CONSUMED = {"FM-Broadcast", "NBFM"}


def phase_sweep(names=None, payload: bytes = b"device-sweep"):
    import jax.numpy as jnp
    import numpy as np

    from r4w_tpu.waveforms import create_waveform, list_waveforms

    names = sorted(list_waveforms()) if names is None else names
    returned, no_data = [], []
    for name in names:
        wf = create_waveform(name, SWEEP_RATE_HZ.get(name, 48000.0))
        iq = np.asarray(wf.modulate(payload))
        check(bool(np.isfinite(iq).all()), f"{name}: non-finite IQ")
        res = wf.demodulate(jnp.asarray(iq))
        if wf.info().carries_data:
            want = payload[1:] if name in FIRST_BYTE_CONSUMED else payload
            got = bytes(np.asarray(res.bits).astype(np.uint8))[:len(want)]
            check(got == want, f"{name}: payload {got!r}, sent {want!r}")
            returned.append(name)
        else:
            if res.bits is not None:
                check(bool(np.isfinite(np.asarray(res.bits)).all()),
                      f"{name}: non-finite output")
            no_data.append(name)
    return {"waveforms": len(names), "payload_returned": len(returned),
            "no_data": no_data,
            "comparison": "demodulated payload vs sent (FM: from the "
                          "second byte); finite output for waveforms that "
                          "carry no data",
            "tolerance": "exact"}


PHASES = (
    ("device", phase_device),
    ("lora_link", phase_lora_link),
    ("fir", phase_fir),
    ("viterbi", phase_viterbi),
    ("gnss", phase_gnss),
    ("cli", phase_cli),
    ("sweep", phase_sweep),
)


# ----------------------------------------------------------------------
# Four cards: the sharded paths and their one-card comparisons
# ----------------------------------------------------------------------

def sharded_ber(lanes: int = 16384, n_bytes: int = 64, seed: int = 0,
                chunk: int = 4096):
    """parallel.ber_sweep over a ("dp",) mesh of every card vs the same
    keys on one card (in chunks of `chunk` lanes)."""
    import jax
    import numpy as np

    from r4w_tpu import parallel
    from r4w_tpu.channel import awgn
    from r4w_tpu.waveforms import lora

    payload = np.random.default_rng(seed).integers(0, 256, n_bytes).astype(
        np.int32)
    snrs = np.asarray(SNRS_DB, np.float32)
    p7 = lora.LoRaParams(sf=7)
    fn = functools.partial(lora.loopback_ber, p7, payload)
    mesh = parallel.make_mesh(("dp",))
    keys = jax.random.split(jax.random.key(seed), lanes)
    sharded = np.asarray(parallel.monte_carlo_ber(fn, keys, snrs,
                                                  mesh=mesh))
    mean = np.asarray(parallel.ber_sweep(
        functools.partial(lora.loopback_ber, p7), payload, snrs,
        n_lanes=lanes, seed=seed, mesh=mesh))
    one = np.concatenate([
        np.asarray(parallel.monte_carlo_ber(fn, keys[i:i + chunk], snrs))
        for i in range(0, lanes, chunk)])
    check(np.allclose(mean, sharded.mean(0), rtol=1e-5, atol=1e-7),
          "sharded ber_sweep mean != mean of the sharded grid")
    lane, col = np.nonzero(sharded != one)
    near_ties = 0
    if lane.size:
        # a differing lane must hold a symbol at a near-tie
        @jax.jit
        def rx_of(k, s):
            return awgn(k, lora.modulate(p7, payload,
                                         include_preamble=False), s)

        for i, j in zip(lane, col):
            pw = ref_lora_symbol_powers(
                np.asarray(rx_of(keys[i], snrs[j])), 7, p7.bw_hz)
            top2 = np.sort(np.partition(pw, -2, -1)[..., -2:], -1)
            gap = (top2[..., 1] - top2[..., 0]) / top2[..., 1]
            check(bool((gap < NEAR_TIE).any()),
                  f"lane {i} @ {snrs[j]} dB differs away from a tie")
            near_ties += 1
    return {"lanes": lanes, "devices": len(mesh.devices.flat),
            "ber": [float(b) for b in mean], "differ_at_near_ties":
            near_ties, "comparison": "per-lane BER, sharded vs one card",
            "tolerance": "equal except lanes with a near-tie symbol"}


def sharded_pcps(n_prn: int = 32, fs: float = 2_046_000.0, seed: int = 0):
    """PRN bank sharded over the cards vs the whole bank on one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P

    from r4w_tpu.gnss import acquisition, prn as prn_mod

    devices = jax.devices()
    sps = int(round(fs / 1_023_000.0))
    prns = [i % 32 + 1 for i in range(n_prn)]
    codes = np.repeat(prn_mod.code_bank(prns), sps, axis=-1).astype(
        np.float32)
    cfg = acquisition.PcpsConfig(doppler_max_hz=5000.0,
                                 doppler_step_hz=250.0,
                                 coherent_periods=2)
    true_idx, true_dop = 5, 1250.0
    n = 2 * codes.shape[-1]
    t = np.arange(n) / fs
    rng = np.random.default_rng(seed)
    x = (np.tile(codes[true_idx], 2) * np.exp(2j * np.pi * true_dop * t)
         + 2.0 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
    x = jnp.asarray(x.astype(np.complex64))
    mesh = Mesh(np.asarray(devices), ("prn",))

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(P(), P("prn")),
                       out_specs=P("prn"))
    def shard(x, local_codes):
        grid = acquisition.pcps_grid(x, local_codes, fs, cfg)
        return jnp.max(grid.reshape(grid.shape[0], -1), axis=-1)

    peaks = np.asarray(jax.jit(shard)(x, jnp.asarray(codes)))
    one = jax.device_put(x, devices[0])
    grid = acquisition.pcps_grid(one, jax.device_put(codes, devices[0]),
                                 fs, cfg)
    want = np.asarray(jnp.max(grid.reshape(grid.shape[0], -1), axis=-1))
    rel = 1e-5
    err = compare_rel(peaks, want, rel, "PRN-sharded PCPS peaks")
    check(int(np.argmax(peaks)) == true_idx, "sharded PCPS missed the PRN")
    return {"prns": n_prn, "devices": len(devices), **err,
            "comparison": "per-PRN grid peak, sharded vs one card",
            "tolerance": f"max err <= {rel:g} x max peak (FFT batch "
                         "order)"}


def sharded_scenario(n_sv: int = 8, n_blk: int = 1 << 22):
    """SV bank sharded over the cards, psum'd composite vs one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P

    from r4w_tpu.gnss import scenario as sc

    devices = jax.devices()
    cfg = sc.ScenarioConfig(
        sample_rate=1_023_000.0 * 2,
        satellites=tuple(
            sc.SatelliteConfig(signal="GpsL1Ca", prn=p + 1, cn0_dbhz=45.0,
                               doppler_hz=250.0 * p - 800.0,
                               range_m=2.1e7 + 3.0e5 * p)
            for p in range(n_sv)),
        seed=5)
    gen = sc.GnssScenario(cfg)
    banks = gen.sv_banks()
    args, key = gen.block_inputs(n_blk)
    zero_noise = jnp.asarray(0.0, jnp.float32)
    on0 = functools.partial(jax.device_put, device=devices[0])
    ref = sc.composite_block(*map(on0, banks), *map(on0, args),
                             zero_noise, key, n=n_blk, fs=cfg.sample_rate)
    mesh = Mesh(np.asarray(devices), ("sv",))
    specs = tuple(P("sv") for _ in banks) + tuple(P("sv") for _ in args)

    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=specs + (P(), P()), out_specs=P())
    def shard(*all_args):
        *sharded, ns, k = all_args
        local = sc.composite_block(*sharded, ns, k, n=n_blk,
                                   fs=cfg.sample_rate)
        return jax.lax.psum(local, axis_name="sv")

    composite = jax.jit(shard)(*banks, *args, zero_noise, key)
    rel = 1e-4
    err = compare_rel(composite, ref, rel, "SV-sharded composite")
    return {"svs": n_sv, "samples": n_blk, "devices": len(devices), **err,
            "comparison": "psum'd sharded composite vs one card",
            "tolerance": f"max err <= {rel:g} x max|composite|"}


FOUR_CARD_PHASES = (
    ("sharded_ber", sharded_ber),
    ("sharded_pcps", sharded_pcps),
    ("sharded_scenario", sharded_scenario),
)


# ----------------------------------------------------------------------

def run_phases(phases, card_info: str) -> None:
    import jax

    for name, fn in phases:
        t0 = time.perf_counter()
        res = fn()
        rec = {"phase": name, "seconds": time.perf_counter() - t0, **res,
               "card": card_info,
               "matmul_precision": str(jax.config.jax_default_matmul_precision)}
        print(json.dumps(rec), flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four = "--four-cards" in argv
    if not os.path.isdir(os.path.join(ROOT, "r4w_tpu")):
        print("chip_smoke.py needs the repository beside it (r4w_tpu/)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform}", file=sys.stderr)
        return 1
    want = 4 if four else 1
    if len(devices) < want:
        print(f"need {want} GPUs, found {len(devices)}", file=sys.stderr)
        return 1

    from r4w_tpu import compile_cache

    compile_cache.configure()
    card_info = card()
    run_phases(FOUR_CARD_PHASES if four else PHASES, card_info)
    print(f"card: {card_info}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
