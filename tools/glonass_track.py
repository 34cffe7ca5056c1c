"""GLONASS L1OF FDMA acquisition+tracking acceptance (third
constellation).

A 6-SV scenario puts every satellite on its own FDMA channel
(k·562.5 kHz, k = −3..+2) with the true 0.511 Mchip/s code rate,
distinct range rates, and PRBS nav bits at 50 bps. The receiver knows
only the FDMA plan: it mixes each channel to baseband with the exact
integer-phase rational (no float drift over the capture), runs PCPS
acquisition per channel with the shared 511-chip m-sequence, hands off
to the production Costas DLL/PLL, and recovers the 20 ms nav bits from
the prompt stream. All six channels share ONE spreading code — the
only separation is frequency, so this is a true FDMA test.

Prints ONE JSON line. Run on the GPU:
  timeout 900 python tools/glonass_track.py

Reference role: the reference carries the GLONASS L1OF waveform
(crates/r4w-core/src/waveform/gnss/glonass_l1of.rs) but its scenario
engine and receiver never model FDMA; this gate goes beyond by closing
generation → FDMA channelization → tracking → bit recovery end to end.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
from fractions import Fraction

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

FS = 6_132_000.0          # 12 samples/chip, exact on the 562.5 kHz grid
CHIP_RATE = 511_000.0
CODE_LEN = 511
SPS = 12                  # samples per chip
L = CODE_LEN * SPS        # samples per 1 ms code period
GLONASS_L1_HZ = 1_602_000_000.0
FDMA_STEP_HZ = 562_500.0
LIGHT = 299_792_458.0


def _fdma_plan(ks):
    """(nums (K,), den) with num/den = k·562.5 kHz / fs exactly."""
    fracs = [Fraction(k * FDMA_STEP_HZ) / Fraction(FS) for k in ks]
    den = 1
    for fr in fracs:
        den = den * fr.denominator // math.gcd(den, fr.denominator)
    return np.asarray([int(fr * den) % den for fr in fracs],
                      np.int32), den


def _prbs_bits(seed: int, n: int = 256) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (1 - 2 * rng.integers(0, 2, n)).astype(np.int32)


def main(cn0_dbhz: float = 45.0, duration_s: float = 4.0) -> dict:
    import jax
    import jax.numpy as jnp

    from r4w_tpu.core.hostio import cis
    from r4w_tpu.gnss import acquisition, prn as prn_mod, tracking
    from r4w_tpu.gnss.scenario import (GnssScenario, ReceiverConfig,
                                       SatelliteConfig, ScenarioConfig)

    ks = [-3, -2, -1, 0, 1, 2]
    prns = list(range(1, len(ks) + 1))
    rdots = [-90.0, -55.0, -20.0, 15.0, 50.0, 85.0]
    nav = [_prbs_bits(100 + p) for p in prns]

    t0 = time.time()
    sats = tuple(
        SatelliteConfig(
            signal="GlonassL1of", prn=p, cn0_dbhz=cn0_dbhz,
            carrier_offset_hz=k * FDMA_STEP_HZ,
            range_m=21_000_000.0 + 150_000.0 * i,
            range_rate_mps=rdots[i], elevation_deg=55.0,
            nav_data=True, nav_bits=tuple(int(v) for v in nav[i]))
        for i, (p, k) in enumerate(zip(prns, ks)))
    cfg = ScenarioConfig(sample_rate=FS, duration_s=duration_s,
                         satellites=sats,
                         receiver=ReceiverConfig(lat_deg=45.0,
                                                 lon_deg=7.0),
                         seed=202)
    rx = GnssScenario(cfg).generate_device(duration_s)
    rx.block_until_ready()
    gen_s = time.time() - t0

    # --- exact FDMA mixdown (one (K, N) baseband bank) ----------------
    nums, den = _fdma_plan(ks)
    n_total = rx.shape[0]

    @jax.jit
    def mixdown(x, ms):
        q = jnp.mod(jnp.arange(n_total, dtype=jnp.int32), den)

        def one(m):
            ph = jnp.mod(q * m, den).astype(jnp.float32) / den
            return x * cis(-2.0 * jnp.pi * ph)

        return jax.vmap(one)(ms)

    mixed = mixdown(rx, jnp.asarray(nums))
    mixed.block_until_ready()

    # --- PCPS acquisition per channel (shared m-sequence) -------------
    code = prn_mod.glonass_l1of_code().astype(np.float32)
    code_os = np.repeat(code, SPS)[None]  # (1, L)
    acq_cfg = acquisition.PcpsConfig(
        doppler_max_hz=750.0, doppler_step_hz=250.0,
        coherent_periods=8, threshold=2.0, subsample_phases=1)
    n_acq = 12 * L
    t1 = time.time()
    det, tau, dop, metric = [], [], [], []
    for i in range(len(ks)):
        res = acquisition.acquire(mixed[i, :n_acq],
                                  jnp.asarray(code_os), [prns[i]],
                                  FS, acq_cfg)
        det.append(bool(np.asarray(res.detected)[0]))
        tau.append(float(np.asarray(res.code_phase)[0]))
        dop.append(float(np.asarray(res.doppler_hz)[0]))
        metric.append(float(np.asarray(res.peak_metric)[0]))
    acquire_s = time.time() - t1
    det = np.asarray(det)
    tau = np.asarray(tau)
    dop = np.asarray(dop)

    # --- production DLL/PLL per channel (code-epoch-aligned) ----------
    t2 = time.time()
    tcfg = tracking.TrackingConfig(
        code_length=CODE_LEN, sample_rate=FS, chipping_rate=CHIP_RATE,
        carrier_hz=GLONASS_L1_HZ, costas=True, fll_gain=0.2)
    cps = CHIP_RATE / FS
    istart = np.floor(tau).astype(np.int64)
    frac = tau - istart
    phase0 = (CODE_LEN - frac * cps) % CODE_LEN
    bs = tcfg.block_size
    n_keep = ((n_total - int(istart.max())) // bs) * bs
    st0 = tracking.init_state(tcfg,
                              jnp.asarray(phase0, jnp.float32),
                              jnp.asarray(dop, jnp.float32))
    run = jax.jit(jax.vmap(
        lambda s, i0, x: tracking.track(
            tcfg, s, jax.lax.dynamic_slice(x, (i0,), (n_keep,)),
            jnp.asarray(code)),
        in_axes=(0, 0, 0)))
    _fin, outs = run(st0, jnp.asarray(istart.astype(np.int32)), mixed)
    prompt_i = np.asarray(jax.device_get(outs.prompt_i), np.float64)
    prompt_q = np.asarray(jax.device_get(outs.prompt_q), np.float64)
    carr = np.asarray(jax.device_get(outs.carrier_freq), np.float64)
    cn0_tr = np.asarray(jax.device_get(outs.cn0_dbhz), np.float64)
    track_s = time.time() - t2

    # --- per-channel verdicts -----------------------------------------
    n_blocks = prompt_i.shape[1]
    half = n_blocks // 2
    per_ch = []
    n_lock = 0
    for i, (p, k) in enumerate(zip(prns, ks)):
        # expected residual Doppler on THIS channel after mixdown
        f_ch = GLONASS_L1_HZ + k * FDMA_STEP_HZ
        dop_true = -rdots[i] * f_ch / LIGHT
        dop_meas = float(np.median(carr[i, half:]))
        # I/Q power dominance over the locked half
        pi = prompt_i[i, half:]
        pq = prompt_q[i, half:]
        lock = float(np.mean(np.abs(pi)) / (np.mean(np.abs(pq)) + 1e-12))
        cn0_est = float(np.median(cn0_tr[i, -1000:]))
        # 20 ms nav bits: best (offset, shift) alignment against the
        # transmitted PRBS; Costas 180° ambiguity → accept either sign
        signs = np.sign(pi)
        best = 0.0
        for off in range(20):
            m = (len(signs) - off) // 20
            if m < 60:
                continue
            grp = signs[off:off + m * 20].reshape(m, 20).sum(axis=1)
            bits_est = np.sign(grp + 1e-9).astype(np.int32)
            tx = np.asarray(nav[i], np.float64)
            # correlate over cyclic shifts of the 256-bit PRBS
            for sh in range(256):
                ref = tx[(sh + np.arange(m)) % 256]
                match = float(np.mean(bits_est == ref))
                best = max(best, match, 1.0 - match)
        ok = bool(det[i] and lock > 2.0
                  and abs(dop_meas - dop_true) < 5.0 and best >= 0.98)
        n_lock += ok
        per_ch.append({
            "prn": p, "k": k, "acq": bool(det[i]),
            "acq_metric": round(metric[i], 2),
            "dop_err_hz": round(dop_meas - dop_true, 2),
            "lock": round(lock, 2), "cn0_dbhz": round(cn0_est, 1),
            "bit_match": round(best, 4), "ok": ok,
        })

    import jax as _jax
    return {
        "metric": "glonass_track",
        "value": n_lock,
        "unit": "channels",
        "of": len(ks),
        "pass": bool(n_lock == len(ks)),
        "cn0_dbhz": cn0_dbhz,
        "fs": FS,
        "per_ch": per_ch,
        "device": str(_jax.devices()[0]),
        "gen_s": round(gen_s, 1),
        "acquire_s": round(acquire_s, 1),
        "track_s": round(track_s, 1),
    }


if __name__ == "__main__":
    print(json.dumps(main()))
