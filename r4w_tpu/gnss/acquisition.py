"""PCPS acquisition, batched over PRN × Doppler × code phase.

Re-design of waveform/gnss/acquisition.rs:104-199: the reference loops
Doppler bins per PRN with a serial FFT each. Here the entire
(PRN × Doppler) grid is ONE batched computation:

    mixed[p, d, n]   = x[n]·e^{-j2πf_d t_n}           (outer product)
    CORR[p, d, :]    = IFFT( FFT(mixed) · conj(FFT(code_p)) )

XLA maps the batched FFTs and the broadcast multiply straight onto the
device — millions of correlations per call.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from r4w_tpu.core.hostio import cis
import numpy as np

from r4w_tpu.core.types import IQ_DTYPE, REAL_DTYPE, next_pow2


class AcquisitionResult(NamedTuple):
    prn: jax.Array  # (P,) PRN ids
    detected: jax.Array  # (P,) bool
    code_phase: jax.Array  # (P,) samples
    doppler_hz: jax.Array  # (P,)
    peak_metric: jax.Array  # (P,) peak/noise-floor
    cn0_estimate: jax.Array  # (P,) dB-Hz (valid where detected)


@dataclasses.dataclass(frozen=True)
class PcpsConfig:
    """Mirror of PcpsAcquisition settings (acquisition.rs:60-95)."""

    doppler_max_hz: float = 5000.0
    doppler_step_hz: float = 500.0
    threshold: float = 2.5
    coherent_periods: int = 1
    # Sub-sample replica phases: a worst-case half-sample code misalignment
    # costs ~3.7 dB on nearest-sampled CBOC at 5 MS/s. Supply codes of
    # shape (P, S, L) — S replicas gathered at sub-sample offsets (see
    # `sampled_code_bank`) — and the grid takes the best sub-phase.
    subsample_phases: int = 4
    # Deviation from acquisition.rs: the noise grid max follows
    # max-of-gamma(K) statistics, so a fixed peak/mean threshold
    # false-alarms on any realistic grid. With auto_threshold the
    # effective threshold is threshold + A(K, N) where
    # A = 1 + 2·sqrt(ln N / K) + 2·ln N / K (Gumbel-ish upper bound).
    auto_threshold: bool = True
    # FFT strategy: "exact" = circular correlation at nfft=L (always
    # correct); "pow2" = two-period linear correlation at
    # nfft=next_pow2(2L) — every lag is a full L-term sum (exact, no
    # wrap) but needs >=2 code periods of input, spends K-1 instead of
    # K non-coherent sums, and inflates the correlation tensor by
    # next_pow2(2L)/L (3.3x at E1C's L=20000 — the big-grid memory
    # limit, not FLOPs, usually binds). "auto" resolves to "exact",
    # which is also the faster on an H100 at the E1C grid (PERF.md,
    # "PCPS fft_mode"); opt into "pow2" for awkward (prime-ish) L.
    fft_mode: str = "auto"
    # chunk the (P,S,K,D,F) correlation tensor to fit device memory;
    # None = a quarter of what the device lets this process hold (see
    # default_memory_budget; the per-PRN estimate already carries 4x
    # slack for XLA's FFT temps)
    memory_budget_bytes: float | None = None
    # Alignment verification pass: after the coarse grid peak, re-measure
    # each PRN with correlation windows aligned to its code-period
    # boundaries (segments start at the found code phase). Pilot signals
    # with secondary codes (Galileo E1C CS25) flip sign at period
    # boundaries; unaligned windows straddle a flip and lose up to the
    # whole peak, while aligned windows see a constant sign — this
    # restores the full non-coherent gain. Harmless (same statistic) for
    # plain codes. Needs >= 2 code periods of input.
    align_refine: bool = True
    # carrier frequency for code-Doppler slewing in the refine pass
    carrier_hz: float = 1_575_420_000.0

    def noise_max_estimate(self, total_bins: int) -> float:
        """Mean-normalized (1-1/N) quantile of the max of N Gamma(K)
        noise bins, via the Wilson-Hilferty chi-square approximation."""
        k = max(1, self.coherent_periods)
        ln_n = float(np.log(max(total_bins, 2)))
        z = np.sqrt(2.0 * ln_n)  # ~ Phi^-1(1 - 1/N)
        wh = (1.0 - 1.0 / (9.0 * k) + z / (3.0 * np.sqrt(k))) ** 3
        return float(wh)


def default_memory_budget() -> float:
    """A quarter of the default device's memory limit for this process
    (`bytes_limit`), or 4e9 where the device reports none (the CPU)."""
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    return limit / 4.0 if limit else 4e9


def doppler_bins(cfg: PcpsConfig) -> np.ndarray:
    n = int(2 * cfg.doppler_max_hz / cfg.doppler_step_hz) + 1
    return (-cfg.doppler_max_hz
            + np.arange(n) * cfg.doppler_step_hz).astype(np.float32)


def pcps_grid(x, codes, sample_rate, cfg: PcpsConfig = PcpsConfig(),
              dop_subset=None):
    """Full correlation surface |corr|² of shape (P, D, L).

    dop_subset: optional explicit Doppler bins (Hz) instead of the
    cfg-derived grid — the seam for sharding the Doppler axis across
    devices (each device evaluates its slice of the search grid).

    x: (N,) complex input; codes: (P, L) ±1 sampled replicas (L samples
    per code period, same rate as x). With cfg.coherent_periods=K and
    N ≥ K·L, K period slices are correlated as one extra batch axis and
    their powers summed (non-coherent integration — robust to residual
    Doppler, unlike coherent summation over long spans).

    The intermediate correlation tensor is (P, S, K, D, F) complex64;
    at E1C scale with long integration it can exceed HBM, so the PRN
    and Doppler axes are chunked to cfg.memory_budget_bytes (static
    shapes — safe under jit, loops unroll).
    """
    codes = jnp.asarray(codes, REAL_DTYPE)
    if codes.ndim == 2:
        codes = codes[:, None, :]  # (P, S=1, L)
    p, s, l = codes.shape
    if dop_subset is not None:
        return _pcps_grid_one(x, codes, sample_rate, cfg,
                              dop_subset=dop_subset)
    n_dop = len(doppler_bins(cfg))
    k_eff = max(1, min(cfg.coherent_periods, np.shape(x)[-1] // l))
    nfft_est = (1 << int(np.ceil(np.log2(2 * l)))
                if cfg.fft_mode == "pow2" and k_eff >= 2 else l)
    # per-PRN live bytes per scan step: complex corr + f32 accumulator
    # (+ slack for XLA fft padding/temps)
    per_prn = s * n_dop * nfft_est * 8 * 4
    budget = cfg.memory_budget_bytes or default_memory_budget()
    if p * per_prn > budget:
        if per_prn <= budget:
            chunk = max(1, int(budget // per_prn))
            return jnp.concatenate(
                [_pcps_grid_one(x, codes[i: i + chunk], sample_rate, cfg)
                 for i in range(0, p, chunk)], axis=0)
        # one PRN alone exceeds the budget: also chunk the Doppler axis
        d_chunk = max(1, int(budget * n_dop // per_prn))
        dops = doppler_bins(cfg)
        outs = []
        for i in range(0, p):
            rows = [
                _pcps_grid_one(x, codes[i: i + 1], sample_rate, cfg,
                               dop_subset=dops[j: j + d_chunk])
                for j in range(0, n_dop, d_chunk)
            ]
            outs.append(jnp.concatenate(rows, axis=1))
        return jnp.concatenate(outs, axis=0)
    return _pcps_grid_one(x, codes, sample_rate, cfg)


def _pcps_grid_one(x, codes, sample_rate, cfg: PcpsConfig,
                   dop_subset=None):
    p, s, l = codes.shape
    x = jnp.asarray(x, IQ_DTYPE)
    k = max(1, min(cfg.coherent_periods, x.shape[-1] // l))
    mode = cfg.fft_mode
    if mode == "auto":
        mode = "exact"  # see PcpsConfig.fft_mode: memory binds first
    if mode == "pow2" and k >= 2:
        # Two-period linear correlation: slice i covers samples
        # [i·L, i·L + 2L); c[tau] = sum_m x[iL+tau+m]·code[m] is a full
        # L-term sum for every tau in [0, L) with nfft >= 2L (no wrap
        # because the zero-padded code kills indices >= L). Exact.
        k_slices = k - 1
        nfft = 1 << int(np.ceil(np.log2(2 * l)))
        idx = (jnp.arange(k_slices)[:, None] * l
               + jnp.arange(2 * l)[None, :])
        xs = x[..., : k * l][idx]  # (K-1, 2L)
        t = jnp.arange(2 * l, dtype=REAL_DTYPE) / sample_rate
    else:
        # Exact-length FFT: the code is L-periodic, so circular
        # correlation at period L is the correct operation. (The
        # reference zero-pads to the next power of two,
        # acquisition.rs:64 — harmless for L=1023→1024 but badly
        # aliased for L=20000→32768, killing peaks at lags > nfft-L.)
        k_slices = k
        nfft = l
        xs = x[..., : k * l].reshape(k, l)
        t = jnp.arange(l, dtype=REAL_DTYPE) / sample_rate
    dops = jnp.asarray(doppler_bins(cfg) if dop_subset is None
                       else dop_subset)
    # carrier wipeoff for every Doppler bin at once. Per-slice carrier
    # start phases differ but only add a constant rotation per slice,
    # which |·|² discards.
    carriers = cis(
        -2 * jnp.pi * (dops[:, None] * t[None, :]).astype(REAL_DTYPE)
    ).astype(IQ_DTYPE)
    code_fft = jnp.conj(
        jnp.fft.fft(codes.astype(IQ_DTYPE), n=nfft, axis=-1)
    )  # (P, S, F)

    # Non-coherent sum as a scan over the K' period slices: the live
    # tensor is (P, S, D, F) per step instead of (P, S, K', D, F) —
    # long integrations (K=50+) would otherwise blow out HBM.
    def step(acc, x_slice):
        mixed = x_slice[None, :] * carriers  # (D, W)
        mf = jnp.fft.fft(mixed, n=nfft, axis=-1)  # (D, F)
        corr = jnp.fft.ifft(
            mf[None, None, :, :] * code_fft[:, :, None, :], axis=-1
        )  # (P, S, D, F)
        return acc + (corr.real**2 + corr.imag**2), None

    init = jnp.zeros((p, s, dops.shape[0], nfft), REAL_DTYPE)
    # under shard_map the body output varies over the mesh axes of
    # codes/x; the init carry must carry the same varying-manual-axes
    # marking or scan rejects the carry type (no-op outside shard_map)
    vma = (frozenset(getattr(jax.typeof(codes), "vma", ()))
           | frozenset(getattr(jax.typeof(x), "vma", ()))
           | frozenset(getattr(jax.typeof(dops), "vma", ())))
    if vma:
        init = jax.lax.pvary(init, tuple(vma))
    power, _ = jax.lax.scan(step, init, xs)
    power = jnp.max(power, axis=1)  # best sub-phase replica: (P, D, F)
    return power[..., :l]


def _aligned_metric(x, codes, phase, dop, noise_floor, sample_rate,
                    cfg: PcpsConfig):
    """Verification statistic with code-period-aligned windows: for each
    PRN, segments of one code period starting at its found code phase
    are coherently correlated at the found Doppler and power-summed.
    Secondary-code sign flips land exactly on window edges, so the full
    per-period coherent gain survives (|·|² is sign-invariant).

    The window slew is SUB-SAMPLE: the received code period is
    L·(1−fd/fc) samples, so over long integrations the code phase
    drifts continuously (≈0.9 samples per 100 ms at ±3 kHz on E1) —
    each window takes its integer start from floor(k·period) AND its
    replica from the sub-phase bank entry nearest the residual
    fraction. A single global sub-phase decorrelates once the total
    drift approaches a sample (measured on the E1C C/N0-34 gate:
    metrics eroded 3.5→2.3 from K=25 to K=100 with the global
    sub-phase; per-window selection holds them)."""
    codes = jnp.asarray(codes, REAL_DTYPE)
    if codes.ndim == 2:
        codes = codes[:, None, :]
    p, s, l = codes.shape
    n = x.shape[-1]
    k_ref = max(1, min(cfg.coherent_periods, n // l) - 1)
    t = jnp.arange(l, dtype=REAL_DTYPE) / sample_rate
    ks = jnp.arange(k_ref, dtype=REAL_DTYPE)
    best = jnp.zeros((p,), REAL_DTYPE)
    # local search: ±half a Doppler bin; code phase offsets at
    # sub-phase granularity over ±2 samples (the coarse phase is a
    # drift-midpoint estimate)
    taus = np.arange(-2.0, 2.0 + 1e-9, 1.0 / s)
    for ddop in (-0.5, 0.0, 0.5):
        fd = dop + ddop * cfg.doppler_step_hz  # (P,)
        drift = -fd / cfg.carrier_hz * l  # samples gained per period
        carrier = cis(
            (-2 * jnp.pi * fd[:, None] * t[None, :]).astype(REAL_DTYPE)
        ).astype(IQ_DTYPE)  # (P, L)
        for dtau in taus:
            # start of window k relative to the coarse integer phase =
            # k·L (exact int) + the small slew dtau + k·drift. Keeping
            # the k·L term OUT of the float math is load-bearing: at
            # K=100 the absolute position reaches ~2e6 samples where
            # the f32 ulp is 0.25 — the fractional part (which selects
            # the sub-phase) would be noise.
            slew = dtau + ks[None, :] * drift[:, None]  # (P, K), small
            i0 = jnp.floor(slew)
            sub_raw = jnp.round((slew - i0) * s).astype(jnp.int32)
            i0 = i0.astype(jnp.int32) + sub_raw // s
            # signal delayed by frac ↔ replica bank entry ADVANCED by
            # s/S (sampled_code_bank samples w at (i + s/S)·ratio), so
            # the matching sub-phase is the NEGATED residual
            sub = jnp.mod(-sub_raw, s)  # (P, K) replica sub-phase
            idx = (phase.astype(jnp.int32)[:, None, None]
                   + (ks.astype(jnp.int32) * l)[None, :, None]
                   + i0[:, :, None] + jnp.arange(l)[None, None, :])
            segs = x[jnp.clip(idx, 0, n - 1)]  # (P, K, L)
            mixed = segs * carrier[:, None, :]
            code_k = jnp.take_along_axis(
                codes, sub[:, :, None], axis=1)  # (P, K, L)
            # correlations in float32: HIGHEST keeps a GPU from
            # running these contractions in TF32
            corr_r = jnp.einsum("pkl,pkl->pk", mixed.real, code_k,
                                precision=jax.lax.Precision.HIGHEST)
            corr_i = jnp.einsum("pkl,pkl->pk", mixed.imag, code_k,
                                precision=jax.lax.Precision.HIGHEST)
            pw = jnp.sum(corr_r**2 + corr_i**2, axis=-1)  # (P,)
            best = jnp.maximum(best, pw)
    k_grid = max(1, min(cfg.coherent_periods, n // l))
    return best / jnp.maximum(noise_floor * k_ref / k_grid, 1e-30)


def acquire(x, codes, prns, sample_rate, cfg: PcpsConfig = PcpsConfig()
            ) -> AcquisitionResult:
    """Batched PCPS for all PRNs at once (acquisition.rs:104 `acquire`)."""
    n_subphases = np.shape(codes)[1] if np.ndim(codes) == 3 else 1
    x = jnp.asarray(x, IQ_DTYPE)
    power = pcps_grid(x, codes, sample_rate, cfg)  # (P, D, L)
    p, d, l = power.shape
    flat = power.reshape(p, -1)
    peak = jnp.max(flat, axis=-1)
    arg = jnp.argmax(flat, axis=-1)
    dop_idx = arg // l
    phase = arg % l
    noise_floor = (jnp.sum(flat, axis=-1) - peak) / (d * l - 1)
    k = max(1, cfg.coherent_periods)
    metric = peak / jnp.maximum(noise_floor, 1e-30)
    if cfg.align_refine and x.shape[-1] >= 2 * l:
        dops_found = jnp.asarray(doppler_bins(cfg))[dop_idx]
        refined = _aligned_metric(x, codes, phase, dops_found,
                                  noise_floor, sample_rate, cfg)
        metric = jnp.maximum(metric, refined)
    eff_threshold = cfg.threshold + (
        cfg.noise_max_estimate(d * l * n_subphases)
        if cfg.auto_threshold else 0.0
    )
    detected = metric > eff_threshold
    code_period = l / sample_rate
    cn0 = 10.0 * jnp.log10(jnp.maximum(metric / code_period, 1e-12))
    dops = jnp.asarray(doppler_bins(cfg))
    return AcquisitionResult(
        prn=jnp.asarray(prns, jnp.int32),
        detected=detected,
        code_phase=phase.astype(REAL_DTYPE),
        doppler_hz=dops[dop_idx],
        peak_metric=metric.astype(REAL_DTYPE),
        cn0_estimate=cn0.astype(REAL_DTYPE),
    )


def acquire_jit(x, codes, prns, sample_rate,
                cfg: PcpsConfig = PcpsConfig()) -> AcquisitionResult:
    fn = jax.jit(
        lambda xx, cc: acquire(xx, cc, prns, sample_rate, cfg),
    )
    return fn(x, codes)


def sampled_code_bank(waveforms, waveform_rate, sample_rate, n_samples,
                      n_subphases: int = 4) -> np.ndarray:
    """(P, S, L) replica bank: each PRN's spread waveform nearest-sampled
    at S sub-sample phase offsets — matching how a delayed signal is
    actually gathered, which a band-limited fractional shift cannot
    (nearest-neighbour sampling of a non-band-limited BOC waveform).

    waveforms: sequence of per-PRN spread chip waveforms (±1-ish arrays at
    waveform_rate, e.g. CBOC sub-chips at 12.276 MHz).
    """
    out = []
    ratio = waveform_rate / sample_rate
    n = np.arange(n_samples)
    for w in waveforms:
        lw = len(w)
        rows = []
        for sp in range(n_subphases):
            idx = np.floor((n + sp / n_subphases) * ratio).astype(np.int64) % lw
            rows.append(w[idx])
        out.append(np.stack(rows))
    return np.stack(out).astype(np.float32)
