"""Resampling & polyphase channelization ops.

Re-design of filters/polyphase.rs (PolyphaseDecimator:52,
PolyphaseInterpolator:281, Resampler:471, HalfbandFilter:657),
filters/fractional_resampler.rs, arbitrary_resampler.rs,
pfb_channelizer.rs, pfb_synthesizer.rs (+ the flat synthesizer.rs
bank): everything is expressed as
reshapes + batched convs/FFTs so XLA can tile it; no per-sample loops.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from r4w_tpu.core.hostio import zeros_iq
import numpy as np

from r4w_tpu.core.types import IQ_DTYPE, REAL_DTYPE
from r4w_tpu.ops.filters import design_lowpass, fir_apply


def polyphase_decompose(taps: np.ndarray, phases: int) -> np.ndarray:
    """(K,) prototype -> (phases, ceil(K/phases)) polyphase bank."""
    k = len(taps)
    pad = (-k) % phases
    t = np.pad(np.asarray(taps), (0, pad))
    return t.reshape(-1, phases).T.copy()  # (phases, taps_per_phase)


def polyphase_decimate(x, taps, factor: int):
    """Efficient decimating FIR: filter+downsample in one pass
    (polyphase.rs:52). Output rate = input/factor."""
    y = fir_apply(jnp.asarray(taps), x)
    return y[..., ::factor]


def polyphase_interpolate(x, taps, factor: int):
    """Efficient interpolating FIR (polyphase.rs:281). Gain-compensated."""
    x = jnp.asarray(x)
    up = jnp.zeros(x.shape[:-1] + (x.shape[-1] * factor,), x.dtype)
    up = up.at[..., ::factor].set(x * factor)
    return fir_apply(jnp.asarray(taps), up)


def rational_resample(x, up: int, down: int, num_taps: int = 128):
    """Rational L/M resampler (polyphase.rs:471 Resampler)."""
    fs = 1.0
    cutoff = 0.5 / max(up, down) * fs
    taps = design_lowpass(num_taps, cutoff, fs)
    y = polyphase_interpolate(x, taps, up)
    return y[..., ::down]


@functools.lru_cache(maxsize=None)
def halfband_taps(num_taps: int = 31) -> np.ndarray:
    """Halfband lowpass: every other tap zero (polyphase.rs:657)."""
    assert num_taps % 2 == 1
    t = design_lowpass(num_taps, 0.25, 1.0, window="hamming")
    mid = num_taps // 2
    idx = np.arange(num_taps)
    t = np.where((idx != mid) & ((idx - mid) % 2 == 0), 0.0, t)
    return (t / t.sum()).astype(np.float32)


def halfband_decimate(x, num_taps: int = 31):
    return polyphase_decimate(x, halfband_taps(num_taps), 2)


def arbitrary_resample(x, ratio: float, num_taps: int = 8, n_filters: int = 32):
    """Arbitrary-ratio resampler via a bank of fractional-delay subfilters
    (arbitrary_resampler.rs / pfb_arb_resampler.rs).

    output[k] = interp(x, k / ratio) with windowed-sinc interpolation,
    vectorized as a gather + small matmul against an (n_filters, num_taps)
    fractional-delay bank.
    """
    from r4w_tpu.ops.filters import fractional_delay_taps

    x = jnp.asarray(x)
    n_in = x.shape[-1]
    n_out = int(np.floor(n_in * ratio))
    # sample positions in input space
    pos = jnp.arange(n_out, dtype=jnp.float64) / ratio
    base = jnp.floor(pos).astype(jnp.int32)
    frac = (pos - base).astype(REAL_DTYPE)
    # quantize fraction to a filter index
    fidx = jnp.clip(jnp.round(frac * n_filters).astype(jnp.int32), 0,
                    n_filters - 1)
    bank = np.stack([
        fractional_delay_taps(d / n_filters, num_taps)
        for d in range(n_filters)
    ])  # (F, K)
    k = num_taps
    half = (k - 1) // 2
    pad = [(0, 0)] * (x.ndim - 1) + [(half, k - half)]
    ext = jnp.pad(x, pad)
    gather_idx = base[:, None] + jnp.arange(k)[None, :]  # (n_out, K)
    windows = ext[..., gather_idx]  # (..., n_out, K)
    taps = jnp.asarray(bank)[fidx]  # (n_out, K)
    # taps are designed for delay d applied to window starting at base-half;
    # windowed-sinc with fractional delay reproduces x(base + frac)
    return jnp.sum(windows * taps, axis=-1)


def pfb_channelizer(x, n_channels: int, taps_per_phase: int = 8):
    """Polyphase filterbank channelizer (pfb_channelizer.rs).

    Splits x into n_channels equally-spaced baseband channels, each at
    fs/n_channels: polyphase filter + FFT across phases. Returns
    (..., n_frames, n_channels) complex.
    """
    x = jnp.asarray(x, IQ_DTYPE)
    proto = design_lowpass(n_channels * taps_per_phase,
                           0.5 / n_channels, 1.0)
    bank = jnp.asarray(polyphase_decompose(proto, n_channels))  # (C, T)
    n = x.shape[-1]
    n_frames = n // n_channels - taps_per_phase + 1
    if n_frames <= 0:
        return zeros_iq(x.shape[:-1] + (0, n_channels))
    # commutator: sample m*C + c feeds phase c (reversed order)
    frames = x[..., : (n // n_channels) * n_channels].reshape(
        *x.shape[:-1], -1, n_channels
    )  # (..., M, C)
    # sliding dot along M with per-phase taps
    idx = jnp.arange(n_frames)[:, None] + jnp.arange(taps_per_phase)[None, :]
    windows = frames[..., idx, :]  # (..., n_frames, T, C)
    filtered = jnp.einsum("...ftc,ct->...fc", windows,
                          bank * n_channels)  # scale for unity passband
    # fft across phases maps a tone at +k/C to channel k
    return jnp.fft.fft(filtered, axis=-1)


def pfb_synthesizer(channels, taps_per_phase: int = 8):
    """Inverse of pfb_channelizer (pfb_synthesizer.rs): combine
    (..., n_frames, C) channel samples into one stream at C× rate."""
    channels = jnp.asarray(channels, IQ_DTYPE)
    c = channels.shape[-1]
    spectra = jnp.fft.ifft(channels, axis=-1)  # (..., F, C)
    proto = design_lowpass(c * taps_per_phase, 0.5 / c, 1.0)
    bank = jnp.asarray(polyphase_decompose(proto, c))  # (C, T)
    # each output frame m, phase p: sum_t bank[p,t]*spectra[m-t, p]
    f = spectra.shape[-2]
    pad = [(0, 0)] * (spectra.ndim - 2) + [(taps_per_phase - 1, 0), (0, 0)]
    ext = jnp.pad(spectra, pad)
    idx = jnp.arange(f)[:, None] + jnp.arange(taps_per_phase)[None, :]
    windows = ext[..., idx, :]  # (..., F, T, C)
    out = jnp.einsum("...ftc,ct->...fc", windows, bank[:, ::-1] * c)
    return out.reshape(*out.shape[:-2], -1)


# ---------------------------------------------------------------- Farrow


def farrow_resample(x, ratio: float, order: int = 3):
    """Farrow-structure fractional resampler (farrow_resampler.rs).

    Cubic-Lagrange interpolation at output positions k/ratio; unlike the
    reference's per-sample state machine, every output sample's base
    index and fractional offset mu are computed up-front, so the whole
    resample is one gather + polynomial evaluation.
    """
    if order not in (1, 2, 3):
        raise ValueError("farrow order must be 1, 2 or 3")
    x = jnp.asarray(x)
    n = x.shape[-1]
    n_out = int(np.floor((n - order) * ratio))
    t = jnp.arange(n_out, dtype=REAL_DTYPE) / ratio
    base = jnp.floor(t).astype(jnp.int32)
    mu = (t - base).astype(REAL_DTYPE)
    if order == 1:
        i0 = jnp.clip(base, 0, n - 2)
        a = x[..., i0]
        b = x[..., i0 + 1]
        return a + (b - a) * mu
    if order == 2:
        i0 = jnp.clip(base, 1, n - 2)
        m = mu + (base - i0).astype(REAL_DTYPE)
        xm, x0, x1 = x[..., i0 - 1], x[..., i0], x[..., i0 + 1]
        c1 = 0.5 * (x1 - xm)
        c2 = 0.5 * (x1 - 2 * x0 + xm)
        return x0 + m * (c1 + m * c2)
    # cubic Lagrange on x[base-1 .. base+2], mu in [0,1) between the
    # middle two points
    i0 = jnp.clip(base, 1, n - 3)
    mu = mu + (base - i0).astype(REAL_DTYPE)  # keep exact position
    xm1, x0, x1, x2 = (x[..., i0 - 1], x[..., i0], x[..., i0 + 1],
                       x[..., i0 + 2])
    l_m1 = -mu * (mu - 1) * (mu - 2) / 6.0
    l_0 = (mu + 1) * (mu - 1) * (mu - 2) / 2.0
    l_1 = -(mu + 1) * mu * (mu - 2) / 2.0
    l_2 = (mu + 1) * mu * (mu - 1) / 6.0
    return xm1 * l_m1 + x0 * l_0 + x1 * l_1 + x2 * l_2


# ----------------------------------------------------------------- WOLA


def wola_channelize(x, num_channels: int, taps_per_channel: int = 4,
                    window=None):
    """Weighted overlap-add analysis channelizer (wola_channelizer.rs
    process): critically sampled (hop = num_channels); returns
    (..., n_frames, num_channels)."""
    k = num_channels
    p = taps_per_channel
    x = jnp.asarray(x, IQ_DTYPE)
    if window is None:
        if p == 1:
            w = np.ones(k)
        else:
            # windowed-sinc prototype with cutoff at the channel edge
            t = np.arange(k * p) - (k * p - 1) / 2.0
            w = np.sinc(t / k) * np.hanning(k * p)
    else:
        w = np.asarray(window, np.float64)
        if len(w) != k * p:
            raise ValueError("window must have num_channels*taps entries")
    w = jnp.asarray(w, REAL_DTYPE)
    n = x.shape[-1]
    n_frames = n // k - p + 1
    if n_frames <= 0:
        return zeros_iq(x.shape[:-1] + (0, k))
    idx = jnp.arange(n_frames)[:, None] * k + jnp.arange(k * p)[None, :]
    frames = x[..., idx] * w  # (..., F, K*P)
    folded = frames.reshape(*frames.shape[:-1], p, k).sum(-2)
    return jnp.fft.fft(folded, axis=-1)


def wola_synthesize(channels, taps_per_channel: int = 4, window=None):
    """Overlap-add synthesis inverse of wola_channelize
    (wola_channelizer.rs synthesize_frame). With taps_per_channel=1
    (rectangular window) reconstruction is exact."""
    ch = jnp.asarray(channels, IQ_DTYPE)
    k = ch.shape[-1]
    p = taps_per_channel
    if window is None:
        if p == 1:
            w = np.ones(k)
        else:
            t = np.arange(k * p) - (k * p - 1) / 2.0
            w = np.sinc(t / k) * np.hanning(k * p)
    else:
        w = np.asarray(window, np.float64)
    # normalize so analysis+synthesis windows overlap-add to unity
    wsum = np.zeros(k)
    for i in range(p):
        wsum += (np.asarray(w[i * k:(i + 1) * k]) ** 2
                 if p > 1 else np.ones(k))
    w_syn = jnp.asarray(
        (w if p > 1 else np.ones(k)) /
        np.tile(np.maximum(wsum, 1e-12), p), REAL_DTYPE)
    frames = jnp.fft.ifft(ch, axis=-1)  # (..., F, K)
    expanded = jnp.tile(frames, (1,) * (frames.ndim - 1) + (p,)) * w_syn
    f = frames.shape[-2]
    n_out = (f + p - 1) * k
    out = zeros_iq((*frames.shape[:-2], n_out))
    idx = jnp.arange(f)[:, None] * k + jnp.arange(k * p)[None, :]
    out = out.at[..., idx].add(expanded)
    return out


# -------------------------------------------------------- PFB clock sync


def pfb_clock_sync(x, sps: float, num_filts: int = 32,
                   loop_bw: float = 0.1, rrc_beta: float = 0.35,
                   span_symbols: int = 8):
    """Polyphase-filterbank symbol timing recovery (pfb_clock_sync.rs).

    GNU-Radio style: a bank of `num_filts` fractionally-delayed RRC
    matched filters plus their derivatives; a 2nd-order loop picks the
    branch whose derivative output is orthogonal to the symbol output.
    One `lax.scan` step per recovered symbol. Returns (symbols (S,),
    timing_track (S,))."""
    from r4w_tpu.ops.pulse import root_raised_cosine_taps

    x = jnp.asarray(x, IQ_DTYPE)
    if x.ndim != 1:
        raise ValueError("pfb_clock_sync expects a 1-D sample stream")
    nf = num_filts
    sps_i = int(round(sps))
    # prototype RRC oversampled by the bank size; branch k is the
    # prototype delayed by k/nf of a sample
    proto = np.asarray(
        root_raised_cosine_taps(sps_i * nf, num_symbols=span_symbols,
                                rolloff=rrc_beta), np.float64) * nf
    span = -(-len(proto) // nf)
    proto = np.pad(proto, (0, span * nf - len(proto)))
    dproto = np.gradient(proto)
    bank = jnp.asarray(proto.reshape(span, nf).T, REAL_DTYPE)   # (NF, span)
    dbank = jnp.asarray(dproto.reshape(span, nf).T, REAL_DTYPE)
    n = x.shape[-1]
    n_sym = int((n - span) // sps) - 2
    if n_sym <= 0:
        return zeros_iq(0), jnp.zeros(0, REAL_DTYPE)
    kp = loop_bw
    ki = 0.25 * loop_bw * loop_bw

    def step(carry, i):
        phase, rate = carry
        pos = i * sps + phase
        base = jnp.floor(pos).astype(jnp.int32)
        frac = pos - base.astype(REAL_DTYPE)
        # branch k applies a delay of -k/nf, so position base+frac needs
        # branch nf - frac*nf applied one sample later
        braw = jnp.round((1.0 - frac) * nf).astype(jnp.int32) % nf
        base = jnp.clip(base + jnp.where(braw != 0, 1, 0), 0, n - span - 1)
        win = jax.lax.dynamic_slice(x, (base,), (span,))
        sym = jnp.sum(win * bank[braw])
        dsym = jnp.sum(win * dbank[braw])
        # energy-gradient TED, power-normalized: positive when late
        err = jnp.clip(
            (sym.real * dsym.real + sym.imag * dsym.imag)
            / (sym.real**2 + sym.imag**2 + 1e-6), -1.0, 1.0)
        rate = jnp.clip(rate - ki * err, -0.1, 0.1)
        phase = phase + rate - kp * err
        return (phase, rate), (sym, phase)

    _, (syms, track) = jax.lax.scan(
        step, (jnp.asarray(0.0, REAL_DTYPE), jnp.asarray(0.0, REAL_DTYPE)),
        jnp.arange(n_sym))
    return syms, track
