"""Filter ops (crates/r4w-core/src/filters/mod.rs family — fir.rs,
iir.rs, filters/cic.rs, filters/windows.rs, remez.rs, pulse_shaping.rs —
plus the flat filter blocks, re-designed).

Every filter is a pure block function `f(params, state, x) -> (y, state)`
(SURVEY.md §7 design stance): streaming parity comes from carrying the
conv tail / IIR state between blocks, while within a block everything is
batched. FIR paths lower to shifted multiply-adds or
`lax.conv_general_dilated` (see SHIFT_ADD_MAX_TAPS); recursive filters
(IIR, single-pole) use `lax.scan`.

Complex signals are filtered as stacked (re, im) channels so the
arithmetic stays in float32 with real taps.
"""

from __future__ import annotations

import functools

import jax
import jax.lax as lax
import jax.numpy as jnp

from r4w_tpu.core.hostio import cis, zeros_iq, zeros_like_safe
import numpy as np

from r4w_tpu.core.types import IQ_DTYPE, REAL_DTYPE


# Long inputs filtered by short FIRs lower to K shifted multiply-adds,
# which XLA fuses into one elementwise kernel; everything else lowers
# to lax.conv_general_dilated. N counts every value one call filters:
# all lanes, and both planes of a complex input. Timed per platform
# (PERF.md, "FIR lowering"): on an H100 at >= 2^20 samples shift-add
# ran 1.4-3x faster for K = 16-256, at <= 2^16 both ran within launch
# noise, and above 128 taps the unrolled form's compile time (2-4 s)
# outweighs its gain; on a CPU shift-add ran 1.6-2.6x faster up to
# K = 48, was even at K = 64 and lost above. An untimed platform keeps
# the conv.
SHIFT_ADD_MAX_TAPS = {"gpu": 128, "cpu": 48}
SHIFT_ADD_MIN_SAMPLES = 1 << 20


def _use_shift_add(k: int, n: int, platform: str | None = None) -> bool:
    """The FIR lowering rule: K taps over N values on `platform` (the
    default backend unless named)."""
    limit = SHIFT_ADD_MAX_TAPS.get(platform or jax.default_backend(), 0)
    return k <= limit and n >= SHIFT_ADD_MIN_SAMPLES


def _conv_valid_shift_add(x: jax.Array, taps: jax.Array,
                          stride: int = 1) -> jax.Array:
    """'valid' correlation with reversed taps (== convolution tail) as
    K shifted MACs: out[i] = Σ_j taps[j]·x[i·stride + K-1-j]."""
    k = int(taps.shape[0])
    m = (x.shape[-1] - k) // stride + 1

    def tap(j):
        lo = k - 1 - j
        return lax.slice_in_dim(x, lo, lo + (m - 1) * stride + 1, stride,
                                axis=-1)

    acc = taps[0] * tap(0)
    for j in range(1, k):
        acc = acc + taps[j] * tap(j)
    return acc


def _conv_valid(x: jax.Array, taps: jax.Array, stride: int = 1) -> jax.Array:
    """'valid' correlation of real (..., N) with reversed taps (K,),
    keeping every stride-th output: out (..., (N-K)//stride + 1).

    A strided window computes only the kept outputs, so a decimating
    FIR does 1/stride of the multiply work of filter-then-discard.
    """
    k = int(taps.shape[0])
    x = x.astype(REAL_DTYPE)
    taps = taps.astype(REAL_DTYPE)
    if _use_shift_add(k, x.size):
        return _conv_valid_shift_add(x, taps, stride)
    batch_shape = x.shape[:-1]
    n = x.shape[-1]
    lhs = x.reshape(-1, 1, n)  # (B, C=1, N)
    # FIR convolution y[n] = sum_k taps[k] x[n-k] == correlation with
    # reversed taps; conv_general_dilated computes correlation, so reverse.
    rhs = taps[::-1].reshape(1, 1, k)  # (O, I, K)
    out = lax.conv_general_dilated(
        lhs, rhs, window_strides=(stride,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        # a float32 conv may otherwise run in TF32 (about three decimal
        # digits) on the GPU; filters need float32
        precision=lax.Precision.HIGHEST,
    )
    return out.reshape(*batch_shape, out.shape[-1])


def _fir_valid(ext: jax.Array, taps: jax.Array, stride: int = 1):
    """_conv_valid over real or complex input (complex as a stacked
    (re, im) batch, so one kernel filters both planes)."""
    if not jnp.iscomplexobj(ext):
        return _conv_valid(ext, taps, stride)
    planes = jnp.stack([ext.real, ext.imag], axis=-2)
    y = _conv_valid(planes, taps, stride)
    return jax.lax.complex(y[..., 0, :], y[..., 1, :]).astype(IQ_DTYPE)


def fir_filter(taps, x, state=None):
    """Streaming FIR: y[n] = Σ taps[k]·x[n-k] (filters/fir.rs:38).

    state: previous (K-1) input samples (zeros initially).
    Returns (y same length as x, new state). Complex-safe.
    """
    return decimating_fir(taps, x, 1, state)


def fir_apply(taps, x):
    """One-shot FIR with zero initial state (returns y only)."""
    y, _ = fir_filter(taps, x)
    return y


def decimating_fir(taps, x, factor: int, state=None):
    """FIR + keep every factor-th output (decimating_fir.rs).

    Polyphase: only the kept outputs are computed (a strided window),
    1/factor of the multiply work of filtering then discarding.
    Returns (y with ceil(N/factor) samples, new state).
    """
    taps = jnp.asarray(taps, REAL_DTYPE)
    k = int(taps.shape[0])
    x = jnp.asarray(x)
    if state is None:
        shape = x.shape[:-1] + (k - 1,)
        state = (zeros_iq(shape) if jnp.iscomplexobj(x)
                 else jnp.zeros(shape, x.dtype))
    ext = jnp.concatenate([state, x], axis=-1)
    y = _fir_valid(ext, taps, factor)
    new_state = ext[..., ext.shape[-1] - (k - 1):] if k > 1 else state
    return y, new_state


def interpolating_fir(taps, x, factor: int):
    """Zero-stuff by factor then FIR (interp_fir.rs). Gain = factor."""
    x = jnp.asarray(x)
    up = jnp.zeros(x.shape[:-1] + (x.shape[-1] * factor,), x.dtype)
    up = up.at[..., ::factor].set(x * factor)
    return fir_apply(taps, up)


def freq_xlating_fir(taps, x, center_freq, sample_rate, state=None,
                     phase0=0.0):
    """Mix to baseband then lowpass+FIR (freq_xlating_fir.rs)."""
    x = jnp.asarray(x, IQ_DTYPE)
    n = x.shape[-1]
    w = -2.0 * jnp.pi * center_freq / sample_rate
    ph = phase0 + w * jnp.arange(n, dtype=REAL_DTYPE)
    shifted = x * cis(ph.astype(REAL_DTYPE))
    y, state = fir_filter(taps, shifted, state)
    return y, state, phase0 + w * n


def iir_filter(b, a, x, zi=None):
    """Direct-form-II-transposed IIR via lax.scan (filters/iir.rs).

    b, a: transfer function coefficients (a[0] normalized to 1).
    zi: (max(len(a),len(b))-1,) initial state. Returns (y, zf).
    """
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    b = b / a[0]
    a = a / a[0]
    n = max(len(a), len(b))
    b = np.pad(b, (0, n - len(b)))
    a = np.pad(a, (0, n - len(a)))
    bj = jnp.asarray(b, REAL_DTYPE)
    aj = jnp.asarray(a, REAL_DTYPE)
    x = jnp.asarray(x)
    complex_in = jnp.iscomplexobj(x)
    if zi is None:
        zi = jnp.zeros((n - 1,), x.dtype if complex_in else REAL_DTYPE)

    def step(z, xn):
        yn = bj[0] * xn + z[0]
        znew = bj[1:] * xn - aj[1:] * yn
        znew = znew + jnp.concatenate([z[1:], zeros_like_safe(z[:1])])
        return znew, yn

    zf, y = lax.scan(step, zi, jnp.moveaxis(x, -1, 0))
    return jnp.moveaxis(y, 0, -1), zf


def single_pole_iir(alpha: float, x, state=None):
    """y[n] = α·x[n] + (1-α)·y[n-1] (single_pole_iir.rs)."""
    x = jnp.asarray(x)
    if state is None:
        state = jnp.zeros(x.shape[:-1], x.dtype)

    def step(y_prev, xn):
        y = alpha * xn + (1.0 - alpha) * y_prev
        return y, y

    yf, y = lax.scan(step, state, jnp.moveaxis(x, -1, 0))
    return jnp.moveaxis(y, 0, -1), yf


def dc_blocker(x, alpha: float = 0.995, state=None):
    """y[n] = x[n] - x[n-1] + α·y[n-1] (dc_blocker.rs)."""
    x = jnp.asarray(x)
    if state is None:
        xprev = jnp.zeros(x.shape[:-1], x.dtype)
        yprev = jnp.zeros(x.shape[:-1], x.dtype)
    else:
        xprev, yprev = state

    def step(carry, xn):
        xp, yp = carry
        y = xn - xp + alpha * yp
        return (xn, y), y

    (xf, yf), y = lax.scan(step, (xprev, yprev), jnp.moveaxis(x, -1, 0))
    return jnp.moveaxis(y, 0, -1), (xf, yf)


def cic_decimator(x, rate: int, stages: int = 3, state=None):
    """CIC decimating filter (cic_filter.rs): N integrators @ input rate,
    decimate by R, N combs @ output rate (differential delay 1).

    Gain = R^N. Integrators run as cumsum chains per block with carried
    accumulators; combs as diff with carried last samples.
    """
    x = jnp.asarray(x)
    if state is None:
        integ = jnp.zeros((stages,) + x.shape[:-1], x.dtype)
        comb = jnp.zeros((stages,) + x.shape[:-1], x.dtype)
    else:
        integ, comb = state
    # integrator cascade: cumsum with carry-in
    v = x
    new_integ = []
    for s in range(stages):
        v = jnp.cumsum(v, axis=-1) + integ[s][..., None]
        new_integ.append(v[..., -1])
    dec = v[..., rate - 1 :: rate]
    # comb cascade on decimated stream
    w = dec
    new_comb = []
    for s in range(stages):
        prev = jnp.concatenate([comb[s][..., None], w[..., :-1]], axis=-1)
        new_comb.append(w[..., -1])
        w = w - prev
    return w, (jnp.stack(new_integ), jnp.stack(new_comb))


def moving_average(x, length: int, state=None):
    """Boxcar moving average (moving_average.rs) as FIR."""
    taps = jnp.full((length,), 1.0 / length, REAL_DTYPE)
    return fir_filter(taps, x, state)


def moving_rms(x, length: int):
    p, _ = moving_average(jnp.abs(jnp.asarray(x)) ** 2, length)
    return jnp.sqrt(p)


def median_filter(x, length: int):
    """Sliding median (median_filter.rs), edge-padded."""
    x = jnp.asarray(x)
    half = length // 2
    pad = [(0, 0)] * (x.ndim - 1) + [(half, length - 1 - half)]
    ext = jnp.pad(x, pad, mode="edge")
    idx = jnp.arange(x.shape[-1])[:, None] + jnp.arange(length)[None, :]
    windows = ext[..., idx]
    return jnp.median(windows, axis=-1)


def hilbert_fir_taps(num_taps: int = 65, window: str = "hamming") -> np.ndarray:
    """Type-III FIR Hilbert transformer taps (hilbert.rs)."""
    from r4w_tpu.core.windows import _np_window

    m = num_taps // 2
    n = np.arange(num_taps) - m
    h = np.zeros(num_taps)
    odd = n % 2 != 0
    h[odd] = 2.0 / (np.pi * n[odd])
    return (h * _np_window(window, num_taps)).astype(np.float32)


def fractional_delay_taps(delay: float, num_taps: int = 31) -> np.ndarray:
    """Windowed-sinc fractional delay (fractional_delay.rs)."""
    from r4w_tpu.core.windows import _np_window

    m = (num_taps - 1) / 2.0
    n = np.arange(num_taps)
    h = np.sinc(n - m - delay)
    return (h * _np_window("hamming", num_taps)).astype(np.float32)


# --------------------------------------------------------------------------
# FIR design (filters/remez.rs is Parks-McClellan; we provide windowed-sinc
# design which covers the same lowpass/highpass/bandpass use sites)
# --------------------------------------------------------------------------


def design_lowpass(num_taps: int, cutoff: float, sample_rate: float,
                   window: str = "hamming") -> np.ndarray:
    from r4w_tpu.core.windows import _np_window

    m = (num_taps - 1) / 2.0
    n = np.arange(num_taps)
    fc = cutoff / sample_rate  # normalized (cycles/sample)
    h = 2.0 * fc * np.sinc(2.0 * fc * (n - m))
    h = h * _np_window(window, num_taps)
    return (h / h.sum()).astype(np.float32)


def design_highpass(num_taps: int, cutoff: float, sample_rate: float,
                    window: str = "hamming") -> np.ndarray:
    lp = design_lowpass(num_taps, cutoff, sample_rate, window)
    hp = -lp
    hp[(num_taps - 1) // 2] += 1.0
    return hp.astype(np.float32)


def design_bandpass(num_taps: int, f_lo: float, f_hi: float,
                    sample_rate: float, window: str = "hamming") -> np.ndarray:
    m = (num_taps - 1) / 2.0
    n = np.arange(num_taps)
    center = (f_lo + f_hi) / 2.0 / sample_rate
    lp = design_lowpass(num_taps, (f_hi - f_lo) / 2.0, sample_rate, window)
    return (2.0 * lp * np.cos(2.0 * np.pi * center * (n - m))).astype(
        np.float32
    )


def design_equiripple(num_taps: int, bands, desired, weights=None,
                      grid_density: int = 16, iters: int = 60
                      ) -> np.ndarray:
    """Equiripple linear-phase FIR design (filters/remez.rs role).

    Same problem as Parks-McClellan — minimax multiband approximation —
    solved with Lawson's iteratively-reweighted least squares on a dense
    cosine-basis grid (robust, no exchange-step edge cases). Host-side
    numpy float64 design.

    bands: [(f_lo, f_hi), ...] in normalized frequency [0, 0.5];
    desired: target gain per band; weights: relative ripple weights.
    """
    if num_taps % 2 == 0:
        raise ValueError("design_equiripple needs an odd tap count")
    bands = list(bands)
    desired = list(desired)
    if len(bands) != len(desired):
        raise ValueError("bands and desired must have equal length")
    w_bands = list(weights) if weights is not None else [1.0] * len(bands)
    half = num_taps // 2
    freqs = []
    target = []
    wgrid = []
    for (lo, hi), d, wb in zip(bands, desired, w_bands):
        npts = max(int((hi - lo) * 2 * grid_density * num_taps), 8)
        f = np.linspace(lo, hi, npts)
        freqs.append(f)
        target.append(np.full(npts, float(d)))
        wgrid.append(np.full(npts, float(wb)))
    f = np.concatenate(freqs)
    d = np.concatenate(target)
    wb = np.concatenate(wgrid)
    # amplitude response of a symmetric type-I filter:
    # A(f) = c0 + 2 sum_k c_k cos(2 pi f k)
    basis = np.cos(2 * np.pi * np.outer(f, np.arange(half + 1)))
    basis[:, 1:] *= 2.0
    lawson = np.ones_like(f)
    c = None
    for _ in range(iters):
        w = np.sqrt(lawson) * wb
        c, *_ = np.linalg.lstsq(basis * w[:, None], d * w, rcond=None)
        err = np.abs(basis @ c - d) * wb
        lawson *= err + 1e-12
        lawson /= lawson.max()
    taps = np.concatenate([c[half:0:-1], c[:half + 1]])
    return taps


def _remez_grid(num_taps: int, bands, desired, weights, grid_density: int):
    """Dense frequency grid over the union of bands with D(f), W(f)."""
    freqs, d, w = [], [], []
    for (lo, hi), dd, ww in zip(bands, desired, weights):
        npts = max(int((hi - lo) * 2 * grid_density * num_taps), 8)
        f = np.linspace(lo, hi, npts)
        freqs.append(f)
        d.append(np.full(npts, float(dd)))
        w.append(np.full(npts, float(ww)))
    return np.concatenate(freqs), np.concatenate(d), np.concatenate(w)


def _bary_weights(x: np.ndarray) -> np.ndarray:
    """Barycentric weights a_k = 1/prod_{j!=k}(x_k - x_j), computed in
    log space (sign tracked) so ~100-point extremal sets don't
    over/underflow float64."""
    diff = x[:, None] - x[None, :]
    np.fill_diagonal(diff, 1.0)
    sign = np.prod(np.sign(diff), axis=1)
    logs = np.sum(np.log(np.abs(diff)), axis=1)
    logs -= logs.mean()  # common scale cancels in every ratio we form
    return sign * np.exp(-logs)


def _remez_exchange(num_taps: int, bands, desired, weights,
                    grid_density: int = 16, max_iters: int = 40):
    """True Parks-McClellan Remez exchange (filters/remez.rs re-design).

    Type-I (odd-length symmetric) linear-phase multiband design: the
    amplitude A(f) = sum_k c_k cos(2 pi f k) is the minimax weighted
    approximation of D(f), found by iterating the exchange: solve the
    alternation system on the current extremal set via barycentric
    Lagrange interpolation in x = cos(2 pi f), locate the new extrema of
    the weighted error on a dense grid, exchange, repeat until the
    ripple stops growing. Host-side float64 design code (not a hot
    path). Returns (taps, delta, extremal_freqs).
    """
    half = num_taps // 2
    n_ext = half + 2  # r+1 alternations for r = half+1 cosine coefficients
    f, d, wt = _remez_grid(num_taps, bands, desired, weights, grid_density)
    x = np.cos(2 * np.pi * f)
    # initial extremal set: spread evenly across the grid
    ext = np.round(np.linspace(0, len(f) - 1, n_ext)).astype(int)
    last_delta = 0.0
    signs = (-1.0) ** np.arange(n_ext)
    for _ in range(max_iters):
        xe, de, we = x[ext], d[ext], wt[ext]
        a = _bary_weights(xe)
        delta = float(np.sum(a * de) / np.sum(a * signs / we))
        ce = de - signs * delta / we  # A at the extremal points
        # barycentric interpolation of A on the full grid
        dx = x[:, None] - xe[None, :]
        hit = np.isclose(dx, 0.0, atol=1e-14)
        dx_safe = np.where(hit, 1.0, dx)
        num = np.sum(a * ce / dx_safe, axis=1)
        den = np.sum(a / dx_safe, axis=1)
        amp = num / den
        exact = hit.any(axis=1)
        if exact.any():
            amp[exact] = ce[hit[exact].argmax(axis=1)]
        err = wt * (amp - d)
        # candidate extrema: local maxima of |err| plus band edges
        abs_err = np.abs(err)
        cand = [0]
        cand += [i for i in range(1, len(f) - 1)
                 if abs_err[i] >= abs_err[i - 1] and abs_err[i] >= abs_err[i + 1]]
        cand.append(len(f) - 1)
        # band-edge grid indices (each band contributes its endpoints)
        edge = np.cumsum([0] + [max(int((hi - lo) * 2 * grid_density
                                        * num_taps), 8)
                                for lo, hi in bands])
        for e in edge[1:-1]:
            cand += [e - 1, e]
        cand = sorted(set(cand))
        # enforce sign alternation: among same-sign runs keep the largest
        kept: list[int] = []
        for i in cand:
            if kept and np.sign(err[i]) == np.sign(err[kept[-1]]):
                if abs_err[i] > abs_err[kept[-1]]:
                    kept[-1] = i
            else:
                kept.append(i)
        # trim to n_ext by dropping the weaker endpoint repeatedly
        while len(kept) > n_ext:
            if abs_err[kept[0]] < abs_err[kept[-1]]:
                kept.pop(0)
            else:
                kept.pop()
        if len(kept) < n_ext:  # degenerate grid — keep previous set
            break
        new_ext = np.asarray(kept, int)
        converged = (np.array_equal(new_ext, ext)
                     or abs(abs(delta) - last_delta) <= 1e-12
                     + 1e-6 * abs(delta))
        ext = new_ext
        last_delta = abs(delta)
        if converged:
            break
    # final solve on the settled extremal set, then reconstruct taps by
    # sampling A(f) at num_taps uniform frequencies (type-I IDFT)
    xe, de, we = x[ext], d[ext], wt[ext]
    a = _bary_weights(xe)
    delta = float(np.sum(a * de) / np.sum(a * signs / we))
    ce = de - signs * delta / we
    fu = np.arange(half + 1) / num_taps
    xu = np.cos(2 * np.pi * fu)
    dxu = xu[:, None] - xe[None, :]
    hitu = np.isclose(dxu, 0.0, atol=1e-14)
    dxu_safe = np.where(hitu, 1.0, dxu)
    au = (np.sum(a * ce / dxu_safe, axis=1)
          / np.sum(a / dxu_safe, axis=1))
    if hitu.any():
        rows = hitu.any(axis=1)
        au[rows] = ce[hitu[rows].argmax(axis=1)]
    n = np.arange(num_taps) - half
    # h[n] = (1/N) [A(0) + 2 sum_k A(k/N) cos(2 pi k n / N)]
    taps = (au[0] + 2.0 * np.sum(
        au[1:, None] * np.cos(2 * np.pi * np.arange(1, half + 1)[:, None]
                              * n[None, :] / num_taps), axis=0)) / num_taps
    return taps.astype(np.float64), abs(delta), f[ext]


def design_remez(num_taps: int, bands, desired, weights=None,
                 grid_density: int = 16) -> np.ndarray:
    """Parks-McClellan equiripple FIR design via true Remez exchange
    (filters/remez.rs:design). Falls back to the IRLS solver only if the
    exchange degenerates (non-convergent extremal set)."""
    if num_taps % 2 == 0:
        raise ValueError("design_remez needs an odd tap count")
    bands = list(bands)
    desired = list(desired)
    if len(bands) != len(desired):
        raise ValueError("bands and desired must have equal length")
    w = list(weights) if weights is not None else [1.0] * len(bands)
    try:
        taps, _, _ = _remez_exchange(num_taps, bands, desired, w,
                                     grid_density)
        if not np.all(np.isfinite(taps)):
            raise FloatingPointError("non-finite taps")
        return taps
    except (FloatingPointError, np.linalg.LinAlgError, ZeroDivisionError):
        return design_equiripple(num_taps, bands, desired, w)
