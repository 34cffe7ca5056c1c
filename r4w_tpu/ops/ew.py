"""Electronic warfare & advanced radar ops (esprit.rs, sar_processor.rs,
passive_radar_processor.rs, tdoa_estimator.rs, emitter_localization.rs,
elint_pulse_characterizer.rs, esm_receiver.rs re-designs).

Batch-first: the cross-ambiguity surface is one gather + batched FFT,
SAR range/azimuth compression are batched frequency-domain matched
filters, ESPRIT reduces to one eigh on the array covariance plus a tiny
host-side eigensolve (n_sources x n_sources, non-Hermitian — not a device
op). Detection lists with data-dependent length (pulses, emitters) are
returned as fixed-size arrays with a validity count, XLA-style.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from r4w_tpu.core.types import IQ_DTYPE, REAL_DTYPE


# -------------------------------------------------------------- ESPRIT


def esprit_doa(snapshots, n_sources: int, d: float = 0.5):
    """ESPRIT direction finding on a uniform linear array
    (esprit.rs:204 estimate): snapshots (T, M) -> angles_deg
    (n_sources,) sorted. d = element spacing in wavelengths."""
    x = jnp.asarray(snapshots, IQ_DTYPE)
    # R[i,j] = E[x_i conj(x_j)] (Hermitian array covariance)
    r = (x.T @ x.conj()) / x.shape[0]
    phi = _esprit_rotation(r, n_sources)
    mu = np.angle(phi)  # = -2 pi d sin(theta)
    s = np.clip(-mu / (2 * np.pi * d), -1.0, 1.0)
    return np.sort(np.degrees(np.arcsin(s)))


def esprit_frequencies(x, n_sources: int, m: int = 16):
    """Time-series ESPRIT: estimate n_sources complex-exponential
    frequencies (cycles/sample) from 1-D x via Hankel snapshots."""
    x = jnp.asarray(x, IQ_DTYPE).reshape(-1)
    n = x.shape[0]
    t = n - m + 1
    idx = jnp.arange(t)[:, None] + jnp.arange(m)[None, :]
    snaps = x[idx]  # (T, M)
    r = (snaps.T @ snaps.conj()) / t
    phi = _esprit_rotation(r, n_sources)
    return np.sort(np.angle(phi) / (2 * np.pi))


def _esprit_rotation(r, n_sources: int) -> np.ndarray:
    """Eigenvalues of the subarray rotation operator from covariance r."""
    w, v = jnp.linalg.eigh(r)  # ascending
    es = v[:, -n_sources:]  # signal subspace (M, K)
    e1 = np.asarray(es[:-1, :])
    e2 = np.asarray(es[1:, :])
    # LS solve e1 @ psi = e2; eig of psi gives the rotations
    psi, *_ = np.linalg.lstsq(e1, e2, rcond=None)
    return np.linalg.eigvals(psi)


# ----------------------------------------------------------------- SAR


def sar_range_compress(raw, range_ref):
    """Frequency-domain matched filter per pulse (sar_processor.rs:259).
    raw (P, N) complex, range_ref (K,) transmitted chirp."""
    raw = jnp.asarray(raw, IQ_DTYPE)
    n = raw.shape[-1]
    ref = jnp.fft.fft(jnp.asarray(range_ref, IQ_DTYPE), n)
    return jnp.fft.ifft(jnp.fft.fft(raw, axis=-1) * jnp.conj(ref),
                        axis=-1)


def sar_azimuth_compress(rc, azimuth_ref):
    """Azimuth matched filter down the pulse axis (sar_processor.rs:332).
    rc (P, N) range-compressed, azimuth_ref (P,) expected Doppler
    history of a point target."""
    rc = jnp.asarray(rc, IQ_DTYPE)
    p = rc.shape[0]
    ref = jnp.fft.fft(jnp.asarray(azimuth_ref, IQ_DTYPE), p)
    return jnp.fft.ifft(jnp.fft.fft(rc, axis=0)
                        * jnp.conj(ref)[:, None], axis=0)


def sar_process(raw, range_ref, azimuth_ref):
    """Basic range-Doppler algorithm: range compress -> azimuth
    compress -> magnitude image (sar_processor.rs:234 without RCMC)."""
    img = sar_azimuth_compress(sar_range_compress(raw, range_ref),
                               azimuth_ref)
    return jnp.abs(img)


def sar_point_target(n_pulses: int, n_range: int, rng_bin: int,
                     az_bin: int, range_ref, azimuth_ref):
    """Synthetic raw echo of one point scatterer (sar_processor.rs:426
    generate_point_target) for pipeline tests."""
    k = len(np.asarray(range_ref))
    raw = np.zeros((n_pulses, n_range), np.complex64)
    rr = np.asarray(range_ref)
    ar = np.asarray(azimuth_ref)
    for p in range(n_pulses):
        if 0 <= p - az_bin < len(ar) and rng_bin + k <= n_range:
            raw[p, rng_bin:rng_bin + k] += ar[p - az_bin] * rr
    return raw


# -------------------------------------------------------- passive radar


def cross_ambiguity(reference, surveillance, max_delay: int,
                    n_doppler: int | None = None):
    """Cross-ambiguity surface CAF[tau, nu] = sum_t s(t) r*(t-tau)
    e^{-j2pi nu t} (passive_radar_processor.rs:245): one gather builds
    all delay lags, one batched FFT gives every Doppler bin. Returns
    (caf (max_delay, n_doppler), doppler_bins cycles/sample)."""
    r = jnp.asarray(reference, IQ_DTYPE)
    s = jnp.asarray(surveillance, IQ_DTYPE)
    n = min(r.shape[-1], s.shape[-1])
    r = r[:n]
    s = s[:n]
    lags = jnp.arange(max_delay)
    idx = jnp.arange(n)[None, :] - lags[:, None]
    r_lagged = jnp.where(idx >= 0, r[jnp.clip(idx, 0, n - 1)], 0.0)
    prod = s[None, :] * jnp.conj(r_lagged)  # (D, N)
    caf = jnp.fft.fft(prod, axis=-1)
    caf = jnp.fft.fftshift(caf, axes=-1)
    freqs = np.fft.fftshift(np.fft.fftfreq(n))
    if n_doppler is not None and n_doppler < n:
        c = n // 2
        h = n_doppler // 2
        caf = caf[:, c - h:c - h + n_doppler]
        freqs = freqs[c - h:c - h + n_doppler]
    return caf, freqs


def cancel_dsi(reference, surveillance, n_taps: int = 16):
    """Direct-signal interference cancellation
    (passive_radar_processor.rs:325): least-squares projection of the
    surveillance channel onto delayed copies of the reference (ECA)."""
    r = jnp.asarray(reference, IQ_DTYPE)
    s = jnp.asarray(surveillance, IQ_DTYPE)
    n = min(r.shape[-1], s.shape[-1])
    r = r[:n]
    s = s[:n]
    lags = jnp.arange(n_taps)
    idx = jnp.arange(n)[None, :] - lags[:, None]
    a = jnp.where(idx >= 0, r[jnp.clip(idx, 0, n - 1)], 0.0).T  # (N, T)
    w, *_ = jnp.linalg.lstsq(a, s)
    return s - a @ w


# ------------------------------------------------------ TDOA / location


def gcc_phat(x1, x2, max_delay: int | None = None):
    """Generalized cross-correlation with phase transform
    (tdoa_estimator.rs role): returns (delay_samples, correlation)."""
    a = jnp.asarray(x1, IQ_DTYPE)
    b = jnp.asarray(x2, IQ_DTYPE)
    n = a.shape[-1] + b.shape[-1]
    fa = jnp.fft.fft(a, n)
    fb = jnp.fft.fft(b, n)
    cross = fa * jnp.conj(fb)
    cross = cross / jnp.maximum(jnp.abs(cross), 1e-12)
    cc = jnp.fft.fftshift(jnp.fft.ifft(cross).real)
    center = n // 2
    if max_delay is not None:
        cc = jax.lax.dynamic_slice(
            cc, (center - max_delay,), (2 * max_delay + 1,))
        delay = jnp.argmax(cc) - max_delay
    else:
        delay = jnp.argmax(cc) - center
    return delay, cc


def tdoa_localize(positions, tdoas_m, iters: int = 20):
    """2-D emitter localization from range differences
    (emitter_localization.rs): positions (R, 2) receiver coordinates,
    tdoas_m (R-1,) range differences d_i - d_0 in meters (receiver 0 is
    the reference). Gauss-Newton iteration from the array centroid."""
    p = jnp.asarray(positions, jnp.float32)
    dd = jnp.asarray(tdoas_m, jnp.float32)

    def gn_step(est, _):
        d = jnp.linalg.norm(p - est, axis=1)
        f = (d[1:] - d[0]) - dd
        # jacobian of d_i - d_0 wrt position
        u = (est - p) / jnp.maximum(d[:, None], 1e-9)
        jac = u[1:] - u[0]
        # 2 unknowns: normal equations (regularized) replace lstsq
        jtj = jac.T @ jac + 1e-9 * jnp.eye(2, dtype=jnp.float32)
        step = jnp.linalg.solve(jtj, -jac.T @ f)
        return est + step, None

    est, _ = jax.lax.scan(gn_step, jnp.mean(p, axis=0), None,
                          length=iters)
    return est


# ------------------------------------------------------------- ELINT


def pulse_characterize(x, sample_rate: float, threshold_db: float = 10.0,
                       max_pulses: int = 64, min_width: int = 4):
    """ELINT pulse measurement (elint_pulse_characterizer.rs): detect
    pulses against the noise floor and measure TOA, width, amplitude
    and coarse carrier offset per pulse. Returns a dict of fixed-size
    arrays plus a validity count (static shapes, XLA-style)."""
    x = np.asarray(x)
    env = np.abs(x)
    floor = np.median(env) + 1e-12
    mask = env > floor * 10 ** (threshold_db / 20.0)
    dm = np.diff(mask.astype(np.int8))
    rises = np.where(dm == 1)[0] + 1
    falls = np.where(dm == -1)[0] + 1
    if mask[0]:
        rises = np.concatenate([[0], rises])
    if mask[-1]:
        falls = np.concatenate([falls, [len(x)]])
    # drop noise spikes narrower than min_width samples
    keep = [(a, b) for a, b in zip(rises, falls) if b - a >= min_width]
    rises = np.asarray([a for a, _ in keep], np.int64)
    falls = np.asarray([b for _, b in keep], np.int64)
    n = min(len(rises), len(falls), max_pulses)
    toa = np.zeros(max_pulses)
    width = np.zeros(max_pulses)
    amp = np.zeros(max_pulses)
    freq = np.zeros(max_pulses)
    for i in range(n):
        a, b = rises[i], falls[i]
        toa[i] = a / sample_rate
        width[i] = (b - a) / sample_rate
        seg = x[a:b]
        amp[i] = np.max(np.abs(seg))
        if len(seg) >= 4 and np.iscomplexobj(x):
            spec = np.abs(np.fft.fft(seg, 256))
            freq[i] = np.fft.fftfreq(256, 1 / sample_rate)[np.argmax(spec)]
    pri = np.diff(toa[:n]) if n > 1 else np.zeros(0)
    return {
        "count": n, "toa_s": toa, "width_s": width, "amplitude": amp,
        "carrier_hz": freq,
        "pri_s": float(np.median(pri)) if len(pri) else 0.0,
    }


def esm_scan(x, sample_rate: float, nfft: int = 1024,
             threshold_db: float = 12.0, max_emitters: int = 16):
    """ESM spectral surveillance (esm_receiver.rs): Welch PSD -> peaks
    above the noise floor -> emitter list (freq, power, bandwidth)."""
    from r4w_tpu.ops.measure import welch_psd

    psd = np.asarray(welch_psd(jnp.asarray(x, IQ_DTYPE), nperseg=nfft,
                               sample_rate=sample_rate))
    # welch_psd returns an already-fftshifted spectrum
    psd_db = 10 * np.log10(np.maximum(psd, 1e-30))
    freqs = np.fft.fftshift(np.fft.fftfreq(nfft, 1 / sample_rate))
    floor = np.median(psd_db)
    above = psd_db > floor + threshold_db
    emitters = []
    i = 0
    while i < nfft and len(emitters) < max_emitters:
        if above[i]:
            j = i
            while j < nfft and above[j]:
                j += 1
            seg = slice(i, j)
            k = i + int(np.argmax(psd_db[seg]))
            emitters.append({
                "freq_hz": float(freqs[k]),
                "power_db": float(psd_db[k] - floor),
                "bandwidth_hz": float((j - i) * sample_rate / nfft),
            })
            i = j
        else:
            i += 1
    return emitters
