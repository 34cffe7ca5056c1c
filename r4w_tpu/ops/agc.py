"""AGC + assorted transform blocks: CORDIC, chirp-Z, cyclostationary
detector, Wigner-Ville.

agc.rs is the reference's canonical block pattern (agc.rs:33-60);
cordic.rs, chirp_z_transform.rs, cyclostationary_detector.rs,
wigner_ville_distribution.rs are flat library blocks.
"""

from __future__ import annotations

import jax
import jax.lax as lax
import jax.numpy as jnp

from r4w_tpu.core.hostio import cis
import numpy as np

from r4w_tpu.core.types import IQ_DTYPE, REAL_DTYPE


def agc(x, target_level: float = 1.0, attack: float = 0.01,
        decay: float = 0.001, gain0: float = 1.0, max_gain: float = 1e4):
    """Automatic gain control (agc.rs): per-sample gain recurrence via
    lax.scan — attack when too loud, decay-up when too quiet.

    Returns (y, final_gain, gain_series).
    """
    x = jnp.asarray(x, IQ_DTYPE)

    def step(gain, xn):
        y = xn * gain
        err = target_level - jnp.abs(y)
        rate = jnp.where(err < 0, attack, decay)
        gain = jnp.clip(gain * (1.0 + rate * err), 1e-6, max_gain)
        return gain, (y, gain)

    gain, (y, gains) = lax.scan(
        step, jnp.asarray(gain0, REAL_DTYPE), jnp.moveaxis(x, -1, 0)
    )
    return jnp.moveaxis(y, 0, -1), gain, jnp.moveaxis(gains, 0, -1)


def agc_block(x, target_level: float = 1.0, block: int = 256):
    """Feed-forward block AGC (batch-friendly): one gain per block from the
    block RMS — the batch-first alternative to the per-sample loop."""
    x = jnp.asarray(x, IQ_DTYPE)
    n = x.shape[-1]
    nb = n // block
    blocks = x[..., : nb * block].reshape(*x.shape[:-1], nb, block)
    rms = jnp.sqrt(jnp.mean(jnp.abs(blocks) ** 2, axis=-1, keepdims=True))
    gain = target_level / jnp.maximum(rms, 1e-9)
    return (blocks * gain).reshape(*x.shape[:-1], nb * block)


def cordic_rotate(x, y, angle_rad, iterations: int = 16):
    """CORDIC vector rotation (cordic.rs) — shift-add only, batched.

    Returns (x', y') ≈ (x·cosθ − y·sinθ, x·sinθ + y·cosθ).
    """
    x = jnp.asarray(x, REAL_DTYPE)
    y = jnp.asarray(y, REAL_DTYPE)
    z = jnp.asarray(angle_rad, REAL_DTYPE)
    # wrap into [-pi/2, pi/2] with quadrant correction
    flip = jnp.abs(z) > jnp.pi / 2
    x = jnp.where(flip, -x, x)
    y = jnp.where(flip, -y, y)
    z = jnp.where(z > jnp.pi / 2, z - jnp.pi,
                  jnp.where(z < -jnp.pi / 2, z + jnp.pi, z))
    angles = np.arctan(2.0 ** -np.arange(iterations))
    k = float(np.prod(1.0 / np.sqrt(1 + 2.0 ** (-2.0 * np.arange(iterations)))))
    for i in range(iterations):
        d = jnp.where(z >= 0, 1.0, -1.0)
        x, y = x - d * y * 2.0**-i, y + d * x * 2.0**-i
        z = z - d * angles[i]
    return x * k, y * k


def cordic_magnitude_phase(i, q, iterations: int = 16):
    """Vectoring-mode CORDIC: (|v|, atan2(q, i)) via shift-add rotations
    (cordic.rs vectoring mode)."""
    x = jnp.asarray(i, REAL_DTYPE)
    y = jnp.asarray(q, REAL_DTYPE)
    # reflect the left half-plane onto the right; remember the offset
    neg = x < 0
    z = jnp.where(neg, jnp.where(y >= 0, jnp.pi, -jnp.pi), 0.0)
    x = jnp.where(neg, -x, x)
    y = jnp.where(neg, -y, y)
    angles = np.arctan(2.0 ** -np.arange(iterations))
    k = float(np.prod(
        1.0 / np.sqrt(1 + 2.0 ** (-2.0 * np.arange(iterations)))))
    for it in range(iterations):
        d = jnp.where(y >= 0, 1.0, -1.0)
        x, y = x + d * y * 2.0**-it, y - d * x * 2.0**-it
        z = z + d * angles[it]
    return x * k, z


def chirp_z_transform(x, m: int, w: complex, a: complex = 1.0 + 0j):
    """Chirp-Z transform (chirp_z_transform.rs): evaluate the z-transform
    on the spiral a·w^-k, k=0..M-1, via Bluestein's algorithm."""
    x = jnp.asarray(x, IQ_DTYPE)
    n = x.shape[-1]
    k2 = (np.arange(max(n, m)) ** 2) / 2.0
    wk = np.power(np.asarray(w, np.complex128), k2[:n])
    an = np.power(1.0 / np.asarray(a, np.complex128), np.arange(n))
    y = x * jnp.asarray((an * wk).astype(np.complex64))
    nfft = 1
    while nfft < n + m - 1:
        nfft <<= 1
    v_np = np.zeros(nfft, np.complex128)
    wmk = np.power(np.asarray(w, np.complex128), -k2[: max(n, m)])
    v_np[:m] = wmk[:m]
    v_np[nfft - n + 1:] = wmk[1:n][::-1]
    v_f = jnp.fft.fft(jnp.asarray(v_np.astype(np.complex64)))
    out = jnp.fft.ifft(
        jnp.fft.fft(y, n=nfft, axis=-1) * v_f, axis=-1
    )[..., :m]
    wm = np.power(np.asarray(w, np.complex128), k2[:m])
    return out * jnp.asarray(wm.astype(np.complex64))


def zoom_fft(x, f_lo: float, f_hi: float, m: int, sample_rate: float):
    """Zoomed spectrum on [f_lo, f_hi) with m bins via chirp-Z."""
    a = np.exp(2j * np.pi * f_lo / sample_rate)
    w = np.exp(-2j * np.pi * (f_hi - f_lo) / (m * sample_rate))
    return chirp_z_transform(x, m, w, a)


def cyclostationary_detector(x, alpha_hz, sample_rate, nfft: int = 256):
    """Spectral correlation at cyclic frequency α (cyclostationary_
    detector.rs): correlate shifted spectra — detects cyclostationary
    signals (e.g. BPSK at symbol rate) buried in noise."""
    x = jnp.asarray(x, IQ_DTYPE)
    n = x.shape[-1]
    t = jnp.arange(n, dtype=REAL_DTYPE) / sample_rate
    up = x * cis((jnp.pi * alpha_hz * t).astype(REAL_DTYPE))
    dn = x * cis(-(jnp.pi * alpha_hz * t).astype(REAL_DTYPE))
    from r4w_tpu.ops.measure import stft

    s_up = stft(up, nfft)
    s_dn = stft(dn, nfft)
    scf = jnp.mean(s_up * jnp.conj(s_dn), axis=-2)
    p_up = jnp.mean(jnp.abs(s_up) ** 2, axis=-2)
    p_dn = jnp.mean(jnp.abs(s_dn) ** 2, axis=-2)
    coherence = jnp.abs(scf) / jnp.sqrt(
        jnp.maximum(p_up * p_dn, 1e-30)
    )
    return coherence  # (..., nfft) in [0, 1]


def wigner_ville(x, nfft: int = 128):
    """Discrete pseudo-Wigner-Ville distribution
    (wigner_ville_distribution.rs): time-frequency energy surface."""
    x = jnp.asarray(x, IQ_DTYPE)
    n = x.shape[-1]
    half = nfft // 2
    pad = jnp.pad(x, (half, half))
    taus = jnp.arange(-half, half)
    # r[t, tau] = x[t+tau]·conj(x[t-tau])
    t_idx = jnp.arange(n)[:, None] + half
    r = pad[t_idx + taus[None, :]] * jnp.conj(pad[t_idx - taus[None, :]])
    spec = jnp.fft.fft(r, n=nfft, axis=-1)
    return jnp.real(spec)  # (n, nfft)
