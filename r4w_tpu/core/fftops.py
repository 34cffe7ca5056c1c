"""Batched FFT utilities.

Batch-first equivalent of the reference FFT wrapper
(crates/r4w-core/src/fft_utils.rs:44-300): instead of a cached-plan
``FftProcessor`` object, every helper here is a pure, jit/vmap-composable
function operating on the *last* axis, so arbitrary leading batch axes
(symbols, Monte-Carlo lanes, PRNs, Doppler bins) are free parallelism for
XLA.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from r4w_tpu.core.types import IQ_DTYPE, REAL_DTYPE


def fft(x: jax.Array, n: int | None = None, axis: int = -1) -> jax.Array:
    """Forward FFT (fft_utils.rs:85 `fft`)."""
    return jnp.fft.fft(x.astype(IQ_DTYPE), n=n, axis=axis)


def ifft(x: jax.Array, n: int | None = None, axis: int = -1) -> jax.Array:
    """Inverse FFT (normalized by 1/N, matching rustfft usage + manual scale)."""
    return jnp.fft.ifft(x.astype(IQ_DTYPE), n=n, axis=axis)


def fftshift(x: jax.Array, axis: int = -1) -> jax.Array:
    """Center DC (fft_utils.rs fftshift)."""
    return jnp.fft.fftshift(x, axes=axis)


def power_spectrum(x: jax.Array, axis: int = -1) -> jax.Array:
    """|FFT|^2 (fft_utils.rs power_spectrum)."""
    spec = fft(x, axis=axis)
    return (spec.real**2 + spec.imag**2).astype(REAL_DTYPE)


def magnitude(x: jax.Array) -> jax.Array:
    return jnp.abs(x).astype(REAL_DTYPE)


def find_peak(spectrum: jax.Array, axis: int = -1):
    """Peak bin, magnitude, and phase of a complex spectrum.

    Mirrors fft_utils.rs:120 `find_peak`. Batched over leading axes.
    Returns (bin_index:int32, magnitude:f32, phase:f32).
    """
    mag = jnp.abs(spectrum)
    idx = jnp.argmax(mag, axis=axis)
    peak = jnp.take_along_axis(spectrum, idx[..., None], axis=axis)[..., 0]
    return (
        idx.astype(jnp.int32),
        jnp.abs(peak).astype(REAL_DTYPE),
        jnp.angle(peak).astype(REAL_DTYPE),
    )


def find_peak_interpolated(spectrum: jax.Array, axis: int = -1):
    """Quadratic (parabolic) peak interpolation on |spectrum|.

    Mirrors fft_utils.rs:145 `find_peak_interpolated`: fits a parabola
    through the peak bin and its circular neighbors, returning
    (fractional_index:f32, interpolated_magnitude:f32).
    """
    mag = jnp.abs(spectrum)
    n = mag.shape[axis]
    mag = jnp.moveaxis(mag, axis, -1)
    idx = jnp.argmax(mag, axis=-1)
    ym = jnp.take_along_axis(mag, ((idx - 1) % n)[..., None], axis=-1)[..., 0]
    y0 = jnp.take_along_axis(mag, idx[..., None], axis=-1)[..., 0]
    yp = jnp.take_along_axis(mag, ((idx + 1) % n)[..., None], axis=-1)[..., 0]
    denom = ym - 2.0 * y0 + yp
    # delta in [-0.5, 0.5]; guard flat spectra
    delta = jnp.where(jnp.abs(denom) > 1e-12, 0.5 * (ym - yp) / denom, 0.0)
    delta = jnp.clip(delta, -0.5, 0.5)
    y_interp = y0 - 0.25 * (ym - yp) * delta
    return (idx.astype(REAL_DTYPE) + delta).astype(REAL_DTYPE), y_interp.astype(
        REAL_DTYPE
    )


def cross_correlate(a: jax.Array, b: jax.Array) -> jax.Array:
    """Circular cross-correlation via FFT (fft_utils.rs:210).

    corr = IFFT(FFT(a) * conj(FFT(b))), computed at the padded power-of-two
    length of len(a)+len(b)-1 and truncated. Batched over leading axes.
    """
    la, lb = a.shape[-1], b.shape[-1]
    n = 1 << (la + lb - 2).bit_length() if (la + lb - 1) > 1 else 1
    fa = jnp.fft.fft(a.astype(IQ_DTYPE), n=n, axis=-1)
    fb = jnp.fft.fft(b.astype(IQ_DTYPE), n=n, axis=-1)
    corr = jnp.fft.ifft(fa * jnp.conj(fb), axis=-1)
    return corr[..., : la + lb - 1]


@functools.partial(jax.jit, static_argnames=("nfft", "hop", "window"))
def spectrogram(
    x: jax.Array, nfft: int = 256, hop: int | None = None, window: str = "hann"
) -> jax.Array:
    """Magnitude spectrogram, frames x bins (fft_utils.rs:241 `Spectrogram`).

    Frames the last axis with `hop` (defaults to nfft//2), windows, FFTs,
    and returns |S| of shape (..., n_frames, nfft).
    """
    from r4w_tpu.core.windows import make_window

    hop = hop or nfft // 2
    n = x.shape[-1]
    n_frames = max(0, (n - nfft) // hop + 1)
    if n_frames == 0:
        return jnp.zeros(x.shape[:-1] + (0, nfft), REAL_DTYPE)
    starts = jnp.arange(n_frames) * hop
    idx = starts[:, None] + jnp.arange(nfft)[None, :]
    frames = x[..., idx]  # (..., n_frames, nfft)
    w = make_window(window, nfft).astype(REAL_DTYPE)
    spec = jnp.fft.fft(frames * w, axis=-1)
    return jnp.abs(spec).astype(REAL_DTYPE)
