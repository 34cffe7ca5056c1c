"""Shared machinery for memoryless linear modulations (PSK/QAM/ASK/OOK).

The reference implements each of these with per-symbol Rust loops
(psk.rs:206-300, qam.rs, ask.rs). Here one batched path serves them all:

  TX: bits → symbol values → gray LUT → constellation gather → repeat sps
  RX: reshape (S, sps) → mean → nearest-constellation argmin → gray⁻¹ LUT

The nearest-point search is a (S × M) distance matrix — a matmul-shaped op
batched matmuls handle well at Monte-Carlo batch sizes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from r4w_tpu.core.types import IQ_DTYPE, REAL_DTYPE, SYMBOL_DTYPE
from r4w_tpu.ops.coding import bits_to_symbols, symbols_to_bits, bits_to_bytes

# 1-D Gray sequences used by the reference (psk.rs:95-101, qam.rs:144-152)
GRAY_1D = {
    2: [0, 1],
    4: [0, 1, 3, 2],
    8: [0, 1, 3, 2, 6, 7, 5, 4],
    16: [0, 1, 3, 2, 6, 7, 5, 4, 12, 13, 15, 14, 10, 11, 9, 8],
}


def psk_constellation(m: int, amplitude: float = 1.0) -> np.ndarray:
    """PSK points: amp·e^{j(offset + 2πi/M)}, offset π/4 for QPSK (psk.rs:80-93)."""
    offset = np.pi / 4.0 if m == 4 else 0.0
    ang = offset + 2.0 * np.pi * np.arange(m) / m
    return (amplitude * np.exp(1j * ang)).astype(np.complex64)


def psk_value_to_index(m: int) -> np.ndarray:
    """Map bit-group value -> constellation index (inverse of psk gray_map)."""
    gray_map = np.array(GRAY_1D.get(m, list(range(m))))
    inv = np.zeros(m, np.int32)
    inv[gray_map] = np.arange(m)
    return inv


def qam_constellation(order: int, amplitude: float = 1.0) -> np.ndarray:
    """Square QAM grid, unit average power (qam.rs:113-141)."""
    side = int(round(np.sqrt(order)))
    i = (2.0 * np.arange(side) - (side - 1))[:, None]
    q = (2.0 * np.arange(side) - (side - 1))[None, :]
    pts = (i + 1j * q).reshape(-1)
    norm = np.sqrt(np.mean(np.abs(pts) ** 2))
    return (amplitude * pts / norm).astype(np.complex64)


def qam_value_to_index(order: int) -> np.ndarray:
    """map[gray_value] = grid index (qam.rs:144-165)."""
    side = int(round(np.sqrt(order)))
    gray_1d = np.array(GRAY_1D.get(side, list(range(side))))
    out = np.zeros(order, np.int32)
    for idx, gi in enumerate(gray_1d):
        for jdx, gq in enumerate(gray_1d):
            out[gi * side + gq] = idx * side + jdx
    return out


def index_to_value(value_to_index: np.ndarray) -> np.ndarray:
    inv = np.zeros_like(value_to_index)
    inv[value_to_index] = np.arange(len(value_to_index), dtype=np.int32)
    return inv


# --------------------------------------------------------------------------
# Batched TX/RX cores (pure, jittable)
# --------------------------------------------------------------------------


def linear_modulate(bits: jax.Array, constellation: jax.Array,
                    value_to_index: jax.Array, bits_per_symbol: int,
                    sps: int) -> jax.Array:
    """bits (..., B) -> IQ (..., (B/bps)*sps). B must divide bps (pre-pad)."""
    from r4w_tpu.core.hostio import to_device

    values = bits_to_symbols(bits, bits_per_symbol)
    idx = jnp.asarray(value_to_index)[values]
    # host->device through core.hostio (ARCHITECTURE.md §7)
    points = to_device(constellation).astype(IQ_DTYPE)[idx]  # (..., S)
    return jnp.repeat(points, sps, axis=-1)


def linear_demodulate_symbols(samples: jax.Array, constellation: jax.Array,
                              sps: int):
    """IQ (..., S*sps) -> (constellation indices (..., S), evm_rms, snr_db)."""
    from r4w_tpu.core.hostio import to_device

    samples = to_device(samples).astype(IQ_DTYPE)
    s = samples.shape[-1] // sps
    chunks = samples[..., : s * sps].reshape(*samples.shape[:-1], s, sps)
    avg = jnp.mean(chunks, axis=-1)  # (..., S)
    const = to_device(constellation).astype(IQ_DTYPE)
    d = avg[..., None] - const  # (..., S, M)
    dist = d.real**2 + d.imag**2
    idx = jnp.argmin(dist, axis=-1).astype(SYMBOL_DTYPE)
    ref = const[idx]
    err = avg - ref
    evm_rms = jnp.sqrt(jnp.mean(err.real**2 + err.imag**2, axis=-1))
    snr_db = -20.0 * jnp.log10(jnp.maximum(evm_rms, 1e-12))
    return idx, evm_rms.astype(REAL_DTYPE), snr_db.astype(REAL_DTYPE)


def indices_to_bits(idx: jax.Array, index_to_value_lut: jax.Array,
                    bits_per_symbol: int) -> jax.Array:
    values = jnp.asarray(index_to_value_lut)[idx]
    return symbols_to_bits(values, bits_per_symbol)


@functools.partial(jax.jit, static_argnames=("bits_per_symbol", "sps"))
def linear_modulate_jit(bits, constellation, value_to_index, bits_per_symbol,
                        sps):
    return linear_modulate(bits, constellation, value_to_index,
                           bits_per_symbol, sps)


def pack_demod_bits(bits: jax.Array) -> jax.Array:
    """Pad bit stream to a whole number of bytes and pack MSB-first
    (psk.rs bits_to_bytes)."""
    n = bits.shape[-1]
    rem = n % 8
    if rem:
        pad = [(0, 0)] * (bits.ndim - 1) + [(0, 8 - rem)]
        bits = jnp.pad(bits, pad)
    return bits_to_bytes(bits)
