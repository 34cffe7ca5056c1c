"""Bit-level coding ops: Gray code, LoRa Hamming FEC, whitening, interleaving.

Vectorized re-designs of the reference LoRa coding chain
(crates/r4w-core/src/coding.rs, whitening.rs): all codecs are pure
array→array functions. Small codes are expressed as lookup tables
(numpy-precomputed, constant-folded under jit) and gathers — the natural
batched formulation — rather than per-symbol bit loops.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# --------------------------------------------------------------------------
# Gray code (coding.rs:52-120): g = n ^ (n >> 1)
# --------------------------------------------------------------------------


def gray_encode(x: jax.Array) -> jax.Array:
    x = jnp.asarray(x, jnp.int32)
    return x ^ (x >> 1)


def gray_decode(g: jax.Array) -> jax.Array:
    """Inverse Gray: repeated xor-shift (log2(16-bit) = 4 steps)."""
    g = jnp.asarray(g, jnp.int32)
    g = g ^ (g >> 8)
    g = g ^ (g >> 4)
    g = g ^ (g >> 2)
    g = g ^ (g >> 1)
    return g


# --------------------------------------------------------------------------
# LoRa Hamming(4, 4+cr) FEC (coding.rs:126-240)
# Parity matrices from the reference (rows generate parity bits appended
# above the 4 data bits; data bit i corresponds to (data >> (3-i)) & 1).
# --------------------------------------------------------------------------

_PARITY_ROWS = {
    1: [[1, 1, 1, 1]],
    2: [[1, 0, 1, 1], [0, 1, 1, 1]],
    3: [[1, 0, 1, 1], [1, 1, 1, 0], [0, 1, 1, 1]],
    4: [[1, 0, 1, 1], [1, 1, 1, 0], [1, 1, 0, 1], [0, 1, 1, 1]],
}


@functools.lru_cache(maxsize=None)
def _hamming_tables(cr: int) -> tuple[np.ndarray, np.ndarray]:
    """(encode LUT [16] -> codeword, decode LUT [2^(4+cr)] -> nibble)."""
    rows = _PARITY_ROWS[cr]
    enc = np.zeros(16, np.int32)
    for data in range(16):
        bits = [(data >> (3 - i)) & 1 for i in range(4)]
        cw = data & 0x0F
        for i, row in enumerate(rows):
            p = sum(r & d for r, d in zip(row, bits)) & 1
            cw |= p << (4 + i)
        enc[data] = cw

    # Decode by minimum-distance to the 16 valid codewords. CR4/7 and CR4/8
    # have minimum distance 3 → true single-bit correction. (Deviation from
    # the reference: its simplified syndrome rule, coding.rs:214-227, never
    # matches the syndromes data-bit flips actually produce with its parity
    # matrices, so it corrects nothing and corrupts data on parity-bit
    # errors; we do proper MD decoding instead. Identical on clean input.)
    t = 1 if cr in (3, 4) else 0
    size = 1 << (4 + cr)
    dec = np.zeros(size, np.int32)
    codewords = enc  # [16]
    for w in range(size):
        dists = np.array([bin(w ^ int(c)).count("1") for c in codewords])
        best = int(np.argmin(dists))
        dec[w] = best if dists[best] <= t else (w & 0x0F)
    return enc, dec


def hamming_encode(nibbles: jax.Array, cr: int) -> jax.Array:
    """Encode 4-bit nibbles to (4+cr)-bit codewords. cr in 1..4."""
    enc, _ = _hamming_tables(cr)
    return jnp.asarray(enc)[jnp.asarray(nibbles, jnp.int32) & 0xF]


def hamming_decode(codewords: jax.Array, cr: int) -> jax.Array:
    """Decode (4+cr)-bit codewords to nibbles, correcting 1-bit errors at CR4/8."""
    _, dec = _hamming_tables(cr)
    mask = (1 << (4 + cr)) - 1
    return jnp.asarray(dec)[jnp.asarray(codewords, jnp.int32) & mask]


# --------------------------------------------------------------------------
# LoRa whitening (whitening.rs:40-120): 8-bit LFSR, state<<1 | parity(state
# & 0x3A), output = old MSB. XOR'd bytewise with data. The whole sequence
# is a pure function of position → precompute as a LUT and gather.
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _whitening_sequence(n_bytes: int) -> np.ndarray:
    state = 0xFF
    out = np.zeros(n_bytes, np.int32)
    for b in range(n_bytes):
        byte = 0
        for i in range(8):
            fb = bin(state & 0x3A).count("1") & 1
            msb = (state >> 7) & 1
            state = ((state << 1) | fb) & 0xFF
            byte |= msb << (7 - i)
        out[b] = byte
    return out


def whitening_sequence(n_bytes: int) -> jax.Array:
    """First n_bytes of the LoRa whitening PRBS (as int32 bytes)."""
    return jnp.asarray(_whitening_sequence(n_bytes))


def whiten(data: jax.Array) -> jax.Array:
    """XOR data bytes with the whitening sequence (self-inverse)."""
    data = jnp.asarray(data, jnp.int32)
    seq = whitening_sequence(int(data.shape[-1]))
    return data ^ seq


dewhiten = whiten


# --------------------------------------------------------------------------
# LoRa diagonal interleaver (coding.rs:261-304)
# sf codewords of (4+cr) bits  <->  (4+cr) symbols of sf bits
#   symbols[(i+j) % n_bits] bit i = codeword[i] bit j
# --------------------------------------------------------------------------


def interleave(codewords: jax.Array, sf: int, cr: int) -> jax.Array:
    """Interleave blocks of sf codewords -> n_bits symbols.

    codewords: (..., sf) int32. Returns (..., 4+cr) int32 symbols.
    """
    n_bits = 4 + cr
    cw = jnp.asarray(codewords, jnp.int32)
    i = jnp.arange(sf)[:, None]  # codeword index / bit position in symbol
    j = jnp.arange(n_bits)[None, :]  # bit index in codeword
    bits = (cw[..., :, None] >> j) & 1  # (..., sf, n_bits)
    sym_idx = (i + j) % n_bits  # target symbol for each (i, j)
    contrib = bits << i  # bit value at position i
    # scatter-add contributions into symbols along a new axis
    onehot = (sym_idx[None, ...] == jnp.arange(n_bits)[:, None, None]).astype(
        jnp.int32
    )  # (n_bits, sf, n_bits)
    symbols = jnp.einsum("...ij,kij->...k", contrib, onehot)
    return symbols


def deinterleave(symbols: jax.Array, sf: int, cr: int) -> jax.Array:
    """Inverse of `interleave`: (..., 4+cr) symbols -> (..., sf) codewords."""
    n_bits = 4 + cr
    syms = jnp.asarray(symbols, jnp.int32)
    i = jnp.arange(sf)[:, None]
    j = jnp.arange(n_bits)[None, :]
    sym_idx = (i + j) % n_bits  # (sf, n_bits)
    gathered = jnp.take(syms, sym_idx, axis=-1)  # (..., sf, n_bits)
    bits = (gathered >> i) & 1
    codewords = jnp.sum(bits << j, axis=-1)
    return codewords


# --------------------------------------------------------------------------
# Byte/nibble/bit packing helpers
# --------------------------------------------------------------------------


def bytes_to_nibbles(data: jax.Array) -> jax.Array:
    """(..., n) bytes -> (..., 2n) nibbles, high nibble first (modulation.rs)."""
    data = jnp.asarray(data, jnp.int32)
    hi = (data >> 4) & 0xF
    lo = data & 0xF
    return jnp.stack([hi, lo], axis=-1).reshape(*data.shape[:-1], -1)


def nibbles_to_bytes(nibbles: jax.Array) -> jax.Array:
    """(..., 2n) nibbles -> (..., n) bytes (demodulation.rs:355-368)."""
    nib = jnp.asarray(nibbles, jnp.int32)
    pairs = nib.reshape(*nib.shape[:-1], -1, 2)
    return (pairs[..., 0] << 4) | (pairs[..., 1] & 0x0F)


def bytes_to_bits(data: jax.Array) -> jax.Array:
    """(..., n) bytes -> (..., 8n) bits, MSB first."""
    data = jnp.asarray(data, jnp.int32)
    shifts = jnp.arange(7, -1, -1)
    bits = (data[..., None] >> shifts) & 1
    return bits.reshape(*data.shape[:-1], -1)


def bits_to_bytes(bits: jax.Array) -> jax.Array:
    """(..., 8n) bits -> (..., n) bytes, MSB first."""
    bits = jnp.asarray(bits, jnp.int32)
    b = bits.reshape(*bits.shape[:-1], -1, 8)
    shifts = jnp.arange(7, -1, -1)
    return jnp.sum(b << shifts, axis=-1)


def bits_to_symbols(bits: jax.Array, bits_per_symbol: int) -> jax.Array:
    """Group bits (MSB first) into symbols of `bits_per_symbol` bits."""
    bits = jnp.asarray(bits, jnp.int32)
    b = bits.reshape(*bits.shape[:-1], -1, bits_per_symbol)
    shifts = jnp.arange(bits_per_symbol - 1, -1, -1)
    return jnp.sum(b << shifts, axis=-1)


def symbols_to_bits(symbols: jax.Array, bits_per_symbol: int) -> jax.Array:
    """Unpack symbols into bits, MSB first."""
    s = jnp.asarray(symbols, jnp.int32)
    shifts = jnp.arange(bits_per_symbol - 1, -1, -1)
    bits = (s[..., None] >> shifts) & 1
    return bits.reshape(*s.shape[:-1], -1)
