"""Spreading-code generators: LFSR/m-sequence, Gold, Barker, Zadoff-Chu.

Re-design of crates/r4w-core/src/spreading/lfsr.rs, spreading/gold.rs,
spreading/barker.rs (family root spreading/mod.rs), the flat
barker_code.rs / gold_code_generator.rs blocks, and
zadoff_chu_generator.rs: codes are precomputed on the host as numpy
arrays (they're tiny and static) and consumed on-device as constants —
the streaming `next_chip` iterators of the reference collapse into whole
sequences.

Chips use the BPSK mapping bit 0 -> +1, bit 1 -> -1 (lfsr.rs:138-146).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Preferred m-sequence polynomial pairs for Gold codes (lfsr.rs:157-165)
GOLD_PREFERRED_PAIRS = {
    5: (0x12, 0x1E),
    6: (0x21, 0x33),
    7: (0x41, 0x47),
    8: (0x8E, 0xAE),
    9: (0x108, 0x130),
    10: (0x204, 0x327),
}

# Default m-sequence polynomials by degree (lfsr.rs:113-124)
MSEQ_POLY = {
    3: 0x05, 4: 0x09, 5: 0x12, 6: 0x21, 7: 0x41, 8: 0x8E, 9: 0x108,
    10: 0x204,
}

# All known Barker codes (barker.rs:36-55)
BARKER_CODES = {
    2: [1, -1],
    3: [1, 1, -1],
    4: [1, 1, -1, 1],
    5: [1, 1, 1, -1, 1],
    7: [1, 1, 1, -1, -1, 1, -1],
    11: [1, 1, 1, -1, -1, -1, 1, -1, -1, 1, -1],
    13: [1, 1, 1, 1, 1, -1, -1, 1, 1, -1, 1, -1, 1],
}


def lfsr_bits(degree: int, polynomial: int, initial_state: int = 0x01,
              length: int | None = None) -> np.ndarray:
    """Fibonacci LFSR output bits (lfsr.rs:58-72): MSB out, feedback =
    parity(state & poly), shift left."""
    n = length if length is not None else (1 << degree) - 1
    state = initial_state
    mask = (1 << degree) - 1
    out = np.empty(n, np.int8)
    for i in range(n):
        out[i] = (state >> (degree - 1)) & 1
        fb = bin(state & polynomial).count("1") & 1
        state = ((state << 1) | fb) & mask
    return out


def _bits_to_chips(bits: np.ndarray) -> np.ndarray:
    return np.where(bits == 0, 1, -1).astype(np.int8)


@functools.lru_cache(maxsize=None)
def m_sequence(degree: int, polynomial: int | None = None,
               initial_state: int = 0x01) -> np.ndarray:
    """Full-period m-sequence as ±1 chips, length 2^degree - 1."""
    poly = polynomial if polynomial is not None else MSEQ_POLY[degree]
    return _bits_to_chips(lfsr_bits(degree, poly, initial_state))


@functools.lru_cache(maxsize=None)
def gold_code(degree: int, index: int) -> np.ndarray:
    """Gold code family member as ±1 chips (gold.rs:131-163).

    index 0 -> m-seq A, 1 -> m-seq B, k>=2 -> A xor roll(B, -(k-2)).
    Family size 2^degree + 1.
    """
    poly_a, poly_b = GOLD_PREFERRED_PAIRS[degree]
    a = lfsr_bits(degree, poly_a)
    b = lfsr_bits(degree, poly_b)
    n = len(a)
    index = index % (n + 2)
    if index == 0:
        return _bits_to_chips(a)
    if index == 1:
        return _bits_to_chips(b)
    return _bits_to_chips(a ^ np.roll(b, -(index - 2)))


def gold_family(degree: int, count: int | None = None) -> np.ndarray:
    """(count, 2^degree - 1) bank of Gold codes — one constant array for
    batched correlation as a matmul."""
    n = (1 << degree) - 1
    count = count if count is not None else n + 2
    return np.stack([gold_code(degree, i) for i in range(count)])


def barker_code(length: int) -> np.ndarray:
    if length not in BARKER_CODES:
        raise ValueError(
            f"no Barker code of length {length}; "
            f"available: {sorted(BARKER_CODES)}"
        )
    return np.asarray(BARKER_CODES[length], np.int8)


def zadoff_chu(root: int, length: int, shift: int = 0) -> np.ndarray:
    """Zadoff-Chu sequence (zadoff_chu_generator.rs): constant amplitude,
    zero autocorrelation. x[n] = exp(-jπ·u·n·(n+1+2q)/N) for odd N."""
    n = np.arange(length)
    if length % 2 == 0:
        phase = -np.pi * root * n * n / length
    else:
        phase = -np.pi * root * n * (n + 1 + 2 * shift) / length
    return np.exp(1j * phase).astype(np.complex64)


def pn_autocorrelation(chips: np.ndarray) -> np.ndarray:
    """Circular autocorrelation of a ±1 chip sequence (test utility)."""
    n = len(chips)
    f = np.fft.fft(chips.astype(np.float64))
    return np.round(np.real(np.fft.ifft(f * np.conj(f)))).astype(np.int64)


# --------------------------------------------------------------------------
# RAKE receiver (rake_receiver.rs re-design)
# --------------------------------------------------------------------------


def rake_search(rx, code, max_fingers: int = 4, window: int | None = None,
                threshold: float = 0.2):
    """Find multipath fingers by correlating one code period over a
    delay window (rake_receiver.rs:89 search_fingers).

    rx: (N,) complex; code: (L,) ±1 chips at the same rate.
    Returns (delays (F,) int32, gains (F,) complex64, valid (F,) bool):
    up to max_fingers delays whose correlation magnitude exceeds
    threshold × the strongest peak; gains are the normalized complex
    correlations (used as MRC weights).
    """
    rx = jnp.asarray(rx)
    code = jnp.asarray(code, jnp.float32)
    l = code.shape[-1]
    w = int(window) if window is not None else l
    # (W, L) delayed windows of rx against the code
    idx = jnp.arange(w)[:, None] + jnp.arange(l)[None, :]
    idx = jnp.minimum(idx, rx.shape[-1] - 1)
    segs = rx[idx]
    corr = segs @ code.astype(segs.dtype) / l  # (W,) complex
    mag = jnp.abs(corr)
    # greedy peak pick with ±1-chip exclusion around chosen fingers
    def pick(carry, _):
        m, chosen = carry
        d = jnp.argmax(m)
        g = mag[d]
        excl = jnp.abs(jnp.arange(w) - d) <= 1
        m = jnp.where(excl, -jnp.inf, m)
        return (m, chosen), (d, g)

    (_, _), (delays, mags) = jax.lax.scan(
        pick, (mag, jnp.zeros((), jnp.int32)), None, length=max_fingers)
    valid = mags >= threshold * mags[0]
    gains = corr[delays]
    return delays.astype(jnp.int32), gains, valid


def rake_despread(rx, code, delay):
    """Despread at one finger delay: per-symbol correlation
    (rake_receiver.rs:145 despread_at). rx (N,), code (L,) → (N//L,)."""
    rx = jnp.asarray(rx)
    code = jnp.asarray(code, jnp.float32)
    l = code.shape[-1]
    n_sym = (rx.shape[-1]) // l
    idx = (delay + jnp.arange(n_sym)[:, None] * l
           + jnp.arange(l)[None, :])
    segs = rx[jnp.minimum(idx, rx.shape[-1] - 1)]
    return segs @ code.astype(segs.dtype) / l


def rake_combine(rx, code, delays, gains, valid=None, mode: str = "mrc"):
    """Multi-finger despread + diversity combining
    (rake_receiver.rs:171 combine; CombiningMode MRC/EGC/Selection).

    Returns (n_sym,) combined soft symbols.
    """
    rx = jnp.asarray(rx)
    gains = jnp.asarray(gains)
    delays = jnp.asarray(delays, jnp.int32)
    if valid is None:
        valid = jnp.ones(delays.shape, bool)
    fingers = jax.vmap(lambda d: rake_despread(rx, code, d))(delays)  # (F, S)
    if mode == "mrc":
        w = jnp.conj(gains)
    elif mode == "egc":
        mag = jnp.maximum(jnp.abs(gains), 1e-12)
        w = jnp.conj(gains) / mag
    elif mode == "selection":
        best = jnp.argmax(jnp.where(valid, jnp.abs(gains), -1.0))
        w = jnp.zeros_like(gains).at[best].set(
            jnp.conj(gains[best]) / jnp.maximum(jnp.abs(gains[best]), 1e-12))
    else:
        raise ValueError(f"unknown combining mode {mode}")
    w = jnp.where(valid, w, 0.0)
    return jnp.einsum("f,fs->s", w, fingers)
