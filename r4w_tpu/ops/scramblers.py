"""Scramblers, whiteners & generic-FEC plumbing fills.

Re-designs of scrambler.rs, additive_scrambler.rs, pn_scrambler.rs,
convolutional_interleaver.rs, linear_congruential_whitener.rs,
glfsr_source.rs, gold_code_generator.rs,
cyclic_redundancy_check_parallel.rs, fec_generic_api.rs,
aes_stream_cipher.rs, covert_timing_encoder.rs.

LFSR-driven keystreams that are data-independent are generated
host-side once at trace time (they are pure functions of the static
length, so they constant-fold under jit); the multiplicative
(self-synchronizing) scrambler's bit recursion is data-dependent and
runs as a lax.scan with a population-count feedback tap — every block
here composes under jax.jit/vmap.
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp
from jax import lax

from r4w_tpu.ops import spreading as _spreading

# ------------------------------------------------------- scramblers


def additive_scramble(bits, taps: int, seed: int, nbits: int):
    """Additive (synchronous) scrambler (additive_scrambler.rs):
    XOR with a free-running LFSR keystream. Self-inverse."""
    b = jnp.asarray(bits, jnp.int32)
    ks = _spreading.lfsr_bits(nbits, taps, seed, int(b.shape[0]))
    return b ^ jnp.asarray(ks, jnp.int32)


def _pn_host(bits, taps: int, seed: int, nbits: int, feed_output: bool):
    """Bit-serial fallback for registers wider than a uint32 carry —
    arbitrary-width Python-int state (host-side, 1-D, not jittable)."""
    b = np.asarray(bits).astype(np.int64).reshape(-1)
    mask = (1 << nbits) - 1
    state = seed & mask
    out = np.zeros_like(b)
    for i in range(b.shape[0]):
        fb = bin(state & taps).count("1") & 1
        out[i] = b[i] ^ fb
        state = ((state << 1) | int(out[i] if feed_output else b[i])) & mask
    return jnp.asarray(out, jnp.int32)


def _pn_scan(bits, taps: int, seed: int, nbits: int, feed_output: bool):
    """Shared lax.scan core of the multiplicative (de)scrambler: the
    nbits-wide LFSR state rides the scan carry as a uint32 word and the
    feedback parity is one hardware population-count — the jit/vmap
    form of pn_scrambler.rs's bit loop. Registers wider than 31 bits
    fall back to the host bit-serial loop (correct, not jittable)."""
    if nbits <= 0:
        raise ValueError(f"nbits must be positive, got {nbits}")
    if nbits >= 32:
        return _pn_host(bits, taps, seed, nbits, feed_output)
    b = jnp.asarray(bits, jnp.uint32)
    mask = jnp.uint32((1 << nbits) - 1)
    taps_u = jnp.uint32(taps)
    one = jnp.uint32(1)

    def step(state, bit):
        fb = lax.population_count(state & taps_u) & one
        out = bit ^ fb
        shift_in = out if feed_output else bit
        state = ((state << one) | shift_in) & mask
        return state, out

    _, out = lax.scan(step, jnp.uint32(seed) & mask,
                      jnp.moveaxis(b, -1, 0))
    return jnp.moveaxis(out, 0, -1).astype(jnp.int32)


def pn_scramble(bits, taps: int, seed: int, nbits: int):
    """Multiplicative (self-synchronizing) scrambler (pn_scrambler.rs):
    out = in XOR parity(state&taps); the OUTPUT bit is shifted into the
    state, so the descrambler resynchronizes from the line stream."""
    return _pn_scan(bits, taps, seed, nbits, feed_output=True)


def pn_descramble(bits, taps: int, seed: int, nbits: int):
    """Inverse of pn_scramble — state is fed from the RECEIVED bits."""
    return _pn_scan(bits, taps, seed, nbits, feed_output=False)


@functools.lru_cache(maxsize=None)
def _lcg_keystream(n: int, seed: int) -> np.ndarray:
    state = int(seed)
    a, c, mask = 1664525, 1013904223, (1 << 64) - 1
    ks = np.zeros(n, np.int32)
    for i in range(n):
        state = (a * state + c) & mask
        ks[i] = (state >> 24) & 0xFF
    return ks


def lcg_whiten(data_bytes, seed: int = 0x12345678):
    """XOR bytes with a linear-congruential keystream
    (linear_congruential_whitener.rs). Self-inverse. LCG: Numerical
    Recipes constants, top byte used. The keystream depends only on the
    (static) length, so it is built host-side once and constant-folds
    under jit — the data path is one vectorized XOR."""
    d = jnp.asarray(data_bytes, jnp.int32)
    ks = jnp.asarray(_lcg_keystream(int(d.shape[-1]), int(seed)))
    return d ^ ks


@functools.lru_cache(maxsize=None)
def _glfsr_bits(taps: int, seed: int, nbits: int, n: int) -> np.ndarray:
    mask = (1 << nbits) - 1
    state = seed & mask
    out = np.zeros(n, np.int64)
    for i in range(n):
        out[i] = state & 1
        state >>= 1
        if out[i]:
            state ^= taps
        state &= mask
    return out.astype(np.int32)


def glfsr_source(taps: int, seed: int, nbits: int, n: int):
    """Galois-configuration LFSR bit source (glfsr_source.rs). Pure
    function of static parameters — precomputed host-side, a constant
    under jit."""
    return jnp.asarray(_glfsr_bits(int(taps), int(seed), int(nbits),
                                   int(n)))


def gold_code_generator(degree: int, index: int, n: int | None = None):
    """Named alias of the Gold-code family generator
    (gold_code_generator.rs → spreading.gold_code)."""
    code = _spreading.gold_code(degree, index)
    if n is not None:
        reps = -(-n // code.shape[0])
        code = jnp.tile(code, reps)[:n]
    return code


# ---------------------------------------------------------- CRC batch


def crc16_parallel(frames):
    """CRC-16/X.25 over a BATCH of equal-length byte frames in one
    vectorized table walk (cyclic_redundancy_check_parallel.rs):
    the byte loop is over frame LENGTH, every frame advances in
    lockstep — the batch-first form of per-frame CRC loops."""
    f = jnp.asarray(frames, jnp.int32)          # (B, L)
    # build the X.25 (reflected 0x1021) table host-side
    table = np.zeros(256, np.int64)
    for byte in range(256):
        crc = byte
        for _ in range(8):
            crc = (crc >> 1) ^ 0x8408 if crc & 1 else crc >> 1
        table[byte] = crc
    tab = jnp.asarray(table, jnp.int32)
    crc = jnp.full((f.shape[0],), 0xFFFF, jnp.int32)
    for i in range(f.shape[1]):                 # unrolled over length
        idx = (crc ^ f[:, i]) & 0xFF
        crc = (crc >> 8) ^ tab[idx]
    return crc ^ 0xFFFF


# ------------------------------------------------------ generic FEC API


_FEC_CODECS = {}


def _lazy_codecs():
    if _FEC_CODECS:
        return _FEC_CODECS
    from r4w_tpu.fec import block, convolutional

    def conv_enc(bits, **kw):
        return convolutional.conv_encode(jnp.asarray(bits, jnp.int32))

    def conv_dec(bits, **kw):
        return convolutional.viterbi_decode(jnp.asarray(bits, jnp.int32))

    _FEC_CODECS.update({
        "repetition": (lambda b, r=3, **kw: block.repetition_encode(b, r),
                       lambda b, r=3, **kw: block.repetition_decode(b, r)),
        "golay": (lambda b, **kw: block.golay_encode(b),
                  lambda b, **kw: block.golay_decode(b)[0]),
        "convolutional": (conv_enc, conv_dec),
    })
    return _FEC_CODECS


def fec_encode(name: str, bits, **kw):
    """Unified encoder dispatch (fec_generic_api.rs)."""
    try:
        enc, _ = _lazy_codecs()[name]
    except KeyError:
        raise ValueError(f"unknown FEC '{name}'") from None
    return enc(jnp.asarray(bits, jnp.int32), **kw)


def fec_decode(name: str, bits, **kw):
    try:
        _, dec = _lazy_codecs()[name]
    except KeyError:
        raise ValueError(f"unknown FEC '{name}'") from None
    return dec(jnp.asarray(bits, jnp.int32), **kw)


def fec_list() -> list[str]:
    return sorted(_lazy_codecs())


# ------------------------------------------------------- stream cipher


def aes_ctr_keystream_xor(data: bytes, key: bytes, nonce: bytes) -> bytes:
    """AES-256-CTR stream cipher (aes_stream_cipher.rs) — same CTR core
    the Meshtastic layer uses (mesh_meshtastic.CryptoContext).
    Encrypt == decrypt."""
    from cryptography.hazmat.primitives.ciphers import (
        Cipher, algorithms, modes)
    if len(nonce) != 16:
        nonce = bytes(nonce) + b"\x00" * (16 - len(nonce))
    enc = Cipher(algorithms.AES(bytes(key)), modes.CTR(nonce)).encryptor()
    return enc.update(bytes(data)) + enc.finalize()


# --------------------------------------------------- covert timing code


def covert_timing_encode(bits, base_interval: int, delta: int):
    """Encode bits into inter-event timing (covert_timing_encoder.rs):
    bit 0 → gap of base_interval, bit 1 → base_interval + delta.
    Returns event indices."""
    b = jnp.asarray(bits, jnp.int32)
    gaps = base_interval + delta * b
    return jnp.cumsum(gaps, axis=-1).astype(jnp.int32)


def covert_timing_decode(events, base_interval: int, delta: int):
    ev = jnp.asarray(events, jnp.int32)
    first = ev[..., :1]
    gaps = jnp.concatenate([first, jnp.diff(ev, axis=-1)], axis=-1)
    return (gaps > base_interval + delta // 2).astype(jnp.int32)


BLOCKS = {
    "additive_scrambler": ("additive_scramble", "fec",
                           "synchronous LFSR scrambler "
                           "(additive_scrambler.rs)",
                           ("taps", "seed", "nbits")),
    "pn_scrambler": ("pn_scramble", "fec",
                     "self-synchronizing scrambler (pn_scrambler.rs)",
                     ("taps", "seed", "nbits")),
    "pn_descrambler": ("pn_descramble", "fec",
                       "self-synchronizing descrambler "
                       "(pn_scrambler.rs)", ("taps", "seed", "nbits")),
    "lcg_whitener": ("lcg_whiten", "fec",
                     "LCG byte whitener "
                     "(linear_congruential_whitener.rs)", ("seed",)),
    "glfsr_source": ("glfsr_source", "source",
                     "Galois LFSR source (glfsr_source.rs)",
                     ("taps", "seed", "nbits")),
    "gold_code_generator": ("gold_code_generator", "source",
                            "Gold family (gold_code_generator.rs)",
                            ("degree", "index")),
    "crc_parallel": ("crc16_parallel", "fec",
                     "batched CRC-16/X.25 "
                     "(cyclic_redundancy_check_parallel.rs)"),
    "fec_generic_api": ("fec_encode", "fec",
                        "unified FEC dispatch (fec_generic_api.rs)",
                        ("name",)),
    "aes_stream_cipher": ("aes_ctr_keystream_xor", "fec",
                          "AES-256-CTR stream cipher "
                          "(aes_stream_cipher.rs)", ("key", "nonce")),
    "covert_timing_encoder": ("covert_timing_encode", "modulator",
                              "bits -> event timing "
                              "(covert_timing_encoder.rs)",
                              ("base_interval", "delta")),
}
