"""Linear block codes: repetition, extended Golay(24,12), generic
matrix codes.

Re-designs of repetition_code.rs and golay_code.rs (599 LoC): encoding
is a GF(2) matrix product (one int matmul % 2); Golay
decoding uses the classic syndrome table for guaranteed 3-error
correction.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# --------------------------------------------------------------------------
# Repetition code
# --------------------------------------------------------------------------


def repetition_encode(bits, n: int = 3) -> jax.Array:
    return jnp.repeat(jnp.asarray(bits, jnp.int32), n, axis=-1)


def repetition_decode(bits, n: int = 3) -> jax.Array:
    b = jnp.asarray(bits, jnp.int32)
    k = b.shape[-1] // n
    groups = b[..., : k * n].reshape(*b.shape[:-1], k, n)
    return (jnp.sum(groups, axis=-1) * 2 > n).astype(jnp.int32)


# --------------------------------------------------------------------------
# Extended binary Golay (24, 12, 8)
# --------------------------------------------------------------------------

# Standard B matrix (12x12) for G = [I | B] (golay_code.rs uses the same
# construction); rows are the classic circulant-plus-border form.
_GOLAY_B = np.array([
    [1,1,0,1,1,1,0,0,0,1,0,1],
    [1,0,1,1,1,0,0,0,1,0,1,1],
    [0,1,1,1,0,0,0,1,0,1,1,1],
    [1,1,1,0,0,0,1,0,1,1,0,1],
    [1,1,0,0,0,1,0,1,1,0,1,1],
    [1,0,0,0,1,0,1,1,0,1,1,1],
    [0,0,0,1,0,1,1,0,1,1,1,1],
    [0,0,1,0,1,1,0,1,1,1,0,1],
    [0,1,0,1,1,0,1,1,1,0,0,1],
    [1,0,1,1,0,1,1,1,0,0,0,1],
    [0,1,1,0,1,1,1,0,0,0,1,1],
    [1,1,1,1,1,1,1,1,1,1,1,0],
], np.int32)


@functools.lru_cache(maxsize=None)
def _golay_syndrome_table() -> np.ndarray:
    """Map 12-bit syndrome -> 24-bit error pattern (weight <= 3)."""
    h = np.concatenate([_GOLAY_B.T % 2, np.eye(12, dtype=np.int32)], axis=1)
    # H = [B^T | I], codeword c = [data | parity], syndrome = H c^T
    table = np.zeros(1 << 12, np.int64)  # error pattern packed in 24 bits
    found = np.zeros(1 << 12, bool)
    from itertools import combinations

    cols = h.T  # (24, 12): column j = syndrome of single error at bit j
    def syn_of(positions):
        s = np.zeros(12, np.int32)
        for p in positions:
            s ^= cols[p]
        return int("".join(map(str, s)), 2)

    for w in range(4):
        for pos in combinations(range(24), w):
            s = syn_of(pos)
            if not found[s]:
                found[s] = True
                pat = 0
                for p in pos:
                    pat |= 1 << p
                table[s] = pat
    return table


def golay_encode(data12) -> jax.Array:
    """(..., 12) data bits -> (..., 24) codeword [data | parity]."""
    d = jnp.asarray(data12, jnp.int32)
    parity = jnp.einsum("...k,kj->...j", d, jnp.asarray(_GOLAY_B)) % 2
    return jnp.concatenate([d, parity], axis=-1)


def golay_decode(codeword24):
    """(..., 24) -> ((..., 12) data, (...,) n_corrected).

    Corrects any error pattern of weight <= 3 via the syndrome table.
    """
    c = jnp.asarray(codeword24, jnp.int32)
    data, parity = c[..., :12], c[..., 12:]
    # syndrome = B^T d + p
    syn_bits = (jnp.einsum("...k,jk->...j", data,
                           jnp.asarray(_GOLAY_B.T)) + parity) % 2
    weights = jnp.asarray(1 << np.arange(11, -1, -1))
    syn = jnp.einsum("...j,j->...", syn_bits, weights)
    table = jnp.asarray(_golay_syndrome_table())
    pattern = table[syn]  # packed 24-bit error pattern
    err_bits = (pattern[..., None] >> jnp.arange(24)) & 1
    corrected = (c + err_bits) % 2
    n_corr = jnp.sum(err_bits, axis=-1)
    return corrected[..., :12], n_corr


# --------------------------------------------------------------------------
# Generic linear block code over GF(2)
# --------------------------------------------------------------------------


def matrix_encode(data, generator: np.ndarray) -> jax.Array:
    """c = d·G (mod 2) — one int matmul for big batches."""
    return jnp.einsum(
        "...k,kn->...n", jnp.asarray(data, jnp.int32),
        jnp.asarray(generator, jnp.int32)
    ) % 2


def syndrome(received, parity_check: np.ndarray) -> jax.Array:
    """s = H·r^T (mod 2)."""
    return jnp.einsum(
        "...n,jn->...j", jnp.asarray(received, jnp.int32),
        jnp.asarray(parity_check, jnp.int32)
    ) % 2
