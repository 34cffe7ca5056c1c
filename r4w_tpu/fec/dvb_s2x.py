"""DVB-S2X LDPC codec (dvb_s2x_ldpc_codec.rs re-design).

Like the reference, this is the DVB-S2X *frame structure* — the 11
standard code rates, Normal (64800) / Short (16200) coded-bit frames,
systematic IRA staircase (accumulator) parity — over a deterministic
PEG-like pseudo-random information-column placement, NOT the literal
ETSI EN 302 307-2 address tables (the reference generates its H the
same way, dvb_s2x_ldpc_codec.rs:174 generate_parity_check).

Batched design: encoding is a scatter-add of info bits onto check rows
followed by a prefix-XOR (cumsum mod 2) for the staircase — one fused
pass, batchable over frames. Decoding is normalized min-sum on a dense
(checks × max-row-degree) masked edge layout, fori_loop iterations,
fully vectorized over a leading batch of frames.
"""

from __future__ import annotations

import functools

import jax
import jax.lax as lax
import jax.numpy as jnp
import numpy as np

CODE_RATES = {
    "1/4": 0.25, "1/3": 1 / 3, "2/5": 0.4, "1/2": 0.5, "3/5": 0.6,
    "2/3": 2 / 3, "3/4": 0.75, "4/5": 0.8, "5/6": 5 / 6,
    "8/9": 8 / 9, "9/10": 0.9,
}

FRAME_BITS = {"normal": 64800, "short": 16200}

# information-column weight per rate (dvb_s2x_ldpc_codec.rs:178-186)
_INFO_COL_WEIGHT = {
    "1/4": 6, "1/3": 6, "2/5": 5, "1/2": 5, "3/5": 4, "2/3": 4,
    "3/4": 4, "4/5": 4, "5/6": 3, "8/9": 3, "9/10": 3,
}

_RATE_SEED = {r: 100 * (i + 1) for i, r in enumerate(
    ["1/4", "1/3", "2/5", "1/2", "3/5", "2/3", "3/4", "4/5", "5/6",
     "8/9", "9/10"])}
_SIZE_SEED = {"normal": 0xDEAD0000, "short": 0xBEEF0000}

_LCG_MUL = np.uint64(6364136223846793005)
_LCG_ADD = np.uint64(1442695040888963407)


def info_bits(rate: str, frame: str = "short") -> int:
    """k for (rate, frame) (dvb_s2x_ldpc_codec.rs:139)."""
    return int(round(FRAME_BITS[frame] * CODE_RATES[rate]))


@functools.lru_cache(maxsize=None)
def parity_structure(rate: str, frame: str = "short"):
    """Deterministic sparse H in edge-list form.

    Returns dict with:
      k, n, m — dimensions;
      info_rows, info_cols — (E,) arrays: row/col of each info-column 1;
      edge_col, edge_mask — (m, dc_max) dense decoder layout covering
      info AND staircase parity columns.
    The construction mirrors generate_parity_check: each info column j
    gets `info_col_weight` distinct rows from an LCG seeded by
    (j, rate, size) with linear-probe collision resolution; parity
    columns form the dual-diagonal staircase.
    """
    n = FRAME_BITS[frame]
    k = info_bits(rate, frame)
    m = n - k
    w = _INFO_COL_WEIGHT[rate]

    # vectorized LCG draw of w rows per info column; duplicate rows
    # within a column (rare, ~w²/2m) are linear-probed sequentially
    with np.errstate(over="ignore"):
        seeds = (np.arange(k, dtype=np.uint64) * np.uint64(2654435761)
                 + np.uint64(_RATE_SEED[rate])
                 + np.uint64(_SIZE_SEED[frame]))
        draws = np.empty((k, w), np.int64)
        s = seeds
        for t in range(w):
            s = s * _LCG_MUL + _LCG_ADD
            draws[:, t] = (s >> np.uint64(16)).astype(np.int64) % m
    rows_per_col = draws
    srt = np.sort(draws, axis=1)
    dup = (srt[:, 1:] == srt[:, :-1]).any(axis=1)
    for j in np.nonzero(dup)[0]:
        assigned: list[int] = []
        for row in draws[j]:
            row = int(row)
            while row in assigned:
                row = (row + 1) % m
            assigned.append(row)
        rows_per_col[j] = assigned

    info_rows = rows_per_col.reshape(-1)
    info_cols = np.repeat(np.arange(k, dtype=np.int64), w)

    # decoder layout: group all edges (info + staircase) by row
    all_rows = np.concatenate([
        info_rows,
        np.arange(m),                       # diagonal parity col k+i
        np.arange(1, m),                    # sub-diagonal parity col k+i-1
    ])
    all_cols = np.concatenate([
        info_cols,
        k + np.arange(m),
        k + np.arange(m - 1),
    ])
    order = np.argsort(all_rows, kind="stable")
    r_sorted, c_sorted = all_rows[order], all_cols[order]
    deg = np.bincount(r_sorted, minlength=m)
    dc_max = int(deg.max())
    edge_col = np.zeros((m, dc_max), np.int32)
    edge_mask = np.zeros((m, dc_max), bool)
    pos = np.zeros(m, np.int64)
    starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
    slot = np.arange(len(r_sorted)) - starts[r_sorted]
    edge_col[r_sorted, slot] = c_sorted
    edge_mask[r_sorted, slot] = True
    del pos
    return dict(k=k, n=n, m=m, info_rows=info_rows, info_cols=info_cols,
                edge_col=edge_col, edge_mask=edge_mask)


def encode(bits, rate: str = "1/2", frame: str = "short"):
    """Systematic encode (..., k) -> (..., n): codeword = [u | p] with
    staircase parity p_i = p_{i-1} ⊕ (H_info·u)_i
    (dvb_s2x_ldpc_codec.rs:284 encode_ldpc)."""
    st = parity_structure(rate, frame)
    u = jnp.asarray(bits, jnp.int32)
    assert u.shape[-1] == st["k"], (u.shape, st["k"])
    syn = jnp.zeros(u.shape[:-1] + (st["m"],), jnp.int32)
    syn = syn.at[..., jnp.asarray(st["info_rows"])].add(
        u[..., jnp.asarray(st["info_cols"])])
    parity = jnp.cumsum(syn, axis=-1) % 2  # prefix-XOR staircase
    return jnp.concatenate([u, parity], axis=-1)


def decode(llr, rate: str = "1/2", frame: str = "short",
           iters: int = 25, alpha: float = 0.8):
    """Normalized min-sum decode over the masked irregular layout.

    llr: (..., n), positive = bit 0. Returns (info_bits (..., k),
    parity_ok (...,))."""
    st = parity_structure(rate, frame)
    m, n, k = st["m"], st["n"], st["k"]
    edge_col = jnp.asarray(st["edge_col"])
    mask = jnp.asarray(st["edge_mask"])
    llr = jnp.asarray(llr, jnp.float32)
    assert llr.shape[-1] == n
    batch = llr.shape[:-1]
    msg = jnp.zeros(batch + edge_col.shape, jnp.float32)

    flat_cols = edge_col.reshape(-1)

    def var_sums(msg):
        return jnp.zeros_like(llr).at[..., flat_cols].add(
            jnp.where(mask, msg, 0.0).reshape(*batch, -1))

    def iteration(_, msg):
        belief = llr + var_sums(msg)
        v2c = belief[..., edge_col] - msg
        # masked normalized min-sum
        sign = jnp.where(v2c < 0, -1.0, 1.0)
        sign = jnp.where(mask, sign, 1.0)
        prod_sign = jnp.prod(sign, axis=-1, keepdims=True) * sign
        mag = jnp.where(mask, jnp.abs(v2c), jnp.inf)
        m1 = jnp.min(mag, axis=-1, keepdims=True)
        big = jnp.where(mag == m1, jnp.inf, mag)
        m2 = jnp.min(big, axis=-1, keepdims=True)
        # if the minimum is tied, "min over the other edges" is m1 for
        # every edge (m2 would be inf here otherwise)
        n_min = jnp.sum(mag == m1, axis=-1, keepdims=True)
        m2 = jnp.where(n_min > 1, m1, m2)
        new = alpha * prod_sign * jnp.where((mag == m1) & (n_min == 1),
                                            m2, m1)
        # degree-1 rows (parity-only checks) have no "other edges": the
        # min over the empty set is inf — such checks carry no info
        new = jnp.where(jnp.isfinite(new), new, 0.0)
        return jnp.where(mask, new, 0.0)

    msg = lax.fori_loop(0, iters, iteration, msg)
    belief = llr + var_sums(msg)
    hard = (belief < 0).astype(jnp.int32)
    # parity check: every row XOR == 0
    row_bits = jnp.where(mask, hard[..., edge_col], 0)
    ok = jnp.all(jnp.sum(row_bits, axis=-1) % 2 == 0, axis=-1)
    return hard[..., :k], ok
