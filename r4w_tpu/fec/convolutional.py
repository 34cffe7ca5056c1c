"""Convolutional coding: encoder, Viterbi decoder, puncturing.

Re-design of convolutional_encoder.rs / fec/convolutional.rs /
viterbi_decoder.rs (673 LoC) /
puncture.rs: the encoder is a windowed parity (one gather + popcount),
and the Viterbi decoder is a `lax.scan` over time whose inner
add-compare-select is fully vectorized across the 2^(K-1) states (and
any leading batch axes — decode thousands of frames per call).

Polynomials are given in octal-ish integer form over the constraint
length K, e.g. the ubiquitous K=7 (171, 133) pair: taps 0o171, 0o133.
Convention: state = previous K-1 input bits, newest bit is the MSB fed
into the register; generator bit i of output = parity(poly & [newest..
oldest]).
"""

from __future__ import annotations

import functools

import jax
import jax.lax as lax
import jax.numpy as jnp
import numpy as np

from r4w_tpu.core.types import REAL_DTYPE


def _popcount_parity(x: np.ndarray) -> np.ndarray:
    return np.vectorize(lambda v: bin(v).count("1") & 1)(x)


@functools.lru_cache(maxsize=None)
def _trellis(constraint: int, polys: tuple[int, ...]):
    """Precompute trellis tables.

    Returns (outputs[S, 2, R] bit outputs, next_state[S, 2]) where S =
    2^(K-1) states and input bit b in {0, 1}.
    """
    k = constraint
    s = 1 << (k - 1)
    r = len(polys)
    outputs = np.zeros((s, 2, r), np.int8)
    next_state = np.zeros((s, 2), np.int32)
    for st in range(s):
        for b in (0, 1):
            reg = (b << (k - 1)) | st  # newest bit on top of state bits
            for gi, p in enumerate(polys):
                outputs[st, b, gi] = bin(reg & p).count("1") & 1
            next_state[st, b] = reg >> 1
    return outputs, next_state


def conv_encode(bits, constraint: int = 7,
                polys: tuple[int, ...] = (0o171, 0o133),
                terminate: bool = True) -> jax.Array:
    """Encode bits -> coded bits, rate 1/len(polys).

    With terminate=True, K-1 zero flush bits are appended so the decoder
    ends in state 0 (standard practice; convolutional_encoder.rs).
    """
    bits = jnp.asarray(bits, jnp.int32)
    if terminate:
        pad = [(0, 0)] * (bits.ndim - 1) + [(0, constraint - 1)]
        bits = jnp.pad(bits, pad)
    k = constraint
    n = bits.shape[-1]
    # register window: [newest ... oldest], length K
    padded = jnp.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(k - 1, 0)])
    idx = jnp.arange(n)[:, None] + (k - 1 - jnp.arange(k))[None, :]
    windows = padded[..., idx]  # (..., N, K) newest-first
    poly_bits = np.array(
        [[(p >> (k - 1 - i)) & 1 for i in range(k)] for p in polys], np.int32
    )  # (R, K) matching newest-first order
    par = jnp.einsum("...nk,rk->...nr", windows, jnp.asarray(poly_bits)) % 2
    return par.reshape(*par.shape[:-2], -1)


def _code_table(constraint: int, polys: tuple[int, ...]) -> np.ndarray:
    """(S, 2) int32 codeword index per (state, input bit); generator i
    sits at bit i of the index."""
    outputs_np, _ = _trellis(constraint, tuple(polys))
    weights = 1 << np.arange(outputs_np.shape[-1])
    return (outputs_np.astype(np.int32) * weights[None, None, :]).sum(-1)


def _expected_codes(r: int) -> jax.Array:
    """(C, R) ±1 sequence of every codeword (+1 ~ bit 0)."""
    code_bits = (np.arange(1 << r)[:, None] >> np.arange(r)[None, :]) & 1
    return jnp.asarray((1.0 - 2.0 * code_bits).astype(np.float32))


def _branch_metrics(rx: jax.Array) -> jax.Array:
    """Per-codeword correlation metrics (..., T, R) -> (..., T, C).

    The products are by ±1 and so exact; HIGHEST keeps the sum in
    float32 where the GPU would otherwise run this contraction in TF32.
    """
    return jnp.einsum("...tr,cr->...tc", rx, _expected_codes(rx.shape[-1]),
                      precision=lax.Precision.HIGHEST)


def _soft_steps(received, r: int, soft: bool) -> jax.Array:
    """Received coded bits -> (..., T, R) float32 with +1 ~ bit 0."""
    rx = jnp.asarray(received, REAL_DTYPE)
    n_steps = rx.shape[-1] // r
    rx = rx[..., : n_steps * r].reshape(*rx.shape[:-1], n_steps, r)
    return rx if soft else 1.0 - 2.0 * rx


def viterbi_decode_scan(received, constraint: int = 7,
                        polys: tuple[int, ...] = (0o171, 0o133),
                        terminated: bool = True,
                        soft: bool = False,
                        unroll: int = 4) -> jax.Array:
    """Viterbi decode as a plain `lax.scan` (viterbi_decoder.rs
    re-design); the reference for the CUDA decoder.

    received: hard bits (..., N*R) int, or soft values in [-1,1] per
    coded bit with soft=True (value = 1-2·bit, so +1 means bit 0).
    Returns decoded bits (..., N_info) (flush bits removed when
    terminated=True).

    - branch metrics are computed per distinct CODEWORD (2^R values per
      step, e.g. 4 for rate 1/2) and gathered onto the trellis;
    - the add-compare-select exploits the shift-register butterfly: with
      state = previous K-1 bits (newest at MSB), target s' = b·S/2 + m
      has exactly predecessors {2m, 2m+1}, so ACS is a reshape + max;
    - traceback decisions are bit-packed 8 per int32 word inside the
      scan.
    """
    s = 1 << (constraint - 1)
    half = s // 2
    k = constraint
    code_of = jnp.asarray(_code_table(constraint, polys).T)  # (2, S)

    rx = _soft_steps(received, len(polys), soft)
    n_steps = rx.shape[-2]
    bm = _branch_metrics(rx)                         # (..., T, C)

    init = jnp.full(rx.shape[:-2] + (s,), -1e9, REAL_DTYPE)
    init = init.at[..., 0].set(0.0)

    # decision packing: w decisions per int32 word (8 keeps values tiny
    # and the unpack shift cheap; fall back to s for small trellises)
    w = min(8, s)
    groups = s // w
    pack_w = jnp.asarray(1 << np.arange(w), jnp.int32)

    def step(metrics, bm_t):
        # (..., C) -> (..., 2, S): branch metric for (input bit, prev st)
        bm_sb = bm_t[..., code_of]
        cand = metrics[..., None, :] + bm_sb          # (..., 2, S)
        c = cand.reshape(*cand.shape[:-1], half, 2)   # split st -> (m, j)
        new_metrics = jnp.max(c, axis=-1)             # (..., 2, half)
        dec = jnp.argmax(c, axis=-1).astype(jnp.int32)
        new_metrics = new_metrics.reshape(*new_metrics.shape[:-2], s)
        dec = dec.reshape(*dec.shape[:-2], s)         # indexed by target s'
        packed = (dec.reshape(*dec.shape[:-1], groups, w) * pack_w).sum(-1)
        return new_metrics, packed

    bm_moved = jnp.moveaxis(bm, -2, 0)  # (T, ..., C)
    final_metrics, decisions = lax.scan(step, init, bm_moved, unroll=unroll)

    # traceback
    start_state = (
        jnp.zeros(final_metrics.shape[:-1], jnp.int32)
        if terminated
        else jnp.argmax(final_metrics, axis=-1).astype(jnp.int32)
    )

    def back(state, packed_t):
        word = jnp.take_along_axis(packed_t, (state // w)[..., None],
                                   axis=-1)[..., 0]
        j = (word >> (state % w)) & 1
        bit = state >> (k - 2)          # input bit b encoded in the MSB
        prev = 2 * (state & (half - 1)) + j
        return prev, bit

    _, bits_rev = lax.scan(back, start_state, decisions, reverse=True,
                           unroll=unroll)
    bits = jnp.moveaxis(bits_rev, 0, -1)
    if terminated:
        bits = bits[..., : n_steps - (constraint - 1)]
    return bits.astype(jnp.int32)


def viterbi_forward_ref(rx: jax.Array, code_of: np.ndarray):
    """Plain-JAX forward pass with the CUDA kernel's contract
    (kernels.cuda.viterbi_forward): rx (L, T, R) -> decisions (L, T, 2)
    uint32, bit s' of the 64-bit word set iff target s' took
    predecessor 2m+1, and final metrics (L, S)."""
    code_of = np.asarray(code_of)
    s = code_of.shape[0]
    half = s // 2
    code_t = jnp.asarray(code_of.T)                   # (2, S)
    bm = jnp.moveaxis(_branch_metrics(rx), -2, 0)     # (T, L, C)
    init = jnp.full(rx.shape[:-2] + (s,), -1e9, REAL_DTYPE)
    init = init.at[..., 0].set(0.0)
    bit = np.arange(s)
    weights = [jnp.asarray(np.where(bit // 32 == w, 1 << (bit % 32), 0)
                           .astype(np.uint32)) for w in (0, 1)]

    def step(metrics, bm_t):
        cand = metrics[..., None, :] + bm_t[..., code_t]  # (L, 2, S)
        c = cand.reshape(*cand.shape[:-1], half, 2)
        new = jnp.max(c, axis=-1).reshape(*metrics.shape)
        dec = (c[..., 1] > c[..., 0]).reshape(*metrics.shape)
        dec = dec.astype(jnp.uint32)
        words = jnp.stack([jnp.sum(dec * wt, axis=-1, dtype=jnp.uint32)
                           for wt in weights], axis=-1)
        return new, words

    final, dec = lax.scan(step, init, bm)
    return jnp.moveaxis(dec, 0, -2), final


def viterbi_traceback_ref(dec: jax.Array, start: jax.Array, half: int):
    """Plain-JAX traceback with the CUDA kernel's contract: dec
    (L, T, 2) uint32, start (L,) int32 -> input bits (L, T) int32."""
    shift = int(half).bit_length() - 1

    def back(state, words):
        word = jnp.take_along_axis(words, (state >> 5)[..., None],
                                   axis=-1)[..., 0]
        j = ((word >> (state & 31).astype(jnp.uint32)) & 1).astype(
            jnp.int32)
        return 2 * (state & (half - 1)) + j, state >> shift

    _, bits = lax.scan(back, start, jnp.moveaxis(dec, -2, 0), reverse=True)
    return jnp.moveaxis(bits, 0, -1)


def viterbi_decode_packed(received, constraint: int = 7,
                          polys: tuple[int, ...] = (0o171, 0o133),
                          terminated: bool = True, soft: bool = False,
                          forward=viterbi_forward_ref,
                          traceback=viterbi_traceback_ref) -> jax.Array:
    """Viterbi decode through a packed-decision forward pass and a
    per-frame traceback (the CUDA kernels' contract; the defaults are
    their plain-JAX versions). Same contract as viterbi_decode_scan."""
    if not 3 <= constraint <= 7:
        raise ValueError("packed-decision Viterbi needs 3 <= K <= 7")
    code_of = _code_table(constraint, polys)
    half = code_of.shape[0] // 2
    rx = _soft_steps(received, len(polys), soft)
    lead, n_steps = rx.shape[:-2], rx.shape[-2]
    rx = rx.reshape((-1,) + rx.shape[-2:])            # (L, T, R)
    dec, final = forward(rx, code_of)
    start = (jnp.zeros(rx.shape[:1], jnp.int32) if terminated
             else jnp.argmax(final, axis=-1).astype(jnp.int32))
    bits = traceback(dec, start, half).reshape(lead + (n_steps,))
    if terminated:
        bits = bits[..., : n_steps - (constraint - 1)]
    return bits.astype(jnp.int32)


def viterbi_decode(received, constraint: int = 7,
                   polys: tuple[int, ...] = (0o171, 0o133),
                   terminated: bool = True,
                   soft: bool = False,
                   unroll: int = 4) -> jax.Array:
    """Viterbi decode (viterbi_decoder.rs).

    received: hard bits (..., N*R) int, or soft values in [-1,1] per
    coded bit with soft=True (+1 means bit 0). Returns decoded bits
    (..., N_info), flush bits removed when terminated=True.

    On a CUDA device, codes with 3 <= K <= 7 run the warp-per-frame
    CUDA kernels (kernels/viterbi.cu), bit-identical to the scan;
    everything else runs viterbi_decode_scan (`unroll` applies there).
    """
    if jax.default_backend() == "gpu" and 3 <= constraint <= 7:
        from r4w_tpu.kernels import cuda

        return viterbi_decode_packed(received, constraint, polys,
                                     terminated, soft,
                                     forward=cuda.viterbi_forward,
                                     traceback=cuda.viterbi_traceback)
    return viterbi_decode_scan(received, constraint, polys, terminated,
                               soft, unroll)


def puncture(coded, pattern) -> jax.Array:
    """Remove bits where pattern==0, cycling the pattern (puncture.rs)."""
    coded = jnp.asarray(coded)
    pat = np.asarray(pattern).astype(bool)
    n = coded.shape[-1]
    mask = np.resize(pat, n)
    return coded[..., jnp.asarray(np.nonzero(mask)[0])]


def depuncture(punctured, pattern, total_len: int, fill=0.0) -> jax.Array:
    """Reinsert neutral values at punctured positions (depuncture.rs)."""
    punctured = jnp.asarray(punctured, REAL_DTYPE)
    pat = np.asarray(pattern).astype(bool)
    mask = np.resize(pat, total_len)
    out = jnp.full(punctured.shape[:-1] + (total_len,), fill, REAL_DTYPE)
    return out.at[..., jnp.asarray(np.nonzero(mask)[0])].set(punctured)


def map_decode(received, constraint: int = 7,
               polys: tuple[int, ...] = (0o171, 0o133),
               terminated: bool = True):
    """Max-log-MAP (BCJR) soft-output decode (map_decoder.rs,
    viterbi_sova.rs role): returns per-info-bit LLRs with the library
    convention LLR > 0 ⇒ bit 0, plus hard decisions.

    received: soft values in ±1 per coded bit (+1 ~ bit 0), the same
    convention as viterbi_decode(soft=True). Two lax.scans (forward α,
    backward β) over the trellis — fully batched over leading axes.
    """
    outputs_np, next_np = _trellis(constraint, tuple(polys))
    s, _, r = outputs_np.shape
    expected = jnp.asarray(1.0 - 2.0 * outputs_np.astype(np.float32))
    next_state = jnp.asarray(next_np)  # (S, 2)

    rx = jnp.asarray(received, REAL_DTYPE)
    n_steps = rx.shape[-1] // r
    rx = rx[..., : n_steps * r].reshape(*rx.shape[:-1], n_steps, r)
    bm = jnp.einsum("...tr,sbr->...tsb", rx, expected,
                    precision=lax.Precision.HIGHEST)  # (..., T, S, 2)

    init_a = jnp.full(rx.shape[:-2] + (s,), -1e9, REAL_DTYPE)
    init_a = init_a.at[..., 0].set(0.0)

    def fwd(alpha, bm_t):
        # alpha'(s') = max over (s, b) with next(s,b)=s'
        cand = alpha[..., :, None] + bm_t  # (..., S, 2)
        new = jnp.full_like(alpha, -1e9)
        flat_next = next_state.reshape(-1)
        new = new.at[..., flat_next].max(
            cand.reshape(*cand.shape[:-2], -1))
        new = new - jnp.max(new, axis=-1, keepdims=True)
        return new, alpha

    bm_m = jnp.moveaxis(bm, -3, 0)
    _, alphas = jax.lax.scan(fwd, init_a, bm_m)  # alphas[t] before step t

    if terminated:
        init_b = jnp.full(rx.shape[:-2] + (s,), -1e9, REAL_DTYPE)
        init_b = init_b.at[..., 0].set(0.0)
    else:
        init_b = jnp.zeros(rx.shape[:-2] + (s,), REAL_DTYPE)

    def bwd(beta, bm_t):
        # beta'(s) = max_b bm(s,b) + beta(next(s,b))
        cand = bm_t + beta[..., next_state]  # (..., S, 2)
        new = jnp.max(cand, axis=-1)
        new = new - jnp.max(new, axis=-1, keepdims=True)
        return new, beta

    _, betas = jax.lax.scan(bwd, init_b, bm_m, reverse=True)

    def llr_t(alpha, beta_next, bm_t):
        metric = (alpha[..., :, None] + bm_t
                  + beta_next[..., next_state])  # (..., S, 2)
        m0 = jnp.max(metric[..., 0], axis=-1)
        m1 = jnp.max(metric[..., 1], axis=-1)
        return m0 - m1  # >0 => bit 0

    llr = jax.vmap(llr_t)(alphas, betas, bm_m)  # (T, ...,)
    llr = jnp.moveaxis(llr, 0, -1)
    if terminated:
        llr = llr[..., : n_steps - (constraint - 1)]
    return llr, (llr < 0).astype(jnp.int32)
