"""Modem building blocks (constellation_soft_decoder.rs,
constellation_demapper.rs, quadrature_demod.rs, frequency_modulator.rs,
phase_modulator.rs, differential.rs, diff_phasor.rs, cpm.rs,
gmsk_modulator.rs, msk_modulator.rs, sc_fdma.rs, papr_reduction.rs,
cyclic_prefix.rs, index_modulation_mapper.rs re-designs).

Everything is a pure batched function: soft demapping is one distance
matrix + per-bit masked min (max-log-MAP) that XLA runs as batched matmuls;
CPM is a cumulative phase integral; SC-FDMA is two FFTs and a mask.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from r4w_tpu.core.hostio import cis, zeros_iq
import numpy as np

from r4w_tpu.core.types import IQ_DTYPE, REAL_DTYPE, SYMBOL_DTYPE


# ----------------------------------------------------- soft demapping


def soft_demap_llr(symbols, constellation, noise_var: float = 1.0,
                   bit_map=None):
    """Max-log-MAP bit LLRs (constellation_soft_decoder.rs).

    symbols (..., S) complex; constellation (M,) complex; bit_map (M, B)
    bits of each point (defaults to the natural binary index). Returns
    LLRs (..., S, B) with the convention LLR>0 => bit 0 more likely.
    """
    sym = jnp.asarray(symbols, IQ_DTYPE)
    con = jnp.asarray(constellation, IQ_DTYPE)
    m = con.shape[0]
    b = int(np.log2(m))
    if bit_map is None:
        bit_map = ((np.arange(m)[:, None] >> np.arange(b - 1, -1, -1)) & 1)
    bm = jnp.asarray(bit_map, REAL_DTYPE)  # (M, B)
    d2 = jnp.abs(sym[..., None] - con) ** 2 / noise_var  # (..., S, M)
    big = jnp.asarray(1e30, REAL_DTYPE)
    # min distance over points whose bit b is 0 / 1
    d0 = jnp.min(d2[..., None] + big * bm, axis=-2)     # (..., S, B)
    d1 = jnp.min(d2[..., None] + big * (1.0 - bm), axis=-2)
    return d1 - d0


def hard_from_llr(llr):
    """LLR (>0 => bit 0) to hard bits."""
    return (jnp.asarray(llr) < 0).astype(SYMBOL_DTYPE)


# ------------------------------------------------------ analog demod


def quadrature_demod(x, gain: float = 1.0):
    """FM discriminator y[n] = gain * arg(x[n] conj(x[n-1]))
    (quadrature_demod.rs)."""
    x = jnp.asarray(x, IQ_DTYPE)
    prod = x[..., 1:] * jnp.conj(x[..., :-1])
    y = gain * jnp.angle(prod)
    return jnp.concatenate([jnp.zeros((*y.shape[:-1], 1), y.dtype), y],
                           axis=-1)


def frequency_modulate(msg, sensitivity: float):
    """VCO: exp(j * sensitivity * cumsum(msg)) (frequency_modulator.rs)."""
    m = jnp.asarray(msg, REAL_DTYPE)
    phase = jnp.cumsum(m, axis=-1) * sensitivity
    return cis(phase).astype(IQ_DTYPE)


def phase_modulate(msg, sensitivity: float):
    """exp(j * sensitivity * msg) (phase_modulator.rs)."""
    return cis(sensitivity * jnp.asarray(msg, REAL_DTYPE)
                   ).astype(IQ_DTYPE)


# ------------------------------------------------------- differential


def differential_encode(bits):
    """d[n] = b[n] xor d[n-1] via parity of prefix sums
    (differential.rs; vectorized, no scan)."""
    b = jnp.asarray(bits, jnp.int32)
    return jnp.cumsum(b, axis=-1) % 2


def differential_decode(bits):
    """Inverse of differential_encode."""
    d = jnp.asarray(bits, jnp.int32)
    prev = jnp.concatenate(
        [jnp.zeros((*d.shape[:-1], 1), d.dtype), d[..., :-1]], axis=-1)
    return (d ^ prev).astype(jnp.int32)


def diff_phasor(x):
    """x[n] * conj(x[n-1]) (diff_phasor.rs) — DPSK demod front end."""
    x = jnp.asarray(x, IQ_DTYPE)
    return x[..., 1:] * jnp.conj(x[..., :-1])


# --------------------------------------------------------------- CPM


def _phase_pulse(kind: str, sps: int, span: int, bt: float):
    """Integrated frequency pulse q(t), normalized to 1/2 at the end."""
    n = sps * span
    t = (np.arange(n) + 0.5) / sps  # symbol units
    if kind == "rect":  # LREC (CPFSK / MSK when span=1)
        g = np.ones(n)
    elif kind == "rc":  # raised cosine LRC
        g = 1.0 - np.cos(2 * np.pi * t / span)
    elif kind == "gaussian":  # GMSK
        from math import sqrt, log, pi

        sigma = sqrt(log(2.0)) / (2 * pi * bt)
        tt = t - span / 2.0
        erf = np.vectorize(__import__("math").erf)
        g = 0.5 * (erf((tt + 0.5) / (sigma * np.sqrt(2)))
                   - erf((tt - 0.5) / (sigma * np.sqrt(2))))
    else:
        raise ValueError(f"unknown CPM pulse {kind}")
    q = np.cumsum(g)
    return q / (2.0 * q[-1])  # q(inf) = 1/2


def cpm_modulate(symbols, sps: int, h: float = 0.5, pulse: str = "rect",
                 span: int = 1, bt: float = 0.3):
    """Continuous-phase modulation (cpm.rs): phase(t) = 2 pi h
    sum_k a_k q(t - kT). symbols in {-(M-1)..(M-1)} odd steps.
    pulse='rect' span=1 h=0.5 gives MSK (msk_modulator.rs);
    pulse='gaussian' gives GMSK (gmsk_modulator.rs)."""
    a = np.asarray(symbols, np.float64)
    q = _phase_pulse(pulse, sps, span, bt)
    n_sym = a.shape[-1]
    # frequency-pulse view: phase increments per sample
    g = np.diff(np.concatenate([[0.0], q]))  # (sps*span,)
    up = np.zeros((*a.shape[:-1], n_sym * sps))
    up[..., ::sps] = a
    incr = np.apply_along_axis(
        lambda v: np.convolve(v, g)[: n_sym * sps], -1, up)
    phase = 2 * np.pi * h * np.cumsum(incr, axis=-1)
    return cis(jnp.asarray(phase)).astype(IQ_DTYPE)


def msk_modulate(bits, sps: int):
    """MSK = CPM(rect, h=1/2) over ±1 (msk_modulator.rs)."""
    a = 2 * np.asarray(bits, np.int32) - 1
    return cpm_modulate(a, sps, h=0.5, pulse="rect", span=1)


def gmsk_modulate(bits, sps: int, bt: float = 0.3, span: int = 4):
    """GMSK (gmsk_modulator.rs): Gaussian-filtered MSK."""
    a = 2 * np.asarray(bits, np.int32) - 1
    return cpm_modulate(a, sps, h=0.5, pulse="gaussian", span=span, bt=bt)


# ------------------------------------------------------------ SC-FDMA


def sc_fdma_modulate(symbols, n_fft: int, n_sc: int, cp_len: int,
                     start: int = 0):
    """DFT-spread OFDM uplink modulator (sc_fdma.rs): per block of n_sc
    data symbols: DFT -> map to subcarriers [start, start+n_sc) ->
    IFFT -> CP. symbols (..., B, n_sc) -> (..., B*(n_fft+cp_len))."""
    s = jnp.asarray(symbols, IQ_DTYPE)
    spread = jnp.fft.fft(s, axis=-1) / np.sqrt(n_sc)
    grid = zeros_iq((*s.shape[:-1], n_fft))
    grid = grid.at[..., start:start + n_sc].set(spread)
    time = jnp.fft.ifft(grid, axis=-1) * np.sqrt(n_fft)
    with_cp = jnp.concatenate([time[..., -cp_len:], time], axis=-1)
    return with_cp.reshape(*s.shape[:-2], -1)


def sc_fdma_demodulate(samples, n_fft: int, n_sc: int, cp_len: int,
                       start: int = 0):
    """Inverse of sc_fdma_modulate -> (..., B, n_sc) symbol estimates."""
    x = jnp.asarray(samples, IQ_DTYPE)
    blk = n_fft + cp_len
    b = x.shape[-1] // blk
    x = x[..., : b * blk].reshape(*x.shape[:-1], b, blk)[..., cp_len:]
    grid = jnp.fft.fft(x, axis=-1) / np.sqrt(n_fft)
    spread = grid[..., start:start + n_sc]
    return jnp.fft.ifft(spread, axis=-1) * np.sqrt(n_sc)


# ---------------------------------------------------------------- PAPR


def papr_db(x):
    """Peak-to-average power ratio in dB (papr_reduction.rs metric)."""
    x = jnp.asarray(x, IQ_DTYPE)
    p = x.real**2 + x.imag**2
    return 10.0 * jnp.log10(jnp.max(p, axis=-1)
                            / jnp.maximum(jnp.mean(p, axis=-1), 1e-30))


def papr_reduce_clip_filter(x, clip_ratio_db: float = 3.0,
                            iterations: int = 2, nfft: int | None = None,
                            band: float = 0.5):
    """Iterative clipping-and-filtering PAPR reduction
    (papr_reduction.rs): soft-clip the envelope then lowpass in the
    frequency domain to confine clipping noise out of band."""
    x = jnp.asarray(x, IQ_DTYPE)
    n = x.shape[-1]
    nfft = nfft or n
    rms = jnp.sqrt(jnp.mean(x.real**2 + x.imag**2, axis=-1,
                            keepdims=True))
    limit = rms * 10.0 ** (clip_ratio_db / 20.0)
    f = jnp.fft.fftfreq(nfft)
    mask = (jnp.abs(f) <= band / 2.0).astype(REAL_DTYPE)
    y = x
    for _ in range(iterations):
        env = jnp.sqrt(y.real**2 + y.imag**2 + 1e-30)
        y = jnp.where(env > limit, y * (limit / env), y)
        spec = jnp.fft.fft(y, nfft, axis=-1) * mask
        y = jnp.fft.ifft(spec, axis=-1)[..., :n]
    return y.astype(IQ_DTYPE)


# -------------------------------------------------------- cyclic prefix


def add_cyclic_prefix(blocks, cp_len: int):
    """(..., B, N) -> (..., B, N+cp) (cyclic_prefix.rs)."""
    b = jnp.asarray(blocks)
    return jnp.concatenate([b[..., -cp_len:], b], axis=-1)


def remove_cyclic_prefix(blocks, cp_len: int):
    return jnp.asarray(blocks)[..., cp_len:]


# --------------------------------------------------- index modulation


def index_modulation_map(bits, n_sub: int, n_active: int, constellation):
    """OFDM-IM mapper (index_modulation_mapper.rs): per block, the first
    log2(C(n_sub, n_active)) bits pick which subcarriers are active
    (combinatorial method), remaining bits pick the symbols.
    bits (..., B, k) -> (..., B, n_sub) complex grid."""
    from math import comb, log2

    con = jnp.asarray(constellation, IQ_DTYPE)
    m = con.shape[0]
    bps = int(np.log2(m))
    idx_bits = int(np.floor(log2(comb(n_sub, n_active))))
    combos = _combinations_table(n_sub, n_active)[: 2 ** idx_bits]
    combos = jnp.asarray(combos)  # (2^idx_bits, n_active)
    b = jnp.asarray(bits, jnp.int32)
    k = idx_bits + n_active * bps
    if b.shape[-1] != k:
        raise ValueError(f"need {k} bits per block, got {b.shape[-1]}")
    w_idx = jnp.sum(
        b[..., :idx_bits]
        * (2 ** jnp.arange(idx_bits - 1, -1, -1)), axis=-1)
    active = combos[w_idx]  # (..., n_active)
    sym_bits = b[..., idx_bits:].reshape(*b.shape[:-1], n_active, bps)
    sym_idx = jnp.sum(sym_bits * (2 ** jnp.arange(bps - 1, -1, -1)),
                      axis=-1)
    oh = jax.nn.one_hot(active, n_sub, dtype=IQ_DTYPE)  # (..., A, n_sub)
    grid = jnp.einsum("...a,...as->...s", con[sym_idx], oh)
    return grid, active


def index_modulation_demap(grid, n_sub: int, n_active: int,
                           constellation):
    """ML OFDM-IM demapper: pick the legal active-set with the most
    energy, then nearest-point demap the symbols on it. Returns bits
    (..., idx_bits + n_active*log2(M))."""
    from math import comb, log2

    con = jnp.asarray(constellation, IQ_DTYPE)
    m = con.shape[0]
    bps = int(np.log2(m))
    idx_bits = int(np.floor(log2(comb(n_sub, n_active))))
    combos = jnp.asarray(_combinations_table(n_sub, n_active)
                         [: 2 ** idx_bits])  # (W, A)
    g = jnp.asarray(grid, IQ_DTYPE)
    p = g.real**2 + g.imag**2  # (..., n_sub)
    oh = jax.nn.one_hot(combos, n_sub, dtype=REAL_DTYPE).sum(-2)  # (W, S)
    energy = jnp.einsum("...s,ws->...w", p, oh)
    w_idx = jnp.argmax(energy, axis=-1)
    active = combos[w_idx]  # (..., A)
    picked = jnp.take_along_axis(
        g, active.astype(jnp.int32), axis=-1)  # (..., A)
    d2 = jnp.abs(picked[..., None] - con) ** 2
    sym_idx = jnp.argmin(d2, axis=-1)  # (..., A)
    ib = ((w_idx[..., None] >> jnp.arange(idx_bits - 1, -1, -1)) & 1)
    sb = ((sym_idx[..., None] >> jnp.arange(bps - 1, -1, -1)) & 1)
    return jnp.concatenate(
        [ib, sb.reshape(*sb.shape[:-2], -1)], axis=-1).astype(SYMBOL_DTYPE)


def _combinations_table(n: int, k: int) -> np.ndarray:
    from itertools import combinations

    return np.asarray(list(combinations(range(n), k)), np.int32)


# --------------------------------------------------------------------------
# FBMC/OQAM polyphase mapper (fbmc_polyphase_mapper.rs re-design)
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def phydyas_filter(n_subcarriers: int, overlap: int = 4) -> np.ndarray:
    """PHYDYAS prototype filter, length K·M, unit energy
    (fbmc_polyphase_mapper.rs:78)."""
    m, k = n_subcarriers, overlap
    length = k * m
    if k == 2:
        coeffs = [1.0, 1.0 / np.sqrt(2.0)]
    elif k == 3:
        coeffs = [1.0, 0.911438, 0.411438]
    elif k == 4:
        coeffs = [1.0, 0.971960, 0.707107, 0.235147]
    else:
        coeffs = [1.0] + [np.sinc(i / k) for i in range(1, k)]
    n = np.arange(length) - (length - 1) / 2.0
    h = np.full(length, coeffs[0])
    for i in range(1, len(coeffs)):
        h = h + 2.0 * coeffs[i] * np.cos(2.0 * np.pi * i * n / length)
    return (h / np.sqrt(np.sum(h * h))).astype(np.float32)


def oqam_stagger(qam):
    """QAM (..., T, M) → OQAM real half-symbols (..., 2T, M): real parts
    then imaginary parts per symbol period
    (fbmc_polyphase_mapper.rs:138)."""
    qam = jnp.asarray(qam, IQ_DTYPE)
    re, im = qam.real, qam.imag
    return jnp.stack([re, im], axis=-2).reshape(
        *qam.shape[:-2], 2 * qam.shape[-2], qam.shape[-1])


def oqam_destagger(oqam):
    """Inverse of oqam_stagger: (..., 2T, M) → (..., T, M) complex."""
    x = jnp.asarray(oqam, REAL_DTYPE)
    t2, m = x.shape[-2], x.shape[-1]
    pairs = x.reshape(*x.shape[:-2], t2 // 2, 2, m)
    return (pairs[..., 0, :] + 1j * pairs[..., 1, :]).astype(IQ_DTYPE)


def _fbmc_theta(t_half: int, m: int) -> np.ndarray:
    """OQAM phase map θ[t, n] = j^(n+t) keeping adjacent REs in
    quadrature."""
    n = np.arange(m)
    t = np.arange(t_half)[:, None]
    return np.power(1j, (n[None, :] + t) % 4).astype(np.complex64)


def fbmc_modulate(oqam, overlap: int = 4):
    """FBMC/OQAM synthesis: per half-symbol IFFT × PHYDYAS prototype,
    overlap-added at M/2 spacing (fbmc_polyphase_mapper.rs:330
    FbmcModulator::modulate).

    oqam: (T2, M) real half-symbols. Returns ((T2-1)·M/2 + K·M,) IQ.
    """
    oqam = jnp.asarray(oqam, REAL_DTYPE)
    t2, m = oqam.shape
    k = overlap
    proto = jnp.asarray(phydyas_filter(m, k))
    theta = jnp.asarray(_fbmc_theta(t2, m))
    freq = oqam.astype(IQ_DTYPE) * theta  # (T2, M)
    base = jnp.fft.ifft(freq, axis=-1) * m  # (T2, M)
    ext = jnp.tile(base, (1, k)) * proto[None, :]  # (T2, K·M)
    out_len = (t2 - 1) * (m // 2) + k * m
    # overlap-add via scatter
    idx = (jnp.arange(t2)[:, None] * (m // 2)
           + jnp.arange(k * m)[None, :]).reshape(-1)
    out = jnp.zeros(out_len, IQ_DTYPE).at[idx].add(ext.reshape(-1))
    return out


def fbmc_demodulate(x, n_subcarriers: int, n_half_symbols: int,
                    overlap: int = 4):
    """FBMC/OQAM analysis: matched prototype filtering + FFT + phase
    derotation, real part (FbmcDemodulator::demodulate). Perfect-
    reconstruction up to the PHYDYAS intrinsic interference on the
    imaginary axis, which OQAM discards."""
    x = jnp.asarray(x, IQ_DTYPE)
    m, k, t2 = n_subcarriers, overlap, n_half_symbols
    proto = jnp.asarray(phydyas_filter(m, k))
    idx = (jnp.arange(t2)[:, None] * (m // 2)
           + jnp.arange(k * m)[None, :])
    segs = x[jnp.minimum(idx, x.shape[-1] - 1)] * proto[None, :]  # (T2, KM)
    folded = segs.reshape(t2, k, m).sum(axis=1)  # alias-fold to M
    freq = jnp.fft.fft(folded, axis=-1) / m
    theta = jnp.asarray(_fbmc_theta(t2, m))
    return (freq * jnp.conj(theta)).real


def fbmc_spectral_efficiency(n_subcarriers: int, overlap: int) -> float:
    """OQAM carries one real symbol per subcarrier per half period — same
    asymptotic efficiency as CP-free OFDM (fbmc_polyphase_mapper.rs:194)."""
    del n_subcarriers, overlap
    return 1.0


# --------------------------------------------------------------------------
# 5G NR resource grid mapper (nr_resource_grid_mapper.rs re-design)
# --------------------------------------------------------------------------

NR_RE_GUARD, NR_RE_DATA, NR_RE_DMRS, NR_RE_PTRS = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class NrGridConfig:
    """5G NR slot grid (nr_resource_grid_mapper.rs:119 NrConfig +
    SlotConfig). numerology μ∈0..4 → SCS 15·2^μ kHz; normal CP = 14
    symbols/slot, extended (μ=2 only) = 12."""

    numerology: int = 0
    num_prbs: int = 6
    num_symbols: int = 14
    slot_number: int = 0
    frame_number: int = 0
    dmrs_symbols: tuple[int, ...] = (2, 3)  # Type A, additional pos 1
    ptrs_density: int = 0  # 0 = off; else every Nth subcarrier

    @property
    def num_subcarriers(self) -> int:
        return 12 * self.num_prbs

    @property
    def subcarrier_spacing_khz(self) -> float:
        return 15.0 * (2 ** self.numerology)

    @property
    def slot_duration_ms(self) -> float:
        return 1.0 / (2 ** self.numerology)


@functools.lru_cache(maxsize=None)
def nr_re_types(cfg: NrGridConfig) -> np.ndarray:
    """(num_symbols, num_subcarriers) int8 resource-type map: DMRS comb-2
    on the configured symbols, optional PTRS columns, DATA elsewhere."""
    grid = np.full((cfg.num_symbols, cfg.num_subcarriers), NR_RE_DATA,
                   np.int8)
    for sym in cfg.dmrs_symbols:
        if sym < cfg.num_symbols:
            grid[sym, 0::2] = NR_RE_DMRS
            grid[sym, 1::2] = NR_RE_GUARD  # comb-2 companion REs unused
    if cfg.ptrs_density > 0:
        for sym in range(cfg.num_symbols):
            if sym in cfg.dmrs_symbols:
                continue
            grid[sym, 0::cfg.ptrs_density] = NR_RE_PTRS
    return grid


@functools.lru_cache(maxsize=None)
def nr_dmrs_values(cfg: NrGridConfig) -> np.ndarray:
    """Deterministic QPSK DMRS sequence seeded by slot/frame
    (nr_resource_grid_mapper.rs:255 dmrs_sequence_value)."""
    types = nr_re_types(cfg)
    vals = np.zeros(types.shape, np.complex64)
    sym_idx, sc_idx = np.nonzero(types == NR_RE_DMRS)
    seed = ((cfg.frame_number * 131 + cfg.slot_number) * 97
            + sc_idx) * 53 + sym_idx
    phase = (seed % 4) * np.pi / 2.0 + np.pi / 4.0
    vals[sym_idx, sc_idx] = (np.cos(phase) + 1j * np.sin(phase)) / np.sqrt(2)
    return vals


def nr_data_capacity(cfg: NrGridConfig) -> int:
    return int((nr_re_types(cfg) == NR_RE_DATA).sum())


def nr_map(data_symbols, cfg: NrGridConfig = NrGridConfig()):
    """Map data symbols onto the slot grid around DMRS/PTRS
    (insert_dmrs + map_pdsch_data roles). data_symbols: (..., D) with
    D = nr_data_capacity(cfg); zero-pad shorter bursts. Returns
    (..., num_symbols, num_subcarriers) complex grid."""
    types = nr_re_types(cfg)
    data_pos = np.nonzero(types.reshape(-1) == NR_RE_DATA)[0]
    ptrs_pos = np.nonzero(types.reshape(-1) == NR_RE_PTRS)[0]
    d = jnp.asarray(data_symbols, IQ_DTYPE)
    cap = len(data_pos)
    assert d.shape[-1] <= cap, (d.shape, cap)
    if d.shape[-1] < cap:
        pad = [(0, 0)] * (d.ndim - 1) + [(0, cap - d.shape[-1])]
        d = jnp.pad(d, pad)
    flat = jnp.zeros(d.shape[:-1] + (types.size,), IQ_DTYPE)
    flat = flat.at[..., jnp.asarray(data_pos)].set(d)
    dmrs_pos = np.nonzero(types.reshape(-1) == NR_RE_DMRS)[0]
    dmrs_vals = nr_dmrs_values(cfg).reshape(-1)[dmrs_pos]
    flat = flat.at[..., jnp.asarray(dmrs_pos)].set(jnp.asarray(dmrs_vals))
    if len(ptrs_pos):
        flat = flat.at[..., jnp.asarray(ptrs_pos)].set(
            (1.0 + 1.0j) / np.sqrt(2.0))
    return flat.reshape(d.shape[:-1] + types.shape)


def nr_demap(grid, cfg: NrGridConfig = NrGridConfig()):
    """Extract the data REs in mapping order (extract_data role)."""
    types = nr_re_types(cfg)
    data_pos = np.nonzero(types.reshape(-1) == NR_RE_DATA)[0]
    g = jnp.asarray(grid, IQ_DTYPE)
    flat = g.reshape(*g.shape[:-2], -1)
    return flat[..., jnp.asarray(data_pos)]
