"""Symbol-mapping & composed-modem fills.

Re-designs of symbol_mapping.rs, symbol_demapper.rs, symbol_slicer.rs,
chunks_to_symbols.rs, constellation_encoder.rs,
constellation_receiver.rs, map_bb.rs, oqpsk_modulator.rs,
qam_modem_transceiver.rs, ssb_modem.rs, am_demod.rs, fm_receiver.rs,
fm_stereo_decoder.rs, rds_decoder.rs, soft_decision_decoder.rs,
log_likelihood_ratio.rs, pilot_inserter.rs, ofdm_carrier_allocator.rs,
ofdm_resource_mapper.rs, subcarrier_allocator.rs,
multicarrier_allocation.rs, crest_factor_reduction.rs,
peak_to_average.rs, incoherent_detector.rs, regenerate_bb.rs,
vector_quantizer.rs.

Constellation tables come from waveforms.linear_mod (the single source
of truth also used by the PSK/QAM waveforms); mapping/demapping is one
gather / one argmin over the table — vmap-batchable.
"""

from __future__ import annotations

import jax
import jax.lax as lax
import jax.numpy as jnp
import numpy as np

from r4w_tpu.core.hostio import cis
from r4w_tpu.core.types import IQ_DTYPE, REAL_DTYPE
from r4w_tpu.ops import filters as _filters
from r4w_tpu.ops import filters2 as _filters2
from r4w_tpu.ops import modem as _modem
from r4w_tpu.waveforms import linear_mod as _lm

# ----------------------------------------------------- symbol mapping


def constellation_table(name: str):
    """Shared constellation lookup (constellation_encoder.rs):
    'bpsk'/'qpsk'/'8psk'/'qam16'/'qam64'/'qam256'."""
    name = name.lower()
    if name in ("bpsk", "qpsk", "8psk"):
        order = {"bpsk": 2, "qpsk": 4, "8psk": 8}[name]
        return jnp.asarray(_lm.psk_constellation(order), IQ_DTYPE)
    if name.startswith("qam"):
        m = int(name[3:])
        return jnp.asarray(_lm.qam_constellation(m), IQ_DTYPE)
    raise ValueError(f"unknown constellation '{name}'")


def symbol_map(indices, constellation):
    """Index → point gather (symbol_mapping.rs / chunks_to_symbols.rs)."""
    table = jnp.asarray(constellation, IQ_DTYPE)
    return table[jnp.asarray(indices, jnp.int32)]


def symbol_demap(x, constellation):
    """Nearest-point hard demapping (symbol_demapper.rs): one argmin
    over the squared distance matrix — a batched reduction."""
    x = jnp.asarray(x, IQ_DTYPE)
    table = jnp.asarray(constellation, IQ_DTYPE)
    d = jnp.abs(x[..., None] - table[None, :]) ** 2
    return jnp.argmin(d, axis=-1).astype(jnp.int32)


def symbol_slicer(x, kind: str = "qpsk"):
    """Quadrant/axis hard slicer (symbol_slicer.rs) — decision without
    a table for the common constellations."""
    x = jnp.asarray(x, IQ_DTYPE)
    if kind == "bpsk":
        return (x.real < 0).astype(jnp.int32)
    if kind == "qpsk":
        return ((x.real < 0).astype(jnp.int32) * 2
                + (x.imag < 0).astype(jnp.int32))
    raise ValueError(f"unknown slicer kind '{kind}'")


def chunks_to_symbols(bits, constellation, bits_per_symbol: int):
    """Bit groups → constellation points (chunks_to_symbols.rs)."""
    b = jnp.asarray(bits, jnp.int32)
    n = (b.shape[0] // bits_per_symbol) * bits_per_symbol
    groups = b[:n].reshape(-1, bits_per_symbol)
    weights = 1 << jnp.arange(bits_per_symbol - 1, -1, -1)
    idx = jnp.sum(groups * weights[None, :], axis=-1)
    return symbol_map(idx, constellation)


def map_bb(x, table):
    """Byte → byte lookup mapping (map_bb.rs)."""
    t = jnp.asarray(table, jnp.int32)
    return t[jnp.asarray(x, jnp.int32)]


def constellation_receiver(x, constellation):
    """Hard decisions + quality metrics (constellation_receiver.rs):
    returns (indices, evm_rms, min_distance_margin)."""
    table = jnp.asarray(constellation, IQ_DTYPE)
    x = jnp.asarray(x, IQ_DTYPE)
    d = jnp.abs(x[..., None] - table[None, :])
    idx = jnp.argmin(d, axis=-1)
    nearest = table[idx]
    err = x - nearest
    evm = jnp.sqrt(jnp.mean(jnp.abs(err) ** 2)
                   / jnp.mean(jnp.abs(table) ** 2))
    d_sorted = jnp.sort(d, axis=-1)
    margin = jnp.mean(d_sorted[..., 1] - d_sorted[..., 0])
    return idx.astype(jnp.int32), evm, margin


def soft_decision_decode(llrs):
    """LLR → (hard bits, confidence) (soft_decision_decoder.rs /
    log_likelihood_ratio.rs consumer). Positive LLR convention = bit 0."""
    llr = jnp.asarray(llrs, REAL_DTYPE)
    bits = (llr < 0).astype(jnp.int32)
    conf = jnp.tanh(jnp.abs(llr) / 2.0)
    return bits, conf


def vector_quantize(x, codebook):
    """Nearest-codeword VQ encode/decode (vector_quantizer.rs).
    x: (N, D), codebook: (K, D). Returns (indices, reconstruction)."""
    x = jnp.asarray(x, REAL_DTYPE)
    cb = jnp.asarray(codebook, REAL_DTYPE)
    d = jnp.sum((x[:, None, :] - cb[None, :, :]) ** 2, axis=-1)
    idx = jnp.argmin(d, axis=-1)
    return idx.astype(jnp.int32), cb[idx]


# ------------------------------------------------------ OQPSK & modems


def oqpsk_modulate(bits, sps: int = 4):
    """Offset-QPSK (oqpsk_modulator.rs): Q delayed by half a symbol —
    constant-envelope transitions (no zero crossings)."""
    b = jnp.asarray(bits, jnp.int32)
    n = (b.shape[0] // 2) * 2
    i_bits = 2.0 * b[0:n:2].astype(REAL_DTYPE) - 1.0
    q_bits = 2.0 * b[1:n:2].astype(REAL_DTYPE) - 1.0
    i_up = jnp.repeat(i_bits, sps)
    q_up = jnp.repeat(q_bits, sps)
    half = sps // 2
    q_del = jnp.concatenate([jnp.zeros((half,), REAL_DTYPE), q_up])
    i_pad = jnp.concatenate([i_up, jnp.zeros((half,), REAL_DTYPE)])
    return (lax.complex(i_pad, q_del) / np.sqrt(2)).astype(IQ_DTYPE)


def oqpsk_demodulate(x, sps: int = 4):
    """Sample I at symbol centers and Q a half-symbol later."""
    x = jnp.asarray(x, IQ_DTYPE)
    half = sps // 2
    n_sym = (x.shape[0] - half) // sps
    i_idx = jnp.arange(n_sym) * sps + sps // 2
    q_idx = i_idx + half
    i_bits = (x.real[i_idx] > 0).astype(jnp.int32)
    q_bits = (x.imag[q_idx] > 0).astype(jnp.int32)
    return jnp.stack([i_bits, q_bits], axis=-1).reshape(-1)


def qam_transceiver(bits, m: int, snr_db: float | None = None,
                    key=None):
    """Composed QAM TX→(AWGN)→RX convenience (qam_modem_transceiver.rs).
    Returns (tx_symbols, rx_bits)."""
    k = int(np.log2(m))
    table = constellation_table(f"qam{m}")
    tx = chunks_to_symbols(bits, table, k)
    rx = tx
    if snr_db is not None and key is not None:
        from r4w_tpu.channel import awgn
        rx = awgn(key, tx, snr_db)
    idx = symbol_demap(rx, table)
    shifts = jnp.arange(k - 1, -1, -1)
    rx_bits = ((idx[:, None] >> shifts[None, :]) & 1).reshape(-1)
    return tx, rx_bits


# --------------------------------------------------------- analog demod


def am_demod(x, coherent: bool = False, carrier_removal: float = 0.999):
    """AM demodulation (am_demod.rs): envelope (noncoherent) or
    real-part (coherent), with DC block for the carrier bias."""
    x = jnp.asarray(x, IQ_DTYPE)
    audio = x.real if coherent else jnp.abs(x)
    y, _ = _filters.dc_blocker(audio.astype(REAL_DTYPE),
                               alpha=carrier_removal)
    return y


def ssb_modulate(audio, sample_rate: float, upper: bool = True,
                 n_taps: int = 129):
    """SSB via the Hilbert (phasing) method (ssb_modem.rs):
    analytic = audio + j·H{audio}; USB keeps positive freqs, LSB the
    conjugate."""
    a = jnp.asarray(audio, REAL_DTYPE)
    h = jnp.asarray(_filters.hilbert_fir_taps(n_taps), REAL_DTYPE)
    q = _filters.fir_apply(h, a)
    delay = (n_taps - 1) // 2
    i = jnp.concatenate([jnp.zeros((delay,), REAL_DTYPE), a])[:a.shape[0]]
    analytic = lax.complex(i, q if upper else -q)
    return analytic.astype(IQ_DTYPE)


def ssb_demodulate(x):
    """Coherent SSB product detector: take the real part (carrier
    already at DC in the complex-baseband representation)."""
    return jnp.asarray(x, IQ_DTYPE).real.astype(REAL_DTYPE)


def fm_receiver(x, sample_rate: float, deviation_hz: float = 75_000.0,
                audio_rate: float | None = None, deemph_us: float = 75.0):
    """Broadcast-FM receive chain (fm_receiver.rs): quadrature demod →
    de-emphasis → audio decimate."""
    x = jnp.asarray(x, IQ_DTYPE)
    demod = _modem.quadrature_demod(x, gain=sample_rate
                                    / (2.0 * np.pi * deviation_hz))
    audio = _filters2.fm_deemphasis(demod, sample_rate, deemph_us)
    if audio_rate is not None:
        decim = max(1, int(round(sample_rate / audio_rate)))
        taps = _filters.design_lowpass(101, audio_rate / 2.0, sample_rate)
        audio = _filters.fir_apply(jnp.asarray(taps, REAL_DTYPE), audio)
        audio = audio[::decim]
    return audio


def _analytic_bandpass(m, f_lo: float, f_hi: float, sample_rate: float,
                       n_taps: int = 301):
    """Analytic (positive-frequency) bandpass: complex taps
    2·lp[n]·exp(jω_c(n−(N−1)/2)); group delay (N−1)/2 like the real
    prototype, so the delayed input stays phase-aligned."""
    f_c = 0.5 * (f_lo + f_hi)
    lp = np.asarray(_filters.design_lowpass(n_taps, (f_hi - f_lo) / 2.0,
                                            sample_rate), np.float64)
    nvec = np.arange(n_taps) - (n_taps - 1) / 2.0
    taps = 2.0 * lp * np.exp(2j * np.pi * f_c * nvec / sample_rate)
    taps = jnp.asarray(taps.astype(np.complex64))
    analytic = (_filters.fir_apply(taps.real, m)
                + 1j * _filters.fir_apply(taps.imag, m))
    delay = (n_taps - 1) // 2
    m_del = jnp.concatenate([jnp.zeros((delay,), REAL_DTYPE), m])[
        :m.shape[0]]
    return analytic.astype(IQ_DTYPE), m_del, delay


def fm_stereo_decode(mpx, sample_rate: float):
    """Stereo MPX decode (fm_stereo_decoder.rs): L+R baseband; the
    38 kHz carrier for the L−R DSB-SC subband is regenerated by
    squaring the ANALYTIC 19 kHz pilot (phase-exact — a squared real
    pilot lands 90° off the standard's in-phase 2nd harmonic).
    Returns (left, right, pilot_present)."""
    m = jnp.asarray(mpx, REAL_DTYPE)
    p_hat, m_del, _ = _analytic_bandpass(m, 18_500.0, 19_500.0,
                                         sample_rate)
    pilot_power = jnp.mean(jnp.abs(p_hat) ** 2)
    present = pilot_power > 2e-6
    # pilot = sin(θ) → analytic = -j·A·e^{jθ}; squared = -A²e^{j2θ};
    # the standard's in-phase subcarrier sin(2θ) = -Im(p̂²)/A².
    sq = p_hat * p_hat
    carrier38 = -sq.imag / jnp.maximum(jnp.abs(sq), 1e-12)
    lp = jnp.asarray(_filters.design_lowpass(201, 15_000.0, sample_rate),
                     REAL_DTYPE)
    sum_ch = _filters.fir_apply(lp, m_del)
    diff_raw = _filters.fir_apply(lp, 2.0 * m_del * carrier38)
    left = (sum_ch + diff_raw) / 2.0
    right = (sum_ch - diff_raw) / 2.0
    return left, right, present


def rds_subcarrier_demod(mpx, sample_rate: float):
    """Recover the 57 kHz RDS BPSK subcarrier and return the 1187.5 bps
    differential-decoded bit stream (rds_decoder.rs physical layer).

    Carrier: cube of the ANALYTIC 19 kHz pilot (3×19k = 57 kHz, phase
    locked); both quadratures are formed and the stronger one is used;
    the residual BPSK polarity ambiguity cancels in the differential
    decode. Symbol timing from the known 1187.5 Hz rate."""
    m = jnp.asarray(mpx, REAL_DTYPE)
    n = m.shape[0]
    p_hat, m_del, bp_delay = _analytic_bandpass(m, 18_700.0, 19_300.0,
                                                sample_rate)
    c3 = p_hat ** 3
    c3 = c3 / jnp.maximum(jnp.abs(c3), 1e-12)     # unit e^{j(3θ+φ0)}
    z = m_del * jnp.conj(c3)
    n_lp = 301
    lp = jnp.asarray(_filters.design_lowpass(n_lp, 2_400.0, sample_rate),
                     REAL_DTYPE)
    zi = _filters.fir_apply(lp, z.real)
    zq = _filters.fir_apply(lp, z.imag)
    use_q = jnp.mean(zq ** 2) > jnp.mean(zi ** 2)
    soft = jnp.where(use_q, zq, zi)
    # total group delay of the soft stream vs the input MPX
    total_delay = bp_delay + (n_lp - 1) // 2
    sps = sample_rate / 1187.5
    n_sym = int((n - total_delay) / sps) - 2
    idx = (jnp.arange(n_sym, dtype=REAL_DTYPE) * sps).astype(jnp.int32) \
        + int(sps / 2) + total_delay
    bits = (soft[idx] > 0).astype(jnp.int32)
    # differential decode (RDS is differentially encoded); global
    # polarity flips cancel here
    out = jnp.concatenate([bits[:1], bits[1:] ^ bits[:-1]])
    return out, soft


# ----------------------------------------------------- OFDM allocation


def ofdm_carrier_allocate(data_syms, n_fft: int, occupied, pilots,
                          pilot_value: complex = 1.0 + 0.0j):
    """Place data + pilots onto an OFDM symbol grid
    (ofdm_carrier_allocator.rs / ofdm_resource_mapper.rs /
    subcarrier_allocator.rs). occupied/pilots are carrier index lists
    (negative = below DC). Returns (n_syms, n_fft) grids."""
    occ = np.asarray(occupied, np.int64) % n_fft
    pil = np.asarray(pilots, np.int64) % n_fft
    data = jnp.asarray(data_syms, IQ_DTYPE)
    per = len(occ)
    n_syms = -(-data.shape[0] // per)
    padded = jnp.concatenate([
        data, jnp.zeros((n_syms * per - data.shape[0],), IQ_DTYPE)])
    grid = jnp.zeros((n_syms, n_fft), IQ_DTYPE)
    grid = grid.at[:, jnp.asarray(occ)].set(padded.reshape(n_syms, per))
    grid = grid.at[:, jnp.asarray(pil)].set(pilot_value)
    return grid


def ofdm_carrier_deallocate(grid, occupied):
    occ = np.asarray(occupied, np.int64) % grid.shape[-1]
    return jnp.asarray(grid)[..., jnp.asarray(occ)].reshape(-1)


def multicarrier_waterfill(channel_gains, total_power: float,
                           noise_power: float = 1.0):
    """Water-filling power allocation across subcarriers
    (multicarrier_allocation.rs): bisection on the water level —
    jit-friendly fixed iteration count."""
    g = jnp.asarray(channel_gains, REAL_DTYPE)
    inv = noise_power / jnp.maximum(g, 1e-12)
    lo = jnp.asarray(0.0, REAL_DTYPE)
    hi = jnp.max(inv) + total_power
    for _ in range(50):
        mid = 0.5 * (lo + hi)
        used = jnp.sum(jnp.maximum(mid - inv, 0.0))
        hi = jnp.where(used > total_power, mid, hi)
        lo = jnp.where(used > total_power, lo, mid)
    level = 0.5 * (lo + hi)
    return jnp.maximum(level - inv, 0.0)


def pilot_insert(symbols, pilot, period: int):
    """Insert a pilot symbol every ``period`` data symbols
    (pilot_inserter.rs)."""
    s = jnp.asarray(symbols, IQ_DTYPE)
    n = (s.shape[0] // period) * period
    blocks = s[:n].reshape(-1, period)
    p = jnp.full((blocks.shape[0], 1), pilot, IQ_DTYPE)
    out = jnp.concatenate([p, blocks], axis=1).reshape(-1)
    return jnp.concatenate([out, s[n:]])


# ------------------------------------------------------------- PAPR/CFR


def peak_to_average(x) -> jax.Array:
    """PAPR in dB (peak_to_average.rs → modem.papr_db)."""
    return _modem.papr_db(x)


def crest_factor_reduce(x, clip_ratio_db: float = 3.0,
                        iterations: int = 3):
    """Iterative clip-and-filter CFR (crest_factor_reduction.rs →
    modem.papr_reduce_clip_filter)."""
    return _modem.papr_reduce_clip_filter(x, clip_ratio_db,
                                          iterations=iterations)


# ---------------------------------------------------------- detectors


def incoherent_detect(x, freqs_hz, sample_rate: float, sym_len: int):
    """Noncoherent M-FSK detection (incoherent_detector.rs): per-symbol
    energy at each candidate tone via one (sym, tone) matmul —
    the Goertzel bank as a matrix product."""
    x = jnp.asarray(x, IQ_DTYPE)
    n_sym = x.shape[0] // sym_len
    frames = x[:n_sym * sym_len].reshape(n_sym, sym_len)
    t = jnp.arange(sym_len, dtype=REAL_DTYPE) / sample_rate
    f = jnp.asarray(freqs_hz, REAL_DTYPE)
    basis = cis(-2.0 * np.pi * f[:, None] * t[None, :])    # (M, L)
    energy = jnp.abs(frames @ basis.T) ** 2                 # (n_sym, M)
    return jnp.argmax(energy, axis=-1).astype(jnp.int32), energy


def regenerate_bb(trigger, period: int, width: int, n: int):
    """Regenerate clean pulses from (possibly jittered) trigger events
    (regenerate_bb.rs): each trigger starts a clean width-``width``
    pulse; retriggers within ``period`` are ignored."""
    from r4w_tpu.ops.events import refractory_trigger

    trig = jnp.asarray(trigger).astype(bool)
    # refractory acceptance on device, then paint width-long pulses by
    # comparing each sample to the most recent accepted trigger index
    # (a cummax — no per-trigger Python loop)
    acc = refractory_trigger(trig, period)
    t_idx = jnp.arange(trig.shape[0])
    last = jax.lax.cummax(jnp.where(acc, t_idx, -period - width))
    out = ((t_idx - last) < width).astype(jnp.int32)
    if n <= trig.shape[0]:
        return out[:n]
    return jnp.concatenate(
        [out, jnp.zeros(n - trig.shape[0], jnp.int32)])


BLOCKS = {
    "constellation_encoder": ("constellation_table", "modulator",
                              "shared constellation tables "
                              "(constellation_encoder.rs)", ("name",)),
    "symbol_mapping": ("symbol_map", "modulator",
                       "index->point gather (symbol_mapping.rs)"),
    "symbol_demapper": ("symbol_demap", "demodulator",
                        "nearest-point demap (symbol_demapper.rs)"),
    "symbol_slicer": ("symbol_slicer", "demodulator",
                      "axis slicer (symbol_slicer.rs)", ("kind",)),
    "chunks_to_symbols": ("chunks_to_symbols", "modulator",
                          "bit groups -> points (chunks_to_symbols.rs)",
                          ("bits_per_symbol",)),
    "map_bb": ("map_bb", "math", "byte LUT mapping (map_bb.rs)"),
    "constellation_receiver": ("constellation_receiver", "demodulator",
                               "decisions + EVM + margin "
                               "(constellation_receiver.rs)"),
    "soft_decision_decoder": ("soft_decision_decode", "fec",
                              "LLR -> bits+confidence "
                              "(soft_decision_decoder.rs)"),
    "log_likelihood_ratio": ("soft_decision_decode", "fec",
                             "LLR consumer (log_likelihood_ratio.rs; "
                             "producer = modem.soft_demap_llr)"),
    "vector_quantizer": ("vector_quantize", "math",
                         "nearest-codeword VQ (vector_quantizer.rs)"),
    "oqpsk_modulator": ("oqpsk_modulate", "modulator",
                        "offset-QPSK (oqpsk_modulator.rs)", ("sps",)),
    "qam_modem_transceiver": ("qam_transceiver", "modulator",
                              "composed QAM TX/RX "
                              "(qam_modem_transceiver.rs)", ("m",)),
    "am_demod": ("am_demod", "demodulator",
                 "envelope/coherent AM (am_demod.rs)", ("coherent",)),
    "ssb_modem": ("ssb_modulate", "modulator",
                  "Hilbert-method SSB (ssb_modem.rs)", ("upper",)),
    "fm_receiver": ("fm_receiver", "demodulator",
                    "quad demod + deemph + decimate (fm_receiver.rs)",
                    ("sample_rate", "deviation_hz")),
    "fm_stereo_decoder": ("fm_stereo_decode", "demodulator",
                          "19k pilot MPX stereo (fm_stereo_decoder.rs)",
                          ("sample_rate",)),
    "rds_decoder": ("rds_subcarrier_demod", "demodulator",
                    "57 kHz RDS BPSK subcarrier (rds_decoder.rs)",
                    ("sample_rate",)),
    "ofdm_carrier_allocator": ("ofdm_carrier_allocate", "modulator",
                               "data+pilot grid placement "
                               "(ofdm_carrier_allocator.rs)",
                               ("n_fft", "occupied", "pilots")),
    "ofdm_resource_mapper": ("ofdm_carrier_deallocate", "demodulator",
                             "grid -> data extraction "
                             "(ofdm_resource_mapper.rs)", ("occupied",)),
    "subcarrier_allocator": ("multicarrier_waterfill", "math",
                             "water-filling power allocation "
                             "(subcarrier_allocator.rs / "
                             "multicarrier_allocation.rs)",
                             ("total_power",)),
    "pilot_inserter": ("pilot_insert", "modulator",
                       "periodic pilot insertion (pilot_inserter.rs)",
                       ("pilot", "period")),
    "peak_to_average": ("peak_to_average", "measurement",
                        "PAPR dB (peak_to_average.rs)"),
    "crest_factor_reduction": ("crest_factor_reduce", "modulator",
                               "clip-and-filter CFR "
                               "(crest_factor_reduction.rs)",
                               ("target_papr_db",)),
    "incoherent_detector": ("incoherent_detect", "demodulator",
                            "noncoherent M-FSK energy detector "
                            "(incoherent_detector.rs)",
                            ("freqs_hz", "sample_rate", "sym_len")),
    "regenerate_bb": ("regenerate_bb", "math",
                      "clean pulse regeneration (regenerate_bb.rs)",
                      ("period", "width")),
}
