"""STANAG 4285 NATO HF serial-tone modem — standard-conformant framing.

Re-design of crates/r4w-core/src/waveform/stanag4285.rs (844 LoC) at
full frame fidelity (the reference itself simplifies the receiver; this
implementation keeps the public STANAG 4285 frame structure and runs a
real soft-decision Viterbi):

* 2400 baud serial tone on an 1800 Hz audio carrier.
* 256-symbol frame = 80-symbol sync preamble + 176 symbols arranged as
  four 32-symbol data blocks separated by three 16-symbol probe blocks
  (stanag4285.rs:15-24 frame diagram).
* Preamble: 80 BPSK symbols from the degree-5 m-sequence x^5 + x^2 + 1
  (init all-ones) tiled 31→80, the public "repeated 31-bit m-sequence"
  construction.
* All 176 data/probe symbols of each frame are scrambled by adding
  (mod 8) the 3-bit output groups of the 9-bit LFSR x^9 + x^4 + 1
  seeded 0x1FF, re-initialised every frame (stanag4285.rs:361-373 uses
  the same polynomial on bits; here it rotates 8PSK symbols as in the
  standard). Probe symbols are index-0 before scrambling, so the
  on-air probe is the scrambler sequence itself — known at the
  receiver and used for channel estimation.
* FEC: K=7 rate-1/2 convolutional code, polynomials 0o171/0o133
  (stanag4285.rs:340-358), decoded with a real soft-decision Viterbi
  (fec/convolutional.py) — the reference's decoder is a placeholder.
* User rates 75..3600 bps via repetition + modulation selection:
  75/150/300/600 BPSK (×8/×4/×2/×1 repetition), 1200 QPSK, 2400 8PSK,
  3600 uncoded 8PSK. Data-symbol rate is 2400·176/256 = 1650 Bd.
* Block interleaver over whole interleave spans: short = 8 frames
  (0.853 s), long = 96 frames (10.24 s) of coded bits, written
  row-wise into a 32-column matrix and read column-wise
  (stanag4285.rs:376-397 block interleaver role).

Batch-first notes: modulation is fully vectorised (frame assembly is one
scatter into a (F, 256) symbol grid); demodulation equalises every
frame in parallel from probe anchors (batched least squares + linear
interpolation) and runs one batched soft Viterbi over the whole burst.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from r4w_tpu.core.hostio import cis, to_device
from r4w_tpu.core.types import IQ_DTYPE, REAL_DTYPE, SYMBOL_DTYPE, CommonParams
from r4w_tpu.fec.convolutional import conv_encode, viterbi_decode
from r4w_tpu.ops.spreading import lfsr_bits
from r4w_tpu.waveforms.base import (
    DemodResult,
    Waveform,
    WaveformInfo,
    data_to_bits,
    register_waveform,
)
from r4w_tpu.waveforms.linear_mod import pack_demod_bits

SYMBOL_RATE = 2400.0
CARRIER_HZ = 1800.0
FRAME_SYMS = 256
PREAMBLE_SYMS = 80
DATA_SYMS_PER_FRAME = 128  # 4 × 32
PROBE_SYMS_PER_FRAME = 48  # 3 × 16
CONV_POLYS = (0o171, 0o133)

# Mode table: user bps -> (bits/symbol, repetition, convolutional?)
MODES: dict[int, tuple[int, int, bool]] = {
    75: (1, 8, True),
    150: (1, 4, True),
    300: (1, 2, True),
    600: (1, 1, True),
    1200: (2, 1, True),
    2400: (3, 1, True),
    3600: (3, 1, False),
}

# Gray maps: bits value -> 8PSK constellation index (multiples of 8/M)
_GRAY_TO_INDEX = {
    1: np.array([0, 4], np.int32),                      # BPSK: 0, π
    2: np.array([0, 2, 6, 4], np.int32),                # QPSK Gray 00,01,10,11
    3: np.array([0, 1, 3, 2, 7, 6, 4, 5], np.int32),    # 8PSK Gray
}


@functools.lru_cache(maxsize=None)
def preamble_indices() -> np.ndarray:
    """80 preamble symbols as 8PSK indices {0,4} (BPSK on the 8PSK grid).

    Degree-5 m-sequence x^5+x^2+1 (taps mask 0b10010), init 11111,
    31 chips tiled to 80.
    """
    bits = lfsr_bits(5, 0b10010, 0x1F, length=31)
    tiled = np.tile(bits, 3)[:PREAMBLE_SYMS]
    return (tiled.astype(np.int32) * 4).astype(np.int32)


@functools.lru_cache(maxsize=None)
def frame_scrambler() -> np.ndarray:
    """176 scrambler values in 0..7 (one frame), x^9+x^4+1 from 0x1FF.

    Taps mask: feedback = s[8] ^ s[3] -> 0b100001000.
    """
    bits = lfsr_bits(9, 0b100001000, 0x1FF,
                     length=3 * (FRAME_SYMS - PREAMBLE_SYMS))
    tri = bits.astype(np.int32).reshape(-1, 3)
    return tri[:, 0] * 4 + tri[:, 1] * 2 + tri[:, 2]


@functools.lru_cache(maxsize=None)
def _frame_layout() -> tuple[np.ndarray, np.ndarray]:
    """(data_pos, probe_pos) within the 176 post-preamble frame symbols.

    Layout: 32 data, 16 probe, 32 data, 16 probe, 32 data, 16 probe,
    32 data.
    """
    pos = []
    probe = []
    cursor = 0
    for blk in range(4):
        pos.extend(range(cursor, cursor + 32))
        cursor += 32
        if blk < 3:
            probe.extend(range(cursor, cursor + 16))
            cursor += 16
    assert cursor == FRAME_SYMS - PREAMBLE_SYMS
    return np.asarray(pos, np.int32), np.asarray(probe, np.int32)


def interleaver_shape(mode_bps: int, long_interleave: bool) -> tuple[int, int]:
    """(rows, cols) of the block interleaver; rows·cols = coded bits per
    interleave span (8 or 96 frames of data symbols). cols is fixed at
    32; rows grows with the span."""
    bps = MODES[mode_bps][0]
    frames = 96 if long_interleave else 8
    span_bits = frames * DATA_SYMS_PER_FRAME * bps
    cols = 32
    return span_bits // cols, cols


@functools.lru_cache(maxsize=None)
def interleave_permutation(rows: int, cols: int) -> np.ndarray:
    """Permutation vector: out[j] = in[perm[j]] for one span (row-write,
    column-read)."""
    n = rows * cols
    idx = np.arange(n).reshape(rows, cols)
    return idx.T.reshape(-1).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class Stanag4285(Waveform):
    """STANAG 4285 HF modem with conformant 256-symbol framing."""

    common: CommonParams = CommonParams(sample_rate=9600.0)
    mode_bps: int = 2400
    long_interleave: bool = False

    name = "STANAG-4285"

    @property
    def common_params(self) -> CommonParams:
        return self.common

    def samples_per_symbol(self) -> int:
        return max(int(round(self.common.sample_rate / SYMBOL_RATE)), 1)

    @property
    def bits_per_symbol(self) -> int:
        return MODES[self.mode_bps][0]

    def info(self) -> WaveformInfo:
        return WaveformInfo(
            name=self.name,
            full_name="NATO STANAG 4285 HF modem",
            description="Serial-tone PSK on 1800 Hz, 256-symbol frames "
                        "(80 sync + 4×32 data + 3×16 probe)",
            complexity=4,
            bits_per_symbol=self.bits_per_symbol,
            characteristics=(
                "2400 Bd on 1800 Hz carrier",
                f"{self.mode_bps} bps, "
                f"{'long' if self.long_interleave else 'short'} interleave",
                "K=7 rate-1/2 convolutional FEC (0o171/0o133)",
                "Scrambled 8PSK symbol grid, known probes",
            ),
        )

    # ------------------------------------------------------------- TX

    def _coded_bits(self, bits: np.ndarray) -> jax.Array:
        _, rep, coded = MODES[self.mode_bps]
        b = jnp.asarray(bits, jnp.int32)
        if coded:
            b = conv_encode(b, 7, CONV_POLYS, terminate=True)
        if rep > 1:
            b = jnp.repeat(b, rep, axis=-1)
        return b

    def _interleave(self, coded: jax.Array) -> jax.Array:
        rows, cols = interleaver_shape(self.mode_bps, self.long_interleave)
        n = rows * cols
        pad = (-int(coded.shape[-1])) % n
        coded = jnp.pad(coded, (0, pad))
        perm = jnp.asarray(interleave_permutation(rows, cols))
        spans = coded.reshape(-1, n)
        return spans[:, perm].reshape(-1)

    def frame_symbols(self, data) -> jax.Array:
        """(F, 256) scrambled 8PSK symbol indices, preamble included."""
        bits = data_to_bits(data)
        bps = self.bits_per_symbol
        inter = self._interleave(self._coded_bits(bits))
        n_sym = inter.shape[-1] // bps
        groups = inter[: n_sym * bps].reshape(n_sym, bps)
        weights = jnp.asarray(2 ** np.arange(bps - 1, -1, -1), jnp.int32)
        vals = jnp.sum(groups * weights, axis=-1)
        dsym = jnp.asarray(_GRAY_TO_INDEX[bps])[vals]

        frames = -(-int(n_sym) // DATA_SYMS_PER_FRAME)
        pad = frames * DATA_SYMS_PER_FRAME - int(n_sym)
        dsym = jnp.pad(dsym, (0, pad)).reshape(frames, DATA_SYMS_PER_FRAME)

        data_pos, _ = _frame_layout()
        body = jnp.zeros((frames, FRAME_SYMS - PREAMBLE_SYMS), jnp.int32)
        body = body.at[:, jnp.asarray(data_pos)].set(dsym)
        body = (body + jnp.asarray(frame_scrambler())[None, :]) % 8
        pre = jnp.broadcast_to(jnp.asarray(preamble_indices())[None, :],
                               (frames, PREAMBLE_SYMS))
        return jnp.concatenate([pre, body], axis=1)

    def modulate(self, data) -> jax.Array:
        syms = self.frame_symbols(data).reshape(-1)
        pts = _psk8_points()[syms]
        sps = self.samples_per_symbol()
        base = jnp.repeat(pts, sps)
        ph = (2.0 * jnp.pi * CARRIER_HZ / self.common.sample_rate
              * jnp.arange(base.shape[-1], dtype=REAL_DTYPE))
        return (self.common.amplitude * base
                * cis(ph.astype(REAL_DTYPE))).astype(IQ_DTYPE)

    # ------------------------------------------------------------- RX

    def _symbol_stream(self, samples: jax.Array) -> jax.Array:
        sps = self.samples_per_symbol()
        n = samples.shape[-1]
        ph = (2.0 * jnp.pi * CARRIER_HZ / self.common.sample_rate
              * jnp.arange(n, dtype=REAL_DTYPE))
        base = samples * jnp.conj(cis(ph.astype(REAL_DTYPE)))
        s = n // sps
        return jnp.mean(base[: s * sps].reshape(s, sps), axis=-1)

    def _equalize_frames(self, frames_iq: jax.Array) -> jax.Array:
        """(F, 256) symbols -> (F, 128) equalized data symbols.

        Channel gain anchors: the preamble (one complex LS gain) and the
        three descrambled probe blocks; linearly interpolated over the
        frame, so slow fading/static offsets are tracked per frame.
        """
        pre_pts = _psk8_points()[jnp.asarray(preamble_indices())]
        body = frames_iq[:, PREAMBLE_SYMS:]
        descr = body * jnp.conj(_psk8_points()[jnp.asarray(frame_scrambler())])
        data_pos, probe_pos = _frame_layout()

        g_pre = jnp.mean(frames_iq[:, :PREAMBLE_SYMS] * jnp.conj(pre_pts),
                         axis=1)
        probes = descr[:, jnp.asarray(probe_pos)].reshape(-1, 3, 16)
        g_probe = jnp.mean(probes, axis=-1)  # (F, 3): probe tx symbol = 1+0j
        anchors_t = jnp.asarray(
            [PREAMBLE_SYMS / 2.0]
            + [PREAMBLE_SYMS + float(probe_pos[16 * k] + 8) for k in range(3)],
            REAL_DTYPE,
        )
        anchors_g = jnp.concatenate([g_pre[:, None], g_probe], axis=1)
        t_data = jnp.asarray(PREAMBLE_SYMS + data_pos.astype(np.float32))
        # piecewise-linear interp of complex gain (vectorised over frames)
        gains = _interp_complex(t_data, anchors_t, anchors_g)
        data = descr[:, jnp.asarray(data_pos)]
        denom = jnp.maximum(jnp.abs(gains), 1e-9)
        return data * jnp.conj(gains) / (denom * denom)

    def demodulate(self, samples) -> DemodResult:
        samples = jnp.asarray(samples, IQ_DTYPE)
        stream = self._symbol_stream(samples)
        f = int(stream.shape[-1]) // FRAME_SYMS
        if f == 0:
            empty = jnp.zeros(0, SYMBOL_DTYPE)
            return DemodResult(bits=empty, symbols=empty)
        frames_iq = stream[: f * FRAME_SYMS].reshape(f, FRAME_SYMS)
        eq = self._equalize_frames(frames_iq)

        bps = self.bits_per_symbol
        m = 1 << bps
        gray = _GRAY_TO_INDEX[bps]
        con = _psk8_points()[jnp.asarray(gray)]  # constellation in value order
        from r4w_tpu.ops.modem import soft_demap_llr

        llr = soft_demap_llr(eq.reshape(-1), con)  # (S, bps), >0 => bit 0
        soft = jnp.tanh(llr / 2.0).reshape(-1)  # +1 ~ bit 0 (viterbi conv.)

        _, rep, coded = MODES[self.mode_bps]
        rows, cols = interleaver_shape(self.mode_bps, self.long_interleave)
        n = rows * cols
        spans = soft.shape[-1] // n
        soft = soft[: spans * n].reshape(spans, n)
        perm = interleave_permutation(rows, cols)
        inv = jnp.asarray(np.argsort(perm).astype(np.int32))
        deint = soft[:, inv].reshape(-1)
        if rep > 1:
            k = deint.shape[-1] // rep
            deint = jnp.sum(deint[: k * rep].reshape(k, rep), axis=-1) / rep
        if coded:
            bits = viterbi_decode(deint, 7, CONV_POLYS, terminated=True,
                                  soft=True)
        else:
            bits = (deint < 0).astype(jnp.int32)
        symbols = jnp.argmax(
            -jnp.abs(eq.reshape(-1)[:, None] - _psk8_points()), axis=-1
        ).astype(SYMBOL_DTYPE)
        return DemodResult(bits=pack_demod_bits(bits), symbols=symbols)

    def get_modulation_stages(self, data):
        bits = data_to_bits(data)
        coded = self._coded_bits(bits)
        syms = self.frame_symbols(data)
        return [("input bits", bits),
                ("coded+repeated bits", coded),
                ("framed scrambled symbols", syms),
                ("modulated IQ", self.modulate(data))]


@functools.lru_cache(maxsize=None)
def _psk8_host() -> np.ndarray:
    ang = 2.0 * np.pi * np.arange(8) / 8.0
    return np.exp(1j * ang).astype(np.complex64)


def _psk8_points() -> jax.Array:
    return to_device(_psk8_host())


def _interp_complex(t: jax.Array, xp: jax.Array, fp: jax.Array) -> jax.Array:
    """Linear interpolation of complex anchors fp (..., A) at query t (T,)
    with anchor times xp (A,); clamps outside the anchor range."""
    re = jax.vmap(lambda row: jnp.interp(t, xp, row))(fp.real)
    im = jax.vmap(lambda row: jnp.interp(t, xp, row))(fp.imag)
    return jax.lax.complex(re, im).astype(IQ_DTYPE)


@register_waveform("STANAG-4285", aliases=("STANAG",))
def _stanag(sample_rate: float) -> Stanag4285:
    return Stanag4285(
        common=CommonParams(sample_rate=max(sample_rate, 9600.0)))
