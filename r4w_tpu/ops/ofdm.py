"""OFDM channel estimation & equalization ops.

Re-design of the reference's pilot-based OFDM receive chain —
`ofdm_channel_est.rs` (LS pilot estimation + interpolation + ZF/MMSE
equalization), `ofdm_pilot_interpolator.rs` (pilot patterns + boost),
`ofdm_frame_equalizer.rs` (PilotPattern, per-frame estimate/equalize) —
as pure batched JAX functions. Instead of the reference's per-symbol
`&mut self` estimate/equalize loop, a whole packet of OFDM symbols is
one (..., n_sym, n_bins) array: LS estimates at every pilot of every
symbol in one gather, common-phase-error per symbol via a reduction,
packet channel estimate via a masked mean, interpolation via one
matmul with a precomputed (n_bins, n_pilots) interpolation operator
(matmul-shaped, no per-bin control flow).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from r4w_tpu.core import hostio
from r4w_tpu.core.types import IQ_DTYPE, REAL_DTYPE


def _iq(x):
    """Coerce to a device complex64 array.

    Host numpy complex arrays cross the boundary through
    hostio.to_device (ARCHITECTURE.md §7); device arrays just get a
    dtype cast.
    """
    if isinstance(x, np.ndarray) and np.iscomplexobj(x):
        return hostio.to_device(np.asarray(x, np.complex64))
    return jnp.asarray(x, IQ_DTYPE)


@dataclasses.dataclass(frozen=True)
class PilotPattern:
    """Pilot layout within the occupied-subcarrier vector
    (ofdm_frame_equalizer.rs:34 PilotPattern).

    Positions index into the *occupied* (data+pilot) subcarrier array,
    not raw FFT bins; values are the known transmitted pilot points.
    """

    positions: tuple[int, ...]
    values: tuple[complex, ...]
    n_occupied: int

    def __post_init__(self):
        assert len(self.positions) == len(self.values)
        assert all(0 <= p < self.n_occupied for p in self.positions)

    @classmethod
    def uniform(cls, n_occupied: int, spacing: int,
                value: complex = 1.0 + 0.0j) -> "PilotPattern":
        """Every `spacing`-th occupied subcarrier is a pilot
        (ofdm_frame_equalizer.rs:47 uniform)."""
        pos = tuple(range(0, n_occupied, spacing))
        return cls(pos, (value,) * len(pos), n_occupied)

    @classmethod
    def edges_and_uniform(cls, n_occupied: int, n_pilots: int,
                          value: complex = 1.0 + 0.0j) -> "PilotPattern":
        """n_pilots spread evenly INCLUDING both band edges, so channel
        interpolation never extrapolates across the occupied band."""
        assert n_pilots >= 2
        pos = tuple(
            int(round(i * (n_occupied - 1) / (n_pilots - 1)))
            for i in range(n_pilots)
        )
        return cls(pos, (value,) * n_pilots, n_occupied)

    @property
    def num_pilots(self) -> int:
        return len(self.positions)

    @property
    def num_data(self) -> int:
        return self.n_occupied - self.num_pilots

    @functools.cached_property
    def data_positions(self) -> np.ndarray:
        mask = np.ones(self.n_occupied, bool)
        mask[list(self.positions)] = False
        return np.nonzero(mask)[0]


@functools.lru_cache(maxsize=None)
def _interp_operator(positions: tuple[int, ...], n_bins: int) -> np.ndarray:
    """(n_bins, n_pilots) linear-interpolation matrix: H_full = W @ H_pilots.

    Linear between adjacent pilots, constant (nearest) extrapolation
    outside — matches ofdm_channel_est.rs:238 interpolate_pilots. Built
    host-side once per pattern; applying it is one complex matmul, so the
    whole packet's interpolation is a matmul instead of a per-bin scan.
    """
    pos = np.asarray(positions, np.float64)
    w = np.zeros((n_bins, len(positions)), np.float32)
    for b in range(n_bins):
        j = np.searchsorted(pos, b)
        if j == 0:
            w[b, 0] = 1.0
        elif j == len(pos):
            w[b, -1] = 1.0
        elif pos[j] == b:
            w[b, j] = 1.0
        else:
            frac = (b - pos[j - 1]) / (pos[j] - pos[j - 1])
            w[b, j - 1] = 1.0 - frac
            w[b, j] = frac
    return w


def estimate_pilot_ls(rx_occupied, pattern: PilotPattern):
    """Least-squares channel estimate at each pilot of each symbol:
    H_ls[..., s, p] = rx[..., s, pos_p] / pilot_value_p
    (ofdm_channel_est.rs:147 estimate)."""
    rx_occupied = _iq(rx_occupied)
    pos = jnp.asarray(np.asarray(pattern.positions, np.int32))
    vals = _iq(np.asarray(pattern.values, np.complex64))
    return rx_occupied[..., pos] / vals


def common_phase_error(h_ls, h_ref):
    """Per-symbol common phase rotation of the pilot LS estimates
    relative to a reference estimate: cpe[..., s] = unit phasor."""
    corr = jnp.sum(h_ls * jnp.conj(h_ref), axis=-1)
    mag = jnp.abs(corr)
    # Degenerate (zero-correlation) symbols fall back to a unit phasor.
    # Built from real planes (core.hostio style, ARCHITECTURE.md §7).
    degen = (mag <= 1e-12).astype(REAL_DTYPE)
    scale = (1.0 - degen) / jnp.maximum(mag, 1e-12)
    return jax.lax.complex(jnp.real(corr) * scale + degen,
                           jnp.imag(corr) * scale)


def estimate_channel(rx_occupied, pattern: PilotPattern):
    """Packet-level channel estimate over the occupied band.

    Block-fading model: the channel is static across the packet's OFDM
    symbols up to a per-symbol common phase error (residual CFO/phase
    noise). Returns (h_occ, cpe):
      h_occ (..., n_occupied) — interpolated complex channel gain;
      cpe   (..., n_sym)     — unit phasor per symbol.
    """
    h_ls = estimate_pilot_ls(rx_occupied, pattern)  # (..., S, P)
    # first-pass reference (CPE-biased), then derotate and re-average
    h0 = jnp.mean(h_ls, axis=-2, keepdims=True)
    cpe = common_phase_error(h_ls, h0)  # (..., S)
    h_pkt = jnp.mean(h_ls * jnp.conj(cpe)[..., None], axis=-2)  # (..., P)
    w = jnp.asarray(_interp_operator(pattern.positions, pattern.n_occupied))
    h_occ = jax.lax.complex(h_pkt.real @ w.T, h_pkt.imag @ w.T)
    return h_occ, cpe


def equalize_zf(rx, h, floor: float = 1e-6):
    """Zero-forcing: rx/h with a magnitude floor
    (ofdm_channel_est.rs:197 equalize)."""
    rx = _iq(rx)
    p = jnp.maximum(jnp.abs(h) ** 2, jnp.asarray(floor, REAL_DTYPE))
    return rx * jnp.conj(h) / p


def equalize_mmse(rx, h, noise_var):
    """MMSE: rx·conj(h)/(|h|²+σ²) (ofdm_channel_est.rs:216
    equalize_mmse)."""
    rx = _iq(rx)
    return rx * jnp.conj(h) / (jnp.abs(h) ** 2
                               + jnp.asarray(noise_var, REAL_DTYPE))


def equalize_frame(rx_occupied, pattern: PilotPattern,
                   method: str = "mmse", noise_var=None):
    """Estimate + equalize a whole packet and strip pilots
    (ofdm_frame_equalizer.rs:222 process_frame + :211 extract_data).

    rx_occupied: (..., n_sym, n_occupied) post-FFT occupied subcarriers.
    noise_var=None estimates σ² from the pilot LS residual spread.
    Returns (data, h_occ, cpe) where data is (..., n_sym, n_data).
    """
    h_occ, cpe = estimate_channel(rx_occupied, pattern)
    derot = rx_occupied * jnp.conj(cpe)[..., None]
    if noise_var is None:
        h_ls = estimate_pilot_ls(rx_occupied, pattern)
        resid = (h_ls * jnp.conj(cpe)[..., None]
                 - h_occ[..., None, jnp.asarray(
                     np.asarray(pattern.positions, np.int32))])
        noise_var = jnp.maximum(
            jnp.mean(jnp.abs(resid) ** 2, axis=(-2, -1)), 1e-6
        )[..., None, None]
    if method == "mmse":
        eq = equalize_mmse(derot, h_occ[..., None, :], noise_var)
    elif method == "zf":
        eq = equalize_zf(derot, h_occ[..., None, :])
    else:
        raise ValueError(f"unknown equalizer method: {method}")
    data = eq[..., jnp.asarray(pattern.data_positions)]
    return data, h_occ, cpe


@functools.lru_cache(maxsize=None)
def training_sequence(n_occupied: int, seed: int = 0x1F) -> np.ndarray:
    """Deterministic known QPSK training symbol over the occupied band
    (the 802.11-LTF role: full-band per-bin channel sounding; the
    reference reaches the same coverage with dense pilot grids,
    ofdm_channel_est.rs:18 doc example)."""
    rng = np.random.default_rng(seed)
    pts = (rng.integers(0, 2, n_occupied) * 2 - 1) + 1j * (
        rng.integers(0, 2, n_occupied) * 2 - 1)
    return (pts / np.sqrt(2.0)).astype(np.complex64)


def estimate_channel_from_training(rx_train, train_vals):
    """Per-bin LS channel estimate from known training symbol(s):
    rx_train (..., T, n_occ) / train_vals (n_occ) → mean over T."""
    rx_train = _iq(rx_train)
    return jnp.mean(rx_train / train_vals, axis=-2)


def equalize_packet(rx_occupied, pattern: PilotPattern, train_vals,
                    n_train: int, method: str = "mmse", noise_var=None):
    """Full packet receive: training-based full-band channel estimate,
    pilot-based per-symbol common-phase tracking, MMSE/ZF equalization.

    rx_occupied: (..., n_train + n_sym, n_occupied) post-FFT points
    (training symbols first). Returns (data, h_occ, cpe) with data
    (..., n_sym, n_data). Unlike interpolated pilot-only estimation
    (equalize_frame), the per-bin estimate handles delay spreads up to
    the cyclic prefix regardless of pilot density.
    """
    rx_occupied = _iq(rx_occupied)
    train_vals = _iq(train_vals)
    rx_train = rx_occupied[..., :n_train, :]
    rx_data = rx_occupied[..., n_train:, :]
    h_occ = estimate_channel_from_training(rx_train, train_vals)
    pos = jnp.asarray(np.asarray(pattern.positions, np.int32))
    vals = _iq(np.asarray(pattern.values, np.complex64))
    h_ls = rx_data[..., pos] / vals  # (..., S, P)
    cpe = common_phase_error(h_ls, h_occ[..., None, pos])
    derot = rx_data * jnp.conj(cpe)[..., None]
    if noise_var is None:
        resid = h_ls * jnp.conj(cpe)[..., None] - h_occ[..., None, pos]
        noise_var = jnp.maximum(
            jnp.mean(jnp.abs(resid) ** 2, axis=(-2, -1)), 1e-6
        )[..., None, None]
    if method == "mmse":
        eq = equalize_mmse(derot, h_occ[..., None, :], noise_var)
    elif method == "zf":
        eq = equalize_zf(derot, h_occ[..., None, :])
    else:
        raise ValueError(f"unknown equalizer method: {method}")
    data = eq[..., jnp.asarray(pattern.data_positions)]
    return data, h_occ, cpe


def channel_magnitude_db(h_occ):
    """Per-bin magnitude response in dB
    (ofdm_channel_est.rs:57 magnitude_response)."""
    return 20.0 * jnp.log10(jnp.maximum(jnp.abs(h_occ), 1e-12))
