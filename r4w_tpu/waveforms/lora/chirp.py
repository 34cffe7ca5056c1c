"""LoRa chirp synthesis, batch-first (crates/r4w-core/src/chirp.rs re-design).

The reference synthesizes each chirp with a per-sample phase-accumulation
loop (chirp.rs:120-265). Here the base up/down chirps are precomputed once
(f64 on host for phase accuracy, cast to complex64), and a *bank* of symbol
chirps is produced as one gather: symbol k is a cyclic rotation of the base
upchirp by k·osf samples (the wrap phase correction of chirp.rs:236-240 is
exp(j·2π·symbol) == 1 for integer symbols, so rotation is exact).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from r4w_tpu.core.types import IQ_DTYPE
from r4w_tpu.waveforms.lora.params import LoRaParams


@functools.lru_cache(maxsize=None)
def _base_chirps_np(sf: int, bw_hz: int, oversample: int):
    """(upchirp, downchirp) as numpy complex64, length 2^sf * osf."""
    chips = 1 << sf
    n = chips * oversample
    ts = 1.0 / (bw_hz * oversample)
    t_symbol = chips / bw_hz
    df = bw_hz / t_symbol
    t = np.arange(n, dtype=np.float64) * ts
    # phase = 2π (f_init t ± df/2 t²), f_init = ∓bw/2 (chirp.rs:120-150)
    up_phase = 2.0 * np.pi * (-bw_hz / 2.0 * t + df / 2.0 * t * t)
    up = np.exp(1j * up_phase).astype(np.complex64)
    down_phase = 2.0 * np.pi * (bw_hz / 2.0 * t - df / 2.0 * t * t)
    down = np.exp(1j * down_phase).astype(np.complex64)
    return up, down


def base_upchirp(params: LoRaParams) -> jax.Array:
    from r4w_tpu.core.hostio import to_device

    up, _ = _base_chirps_np(params.sf, params.bw_hz, params.oversample)
    return to_device(up)


def base_downchirp(params: LoRaParams) -> jax.Array:
    from r4w_tpu.core.hostio import to_device

    _, down = _base_chirps_np(params.sf, params.bw_hz, params.oversample)
    return to_device(down)


def symbol_chirps(params: LoRaParams, symbols: jax.Array) -> jax.Array:
    """Chirps for a batch of symbols: (..., S) int32 -> (..., S, N) complex64.

    Vectorized equivalent of generate_symbol_chirp_fast (chirp.rs:215-260):
    out[s, i] = base_up[(i + symbol[s]*osf) % N], one gather from the
    base chirp table. (A one-hot-matmul form of the same shift lost to
    the gather on an H100 at SF7-SF10; PERF.md, "LoRa chirp synthesis".)
    """
    n = params.samples_per_symbol
    syms = jnp.asarray(symbols, jnp.int32)
    shift = (syms * params.oversample) % n
    idx = (jnp.arange(n)[None, :] + shift[..., None]) % n
    return base_upchirp(params)[idx]


def preamble(params: LoRaParams) -> jax.Array:
    """Preamble: P upchirps, 2 sync chirps (K-8, K-16), 2.25 downchirps.

    Mirrors chirp.rs:296-324 (sync word 0x12 → symbols K-8 and K-16).
    """
    up = base_upchirp(params)
    down = base_downchirp(params)
    n = params.samples_per_symbol
    k = params.chips_per_symbol
    sync1 = max(k - 8, 0)
    sync2 = max(k - 16, 0)
    sync = symbol_chirps(params, jnp.array([sync1, sync2]))
    parts = [jnp.tile(up, params.preamble_length), sync.reshape(-1), down, down,
             down[: n // 4]]
    return jnp.concatenate(parts).astype(IQ_DTYPE)


def instantaneous_frequency(params: LoRaParams, samples: jax.Array) -> jax.Array:
    """Discrete instantaneous frequency in Hz (chirp.rs:329-348)."""
    phase = jnp.angle(samples)
    dphase = jnp.diff(phase)
    dphase = jnp.mod(dphase + jnp.pi, 2 * jnp.pi) - jnp.pi
    return dphase * params.sample_rate / (2.0 * jnp.pi)
