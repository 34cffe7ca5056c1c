"""LoRa modulator/demodulator as pure, jittable batch functions.

Re-designs crates/r4w-core/src/{modulation,demodulation}.rs batch-first:
the full chain — whitening → Hamming → diagonal interleave → Gray →
chirp bank gather on TX, and dechirp → batched FFT → argmax → Gray⁻¹ →
deinterleave → Hamming⁻¹ → dewhiten on RX — is one fused XLA graph with
no per-symbol Python loops. The dechirp-FFT-argmax demod maps every
symbol in the packet (and every Monte-Carlo lane via vmap) onto a single
batched FFT, which is where the FLOPs live.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from r4w_tpu.core.types import IQ_DTYPE, REAL_DTYPE
from r4w_tpu.ops import coding
from r4w_tpu.waveforms.lora import chirp as chirp_mod
from r4w_tpu.waveforms.lora.params import LoRaParams


class LoRaDemodResult(NamedTuple):
    payload: jax.Array  # (n_bytes,) int32 recovered bytes (incl. block pad)
    symbols: jax.Array  # (S,) int32 raw FFT-peak symbols
    snr_db: jax.Array  # (S,) f32 per-symbol peak/avg SNR estimate
    magnitude: jax.Array  # (S,) f32 peak magnitudes


# --------------------------------------------------------------------------
# Encode path
# --------------------------------------------------------------------------


def encode_symbols(params: LoRaParams, payload: jax.Array) -> jax.Array:
    """bytes -> LoRa symbols (modulation.rs:118-226 steps 1-4).

    payload: (..., n_bytes) int32. Returns (..., S) int32 symbols where
    S = ceil(2*n_bytes / sf) * (4+cr).
    """
    sf, cr = params.sf, params.cr
    whitened = coding.whiten(payload)
    nibbles = coding.bytes_to_nibbles(whitened)
    codewords = coding.hamming_encode(nibbles, cr)
    # pad to whole interleaver blocks of sf codewords (modulation.rs:293-298)
    n_cw = codewords.shape[-1]
    n_blocks = -(-n_cw // sf)
    pad = n_blocks * sf - n_cw
    if pad:
        pad_widths = [(0, 0)] * (codewords.ndim - 1) + [(0, pad)]
        codewords = jnp.pad(codewords, pad_widths)
    blocks = codewords.reshape(*codewords.shape[:-1], n_blocks, sf)
    interleaved = coding.interleave(blocks, sf, cr)  # (..., n_blocks, 4+cr)
    symbols = coding.gray_encode(interleaved)
    return symbols.reshape(*symbols.shape[:-2], -1)


def modulate(
    params: LoRaParams, payload: jax.Array, include_preamble: bool = True
) -> jax.Array:
    """Full LoRa TX chain: payload bytes -> IQ (modulation.rs:118).

    payload: (n_bytes,) int32. Returns (n_samples,) complex64.
    """
    symbols = encode_symbols(params, payload)
    chirps = chirp_mod.symbol_chirps(params, symbols)  # (S, N)
    body = chirps.reshape(-1)
    if include_preamble:
        return jnp.concatenate([chirp_mod.preamble(params), body]).astype(IQ_DTYPE)
    return body.astype(IQ_DTYPE)


# --------------------------------------------------------------------------
# Decode path
# --------------------------------------------------------------------------


def demodulate_symbols(params: LoRaParams, samples: jax.Array):
    """Batched dechirp-FFT-argmax (demodulation.rs:167-226).

    samples: (..., S*N) or (..., S, N) complex64 payload-aligned IQ.
    Returns (symbols (..., S) int32, snr_db f32, magnitude f32).
    """
    n = params.samples_per_symbol
    k = params.chips_per_symbol
    if samples.shape[-1] != n:
        s = samples.shape[-1] // n
        samples = samples[..., : s * n].reshape(*samples.shape[:-1], s, n)
    down = chirp_mod.base_downchirp(params)
    mixed = samples.astype(IQ_DTYPE) * down
    if params.oversample > 1:
        mixed = mixed[..., :: params.oversample]  # decimate to k chips
    spectrum = jnp.fft.fft(mixed, axis=-1)  # (..., S, K)
    power = spectrum.real**2 + spectrum.imag**2
    symbols = jnp.argmax(power, axis=-1).astype(jnp.int32)
    peak_power = jnp.max(power, axis=-1)
    avg_power = jnp.mean(power, axis=-1)
    snr_db = 10.0 * jnp.log10(peak_power / jnp.maximum(avg_power, 1e-30))
    return symbols, snr_db.astype(REAL_DTYPE), jnp.sqrt(peak_power).astype(REAL_DTYPE)


def decode_symbols(params: LoRaParams, symbols: jax.Array) -> jax.Array:
    """symbols -> payload bytes (demodulation.rs:247-330 steps).

    symbols: (..., S) int32 with S a multiple of (4+cr).
    Returns (..., n_bytes) int32 including interleaver-block padding bytes.
    """
    sf, cr = params.sf, params.cr
    n_bits = 4 + cr
    gray_decoded = coding.gray_decode(symbols)
    s = gray_decoded.shape[-1]
    n_blocks = s // n_bits
    blocks = gray_decoded[..., : n_blocks * n_bits].reshape(
        *gray_decoded.shape[:-1], n_blocks, n_bits
    )
    codewords = coding.deinterleave(blocks, sf, cr)  # (..., n_blocks, sf)
    nibbles = coding.hamming_decode(codewords, cr).reshape(
        *codewords.shape[:-2], -1
    )
    # drop odd trailing nibble (bytes need pairs)
    n_nib = nibbles.shape[-1] - (nibbles.shape[-1] % 2)
    payload = coding.nibbles_to_bytes(nibbles[..., :n_nib])
    return coding.dewhiten(payload)


def demodulate(params: LoRaParams, samples: jax.Array) -> LoRaDemodResult:
    """Full RX chain on payload-aligned samples (demodulation.rs:247)."""
    symbols, snr_db, mag = demodulate_symbols(params, samples)
    payload = decode_symbols(params, symbols)
    return LoRaDemodResult(payload=payload, symbols=symbols, snr_db=snr_db,
                           magnitude=mag)


# --------------------------------------------------------------------------
# Jitted conveniences
# --------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(0,))
def modulate_jit(params: LoRaParams, payload: jax.Array) -> jax.Array:
    return modulate(params, payload)


@functools.partial(jax.jit, static_argnums=(0,))
def demodulate_jit(params: LoRaParams, samples: jax.Array) -> LoRaDemodResult:
    return demodulate(params, samples)


def loopback_ber(params: LoRaParams, payload, key, snr_db) -> jax.Array:
    """modulate → AWGN → demodulate → bit error rate, one fused graph.

    snr_db may be a scalar or batched via vmap over (key, snr_db) for
    Monte-Carlo BER sweeps — the reference does this serially per trial
    (r4w-cli cmd_simulate, main.rs:1252).
    """
    from r4w_tpu.channel import awgn

    payload = jnp.asarray(payload, jnp.int32)
    tx = modulate(params, payload, include_preamble=False)
    rx = awgn(key, tx, snr_db)
    result = demodulate(params, rx)
    n = payload.shape[-1]
    tx_bits = coding.bytes_to_bits(payload)
    rx_bits = coding.bytes_to_bits(result.payload[..., :n])
    return jnp.mean((tx_bits != rx_bits).astype(REAL_DTYPE))
