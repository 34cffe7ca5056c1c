"""Analog AM/FM waveforms (waveform/am.rs, waveform/fm.rs re-designs).

Audio in/out is float arrays in [-1, 1]; the Waveform byte API maps each
byte as a signed i8 audio sample (am.rs:230-235, fm.rs modulate). The
per-sample phase integral of the reference becomes a cumulative sum.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from r4w_tpu.core.hostio import cis
import numpy as np

from r4w_tpu.core.types import IQ_DTYPE, REAL_DTYPE, SYMBOL_DTYPE, CommonParams
from r4w_tpu.waveforms.base import (
    DemodResult,
    Waveform,
    WaveformInfo,
    coerce_data_bytes,
    register_waveform,
)


def _bytes_to_audio(data) -> jnp.ndarray:
    b = coerce_data_bytes(data).astype(np.int64)
    signed = np.where(b > 127, b - 256, b).astype(np.float32) / 128.0
    return jnp.asarray(signed)


def _audio_to_bytes(audio: jax.Array) -> jax.Array:
    # round to the nearest level: truncation would return a demodulated
    # 99.9999 as 99, one LSB low
    x = jnp.clip(jnp.round(jnp.asarray(audio) * 128.0), -128,
                 127).astype(jnp.int32)
    return jnp.where(x < 0, x + 256, x)


@dataclasses.dataclass(frozen=True)
class AM(Waveform):
    """AM: DSB-FC / DSB-SC variants (am.rs)."""

    common: CommonParams = CommonParams()
    carrier_freq: float = 1000.0
    modulation_index: float = 0.8
    variant: str = "dsb_fc"  # dsb_fc | dsb_sc

    @property
    def common_params(self) -> CommonParams:
        return self.common

    def samples_per_symbol(self) -> int:
        return 1

    def info(self) -> WaveformInfo:
        return WaveformInfo(
            name="AM-Broadcast", full_name="Amplitude Modulation",
            description="Analog audio on carrier amplitude",
            complexity=1, bits_per_symbol=8,
            characteristics=("Envelope detection", f"m={self.modulation_index}"),
        )

    def modulate_audio(self, audio) -> jax.Array:
        audio = jnp.asarray(audio, REAL_DTYPE)
        n = audio.shape[-1]
        omega = 2.0 * jnp.pi * self.carrier_freq / self.common.sample_rate
        phase = (omega * jnp.arange(n, dtype=REAL_DTYPE)).astype(REAL_DTYPE)
        if self.variant == "dsb_fc":
            env = self.common.amplitude * (1.0 + self.modulation_index * audio)
        else:  # dsb_sc
            env = self.common.amplitude * self.modulation_index * audio
        return (env * cis(phase)).astype(IQ_DTYPE)

    def demodulate_audio(self, samples) -> jax.Array:
        samples = jnp.asarray(samples, IQ_DTYPE)
        if self.variant == "dsb_fc":
            env = jnp.abs(samples)
            return ((env / self.common.amplitude - 1.0)
                    / self.modulation_index).astype(REAL_DTYPE)
        n = samples.shape[-1]
        omega = 2.0 * jnp.pi * self.carrier_freq / self.common.sample_rate
        ph = omega * jnp.arange(n, dtype=REAL_DTYPE)
        return (samples.real * jnp.cos(ph) + samples.imag * jnp.sin(ph)).astype(
            REAL_DTYPE
        )

    def modulate(self, data) -> jax.Array:
        return self.modulate_audio(_bytes_to_audio(data))

    def demodulate(self, samples) -> DemodResult:
        audio = self.demodulate_audio(samples)
        return DemodResult(bits=_audio_to_bytes(audio),
                           symbols=jnp.zeros(0, SYMBOL_DTYPE))


@dataclasses.dataclass(frozen=True)
class FM(Waveform):
    """FM: broadcast (75 kHz dev) / narrowband (2.5 kHz dev) (fm.rs:77-104)."""

    common: CommonParams = CommonParams()
    carrier_freq: float = 1000.0
    freq_deviation: float = 75_000.0
    audio_bandwidth: float = 15_000.0
    narrowband: bool = False

    @property
    def common_params(self) -> CommonParams:
        return self.common

    def samples_per_symbol(self) -> int:
        return 1

    def info(self) -> WaveformInfo:
        name = "NBFM" if self.narrowband else "FM-Broadcast"
        return WaveformInfo(
            name=name, full_name="Frequency Modulation",
            description="Analog audio on carrier frequency",
            complexity=2, bits_per_symbol=8,
            characteristics=(f"deviation {self.freq_deviation/1e3:.1f} kHz",
                             "Constant envelope"),
        )

    def modulate_audio(self, audio) -> jax.Array:
        audio = jnp.asarray(audio, REAL_DTYPE)
        n = audio.shape[-1]
        omega_c = 2.0 * jnp.pi * self.carrier_freq / self.common.sample_rate
        k_f = 2.0 * jnp.pi * self.freq_deviation / self.common.sample_rate
        # phase integral: inclusive cumsum matches the reference's
        # accumulate-then-emit loop (fm.rs modulate_audio)
        phase = omega_c * jnp.arange(n, dtype=REAL_DTYPE) + k_f * jnp.cumsum(
            audio, axis=-1
        )
        return (self.common.amplitude * cis(phase)).astype(IQ_DTYPE)

    def demodulate_audio(self, samples) -> jax.Array:
        """Phase-difference discriminator: one sample shorter than its
        input, output i being the audio of input sample i + 1 (the first
        sample has no predecessor to difference against)."""
        samples = jnp.asarray(samples, IQ_DTYPE)
        k_f = 2.0 * jnp.pi * self.freq_deviation / self.common.sample_rate
        omega_c = 2.0 * jnp.pi * self.carrier_freq / self.common.sample_rate
        d = samples[..., 1:] * jnp.conj(samples[..., :-1])
        dphase = jnp.angle(d)  # already wrapped to (-π, π]
        return ((dphase - omega_c) / k_f).astype(REAL_DTYPE)

    def modulate(self, data) -> jax.Array:
        return self.modulate_audio(_bytes_to_audio(data))

    def demodulate(self, samples) -> DemodResult:
        audio = self.demodulate_audio(samples)
        return DemodResult(bits=_audio_to_bytes(audio),
                           symbols=jnp.zeros(0, SYMBOL_DTYPE))


@register_waveform("AM-Broadcast", aliases=("AM",))
def _am(sample_rate: float) -> AM:
    return AM(common=CommonParams(sample_rate=sample_rate),
              carrier_freq=1000.0, modulation_index=0.8)


@register_waveform("FM-Broadcast", aliases=("FM", "WBFM"))
def _fm(sample_rate: float) -> FM:
    return FM(common=CommonParams(sample_rate=sample_rate),
              carrier_freq=1000.0, freq_deviation=75_000.0,
              audio_bandwidth=15_000.0)


@register_waveform("NBFM")
def _nbfm(sample_rate: float) -> FM:
    return FM(common=CommonParams(sample_rate=sample_rate),
              carrier_freq=1000.0, freq_deviation=2500.0,
              audio_bandwidth=3000.0, narrowband=True)
