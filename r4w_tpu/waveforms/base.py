"""Waveform framework: the batch-first `Waveform` API + registry/factory.

Re-design of crates/r4w-core/src/waveform/mod.rs:290-446. Waveforms are
frozen dataclasses (hashable → usable as jit static args) exposing pure
``modulate``/``demodulate`` over JAX arrays. The factory mirrors
`WaveformFactory::{list, create}` (mod.rs:459-600) including the ~60 name
aliases, so the CLI/API surface matches the reference.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp

from r4w_tpu.core.hostio import zeros_iq
import numpy as np

from r4w_tpu.core.types import CommonParams, IQ_DTYPE


@dataclasses.dataclass(frozen=True)
class WaveformInfo:
    """Educational/display metadata (waveform/mod.rs:88-110)."""

    name: str
    full_name: str
    description: str = ""
    complexity: int = 1
    bits_per_symbol: int = 1
    carries_data: bool = True
    characteristics: tuple[str, ...] = ()
    history: str = ""
    modern_usage: str = ""


@dataclasses.dataclass
class DemodResult:
    """Demodulation output (waveform/mod.rs:130-153).

    bits: packed bytes (int32 array, one byte per element, matching the
    reference's Vec<u8> `bits` which holds packed bytes for multi-bit
    schemes). symbols: per-symbol decisions.
    """

    bits: jax.Array
    symbols: jax.Array
    ber_estimate: float | None = None
    snr_estimate: float | None = None
    metadata: dict = dataclasses.field(default_factory=dict)


def coerce_data_bytes(data) -> np.ndarray:
    """Accept bytes / list / array of byte values -> int32 numpy array."""
    if isinstance(data, (bytes, bytearray)):
        return np.frombuffer(bytes(data), dtype=np.uint8).astype(np.int32)
    arr = np.asarray(data)
    return arr.astype(np.int32)


def is_packed_bytes(data: np.ndarray) -> bool:
    """Heuristic from psk.rs:152: values >1 imply packed bytes not bits."""
    return bool(np.any(data > 1))


def data_to_bits(data) -> np.ndarray:
    """Accept packed bytes or a 0/1 bit vector; return bit vector (MSB-first)."""
    arr = coerce_data_bytes(data)
    if arr.size and not is_packed_bytes(arr):
        return arr  # already bits
    bits = np.unpackbits(arr.astype(np.uint8)[:, None], axis=1).reshape(-1)
    return bits.astype(np.int32)


class Waveform(abc.ABC):
    """Abstract waveform (waveform/mod.rs:290). Implementations are frozen
    dataclasses; `modulate`/`demodulate` must be pure and jit-compatible
    for fixed input shapes."""

    @abc.abstractmethod
    def info(self) -> WaveformInfo: ...

    @property
    @abc.abstractmethod
    def common_params(self) -> CommonParams: ...

    @abc.abstractmethod
    def modulate(self, data) -> jax.Array: ...

    @abc.abstractmethod
    def demodulate(self, samples) -> DemodResult: ...

    @abc.abstractmethod
    def samples_per_symbol(self) -> int: ...

    # Educational defaults (mod.rs:307-446) --------------------------------
    def generate_demo(self, duration_ms: float = 10.0) -> jax.Array:
        n = int(self.common_params.sample_rate * duration_ms / 1000.0)
        demo = np.arange(16) % 2
        samples = self.modulate(demo.astype(np.int32))
        return samples[:n]

    def get_visualization(self, data) -> dict:
        samples = self.modulate(data)
        return {
            "samples": samples,
            "constellation": getattr(self, "constellation_points", lambda: zeros_iq(0))(),
            "description": f"{self.info().name} modulated signal",
        }

    def get_modulation_stages(self, data) -> list[tuple[str, object]]:
        """Named intermediate signals for the educational pipeline view
        (mod.rs get_modulation_stages default). Waveforms with richer
        chains override to expose coding/shaping steps."""
        bits = data_to_bits(data)
        return [("input bits", bits),
                ("modulated IQ", self.modulate(data))]

    def get_demodulation_steps(self, samples) -> list[tuple[str, object]]:
        """Named receiver steps (mod.rs get_demodulation_steps default)."""
        res = self.demodulate(samples)
        return [("received IQ", samples),
                ("decisions", res.symbols),
                ("bits", res.bits)]


# --------------------------------------------------------------------------
# Registry / factory (mod.rs:459-600)
# --------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[float], Waveform]] = {}
_CANONICAL: list[str] = []


def _norm(name: str) -> str:
    return name.upper().replace("-", "").replace("_", "").replace(".", "")


def register_waveform(canonical: str, aliases: tuple[str, ...] = ()):
    """Register a builder fn(sample_rate) under a canonical name + aliases."""

    def deco(builder: Callable[[float], Waveform]):
        if canonical not in _CANONICAL:
            _CANONICAL.append(canonical)
        for name in (canonical, *aliases):
            _REGISTRY[_norm(name)] = builder
        return builder

    return deco


def list_waveforms() -> list[str]:
    """Canonical waveform names (mirrors WaveformFactory::list, mod.rs:459)."""
    return list(_CANONICAL)


def create_waveform(name: str, sample_rate: float = 125_000.0) -> Waveform | None:
    """Create a waveform by (aliased) name; None if unknown (mod.rs:491)."""
    key = _norm(name)
    builder = _REGISTRY.get(key)
    if builder is not None:
        return builder(sample_rate)
    # GPS-L1CA-PRN<n> dynamic names (mod.rs:591-597)
    if key.startswith("GPSL1CAPRN"):
        try:
            prn = int(key[10:])
        except ValueError:
            return None
        if 1 <= prn <= 32:
            try:
                from r4w_tpu.waveforms.gnss_waveforms import GpsL1CaWaveform
            except ImportError:
                return None  # GNSS waveforms not built yet
            return GpsL1CaWaveform(sample_rate=sample_rate, prn=prn)
    return None


class WaveformFactory:
    """Namespace mirroring the reference WaveformFactory."""

    list = staticmethod(list_waveforms)
    create = staticmethod(create_waveform)
