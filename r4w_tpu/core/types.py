"""Core types and dtype policy.

Batch-first equivalents of the reference's core types
(crates/r4w-core/src/types.rs:34-90): IQ samples are ``complex64`` JAX
arrays (batch-first blocks), symbols are ``int32`` arrays (u16 range),
and errors are Python exceptions raised at trace/host time — shape and
parameter validation happens before jit, never inside a kernel.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

# Dtype policy ---------------------------------------------------------------
# IQ blocks: complex64 (f32 pairs) on the device; f64 reference checks run on
# CPU-jax in tests. Symbols: int32 (XLA prefers 32-bit lanes over u16).
IQ_DTYPE = jnp.complex64
REAL_DTYPE = jnp.float32
SYMBOL_DTYPE = jnp.int32

C64 = np.complex64
F32 = np.float32


class DspError(Exception):
    """Base error for DSP parameter/shape problems (types.rs:60)."""


class InvalidParameter(DspError):
    pass


class BufferTooShort(DspError):
    def __init__(self, expected: int, actual: int):
        super().__init__(f"buffer too short: expected {expected}, got {actual}")
        self.expected = expected
        self.actual = actual


@dataclasses.dataclass(frozen=True)
class CommonParams:
    """Common waveform parameters (waveform/mod.rs:229-246)."""

    sample_rate: float = 125_000.0
    carrier_freq: float = 0.0
    amplitude: float = 1.0


def as_iq(x) -> jnp.ndarray:
    """Coerce to a complex64 IQ array."""
    return jnp.asarray(x, dtype=IQ_DTYPE)


def db_to_linear_power(db) -> jnp.ndarray:
    return 10.0 ** (jnp.asarray(db, REAL_DTYPE) / 10.0)


def db_to_linear_amplitude(db) -> jnp.ndarray:
    return 10.0 ** (jnp.asarray(db, REAL_DTYPE) / 20.0)


def linear_power_to_db(p) -> jnp.ndarray:
    return 10.0 * jnp.log10(jnp.asarray(p, REAL_DTYPE))


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()
