"""Host <-> device transfer helpers for complex IQ arrays.

These helpers move complex data across the host boundary as split
real/imag float32 planes and (re)combine on the other side; every
framework edge (file IO, CLI, plotting, sockets) routes through them.
They date from a transfer layer without complex64 copies. On an H100 a
plain complex64 round trip is bit-exact (PERF.md), so they can collapse
to plain transfers (ROADMAP.md §3). The split costs one fused kernel.

Mirrors the role of the reference's IQ boundary conversions
(crates/r4w-core/src/io/format.rs) for device arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def _split(v):
    return jnp.real(v), jnp.imag(v)


@jax.jit
def _combine(r, i):
    return jax.lax.complex(r, i)


def to_host(x) -> np.ndarray:
    """Fetch an array to host numpy; complex moves as real/imag planes."""
    if isinstance(x, np.ndarray):
        return x
    x = jnp.asarray(x)
    if not jnp.iscomplexobj(x):
        return np.asarray(x)
    r, i = _split(x)
    return (np.asarray(r) + 1j * np.asarray(i)).astype(np.complex64)


def to_device(x) -> jax.Array:
    """Push an array to the default device; complex moves as planes."""
    if isinstance(x, jax.Array):
        return x
    x = np.asarray(x)
    if not np.iscomplexobj(x):
        return jnp.asarray(x)
    r = jnp.asarray(np.ascontiguousarray(x.real, np.float32))
    i = jnp.asarray(np.ascontiguousarray(x.imag, np.float32))
    return _combine(r, i)


def cis(phase) -> jax.Array:
    """exp(j*phase) via lax.complex(cos, sin).

    Equivalent to jnp.exp(1j*phase) but avoids the f32->c64
    convert_element_type that eager complex promotion emits. Compiles
    to the same HLO under jit.
    """
    p = jnp.asarray(phase, jnp.float32)
    return jax.lax.complex(jnp.cos(p), jnp.sin(p))


def zeros_iq(shape) -> jax.Array:
    """complex64 zeros without a complex fill-value upload.

    jnp.zeros(shape, complex64) broadcasts a host complex scalar to the
    device; this builds the planes as f32 and combines them with
    lax.complex instead.
    """
    if isinstance(shape, int):
        shape = (shape,)
    z = jnp.zeros(shape, jnp.float32)
    return jax.lax.complex(z, z)


def zeros_like_safe(x) -> jax.Array:
    """zeros_like that avoids complex fill-value uploads (see zeros_iq)."""
    if jnp.iscomplexobj(x):
        return zeros_iq(jnp.shape(x))
    return jnp.zeros_like(x)
