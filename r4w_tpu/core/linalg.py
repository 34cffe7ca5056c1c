"""Small linear-algebra helpers that lower on every backend.

Complex least squares without complex QR/SVD lowering: `complex_lstsq` solves the ridge-regularized normal
equations through the standard real 2x2 block embedding
[[Re M, -Im M], [Im M, Re M]] — real `jnp.linalg.solve` lowers
everywhere. Intended for the small design/estimation systems in the
block catalog (channel estimators, DPD fits: tens of unknowns), where
the normal-equation conditioning penalty is irrelevant.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def complex_lstsq(a: jax.Array, b: jax.Array,
                  ridge: float = 1e-9) -> jax.Array:
    """argmin_h ||a @ h - b||² for complex a (m, n), b (m,).

    Pure jnp — jit/vmap-safe. `ridge` scales with trace(aᴴa)/n
    so regularization is relative to the problem's energy.
    """
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    m = a.conj().T @ a                      # (n, n) hermitian
    v = a.conj().T @ b                      # (n,)
    n = m.shape[0]
    lam = ridge * jnp.real(jnp.trace(m)) / n
    m = m + lam * jnp.eye(n, dtype=m.dtype)
    mr, mi = jnp.real(m), jnp.imag(m)
    block = jnp.block([[mr, -mi], [mi, mr]])
    rhs = jnp.concatenate([jnp.real(v), jnp.imag(v)])
    sol = jnp.linalg.solve(block, rhs)
    return jax.lax.complex(sol[:n], sol[n:])
