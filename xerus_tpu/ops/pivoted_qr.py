"""Jitted Householder QR with column pivoting (dgeqp3 semantics).

The reference's rank-revealing QC/CQ is LAPACK dgeqp3 + rank rule
|R[r,r]| < 16*eps*|R[0,0]| (blasLapackWrapper.cpp:262-361).  XLA ships no
pivoted QR on any backend, so core/factorizations.py substitutes an
SVD-based rank rule; this module provides the genuine pivoted
factorization as a jittable kernel (VERDICT r2 item #8) so the dispatch
layer can pick whichever is faster per backend.

Design: classic column-pivoted Householder in a lax.fori_loop with
row/column masks standing in for the shrinking trailing block (static
shapes; jit-compatible).  Pivot selection recomputes trailing column
norms each step — O(mn) per step, same order as the reflection itself,
and immune to the cancellation drift of the classical downdate (LAPACK
guards that drift with recomputation anyway; the PIVOT SEQUENCE matches
dgeqp3 up to ties).  Q is accumulated m x m and sliced by the caller.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp


def householder_qrp(a):
    """A[:, perm] = Q @ R with R upper-triangular, |R| diagonal
    non-increasing (greedy column pivoting).

    Returns (q, r, perm): q (m, k) orthonormal columns, r (k, n) upper
    triangular, perm (n,) int32 with a[:, perm] = q @ r, k = min(m, n).
    """
    m, n = a.shape
    k = min(m, n)
    dtype = a.dtype
    rows = jnp.arange(m)
    cols = jnp.arange(n)

    def body(j, carry):
        A, Q, perm = carry
        rowmask = (rows >= j).astype(dtype)            # trailing rows
        colmask = cols >= j                            # trailing cols
        # -- pivot: trailing column with the largest partial norm ------
        norms2 = jnp.sum((A * rowmask[:, None]) ** 2, axis=0)
        p = jnp.argmax(jnp.where(colmask, norms2, -1.0))
        # -- swap columns j <-> p (gather by swapped index vector) -----
        swap = jnp.where(cols == j, p, jnp.where(cols == p, j, cols))
        A = A[:, swap]
        perm = perm[swap]
        # -- Householder reflector on the trailing part of column j ----
        x = A[:, j] * rowmask
        sigma = jnp.linalg.norm(x)
        xj = x[j]
        alpha = -jnp.sign(jnp.where(xj == 0, 1.0, xj)) * sigma
        v = x - alpha * (rows == j).astype(dtype)
        vnorm2 = jnp.sum(v * v)
        beta = jnp.where(vnorm2 > 0, 2.0 / jnp.maximum(vnorm2, 1e-300), 0.0)
        A = A - beta * jnp.outer(v, v @ A)
        # exact zeros below the diagonal of the finished column
        A = A.at[:, j].set(jnp.where(rows > j, 0.0, A[:, j]))
        Q = Q - beta * jnp.outer(Q @ v, v)
        return (A, Q, perm)

    Q0 = jnp.eye(m, dtype=dtype)
    A, Q, perm = jax.lax.fori_loop(
        0, k, body, (a, Q0, jnp.arange(n, dtype=jnp.int32)))
    return Q[:, :k], A[:k, :], perm


@lru_cache(maxsize=64)
def make_qrp(shape, dtype_str: str):
    from .tt_kernels import jit_f32
    return jit_f32(householder_qrp, dtype_str)


def qrp(a):
    """Convenience dispatcher: jitted householder_qrp cached per shape."""
    return make_qrp(tuple(a.shape), str(a.dtype))(a)
