"""Blocked double-word Cholesky: f64-quality SPD factorization in f32.

The refined solve in ops/df32.py (f32 Cholesky + df residual refinement)
requires kappa * 2^-24 < 1 — beyond that the f32 factorization itself
produces negative pivots and NaNs.  This module factorizes IN double-word
f32 end to end, so positivity is judged at ~2^-48 resolution and the
usable condition range extends to kappa ~ 2^48:

- diagonal blocks + panel triangular solves: masked column-sequential df
  arithmetic (ops/df32.py EFTs) under `lax.fori_loop`;
- trailing updates (all the FLOPs): Ozaki split GEMMs (ops/ozaki.py),
  exact bf16 slice products.

The solve applies the df factor via f32 triangular substitution inside a
df iterative refinement loop: the f32 trsm error scales with kappa(L) =
sqrt(kappa(A)) * 2^-24, which stays < 1 up to kappa(A) ~ 2^48.

The reference's analogue is LAPACK dpotrf/dpotrs (blasLapackWrapper.cpp,
used by Tensor::solve's SPD path tensor.cpp:1583-1704); this reaches its
f64 quality from f32 arithmetic.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .df32 import (df_add, df_sub, df_mul, df_reduce_sum, fast_two_sum,
                   df_matvec)
from .mixed_precision import df_div, df_sqrt
from .ozaki import ozaki_matmul


def _df_chol_unblocked(Ah, Al):
    """Masked column-sequential df Cholesky of a (B, B) df SPD block.
    Returns lower-triangular (Lh, Ll)."""
    B = Ah.shape[0]
    dtype = Ah.dtype
    idx = jnp.arange(B, dtype=jnp.int32)

    def col(j, carry):
        Lh, Ll = carry
        rjh = jax.lax.dynamic_slice_in_dim(Lh, j, 1, axis=0)[0]   # (B,)
        rjl = jax.lax.dynamic_slice_in_dim(Ll, j, 1, axis=0)[0]
        ph, pl = df_mul(Lh, Ll, rjh[None, :], rjl[None, :])
        sh, sl = df_reduce_sum(ph, pl, axis=1)                    # (B,)
        ah = jax.lax.dynamic_slice_in_dim(Ah, j, 1, axis=1)[:, 0]
        al = jax.lax.dynamic_slice_in_dim(Al, j, 1, axis=1)[:, 0]
        sh, sl = df_sub(ah, al, sh, sl)
        djh = jnp.take(sh, j)
        djl = jnp.take(sl, j)
        dh, dl = df_sqrt(jnp.maximum(djh, 1e-30), djl)
        ch, cl = df_div(sh, sl, dh, dl)
        below = (idx > j).astype(dtype)
        diag = (idx == j).astype(dtype)
        newh = ch * below + dh * diag
        newl = cl * below + dl * diag
        Lh = jax.lax.dynamic_update_slice_in_dim(Lh, newh[:, None], j, axis=1)
        Ll = jax.lax.dynamic_update_slice_in_dim(Ll, newl[:, None], j, axis=1)
        return Lh, Ll

    Lh, Ll = jax.lax.fori_loop(0, B, col,
                               (jnp.zeros_like(Ah), jnp.zeros_like(Al)))
    return Lh, Ll


def _df_trsm_rlt(Ah, Al, Lkh, Lkl):
    """Solve X Lkk^T = A for X, Lkk (B, B) lower-triangular df, A (m, B) df.
    Column-sequential df substitution."""
    m, B = Ah.shape
    dtype = Ah.dtype
    idx = jnp.arange(B, dtype=jnp.int32)

    def col(j, carry):
        Xh, Xl = carry
        rjh = jax.lax.dynamic_slice_in_dim(Lkh, j, 1, axis=0)[0]  # (B,)
        rjl = jax.lax.dynamic_slice_in_dim(Lkl, j, 1, axis=0)[0]
        # s = A[:, j] - X @ Lkk[j, :]^T (columns >= j of X are still zero)
        ph, pl = df_mul(Xh, Xl, rjh[None, :], rjl[None, :])
        sh, sl = df_reduce_sum(ph, pl, axis=1)
        ah = jax.lax.dynamic_slice_in_dim(Ah, j, 1, axis=1)[:, 0]
        al = jax.lax.dynamic_slice_in_dim(Al, j, 1, axis=1)[:, 0]
        sh, sl = df_sub(ah, al, sh, sl)
        djh = jnp.take(rjh, j)
        djl = jnp.take(rjl, j)
        ch, cl = df_div(sh, sl, djh, djl)
        Xh = jax.lax.dynamic_update_slice_in_dim(Xh, ch[:, None], j, axis=1)
        Xl = jax.lax.dynamic_update_slice_in_dim(Xl, cl[:, None], j, axis=1)
        return Xh, Xl

    Xh, Xl = jax.lax.fori_loop(0, B, col,
                               (jnp.zeros_like(Ah), jnp.zeros_like(Al)))
    return Xh, Xl


def df_cholesky(Ah, Al, block: int = 64):
    """Blocked right-looking df Cholesky of an (n, n) SPD df matrix.
    n must be a multiple of `block` (pad with an identity tail otherwise).
    Returns lower-triangular (Lh, Ll)."""
    n = Ah.shape[0]
    B = min(block, n)
    require_pad = n % B
    if require_pad:
        pad = B - require_pad
        eye = jnp.eye(pad, dtype=Ah.dtype)
        Ah = jnp.block([[Ah, jnp.zeros((n, pad), Ah.dtype)],
                        [jnp.zeros((pad, n), Ah.dtype), eye]])
        Al = jnp.pad(Al, ((0, pad), (0, pad)))
        n = n + pad
    Lh = jnp.zeros_like(Ah)
    Ll = jnp.zeros_like(Al)
    for k in range(0, n, B):
        Akkh = Ah[k:k + B, k:k + B]
        Akkl = Al[k:k + B, k:k + B]
        Lkh, Lkl = _df_chol_unblocked(Akkh, Akkl)
        Lh = Lh.at[k:k + B, k:k + B].set(Lkh)
        Ll = Ll.at[k:k + B, k:k + B].set(Lkl)
        if k + B < n:
            A21h = Ah[k + B:, k:k + B]
            A21l = Al[k + B:, k:k + B]
            X21h, X21l = _df_trsm_rlt(A21h, A21l, Lkh, Lkl)
            Lh = Lh.at[k + B:, k:k + B].set(X21h)
            Ll = Ll.at[k + B:, k:k + B].set(X21l)
            # trailing update: A22 -= L21 L21^T (Ozaki GEMM)
            Uh, Ul = ozaki_matmul(X21h, X21l,
                                  jnp.transpose(X21h), jnp.transpose(X21l))
            th, tl = df_sub(Ah[k + B:, k + B:], Al[k + B:, k + B:], Uh, Ul)
            Ah = Ah.at[k + B:, k + B:].set(th)
            Al = Al.at[k + B:, k + B:].set(tl)
    if require_pad:
        m = n - (B - require_pad)
        return Lh[:m, :m], Ll[:m, :m]
    return Lh, Ll


def df_solve_spd_chol(Ah, Al, bh, bl, block: int = 64,
                      refine_iters: int = 3):
    """Solve SPD A x = b at df precision via the blocked df Cholesky.

    The factor is applied in f32 (two triangular substitutions) inside a
    df residual-refinement loop; valid for kappa(A) up to ~2^48 — far past
    the 2^24 wall of the plain-f32-factorization solve
    (ops/df32.py df_solve_spd_refined).  Returns (xh, xl)."""
    from jax.scipy.linalg import solve_triangular
    Lh, Ll = df_cholesky(Ah, Al, block)

    def apply_inv(rh):
        y = solve_triangular(Lh, rh, lower=True)
        return solve_triangular(Lh.T, y, lower=False)

    xh = apply_inv(bh + bl)
    xl = jnp.zeros_like(xh)
    for _ in range(refine_iters):
        Axh, Axl = df_matvec(Ah, Al, xh, xl)
        rh, rl = df_sub(bh, bl, Axh, Axl)
        d = apply_inv(rh + rl)
        xh, xl = df_add(xh, xl, d, jnp.zeros_like(d))
    return xh, xl


@lru_cache(maxsize=16)
def make_df_solve_spd_chol(n: int, dtype_str: str, block: int = 64,
                           refine_iters: int = 3):
    from .tt_kernels import jit_f32
    return jit_f32(partial(df_solve_spd_chol, block=block,
                           refine_iters=refine_iters), dtype_str)
