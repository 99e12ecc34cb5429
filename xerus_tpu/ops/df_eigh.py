"""Double-word symmetric eigendecomposition: f32 eigh + Ogita-Aishima
refinement with Ozaki GEMMs.

Completes the df precision stack (ops/df32.py, ops/ozaki.py,
ops/df_cholesky.py): given a symmetric df matrix, an f32 `eigh` seeds
approximate eigenvectors, then each refinement iteration (Ogita & Aishima,
"Iterative refinement for symmetric eigenvalue decomposition", JSIAM 2018)
computes

    R = I - V^T V,   S = V^T A V        (df-accurate Ozaki GEMMs)
    lambda_i = S_ii / (V^T V)_ii        (refined Rayleigh quotients)
    E_ij = (S_ij + lambda_j R_ij) / (lambda_j - lambda_i),  E_ii = R_ii / 2
    V <- V + V E                        (Ozaki GEMM, df accumulate)

E is O(u) small, so computing it in f32 costs only O(u^2) = O(2^-48) in the
result; convergence is quadratic while eigenvalue gaps exceed the current
error.  Clustered eigenvalues cap the attainable accuracy at
~u_df / gap — returned as is (document, don't hide).

The reference's analogue is LAPACK dsyev via blasLapackWrapper; this is
its f64-quality version from f32 arithmetic.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .df32 import df_add, df_sub
from .ozaki import ozaki_matmul


def df_eigh(Ah: jnp.ndarray, Al: jnp.ndarray, iters: int = 6):
    """Symmetric df eigendecomposition.  Returns (wh, wl, Vh, Vl) with
    eigenvalues ascending (f32-eigh order preserved)."""
    n = Ah.shape[0]
    dtype = Ah.dtype
    w0, V0 = jnp.linalg.eigh(Ah)
    Vh, Vl = V0, jnp.zeros_like(V0)
    lam_h, lam_l = w0, jnp.zeros_like(w0)
    eye = jnp.eye(n, dtype=dtype)

    for _ in range(iters):
        # Gram and Rayleigh matrices at df accuracy
        Gh, Gl = ozaki_matmul(jnp.transpose(Vh), jnp.transpose(Vl), Vh, Vl)
        AVh, AVl = ozaki_matmul(Ah, Al, Vh, Vl)
        Sh, Sl = ozaki_matmul(jnp.transpose(Vh), jnp.transpose(Vl), AVh, AVl)
        Rh, Rl = df_sub(eye, jnp.zeros_like(eye), Gh, Gl)
        # refined Rayleigh quotients (df diagonal ratio; G_ii ~ 1)
        gd_h = jnp.diagonal(Gh)
        gd_l = jnp.diagonal(Gl)
        sd_h = jnp.diagonal(Sh)
        sd_l = jnp.diagonal(Sl)
        from .mixed_precision import df_div
        lam_h, lam_l = df_div(sd_h, sd_l, gd_h, gd_l)
        # correction E in f32: it is O(u)-small, so f32 costs O(u^2)
        lam = lam_h + lam_l
        denom = lam[None, :] - lam[:, None]
        # truly degenerate pairs (gap at the df noise floor of the GLOBAL
        # spectral scale) get the orthogonality-only correction R/2 — any
        # orthonormal basis of a degenerate cluster is fine; everything
        # else takes the full Ogita-Aishima step, trust-clipped so a
        # marginal gap can't blow the linearization up (it then converges
        # over extra iterations instead)
        scale = jnp.max(jnp.abs(lam)) + 1e-30
        tiny_gap = jnp.abs(denom) <= 1e-8 * scale
        safe = jnp.where(tiny_gap, 1.0, denom)
        E_full = (Sh + Sl + lam[None, :] * (Rh + Rl)) / safe
        E = jnp.where(tiny_gap, (Rh + Rl) / 2.0, E_full)
        E = jnp.clip(E, -0.25, 0.25)
        # diagonal: exactly R_ii/2 (tiny_gap always includes the diagonal,
        # so zero it out of the off-diagonal branch first)
        offdiag = 1.0 - eye
        E = E * offdiag + jnp.diag(jnp.diagonal(Rh + Rl) / 2.0)
        # divergence gate, PER COLUMN: a healthy OA column has its R
        # column << 1; freeze only columns an out-of-contract cluster
        # has pumped up (a global ||R|| gate permanently froze the WHOLE
        # refinement on Jordan-Wielandt matrices, whose near-zero
        # +-sigma cluster inflates R while the live columns are fine —
        # measured: eigen-residuals stuck after iteration 2)
        rcol = jnp.sqrt(jnp.sum((Rh + Rl) ** 2, axis=0))
        gate = (rcol < 0.1).astype(dtype)[None, :]
        dVh, dVl = ozaki_matmul(Vh, Vl, E, jnp.zeros_like(E))
        Vh, Vl = df_add(Vh, Vl, dVh * gate, dVl * gate)
    return lam_h, lam_l, Vh, Vl


@lru_cache(maxsize=16)
def make_df_eigh(n: int, dtype_str: str, iters: int = 6):
    from .tt_kernels import jit_f32
    return jit_f32(partial(df_eigh, iters=iters), dtype_str)


def df_svd(Ah: jnp.ndarray, Al: jnp.ndarray, iters: int = 6):
    """Thin df SVD of an (m, n) df matrix, m >= n, via the Gram route:
    G = A^T A (Ozaki GEMM) -> df_eigh -> sigma = sqrt(eigenvalues),
    U = A V / sigma.  Gram squaring halves the attainable relative
    accuracy of SMALL singular values (sigma_i below ~2^-24 * sigma_max
    come back at f32 quality; the dominant spectrum is df-accurate) —
    same trade as the 'gram' rounding kernel.  Returns
    (Uh, Ul, sh, sl, Vh, Vl) with singular values DESCENDING."""
    from .mixed_precision import df_sqrt, df_div
    m, n = Ah.shape
    Gh, Gl = ozaki_matmul(jnp.transpose(Ah), jnp.transpose(Al), Ah, Al)
    wh, wl, Vh, Vl = df_eigh(Gh, Gl, iters=iters)
    # descending order
    order = jnp.argsort(-wh)
    wh = jnp.take(wh, order)
    wl = jnp.take(wl, order)
    Vh = jnp.take(Vh, order, axis=1)
    Vl = jnp.take(Vl, order, axis=1)
    sh, sl = df_sqrt(jnp.maximum(wh, 0.0), jnp.where(wh > 0, wl, 0.0))
    AVh, AVl = ozaki_matmul(Ah, Al, Vh, Vl)
    # sigma below the Gram noise floor (~2^-24 * sigma_max) cannot be
    # inverted meaningfully: zero those directions instead.  NOTE: divide
    # DIRECTLY rather than multiplying by a df reciprocal — under one jit
    # XLA folds reciprocal-then-multiply back into a single f32 divide and
    # the double-word accuracy silently drops to 2^-24
    tiny = 6e-8 * jnp.max(sh) + jnp.asarray(1e-30, Ah.dtype)
    dead = (sh <= tiny).astype(Ah.dtype)
    Uh, Ul = df_div(AVh, AVl,
                    jnp.maximum(sh, tiny)[None, :],
                    jnp.where(sh > tiny, sl, 0.0)[None, :])
    Uh = Uh * (1.0 - dead)[None, :]
    Ul = Ul * (1.0 - dead)[None, :]
    # renormalize U columns: exact arithmetic gives unit columns, so this
    # only absorbs sigma estimation error — it keeps U bounded even where
    # sigma_i sits at the Gram noise floor (~2^-24 * sigma_max, where the
    # Gram route's accuracy ends; see docstring)
    cn = jnp.sqrt(jnp.sum((Uh + Ul) ** 2, axis=0))
    sick = jnp.abs(cn - 1.0) > 1e-4          # healthy columns stay exact df
    cinv = jnp.where(cn > 1e-30, 1.0 / jnp.maximum(cn, 1e-30), 0.0)
    factor = jnp.where(sick, cinv, 1.0)
    Uh = Uh * factor[None, :]
    Ul = Ul * factor[None, :]
    return Uh, Ul, sh, sl, Vh, Vl


def df_svd_jw(Ah: jnp.ndarray, Al: jnp.ndarray, iters: int = 6):
    """df SVD via the Jordan-Wielandt embedding — FULL small-sigma
    accuracy (the Gram route's documented limitation; ROADMAP item).

    The symmetric (m+n) x (m+n) matrix J = [[0, A], [A^T, 0]] has
    eigenvalues {+-sigma_i} (plus m-n zeros) and eigenvectors
    (1/sqrt 2)[u_i; +-v_i]: running the Ogita-Aishima df refinement on J
    refines the singular triplets DIRECTLY, never forming A^T A.
    Measured absolute sigma accuracy ~1e-8..1e-9 * sigma_max (bounded by
    df_eigh's degenerate-cluster threshold where the +-sigma pair
    merges), vs the Gram route's ~2e-5 * sigma_max floor — about three
    orders of magnitude on small singular values.  Costs an
    (m+n)-sized eigh against the Gram route's n-sized one — use for
    near-square matrices whose small spectrum matters (the Gram
    `df_svd` stays the default for dominant-spectrum work).

    Vector contract (measured): U/V blocks orthonormal to ~1e-3 for
    sigma >= 1e-6 * sigma_max; smaller singular directions degrade as
    ~u_df * sigma_max / sigma — the frozen near-zero +-sigma cluster
    injects that much basis noise per OA iteration (deflated/blocked OA
    would push further; not needed for the df-rounding use cases).
    Directions below 1e-8 * sigma_max are zeroed (+-pair selection is
    ambiguous there).  Returns (Uh, Ul, sh, sl, Vh, Vl), singular
    values DESCENDING."""
    m, n = Ah.shape
    dtype = Ah.dtype
    zmm = jnp.zeros((m, m), dtype)
    znn = jnp.zeros((n, n), dtype)
    Jh = jnp.block([[zmm, Ah], [jnp.transpose(Ah), znn]])
    Jl = jnp.block([[zmm, Al], [jnp.transpose(Al), znn]])
    wh, wl, Qh, Ql = df_eigh(Jh, Jl, iters=iters)
    order = jnp.argsort(-wh)[:n]              # top n = +sigma, descending
    sh = jnp.take(wh, order)
    sl = jnp.take(wl, order)
    sh = jnp.maximum(sh, 0.0)
    sl = jnp.where(sh > 0, sl, 0.0)
    Qh = jnp.take(Qh, order, axis=1)
    Ql = jnp.take(Ql, order, axis=1)
    rt2 = np.sqrt(np.float64(2.0))
    rt2_h = jnp.asarray(np.float32(rt2), dtype)
    rt2_l = jnp.asarray(np.float32(rt2 - np.float64(np.float32(rt2))), dtype)
    from .df32 import df_mul
    Uh, Ul = df_mul(Qh[:m], Ql[:m], rt2_h, rt2_l)
    Vh, Vl = df_mul(Qh[m:], Ql[m:], rt2_h, rt2_l)
    # vector floor: below df_eigh's degenerate-cluster threshold
    # (1e-8 * spectral scale) the +-sigma pair is unresolved and the
    # selection can pick BOTH members of one pair (parallel U columns,
    # measured at sigma ~ 2e-10 * sigma_max) — zero those directions,
    # exactly like the Gram route zeroes its dead columns.  Sigma VALUES
    # stay accurate to ~1e-8 * sigma_max absolute (the same threshold).
    dead = (sh <= 1e-8 * jnp.max(sh)).astype(dtype)
    Uh = Uh * (1.0 - dead)[None, :]
    Ul = Ul * (1.0 - dead)[None, :]
    Vh = Vh * (1.0 - dead)[None, :]
    Vl = Vl * (1.0 - dead)[None, :]
    # absorb block-norm error for columns in the near-zero cluster (any
    # basis is valid there; keep the blocks orthonormal)
    cu = jnp.sqrt(jnp.sum((Uh + Ul) ** 2, axis=0))
    cv = jnp.sqrt(jnp.sum((Vh + Vl) ** 2, axis=0))
    fu = jnp.where(jnp.abs(cu - 1.0) > 1e-4,
                   jnp.where(cu > 1e-30, 1.0 / jnp.maximum(cu, 1e-30), 0.0),
                   1.0)
    fv = jnp.where(jnp.abs(cv - 1.0) > 1e-4,
                   jnp.where(cv > 1e-30, 1.0 / jnp.maximum(cv, 1e-30), 0.0),
                   1.0)
    Uh = Uh * fu[None, :]
    Ul = Ul * fu[None, :]
    Vh = Vh * fv[None, :]
    Vl = Vl * fv[None, :]
    return Uh, Ul, sh, sl, Vh, Vl
