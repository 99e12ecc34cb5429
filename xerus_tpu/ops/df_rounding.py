"""f64-quality TT rounding from f32 arithmetic: double-word sweeps.

The f32 scan kernels (ops/tt_kernels.py) round at ~1e-7 relative; eps
thresholds below that are invisible to them.  This module runs both
rounding passes in double-word f32, so truncation decisions and the kept
factors carry ~2^-48 accuracy — the reference's f64 `round()` semantics
(ttNetwork.cpp:644-685) without f64 arithmetic:

- orthogonalization: df CholeskyQR per site — Gram via Ozaki GEMM,
  blocked df Cholesky (ops/df_cholesky.py), df triangular solve.
  Gram squaring inside df keeps validity to kappa(M) ~ 2^24, far beyond
  any canonicalization carry.
- truncation: Gram-route df SVD (ops/df_eigh.py) per site; the dominant
  spectrum (what truncation keeps) is df-accurate.

Sequential over sites like the reference; each site's heavy work is
GEMMs.  Cores are plain (rl, n, rr) df pairs; ranks shrink to
min(target, achievable) like tt_round_sweep_uniform.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import List, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .df32 import df_add, df_sub, df_mul, df_from_f64, df_to_f64
from .ozaki import ozaki_matmul
from .df_cholesky import df_cholesky, _df_trsm_rlt
from .df_eigh import df_svd


def _df_qr_chol(Mh, Ml):
    """df thin QR of a tall (m, r) df matrix via CholeskyQR:
    G = M^T M (Ozaki), L = df_chol(G), Q = M L^-T, R = L^T."""
    Gh, Gl = ozaki_matmul(jnp.transpose(Mh), jnp.transpose(Ml), Mh, Ml)
    Lh, Ll = df_cholesky(Gh, Gl, block=min(64, Gh.shape[0]))
    Qh, Ql = _df_trsm_rlt(Mh, Ml, Lh, Ll)
    return Qh, Ql, jnp.transpose(Lh), jnp.transpose(Ll)


# per-site jitted pieces, cached by shape — eager per-op dispatch would pay
# one dispatch per df op, thousands per sweep
@lru_cache(maxsize=64)
def _jit_qr_apply(shape_key, nxt_key, dtype_str):
    """Orthogonalization step: CholeskyQR in df, with an in-program CGS2
    fallback when the Gram conditioning defeats it.

    df CholeskyQR squares the condition number inside the Gram matrix:
    directions with sigma/sigma_max below ~sqrt(u_df) ~ 3e-8 are lost and
    the Q factor silently carries O(1) garbage (observed: a TT sum with a
    1e-9-relative component, repaired to minimal boundary ranks, rounds
    to 0.9 relative error).  The fallback is the CGS2 df QR
    (mixed_precision.df_qr, stable for kappa * u_df < 1, i.e. kappa up
    to ~1e15); selection is a data-dependent lax.cond on the df
    orthogonality defect ||Q^T Q - I||, so well-conditioned inputs keep
    the fast GEMM path."""
    from .mixed_precision import df_qr as _df_qr_cgs2

    def f(Mh, Ml, nh, nl):
        Qh, Ql, Rh, Rl = _df_qr_chol(Mh, Ml)
        r = Qh.shape[1]
        Gh, Gl = ozaki_matmul(jnp.transpose(Qh), jnp.transpose(Ql), Qh, Ql)
        # df defect: Gh - I is Sterbenz-exact (diagonal ~1), and adding
        # the low word keeps the estimate meaningful below f32 resolution
        # — with Gh alone the ~2^-24 head-rounding noise floor sits ABOVE
        # the 1e-11 threshold and the fast path would never be taken
        defect = jnp.linalg.norm((Gh - jnp.eye(r, dtype=Gh.dtype)) + Gl)

        def cgs2_branch(_):
            (Q2h, Q2l), (R2h, R2l) = _df_qr_cgs2(Mh, Ml)
            return Q2h, Q2l, R2h, R2l

        def keep_branch(_):
            return Qh, Ql, Rh, Rl

        # threshold at the df quality target: CholQR's defect is
        # ~u_df*kappa^2, so panels with kappa <~ 1e2 keep the GEMM path
        # and anything that would leak >1e-11 orthogonality error into
        # the sweep takes CGS2
        Qh2, Ql2, Rh2, Rl2 = jax.lax.cond(
            defect > 1e-11, cgs2_branch, keep_branch, operand=None)
        Ph, Pl = ozaki_matmul(Rh2, Rl2, nh, nl)
        return Qh2, Ql2, Ph, Pl
    return jax.jit(f)


@lru_cache(maxsize=64)
def _jit_svd_site(shape_key, dtype_str):
    def f(Mh, Ml):
        return df_svd(jnp.transpose(Mh), jnp.transpose(Ml))
    return jax.jit(f)


@lru_cache(maxsize=64)
def _jit_trunc_apply(keep, u_key, v_key, prev_key, dtype_str):
    def f(Uh, Ul, Vh, Vl, sh, sl, ph, pl):
        USh, USl = df_mul(Vh[:, :keep], Vl[:, :keep],
                          sh[None, :keep], sl[None, :keep])
        Ph, Pl = ozaki_matmul(ph, pl, USh, USl)
        return (jnp.transpose(Uh[:, :keep]), jnp.transpose(Ul[:, :keep]),
                Ph, Pl)
    return jax.jit(f)


def tt_round_df(cores_h: Sequence[jnp.ndarray], cores_l: Sequence[jnp.ndarray],
                target_rank: int, eps: float = 0.0):
    """Round a df TT to `target_rank` (and/or relative eps) in double-word
    arithmetic.  Returns (cores_h, cores_l) lists with trimmed ranks."""
    d = len(cores_h)
    ch = [jnp.asarray(c) for c in cores_h]
    cl = [jnp.asarray(c) for c in cores_l]

    # ---- left->right df CholeskyQR orthogonalization ----
    for k in range(d - 1):
        rl, n, rr = ch[k].shape
        Mh = ch[k].reshape(rl * n, rr)
        Ml = cl[k].reshape(rl * n, rr)
        nh = ch[k + 1].reshape(rr, -1)
        nl = cl[k + 1].reshape(rr, -1)
        fn = _jit_qr_apply(tuple(Mh.shape), tuple(nh.shape), str(Mh.dtype))
        Qh, Ql, Ph, Pl = fn(Mh, Ml, nh, nl)
        ch[k] = Qh.reshape(rl, n, rr)
        cl[k] = Ql.reshape(rl, n, rr)
        ch[k + 1] = Ph.reshape(ch[k + 1].shape)
        cl[k + 1] = Pl.reshape(cl[k + 1].shape)

    # ---- right->left df SVD truncation ----
    for k in range(d - 1, 0, -1):
        rl, n, rr = ch[k].shape
        # SVD of the transposed unfolding (tall side first for the Gram)
        Mh = ch[k].reshape(rl, n * rr)
        Ml = cl[k].reshape(rl, n * rr)
        fn = _jit_svd_site(tuple(Mh.shape), str(Mh.dtype))
        Uh, Ul, sh, sl, Vh, Vl = fn(Mh, Ml)
        s_host = np.asarray(df_to_f64(np.asarray(sh), np.asarray(sl)))
        keep = int(min(target_rank, rl, n * rr))
        if eps > 0.0:
            keep = min(keep, max(1, int(np.sum(s_host > eps * s_host[0]))))
        # M^T = U S V^T  =>  M = (V S) U^T: core k <- U^T (row-orthonormal
        # (keep, n, rr)); carry V S into core k-1 (contract over rl)
        ph = ch[k - 1].reshape(-1, rl)
        pl = cl[k - 1].reshape(-1, rl)
        fn2 = _jit_trunc_apply(keep, tuple(Uh.shape), tuple(Vh.shape),
                               tuple(ph.shape), str(ph.dtype))
        Ut_h, Ut_l, Ph, Pl = fn2(Uh, Ul, Vh, Vl, sh, sl, ph, pl)
        ch[k] = Ut_h.reshape(keep, n, rr)
        cl[k] = Ut_l.reshape(keep, n, rr)
        shape = ch[k - 1].shape[:2] + (keep,)
        ch[k - 1] = Ph.reshape(shape)
        cl[k - 1] = Pl.reshape(shape)
    return ch, cl


def tt_round_df_from_f64(cores64: Sequence[np.ndarray], target_rank: int,
                         eps: float = 0.0):
    """Convenience: f64 host cores in, f64 host cores out (df inside)."""
    hs, ls = [], []
    for c in cores64:
        h, l = df_from_f64(np.asarray(c, np.float64))
        hs.append(jnp.asarray(h))
        ls.append(jnp.asarray(l))
    with jax.enable_x64(False), jax.default_matmul_precision("highest"):
        ch, cl = tt_round_df(hs, ls, target_rank, eps)
    return [df_to_f64(np.asarray(h), np.asarray(l))
            for h, l in zip(ch, cl)]
