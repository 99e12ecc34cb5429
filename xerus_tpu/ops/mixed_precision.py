"""Mixed-precision (double-word f32) TT operations: the on-device path to
1e-10 residuals.

Builds on ops/df32.py: tensor contractions, thin QR (CGS2) and a full SPD
ALS half-sweep carried out entirely in double-word precision, with the only
f32-approximate step being the Cholesky factorization used as a
preconditioner inside the refined local solves.  Everything jit-compiles to
one XLA program per half-sweep, like the f32 kernels in tt_kernels.py.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import List, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .df32 import (df_add, df_sub, df_mul, df_reduce_sum,
                   df_matvec, df_matmul, df_solve_spd_refined, fast_two_sum,
                   two_prod, df_from_f64, df_to_f64)

DF = Tuple[jnp.ndarray, jnp.ndarray]


# ---------------------------------------------------------------------------
# scalar helpers
# ---------------------------------------------------------------------------

def df_div(xh, xl, yh, yl):
    q1 = xh / yh
    # r = x - q1*y in df
    ph, pe = two_prod(q1, yh)
    pe = pe + q1 * yl
    rh, rl = df_sub(xh, xl, *fast_two_sum(ph, pe))
    q2 = rh / yh
    return fast_two_sum(q1, q2)


def df_sqrt(xh, xl):
    s = jnp.sqrt(jnp.maximum(xh, 0.0))
    ph, pe = two_prod(s, s)
    rh, rl = df_sub(xh, xl, ph, pe)
    e = jnp.where(s > 0, rh / jnp.maximum(2.0 * s, 1e-38), 0.0)
    return fast_two_sum(s, e)


def df_dot_vec(xh, xl, yh, yl):
    ph, pl = df_mul(xh, xl, yh, yl)
    return df_reduce_sum(ph, pl, axis=0)


def df_norm_vec(xh, xl):
    sh, sl = df_dot_vec(xh, xl, xh, xl)
    return df_sqrt(sh, sl)


# ---------------------------------------------------------------------------
# df tensordot (mirrors np.tensordot axes semantics)
# ---------------------------------------------------------------------------

def df_tensordot(a: DF, b: DF, axes) -> DF:
    ah, al = a
    bh, bl = b
    if isinstance(axes, int):
        a_axes = list(range(ah.ndim - axes, ah.ndim))
        b_axes = list(range(axes))
    else:
        a_axes = [ax % ah.ndim for ax in np.atleast_1d(axes[0])]
        b_axes = [ax % bh.ndim for ax in np.atleast_1d(axes[1])]
    a_free = [i for i in range(ah.ndim) if i not in a_axes]
    b_free = [i for i in range(bh.ndim) if i not in b_axes]
    at = jnp.transpose(ah, a_free + a_axes)
    alt = jnp.transpose(al, a_free + a_axes)
    bt = jnp.transpose(bh, b_axes + b_free)
    blt = jnp.transpose(bl, b_axes + b_free)
    k = int(np.prod([ah.shape[i] for i in a_axes])) if a_axes else 1
    m = int(np.prod([ah.shape[i] for i in a_free])) if a_free else 1
    n = int(np.prod([bh.shape[i] for i in b_free])) if b_free else 1
    oh, ol = df_matmul(at.reshape(m, k), alt.reshape(m, k),
                       bt.reshape(k, n), blt.reshape(k, n))
    shape = tuple(ah.shape[i] for i in a_free) + tuple(bh.shape[i] for i in b_free)
    return oh.reshape(shape), ol.reshape(shape)


# ---------------------------------------------------------------------------
# df thin QR via twice-reorthogonalized classical Gram-Schmidt (CGS2)
# ---------------------------------------------------------------------------

def df_qr(ah: jnp.ndarray, al: jnp.ndarray) -> Tuple[DF, DF]:
    """Thin QR of an (m, r) df matrix, m >= r.  Returns (Q, R) as df pairs.
    Sequential over columns; each step is df matvecs (CGS2)."""
    m, r = ah.shape
    dtype = ah.dtype
    # matrix scale for the deficiency test: a column whose post-projection
    # norm is f32-noise RELATIVE TO THE MATRIX (not merely to its own
    # original norm) carries no df-trustworthy direction — normalizing it
    # yields a column orthogonal only to ~f32 accuracy (~1e-8 |QtQ-I| for
    # a 1e-16-relative column), silently poisoning the
    # ALS frames and flooring the df sweep at f32 residuals.  Such columns
    # must take the exact canonical-vector fallback instead.
    mat_scale = jnp.sqrt(jnp.max(jnp.sum(ah * ah, axis=0)))

    def body(j, state):
        qh, ql, rh_, rl_ = state
        vh = jax.lax.dynamic_slice(ah, (0, j), (m, 1))[:, 0]
        vl = jax.lax.dynamic_slice(al, (0, j), (m, 1))[:, 0]
        orig_norm = jnp.sqrt(jnp.sum(vh * vh)) + 1e-38
        # two rounds of projection against the (zero-padded) current Q
        coefh = jnp.zeros((r,), dtype)
        coefl = jnp.zeros((r,), dtype)
        for _ in range(2):
            ch, cl = df_matvec(qh.T, ql.T, vh, vl)           # (r,)
            pjh, pjl = df_matvec(qh, ql, ch, cl)             # (m,)
            vh, vl = df_sub(vh, vl, pjh, pjl)
            coefh, coefl = df_add(coefh, coefl, ch, cl)
        nh, nl = df_norm_vec(vh, vl)
        # rank-deficient column: fall back to a projected canonical vector so
        # the frame stays orthonormal (the local problems need full rank).
        # The absolute floor catches exactly-zero columns whose relative
        # threshold underflows; without it 1/nh overflows the Veltkamp split.
        deficient = nh <= jnp.maximum(1e-12 * orig_norm,
                                      1e-13 * mat_scale) + 1e-30
        eh = jnp.zeros((m,), dtype).at[j % m].set(1.0)
        fch, fcl = df_matvec(qh.T, ql.T, eh, jnp.zeros_like(eh))
        fph, fpl = df_matvec(qh, ql, fch, fcl)
        fvh, fvl = df_sub(eh, jnp.zeros_like(eh), fph, fpl)
        fnh, fnl = df_norm_vec(fvh, fvl)
        vh = jnp.where(deficient, fvh, vh)
        vl = jnp.where(deficient, fvl, vl)
        nh2 = jnp.where(deficient, fnh, nh)
        nl2 = jnp.where(deficient, fnl, nl)
        inv_h, inv_l = df_div(jnp.ones((), dtype), jnp.zeros((), dtype),
                              jnp.maximum(nh2, 1e-20), nl2)
        qcol_h, qcol_l = df_mul(vh, vl, inv_h, inv_l)
        # R diagonal keeps the ORIGINAL (possibly ~0) norm
        nh = jnp.where(deficient, jnp.zeros((), dtype), nh)
        nl = jnp.where(deficient, jnp.zeros((), dtype), nl)
        qh = jax.lax.dynamic_update_slice(qh, qcol_h[:, None], (0, j))
        ql = jax.lax.dynamic_update_slice(ql, qcol_l[:, None], (0, j))
        # R column: projections + norm on the diagonal
        rcol_h = coefh.at[j].set(nh)
        rcol_l = coefl.at[j].set(nl)
        rh_ = jax.lax.dynamic_update_slice(rh_, rcol_h[:, None], (0, j))
        rl_ = jax.lax.dynamic_update_slice(rl_, rcol_l[:, None], (0, j))
        return qh, ql, rh_, rl_

    q0 = jnp.zeros((m, r), dtype)
    r0 = jnp.zeros((r, r), dtype)
    qh, ql, rh_, rl_ = jax.lax.fori_loop(0, r, body,
                                         (q0, jnp.zeros_like(q0),
                                          r0, jnp.zeros_like(r0)))
    return (qh, ql), (rh_, rl_)


# ---------------------------------------------------------------------------
# Mixed-precision SPD ALS half-sweep
# ---------------------------------------------------------------------------

def _als_half_sweep_df(x_cores: Sequence[DF], A_cores: Sequence[DF],
                       b_cores: Sequence[DF], refine_iters: int = 3):
    """Left->right single-site SPD half-sweep in df precision; x assumed
    canonicalized at 0 (df-orthogonal).  Mirrors
    tt_kernels._als_half_sweep."""
    d = len(x_cores)
    dtype = x_cores[0][0].dtype

    def dfc(val):
        return (jnp.asarray(val, dtype), jnp.zeros_like(jnp.asarray(val, dtype)))

    def env_push_right(xc: DF, Ac: DF, env: DF) -> DF:
        # env (u,a,v); out = einsum("umU,amnb,vnV,UbV->uav") pushed right:
        # given env over the RIGHT part (U,b,V) produce (u,a,v)
        t1 = df_tensordot(xc, env, axes=([2], [0]))          # (u,m,b,V)
        t2 = df_tensordot(t1, Ac, axes=([1, 2], [1, 3]))     # (u,V,a,n)
        t3 = df_tensordot(t2, xc, axes=([3, 1], [1, 2]))     # (u,a,v)
        return t3

    def rhs_push_right(xc: DF, bc: DF, env: DF) -> DF:
        t1 = df_tensordot(xc, env, axes=([2], [0]))          # (u,m,B)
        t2 = df_tensordot(t1, bc, axes=([1, 2], [1, 2]))     # (u,b)
        return t2

    one3 = dfc(jnp.ones((1, 1, 1), dtype))
    one2 = dfc(jnp.ones((1, 1), dtype))
    op_right: List[DF] = [one3]
    rhs_right: List[DF] = [one2]
    for k in range(d - 1, 0, -1):
        op_right.append(env_push_right(x_cores[k], A_cores[k], op_right[-1]))
        rhs_right.append(rhs_push_right(x_cores[k], b_cores[k], rhs_right[-1]))

    x_out = list(x_cores)
    op_left: DF = one3
    rhs_left: DF = one2
    for k in range(d):
        Ac = A_cores[k]
        bc = b_cores[k]
        Renv = op_right[d - 1 - k]
        Rrhs = rhs_right[d - 1 - k]
        # Aloc[(u m U),(v n V)] = L[u,a,v] A[a,m,n,b] R[U,b,V]
        t = df_tensordot(op_left, Ac, axes=([1], [0]))       # (u,v,m,n,b)
        t = df_tensordot(t, Renv, axes=([4], [1]))           # (u,v,m,n,U,V)
        th, tl = t
        th = jnp.transpose(th, (0, 2, 4, 1, 3, 5))           # (u,m,U,v,n,V)
        tl = jnp.transpose(tl, (0, 2, 4, 1, 3, 5))
        u_, m_, U_ = th.shape[0], th.shape[1], th.shape[2]
        nn = u_ * m_ * U_
        Aloc = (th.reshape(nn, nn), tl.reshape(nn, nn))
        # bloc[u m U] = Lb[u,b] b[b,m,B] Rb[U,B]
        t = df_tensordot(rhs_left, bc, axes=([1], [0]))      # (u,m,B)
        t = df_tensordot(t, Rrhs, axes=([2], [1]))           # (u,m,U)
        bloc = (t[0].reshape(nn), t[1].reshape(nn))

        xh, xl = df_solve_spd_refined(Aloc[0], Aloc[1], bloc[0], bloc[1],
                                      iterations=refine_iters)
        core = (xh.reshape(u_, m_, U_), xl.reshape(u_, m_, U_))
        if k < d - 1:
            (Qh, Ql), (Rh, Rl) = df_qr(core[0].reshape(u_ * m_, U_),
                                       core[1].reshape(u_ * m_, U_))
            kk = Qh.shape[1]
            x_out[k] = (Qh.reshape(u_, m_, kk), Ql.reshape(u_, m_, kk))
            nxt = x_out[k + 1]
            x_out[k + 1] = df_tensordot((Rh, Rl), nxt, axes=([1], [0]))
            op_left = _env_push_left(x_out[k], Ac, op_left)
            rhs_left = _rhs_push_left(x_out[k], bc, rhs_left)
        else:
            x_out[k] = core
    return tuple(x_out)


def _env_push_left(xc: DF, Ac: DF, env: DF) -> DF:
    t1 = df_tensordot(env, xc, axes=([0], [0]))          # (a,v,m,U)
    t2 = df_tensordot(t1, Ac, axes=([0, 2], [0, 1]))     # (v,U,n,b)
    t3 = df_tensordot(t2, xc, axes=([0, 2], [0, 1]))     # (U,b,V)
    return t3


def _rhs_push_left(xc: DF, bc: DF, env: DF) -> DF:
    t1 = df_tensordot(env, xc, axes=([0], [0]))          # (b,m,U)
    t2 = df_tensordot(t1, bc, axes=([0, 1], [0, 1]))     # (U,B)
    return t2


@lru_cache(maxsize=16)
def make_df_als_sweep(shapes_key, dtype_str: str, refine_iters: int = 3):
    from .tt_kernels import jit_f32
    return jit_f32(partial(_als_half_sweep_df, refine_iters=refine_iters),
                   dtype_str)


def _reverse_df(cores, op=False):
    perm = (3, 1, 2, 0) if op else (2, 1, 0)
    return tuple((jnp.transpose(h, perm), jnp.transpose(l, perm))
                 for (h, l) in reversed(cores))


@lru_cache(maxsize=8)
def make_df_als_multi_sweep(shapes_key, dtype_str: str, n_half_sweeps: int,
                            refine_iters: int = 3):
    """N df half-sweeps chained inside ONE XLA program, alternating
    direction via in-program site reversal (exact transposes).  One
    dispatch for the whole f64-quality refinement phase instead of one
    per half-sweep."""
    from .tt_kernels import jit_f32

    def multi(x_df, A_df, b_df):
        rev = False
        for s in range(n_half_sweeps):
            x_df = _als_half_sweep_df(x_df, A_df, b_df,
                                      refine_iters=refine_iters)
            x_df = _reverse_df(x_df)
            A_df = _reverse_df(A_df, op=True)
            b_df = _reverse_df(b_df)
            rev = not rev
        if rev:
            x_df = _reverse_df(x_df)
        return x_df

    return jit_f32(multi, dtype_str)


@lru_cache(maxsize=8)
def make_als_f32_df_run(shapes_key, dtype_str: str, max_f32_sweeps: int,
                        df_sweeps: int, refine_iters: int = 3):
    """The WHOLE mixed-precision solve as ONE XLA program: a lax.while_loop
    of f32 SPD half-sweeps (lr/rl by parity, fused relative residual) that
    stops at the f32 plateau (res > 0.3 * res_two_sweeps_ago — the
    measured e2e auto-stop rule), then an in-program df seed (hi = f32
    cores, lo = 0) and ``df_sweeps`` df half-sweeps with in-program site
    reversal.  One dispatch for the full f64-quality solve: the staged
    driver paid one dispatch + one history fetch per 2-sweep program plus
    a seed dispatch.

    Returns (df_cores, f32_hist, f32_count)."""
    from .tt_kernels import (jit_f32, _als_half_sweep, _als_half_sweep_rl,
                             tt_residual_rel)

    # the df phase needs the core at site 0 (an lr-ended f32 state NaNs
    # its canonicalization assumption), so BOTH exits of the f32 loop —
    # the plateau stop and the sweep cap — must land on even counts
    max_even = max_f32_sweeps - (max_f32_sweeps % 2)

    def run(x32, A32, b32, A_df, b_df):
        dtype = x32[0].dtype
        inf = jnp.asarray(jnp.inf, dtype)

        def cond(carry):
            _cs, _h, i, _r1, _r2, stop = carry
            return jnp.logical_and(i < max_even,
                                   jnp.logical_not(stop))

        def body(carry):
            cores, hist, i, r_prev, r_prev2, _stop = carry
            cores = jax.lax.cond(
                i % 2 == 0,
                lambda cs: _als_half_sweep(cs, A32, b32),
                lambda cs: _als_half_sweep_rl(cs, A32, b32),
                cores)
            res = tt_residual_rel(cores, A32, b32)
            hist = hist.at[i].set(res)
            # no longer improving 3x per sweep — but only stop on EVEN
            # sweep counts (after an rl sweep): the df phase needs the
            # core at site 0, and an lr-ended state (core at d-1) breaks
            # its canonicalization assumption (observed: df NaN)
            stop = jnp.logical_and(res > 0.3 * r_prev2, i % 2 == 1)
            return (cores, hist, i + 1, res, r_prev, stop)

        hist0 = jnp.full((max_f32_sweeps,), jnp.inf, dtype)
        carry = (tuple(x32), hist0, jnp.zeros((), jnp.int32), inf, inf,
                 jnp.zeros((), jnp.bool_))
        cores, hist, cnt, _r1, _r2, _s = jax.lax.while_loop(cond, body,
                                                            carry)
        x_df = tuple((c, jnp.zeros_like(c)) for c in cores)
        for s in range(df_sweeps):
            x_df = _als_half_sweep_df(x_df, A_df, b_df,
                                      refine_iters=refine_iters)
            x_df = _reverse_df(x_df)
            A_df = _reverse_df(A_df, op=True)
            b_df = _reverse_df(b_df)
        if df_sweeps % 2 == 1:
            x_df = _reverse_df(x_df)
        return x_df, hist, cnt

    return jit_f32(run, dtype_str)


def als_spd_mixed(A, x, b, num_half_sweeps: int = 6):
    """Mixed-precision single-site SPD ALS on TT objects: ALL half-sweeps
    run as ONE jitted df program (make_df_als_multi_sweep), alternating
    direction via in-program site reversal.  Residual verification stays
    in host float64 — the df quadratic form would cancel below ~1e-7.
    Returns the refined f64 cores."""
    from ..config import host, require
    x = x.copy()
    with host():   # object-level prep uses host LAPACK
        # the df local solves are Cholesky-based: symmetric operators only
        # (general operators: xe.ALS_SPD auto-selects LU local solves)
        require(A.is_symmetric(),
                "als_spd_mixed requires a symmetric operator; "
                "use xe.ALS_SPD for general operators")
        x.move_core(0)
    d = x.num_components()

    def to_df_list(cores, is_op=False):
        return tuple(df_from_f64(np.asarray(c.to_ndarray(), np.float64))
                     for c in cores)

    x_df = to_df_list(x.components)
    A_df = to_df_list(A.components, True)
    b_df = to_df_list(b.components)

    # 2-half-sweep programs dispatched repeatedly: each program starts
    # and ends site-UNreversed, so chaining them is exact — this keeps
    # the compile bounded (a 2-half-sweep df program is already a large
    # compile; chaining all num_half_sweeps into one program scales it
    # with the sweep count) while still amortizing the
    # per-half-sweep dispatch + reversal dispatches of the old loop.
    # Odd counts round up to the next even (one extra cheap half-sweep).
    shapes_key = tuple(tuple(h.shape) for h, _ in x_df)
    fn = make_df_als_multi_sweep(shapes_key, "float32", 2)
    for _ in range((int(num_half_sweeps) + 1) // 2):
        x_df = fn(x_df, A_df, b_df)
    return [df_to_f64(h, l) for (h, l) in x_df]
