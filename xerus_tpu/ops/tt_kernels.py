"""Fully-jitted TT hot-path kernels (the bench-critical compute chains).

These are the accelerator fast paths for the operations behind the north-star
metric (BASELINE.md): the TT-rounding QR+SVD chain
(reference: ttNetwork.cpp:644 + tensorNetwork.cpp:678) and the ALS sweep
(als.cpp:483-564).  Unlike the generic object layer (tt/ttnetwork.py), which
dispatches op-by-op through Tensor objects, each function here compiles the
ENTIRE sweep into one XLA program: static shapes, no host sync, GEMM-shaped
matricizations.

Truncation ranks are static (compiled into the program); rank-adaptive paths
re-jit per rank tuple, cached by shape signature.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import List, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp


def jit_f32(fn, dtype_str: str = "float32"):
    """jit wrapper for the float32 fast paths: traces/executes with jax
    x64 OFF and matmul precision HIGHEST.

    - x64 off keeps an f32 kernel in f32: with x64 on, Python scalars,
      iotas and index arithmetic inside the trace default to 64-bit types
      and can promote intermediates.
    - An accelerator's DEFAULT f32 matmul precision is reduced (TF32 on
      NVIDIA tensor cores, about three decimal digits) — enough to stall
      an ALS solve far above the f32 residual floor.  HIGHEST keeps
      genuine f32 arithmetic.

    Any other ``dtype_str`` (the float64 object semantics) gets a plain
    jit: f64 kernels run natively."""
    from ..misc.performance import pa_section
    jfn = jax.jit(fn)
    name = getattr(fn, "__qualname__", None) or getattr(
        getattr(fn, "func", None), "__qualname__", "kernel")

    if dtype_str != "float32":
        def wrapped64(*args, **kwargs):
            # host-side dispatch accounting (reference wraps every kernel
            # call in XERUS_PA_START/END, blasLapackWrapper.cpp:582)
            with pa_section("TT Kernels", name, dtype_str):
                return jfn(*args, **kwargs)
        return wrapped64

    def wrapped(*args, **kwargs):
        with pa_section("TT Kernels", name, dtype_str), \
                jax.enable_x64(False), \
                jax.default_matmul_precision("highest"):
            return jfn(*args, **kwargs)

    return wrapped


def chol_orth_cols(X, shift_rels=None, want_r: bool = False):
    """Shifted-CholQR column orthonormalization — the GEMM+Cholesky-only
    replacement for QR/SVD (a Gram GEMM and a Cholesky instead of a
    latency-bound sequential factorization).  One Gram +
    shifted Cholesky + triangular solve per entry of ``shift_rels``
    (relative diagonal shifts; default one 10*eps pass — each single
    shifted pass leaves ~u*kappa^2 orthogonality error, so callers
    needing tight Q^T Q = I chain passes).  want_r=True returns
    (Q, Rtot) with X = Q @ Rtot.  Shared by the subspace/segmented
    rounding kernels and parallel/tsqr_round."""
    from jax.scipy.linalg import solve_triangular
    dtype = X.dtype
    eye = jnp.eye(X.shape[1], dtype=dtype)
    tiny = jnp.asarray(1e-30, dtype)
    if shift_rels is None:
        shift_rels = (10 * float(jnp.finfo(dtype).eps),)
    Rtot = eye
    for rel in shift_rels:
        G = X.T @ X
        shift = jnp.asarray(rel, dtype) * jnp.max(jnp.diagonal(G)) + tiny
        L = jnp.linalg.cholesky(G + shift * eye)
        X = solve_triangular(L, X.T, lower=True).T
        if want_r:
            Rtot = L.T @ Rtot
    return (X, Rtot) if want_r else X


# ---------------------------------------------------------------------------
# TT rounding: left-orthogonalize (QR sweep), then truncate (SVD sweep)
# ---------------------------------------------------------------------------

def _round_sweep(cores: Tuple[jnp.ndarray, ...], target_rank: int):
    """cores[i]: (r_l, n, r_r); returns truncated cores, core at 0.

    The carried R/US factors are renormalized per step with the log-scale
    accumulated separately, then redistributed evenly — in float32 the raw
    chain overflows once the TT norm exceeds ~1e38 (which a d=32 random TT
    easily does)."""
    d = len(cores)
    cores = list(cores)
    dtype = cores[0].dtype
    log_scale = jnp.zeros((), dtype=dtype)
    # QR sweep left -> right (canonicalize_right, ttNetwork.cpp:638)
    for i in range(d - 1):
        rl, n, rr = cores[i].shape
        q, r = jnp.linalg.qr(cores[i].reshape(rl * n, rr))
        k = q.shape[1]
        cores[i] = q.reshape(rl, n, k)
        nrm = jnp.linalg.norm(r) + jnp.asarray(1e-30, dtype)
        log_scale = log_scale + jnp.log(nrm)
        nxt = cores[i + 1]
        cores[i + 1] = jnp.einsum(
            "ab,bnc->anc", r / nrm, nxt,
            preferred_element_type=nxt.dtype)
    # SVD sweep right -> left (round_edge chain, tensorNetwork.cpp:678)
    for i in range(d - 1, 0, -1):
        rl, n, rr = cores[i].shape
        mat = cores[i].reshape(rl, n * rr)
        u, s, vt = jnp.linalg.svd(mat, full_matrices=False)
        k = min(target_rank, u.shape[1])
        u = u[:, :k] * s[None, :k]
        cores[i] = vt[:k, :].reshape(k, n, rr)
        nrm = jnp.linalg.norm(u) + jnp.asarray(1e-30, dtype)
        log_scale = log_scale + jnp.log(nrm)
        prev = cores[i - 1]
        cores[i - 1] = jnp.einsum(
            "anb,bk->ank", prev, u / nrm, preferred_element_type=prev.dtype)
    # redistribute the accumulated scale evenly over all cores
    per_core = jnp.exp(log_scale / d)
    return tuple(c * per_core for c in cores)


@lru_cache(maxsize=64)
def make_round_sweep(shapes: Tuple[Tuple[int, ...], ...], target_rank: int,
                     dtype_str: str):
    """Compiled rounding sweep for the given core shapes."""
    fn = jax.jit(partial(_round_sweep, target_rank=target_rank))
    return fn


def tt_round_sweep(cores: Sequence[jnp.ndarray], target_rank: int):
    shapes = tuple(tuple(c.shape) for c in cores)
    fn = make_round_sweep(shapes, int(target_rank), str(cores[0].dtype))
    return fn(tuple(cores))


def _qr_flops(m: int, n: int) -> float:
    """Householder QR + explicit Q formation (dgeqrf + dorgqr)."""
    k = min(m, n)
    return 2.0 * m * n * k - (2.0 / 3.0) * k ** 3 + 2.0 * m * k * k


def _svd_flops(m: int, n: int) -> float:
    """gesdd-style estimate: bidiagonalization + D&C + back-transform."""
    a, b = max(m, n), min(m, n)
    return 8.0 * a * b * b + (20.0 / 3.0) * b ** 3


def round_flops(shapes: Sequence[Tuple[int, int, int]], target_rank: int) -> float:
    """Analytic FLOP count of one _round_sweep over the given core shapes."""
    shapes = [tuple(s) for s in shapes]
    total = 0.0
    cur = list(shapes)
    # QR sweep
    for i in range(len(cur) - 1):
        rl, n, rr = cur[i]
        k = min(rl * n, rr)
        total += _qr_flops(rl * n, rr)
        rl2, n2, rr2 = cur[i + 1]
        total += 2.0 * k * rl2 * n2 * rr2  # R @ next-core matricization
        cur[i] = (rl, n, k)
        cur[i + 1] = (k, n2, rr2)
    # SVD sweep
    for i in range(len(cur) - 1, 0, -1):
        rl, n, rr = cur[i]
        total += _svd_flops(rl, n * rr)
        k = min(target_rank, min(rl, n * rr))
        rl2, n2, rr2 = cur[i - 1]
        total += 2.0 * rl2 * n2 * rr2 * k
        cur[i] = (k, n, rr)
        cur[i - 1] = (rl2, n2, k)
    return total


# ---------------------------------------------------------------------------
# Scan-based uniform-rank rounding: cores padded to one (d, r, n, r) stack,
# both sweeps are lax.scan's — the QR and the (expensive-to-compile) SVD are
# each compiled ONCE instead of per-site, and every matmul has one shape.
# Truncation to `target_rank` is a static mask on the singular values, so
# shapes stay uniform (the pad-to-max-rank strategy of SURVEY.md §7).
# ---------------------------------------------------------------------------

def _round_sweep_scan(stacked: jnp.ndarray, target_rank: int,
                      eps: float = 0.0):
    """stacked: (d, r, n, r) zero-padded cores (boundary ranks padded).
    Returns the rounded cores, still (d, r, n, r) with bonds beyond the kept
    rank exactly zero; the total scale is redistributed (f32 overflow
    protection).  ``eps`` adds the reference's relative singular-value
    truncation (sigma_j <= eps * sigma_0 dropped, tensor.cpp:1468-1473) as a
    data-dependent mask — shapes stay static."""
    d, r, n, _ = stacked.shape
    dtype = stacked.dtype
    eye = jnp.eye(r, dtype=dtype)
    tiny = jnp.asarray(1e-30, dtype)

    def qr_body(carry, core):
        R, logs = carry
        cur = jnp.einsum("ab,bnc->anc", R, core,
                         preferred_element_type=dtype).reshape(r * n, r)
        q, R2 = jnp.linalg.qr(cur)
        nrm = jnp.linalg.norm(R2) + tiny
        return (R2 / nrm, logs + jnp.log(nrm)), q.reshape(r, n, r)

    (Rlast, logs), qs = jax.lax.scan(
        qr_body, (eye, jnp.zeros((), dtype)), stacked)
    # Rlast carries the trailing boundary bond (logical dim 1): fold into
    # the last core
    qs = qs.at[d - 1].set(jnp.einsum("anb,bc->anc", qs[d - 1], Rlast))

    rank_mask = (jnp.arange(r, dtype=jnp.int32) < target_rank).astype(dtype)
    eps_c = jnp.asarray(eps, dtype)

    def svd_body(carry, core):
        US, logs = carry
        cur = jnp.einsum("anb,bc->anc", core, US,
                         preferred_element_type=dtype).reshape(r, n * r)
        u, s, vt = jnp.linalg.svd(cur, full_matrices=False)
        mask = rank_mask
        if eps > 0.0:
            mask = mask * (s > eps_c * s[0]).astype(dtype)
        s = s * mask
        # also zero the dropped rows of vt: their contribution is already
        # nulled by the zeroed US columns, but keeping them as garbage
        # would hide the effective bond rank from the host-side trim
        new_core = (vt * mask[:, None]).reshape(r, n, r)
        US2 = u * s[None, :]
        nrm = jnp.linalg.norm(US2) + tiny
        return (US2 / nrm, logs + jnp.log(nrm)), new_core

    rest = stacked[1:][::-1]  # cores d-1 .. 1 (sweep right to left)
    (USfinal, logs2), new_rest = jax.lax.scan(
        svd_body, (eye, jnp.zeros((), dtype)), qs[1:][::-1])
    first = jnp.einsum("anb,bc->anc", qs[0], USfinal)
    out = jnp.concatenate([first[None], new_rest[::-1]], axis=0)
    log_scale = logs + logs2
    # distribute the scale evenly
    out = out * jnp.exp(log_scale / d)
    return out


def _round_sweep_scan_gram(stacked: jnp.ndarray, target_rank: int,
                           eps: float = 0.0):
    """Deterministic rounding with the SVD replaced by a Gram-matrix eigh:
    G = M M^T (GEMM) + eigh(r x r).  Squares the condition number, so
    singular values below ~sqrt(eps) of the max lose accuracy — irrelevant
    for the dominant part kept by truncation; the f32 default loses ~3e-4
    relative on the kept spectrum.  ``eps`` adds the reference's relative
    singular-value truncation as a data-dependent mask (sigma from
    sqrt(eigenvalues))."""
    d, r, n, _ = stacked.shape
    dtype = stacked.dtype
    eye = jnp.eye(r, dtype=dtype)
    tiny = jnp.asarray(1e-30, dtype)

    def qr_body(carry, core):
        R, logs = carry
        cur = jnp.einsum("ab,bnc->anc", R, core,
                         preferred_element_type=dtype).reshape(r * n, r)
        q, R2 = jnp.linalg.qr(cur)
        nrm = jnp.linalg.norm(R2) + tiny
        return (R2 / nrm, logs + jnp.log(nrm)), q.reshape(r, n, r)

    (Rlast, logs), qs = jax.lax.scan(
        qr_body, (eye, jnp.zeros((), dtype)), stacked)
    qs = qs.at[d - 1].set(jnp.einsum("anb,bc->anc", qs[d - 1], Rlast))

    mask = (jnp.arange(r, dtype=jnp.int32) < target_rank).astype(dtype)
    eps_c = jnp.asarray(eps, dtype)

    def gram_body(carry, core):
        US, logs = carry
        cur = jnp.einsum("anb,bc->anc", core, US,
                         preferred_element_type=dtype).reshape(r, n * r)
        G = cur @ cur.T                                   # (r, r) GEMM
        lam, V = jnp.linalg.eigh(G)                       # ascending
        lam = lam[::-1]
        V = V[:, ::-1]
        s = jnp.sqrt(jnp.maximum(lam, 0.0)) * mask
        if eps > 0.0:
            s = s * (s > eps_c * s[0]).astype(dtype)
        inv_s = jnp.where(s > tiny, 1.0 / jnp.maximum(s, tiny), 0.0)
        vt = (V.T @ cur) * inv_s[:, None]                 # rows ~ unit
        new_core = vt.reshape(r, n, r)
        US2 = V * s[None, :]
        nrm = jnp.linalg.norm(US2) + tiny
        return (US2 / nrm, logs + jnp.log(nrm)), new_core

    (USfinal, logs2), new_rest = jax.lax.scan(
        gram_body, (eye, jnp.zeros((), dtype)), qs[1:][::-1])
    first = jnp.einsum("anb,bc->anc", qs[0], USfinal)
    out = jnp.concatenate([first[None], new_rest[::-1]], axis=0)
    return out * jnp.exp((logs + logs2) / d)


def _cholqr3(cur, tiny):
    """Shifted CholeskyQR3 of a tall (m, r) matrix: GEMM + small Cholesky +
    triangular solve, three times (Fukaya et al. 2020).  Q R = cur holds
    EXACTLY for any invertible L (Q = cur L^-T, R = L^T), so the shifts
    never bias the factorization — they only keep Cholesky alive on the
    zero-padded bonds of uniform-rank stacks, where the Gram matrix has
    exact zero rows and f32 roundoff makes it slightly indefinite.  The
    first shift must dominate the m*eps*||G|| roundoff cloud; the next two
    iterations square the orthogonality error down to eps level."""
    from jax.scipy.linalg import solve_triangular
    dtype = cur.dtype
    m, r = cur.shape
    eye = jnp.eye(r, dtype=dtype)
    eps_m = jnp.asarray(10 * m * jnp.finfo(dtype).eps, dtype)
    eps_s = jnp.asarray(10 * jnp.finfo(dtype).eps, dtype)

    def step(X, rel):
        G = X.T @ X
        shift = rel * jnp.max(jnp.diagonal(G)) + tiny
        L = jnp.linalg.cholesky(G + shift * eye)
        Q = solve_triangular(L, X.T, lower=True).T
        return Q, L

    Q1, L1 = step(cur, eps_m)
    Q2, L2 = step(Q1, eps_s)
    Q3, L3 = step(Q2, eps_s)
    # cur = Q3 L3^T L2^T L1^T, all upper triangular
    return Q3, L3.T @ (L2.T @ L1.T)


def _round_sweep_scan_cholqr(stacked: jnp.ndarray, target_rank: int):
    """Gram-eigh rounding with the orthogonalization QR replaced by shifted
    CholeskyQR2 — every heavy op is a GEMM plus r x r Cholesky/eigh;
    no Householder panels.  Orthogonality of the sweep's Q factors is
    ~u*kappa^2-limited like the Gram pass itself, so accuracy matches the
    'gram' method; speed is set by the GEMMs instead of XLA's QR."""
    d, r, n, _ = stacked.shape
    dtype = stacked.dtype
    eye = jnp.eye(r, dtype=dtype)
    tiny = jnp.asarray(1e-30, dtype)

    def qr_body(carry, core):
        R, logs = carry
        cur = jnp.einsum("ab,bnc->anc", R, core,
                         preferred_element_type=dtype).reshape(r * n, r)
        q, R2 = _cholqr3(cur, tiny)
        nrm = jnp.linalg.norm(R2) + tiny
        return (R2 / nrm, logs + jnp.log(nrm)), q.reshape(r, n, r)

    (Rlast, logs), qs = jax.lax.scan(
        qr_body, (eye, jnp.zeros((), dtype)), stacked)
    qs = qs.at[d - 1].set(jnp.einsum("anb,bc->anc", qs[d - 1], Rlast))

    mask = (jnp.arange(r, dtype=jnp.int32) < target_rank).astype(dtype)

    def gram_body(carry, core):
        US, logs = carry
        cur = jnp.einsum("anb,bc->anc", core, US,
                         preferred_element_type=dtype).reshape(r, n * r)
        G = cur @ cur.T
        lam, V = jnp.linalg.eigh(G)
        lam = lam[::-1]
        V = V[:, ::-1]
        s = jnp.sqrt(jnp.maximum(lam, 0.0)) * mask
        inv_s = jnp.where(s > tiny, 1.0 / jnp.maximum(s, tiny), 0.0)
        vt = (V.T @ cur) * inv_s[:, None]
        new_core = vt.reshape(r, n, r)
        US2 = V * s[None, :]
        nrm = jnp.linalg.norm(US2) + tiny
        return (US2 / nrm, logs + jnp.log(nrm)), new_core

    (USfinal, logs2), new_rest = jax.lax.scan(
        gram_body, (eye, jnp.zeros((), dtype)), qs[1:][::-1])
    first = jnp.einsum("anb,bc->anc", qs[0], USfinal)
    out = jnp.concatenate([first[None], new_rest[::-1]], axis=0)
    return out * jnp.exp((logs + logs2) / d)


def _round_gram_parallel(stacked: jnp.ndarray, target_rank: int):
    """All-bonds-at-once deterministic rounding via interface Gram matrices
    (the Gram-SVD rounding of 'Parallel Algorithms for Tensor Train
    Arithmetic', arXiv 2011.06532 — PAPERS.md; reference sequential chain:
    ttNetwork.cpp:644 + tensorNetwork.cpp:678).

    Two pure-GEMM ``lax.scan``s compute the left/right interface Gram
    matrices  L_k = X_{<=k}^T X_{<=k}  and  R_k = X_{>k} X_{>k}^T  for every
    bond; the per-bond truncation maps then come from ONE batched Cholesky +
    eigh + triangular-solve over the (d-1, r, r) bond stack, and the core
    updates are two batched GEMMs.  The d-1 *sequential* (r, r) eigh's of
    the scan-gram method — its sequential wall-clock bottleneck — collapse into
    a single batched factorization.

    Math.  With factors L_k = Lam_L Lam_L^T and R_k = Lam_R Lam_R^T the
    bond matricization is X_k = Q_L (Lam_L^T Lam_R) Q_R^T with orthonormal
    Q_L, Q_R, so the singular values of the small M = Lam_L^T Lam_R are
    exactly those of X_k.  The left factor is never needed explicitly:
    M^T M = Lam_R^T L Lam_R =: G.  From eigh(G) = (V, sigma^2), the rank-t
    bond insertion pair is
      P_k      = Lam_R V diag(mask/sqrt(sigma))      (right of core k-1)
      P~_k     = diag(mask*sqrt(sigma)) V^T Lam_R^+  (left of core k)
    since Lam_L^-T M = Lam_R.  Lam_R comes from eigh(R) (Lam_R = V_R
    diag(sqrt(mu)), pinv-masked), which handles the exactly-singular Gram
    matrices of rank-deficient/zero-padded bonds cleanly — no Cholesky
    shift, no junk directions.  New cores C_k <- P~_k C_k P_{k+1}, all
    bonds truncated simultaneously (quasi-optimal: error <= sum of
    per-bond optimal errors instead of the sequential sqrt-of-sum — same
    contract as the reference's eps-per-edge rounding, scaled by sqrt(d)).

    Accuracy contract matches the 'gram' method: forming Gram matrices
    squares the condition number, so singular values below ~sqrt(eps) of
    the max are garbage — irrelevant for the kept dominant part.

    Overflow protection: both Gram scans renormalize their carry per step
    with the log-scale tracked per bond; the per-core correction factors
    are gauge-shifted to a single uniform per-core scale (scalars between
    cores commute), keeping every intermediate bounded in f32."""
    d, r, n, _ = stacked.shape
    dtype = stacked.dtype
    eye = jnp.eye(r, dtype=dtype)
    tiny = jnp.asarray(1e-30, dtype)
    pinv_tol = jnp.asarray(4.0 * r * jnp.finfo(dtype).eps, dtype)

    # ---- left Gram scan over cores 0..d-2: L for bonds 1..d-1 ----
    def l_body(carry, core):
        L, logs = carry
        t = jnp.einsum("ab,bnc->anc", L, core, preferred_element_type=dtype)
        L2 = jnp.einsum("anc,and->cd", t, core, preferred_element_type=dtype)
        L2 = 0.5 * (L2 + L2.T)
        nrm = jnp.linalg.norm(L2) + tiny
        logs = logs + jnp.log(nrm)
        return (L2 / nrm, logs), (L2 / nrm, logs)

    (_, _), (Ls, lam_logs) = jax.lax.scan(
        l_body, (eye, jnp.zeros((), dtype)), stacked[:d - 1])

    # ---- right Gram scan over cores d-1..1: R for bonds d-1..1 ----
    def r_body(carry, core):
        R, logs = carry
        t = jnp.einsum("bnc,cd->bnd", core, R, preferred_element_type=dtype)
        R2 = jnp.einsum("bnd,end->be", t, core, preferred_element_type=dtype)
        R2 = 0.5 * (R2 + R2.T)
        nrm = jnp.linalg.norm(R2) + tiny
        logs = logs + jnp.log(nrm)
        return (R2 / nrm, logs), (R2 / nrm, logs)

    (_, _), (Rs_rev, rho_logs_rev) = jax.lax.scan(
        r_body, (eye, jnp.zeros((), dtype)), stacked[1:][::-1])
    Rs = Rs_rev[::-1]                       # bonds 1..d-1
    rho_logs = rho_logs_rev[::-1]

    # ---- batched bond factorizations ----
    def bond_maps(L, R):
        mu, VR = jnp.linalg.eigh(R)                      # ascending
        mu = jnp.maximum(mu, 0.0)
        keep = (mu > pinv_tol * mu[-1]).astype(dtype)
        rt_mu = jnp.sqrt(mu) * keep
        inv_mu = jnp.where(rt_mu > tiny, 1.0 / jnp.maximum(rt_mu, tiny), 0.0)
        lamR = VR * rt_mu[None, :]                       # R = lamR lamR^T
        G = lamR.T @ (L @ lamR)
        G = 0.5 * (G + G.T)
        lam, V = jnp.linalg.eigh(G)                      # ascending
        lam = lam[::-1]
        V = V[:, ::-1]
        sig = jnp.sqrt(jnp.maximum(lam, 0.0))
        mask = (jnp.arange(r, dtype=jnp.int32) < target_rank).astype(dtype)
        mask = mask * (sig > pinv_tol * sig[0]).astype(dtype)
        inv_rt = jnp.where(sig > tiny, 1.0 / jnp.sqrt(jnp.maximum(sig, tiny)),
                           0.0) * mask
        P = (lamR @ V) * inv_rt[None, :]                 # (r, r)
        rt = jnp.sqrt(sig) * mask
        # Pt = diag(rt) V^T lamR^+ ; lamR^+ = diag(inv_mu) VR^T
        Pt = (V * rt[None, :]).T * inv_mu[None, :] @ VR.T
        return P, Pt

    Ps, Pts = jax.vmap(bond_maps)(Ls, Rs)                # (d-1, r, r)

    # ---- batched core updates (identity maps on the two boundaries) ----
    left_maps = jnp.concatenate([eye[None], Pts], axis=0)    # P~ for core k
    right_maps = jnp.concatenate([Ps, eye[None]], axis=0)    # P for core k
    out = jnp.einsum("kab,kbnc,kcd->kand", left_maps, stacked, right_maps,
                     preferred_element_type=dtype)

    # ---- gauge-balanced scale restoration ----
    lam_full = jnp.concatenate([jnp.zeros((1,), dtype), lam_logs,
                                jnp.zeros((1,), dtype)])     # bonds 0..d
    rho_full = jnp.concatenate([jnp.zeros((1,), dtype), rho_logs,
                                jnp.zeros((1,), dtype)])
    # core k: P~_k contributes (lam_k - rho_k)/4, P_{k+1} (rho_{k+1}-lam_{k+1})/4
    g = (lam_full[:-1] - lam_full[1:] + rho_full[1:] - rho_full[:-1]) / 4.0
    # sum(g) telescopes to exactly 0, so the REPRESENTED tensor is already
    # correct without any correction; applying exp(g_k) per core merely
    # redistributes magnitude between cores (the f32-health balancing the
    # scan normalizations exist for) while leaving the product unchanged
    return out * jnp.exp(g)[:, None, None, None]


def _round_subspace_parallel(stacked: jnp.ndarray, target_rank: int,
                             power_iters: int = 3, eps: float = 0.0):
    """All-bonds-at-once deterministic rounding with NO SVD/eigh anywhere —
    the batched-GEMM marriage of ``_round_gram_parallel`` (structure) and
    ``_trunc_step_subspace`` (per-bond factorization).  Reference semantics
    anchor: ttNetwork.cpp:644 + tensorNetwork.cpp:678 (deterministic
    truncation of every bond).

    Why: a batched eigh is an iterative solver per matrix while a batched
    Cholesky is a short direct factorization, so gram_parallel's two
    vmapped eighs can dominate its wall.  Here every
    per-bond factorization is GEMM + batched shifted Cholesky + batched
    triangular solve:

      C   = chol(R + shift I)        (ANY invertible factor of R works)
      G   = C^T L C                  (eigenvalues = bond sigma^2)
      V   = subspace power iteration on G from the deterministic start
            G[:, :t], CholQR orthogonalization between steps
      P   = C V diag(mask/sqrt(sig)),  P~ = diag(mask*sqrt(sig)) V^T C^-1

    Gauge-freedom argument: for ANY invertible C and ANY invertible
    column gauge T,  (C V T)(T^-1 V^T C^-1) = C V V^T C^-1 — the
    represented tensor depends only on span(V).  The Cholesky shift and
    the Rayleigh-quotient sigma estimates (sig^2 = diag(V^T G V)) thus
    cost NO representation error; truncation quality is governed purely
    by how well span(V) matches the dominant eigenspace of G
    (convergence ratio (sigma_{t+1}/sigma_t)^(2*iters); Frobenius-
    near-free at degenerate crossings).  Dead/padded bond slots surface
    as near-zero columns after shifted CholQR (junk residual / sqrt(shift)
    is tiny, not noise) and are masked by the sigma threshold in place,
    keeping live directions in the leading slots for the host-side
    rank slicing.

    Scale handling is identical to _round_gram_parallel: both Gram scans
    renormalize per step; the per-core exp(g) factors telescope to zero,
    merely redistributing magnitude for f32 health."""
    from jax.scipy.linalg import solve_triangular
    d, r, n, _ = stacked.shape
    dtype = stacked.dtype
    t = min(int(target_rank), r)
    eye = jnp.eye(r, dtype=dtype)
    eye_k = jnp.eye(t, dtype=dtype)
    tiny = jnp.asarray(1e-30, dtype)
    eps_s = jnp.asarray(10 * jnp.finfo(dtype).eps, dtype)
    pinv_tol = jnp.asarray(4.0 * r * jnp.finfo(dtype).eps, dtype)

    # ---- identical left/right interface Gram scans (pure GEMM) ----
    def l_body(carry, core):
        L, logs = carry
        tmp = jnp.einsum("ab,bnc->anc", L, core, preferred_element_type=dtype)
        L2 = jnp.einsum("anc,and->cd", tmp, core, preferred_element_type=dtype)
        L2 = 0.5 * (L2 + L2.T)
        nrm = jnp.linalg.norm(L2) + tiny
        logs = logs + jnp.log(nrm)
        return (L2 / nrm, logs), (L2 / nrm, logs)

    (_, _), (Ls, lam_logs) = jax.lax.scan(
        l_body, (eye, jnp.zeros((), dtype)), stacked[:d - 1])

    def r_body(carry, core):
        R, logs = carry
        tmp = jnp.einsum("bnc,cd->bnd", core, R, preferred_element_type=dtype)
        R2 = jnp.einsum("bnd,end->be", tmp, core, preferred_element_type=dtype)
        R2 = 0.5 * (R2 + R2.T)
        nrm = jnp.linalg.norm(R2) + tiny
        logs = logs + jnp.log(nrm)
        return (R2 / nrm, logs), (R2 / nrm, logs)

    (_, _), (Rs_rev, rho_logs_rev) = jax.lax.scan(
        r_body, (eye, jnp.zeros((), dtype)), stacked[1:][::-1])
    Rs = Rs_rev[::-1]
    rho_logs = rho_logs_rev[::-1]

    # ---- batched GEMM-only bond factorizations ----
    orth_cols = chol_orth_cols

    def bond_maps(L, R):
        shift = eps_s * jnp.max(jnp.abs(jnp.diagonal(R))) + tiny
        C = jnp.linalg.cholesky(R + shift * eye)             # (r, r) lower
        G = C.T @ (L @ C)
        G = 0.5 * (G + G.T)
        V = orth_cols(G[:, :t])
        for _ in range(power_iters):
            V = orth_cols(G @ V)
        V = orth_cols(V)                       # tighten orthogonality
        GV = G @ V
        s2 = jnp.maximum(jnp.sum(V * GV, axis=0), 0.0)       # Rayleigh
        sig = jnp.sqrt(s2)
        mask = (sig > pinv_tol * jnp.max(sig)).astype(dtype)
        if eps > 0.0:
            # relative per-bond eps truncation on the Rayleigh sigma
            # estimates (same contract as the scan kernels' s > eps*s[0];
            # estimates of near-threshold directions carry the subspace-
            # iteration convergence error — use method='svd' when the
            # eps cut itself must be exact)
            mask = mask * (sig > jnp.asarray(eps, dtype)
                           * jnp.max(sig)).astype(dtype)
        inv_rt = jnp.where(sig > tiny,
                           1.0 / jnp.sqrt(jnp.maximum(sig, tiny)), 0.0) * mask
        rt = jnp.sqrt(sig) * mask
        P = (C @ V) * inv_rt[None, :]                        # (r, t)
        Z = solve_triangular(C, V, lower=True, trans=1)      # C^-T V
        Pt = Z.T * rt[:, None]                               # (t, r)
        pad = r - t
        return (jnp.pad(P, ((0, 0), (0, pad))),
                jnp.pad(Pt, ((0, pad), (0, 0))))

    Ps, Pts = jax.vmap(bond_maps)(Ls, Rs)                    # (d-1, r, r)

    left_maps = jnp.concatenate([eye[None], Pts], axis=0)
    right_maps = jnp.concatenate([Ps, eye[None]], axis=0)
    out = jnp.einsum("kab,kbnc,kcd->kand", left_maps, stacked, right_maps,
                     preferred_element_type=dtype)

    lam_full = jnp.concatenate([jnp.zeros((1,), dtype), lam_logs,
                                jnp.zeros((1,), dtype)])
    rho_full = jnp.concatenate([jnp.zeros((1,), dtype), rho_logs,
                                jnp.zeros((1,), dtype)])
    g = (lam_full[:-1] - lam_full[1:] + rho_full[1:] - rho_full[:-1]) / 4.0
    return out * jnp.exp(g)[:, None, None, None]


@lru_cache(maxsize=32)
def make_round_sweep_scan(shape: Tuple[int, ...], target_rank: int,
                          dtype_str: str, method: str = "svd",
                          eps: float = 0.0):
    if method == "svd":
        return jit_f32(partial(_round_sweep_scan, target_rank=target_rank,
                               eps=eps), dtype_str)
    if method == "cholqr":
        return jit_f32(partial(_round_sweep_scan_cholqr,
                               target_rank=target_rank), dtype_str)
    if method == "gram_parallel":
        return jit_f32(partial(_round_gram_parallel,
                               target_rank=target_rank), dtype_str)
    if method == "subspace_parallel":
        return jit_f32(partial(_round_subspace_parallel,
                               target_rank=target_rank, eps=eps), dtype_str)
    if method != "gram":
        raise ValueError(f"unknown rounding method {method!r}; "
                         "expected 'svd', 'gram', 'cholqr', "
                         "'gram_parallel' or 'subspace_parallel'")
    return jit_f32(partial(_round_sweep_scan_gram, target_rank=target_rank,
                           eps=eps), dtype_str)


def tt_round_sweep_uniform(cores: Sequence[jnp.ndarray], target_rank: int,
                           method: str = "svd", eps: float = 0.0):
    """Pad to uniform rank, run the scan kernel, unpad to logical ranks.
    method: 'svd' (exact truncation, supports eps), 'gram' / 'cholqr'
    (GEMM + eigh, same result, squares the condition number), or
    'gram_parallel' (all bonds truncated at once from batched interface
    Gram matrices — quasi-optimal instead of sequential-optimal, result
    not canonicalized), or 'subspace_parallel' (gram_parallel's batched
    structure with GEMM-only per-bond factorizations: batched shifted
    Cholesky + subspace power iteration, no SVD/eigh)."""
    stacked, r = pad_cores([np.asarray(c) for c in cores])
    fn = make_round_sweep_scan(tuple(stacked.shape), int(target_rank),
                               str(stacked.dtype), method, float(eps))
    out = fn(stacked)
    d = stacked.shape[0]
    n = stacked.shape[2]
    # logical output ranks: min(target, maximal TT rank at that bond); with
    # eps the kernel zeroes dropped directions EXACTLY (mask on the singular
    # values), so the data-dependent bond ranks can be read off on host
    bond_rank = [res_rank(i, d, n, target_rank) for i in range(1, d)]
    if eps > 0.0:
        host = np.asarray(out)
        for i in range(1, d):
            nz = np.flatnonzero(np.any(host[i] != 0.0, axis=(1, 2)))
            bond_rank[i - 1] = min(bond_rank[i - 1],
                                   int(nz[-1]) + 1 if nz.size else 1)
    res = []
    for i in range(d):
        rl = 1 if i == 0 else bond_rank[i - 1]
        rr = 1 if i == d - 1 else bond_rank[i]
        core = out[i][:rl, :cores[i].shape[1], :rr]
        res.append(core)
    return res


def pad_cores(cores: Sequence) -> Tuple[jnp.ndarray, int]:
    """Stack TT cores into a uniform (d, r, n, r) array (zero-padded)."""
    d = len(cores)
    r = max(max(c.shape[0], c.shape[2]) for c in cores)
    n = max(c.shape[1] for c in cores)
    out = np.zeros((d, r, n, r), dtype=np.asarray(cores[0]).dtype)
    for k, c in enumerate(cores):
        c = np.asarray(c)
        out[k, :c.shape[0], :c.shape[1], :c.shape[2]] = c
    return jnp.asarray(out), r


def res_rank(bond: int, d: int, n: int, target: int) -> int:
    return min(target, n ** bond, n ** (d - bond))


# ---------------------------------------------------------------------------
# Segmented exact rounding: true shapes everywhere.  The uniform-rank scan
# above pads EVERY core to (r_max, n, r_max), so the ~2*log2(r_max) boundary
# ramp sites (ranks 1..r_max/2) waste most of their QR/SVD on zeros and the
# whole sweep runs d-1 full-size factorizations.  Here the shape schedule is
# computed in Python at trace time: ramp sites are unrolled at their TRUE
# (tiny) shapes, and maximal runs of identical-shape sites (the plateau)
# become one lax.scan each — one compiled QR/SVD body per run, no padding.
# Because every site is traced at its own static shape, a PER-EDGE max-rank
# vector (the reference's full round(vector<maxRanks>, eps) signature,
# ttNetwork.cpp:644-658) costs nothing: truncation is static slicing.
# ---------------------------------------------------------------------------

def _p2(x: int, floor: int = 1) -> int:
    b = floor
    while b < x:
        b *= 2
    return b


def _pad_to(arr, shape):
    pads = [(0, t - s) for s, t in zip(arr.shape, shape)]
    if all(p == (0, 0) for p in pads):
        return arr
    return jnp.pad(arr, pads)


def _qr_sweep_segmented(cores, min_run: int = 3, orth: str = "cholqr",
                        min_bucket: int = 32):
    """Left->right orthogonalization; returns (qs, logs) with qs[i] padded
    to its site's bucket shape (exactly-zero bond slots beyond the true
    rank — the pad-to-max discipline) and a list of true shapes.

    Site shapes are rounded up to power-of-2 BUCKETS so maximal runs of
    equal-bucket sites compile as one lax.scan body — ~4 factorization
    shapes total instead of ~2*log2(r) distinct ramp shapes (each distinct
    QR/SVD shape is a separate compile).  Zero padding
    is exact: shifted CholeskyQR maps zero columns to zero Q columns and
    block-diagonal R (cross-Gram blocks are zero), so padded bond slots
    never contaminate true ones.

    orth='cholqr' uses shifted CholeskyQR3 (GEMM + (w,w) Cholesky + trsm
    instead of a Householder QR); Q R = X
    holds exactly for any invertible L, so semantics match Householder.
    Rank-REDUCING sites (rr > k_prev*n, non-minimal TTs) fall back to
    Householder at true shape: CholQR cannot produce the rank cut."""
    d = len(cores)
    dtype = cores[0].dtype
    tiny = jnp.asarray(1e-30, dtype)

    # ---- static schedule ----
    # per site: true (kprev, rl, n, rr), k_out, bucket B (carry in/out
    # padded to (B, B), core to (B, n, B)); rank-reducing sites unrolled
    sched = []
    kprev = 1
    for i in range(d - 1):
        rl, n, rr = (int(s) for s in cores[i].shape)
        reduce_ = rr > kprev * n
        k_out = min(kprev * n, rr)
        B = max(_p2(max(kprev, rr)), min_bucket)
        sched.append(dict(i=i, kprev=kprev, rl=rl, n=n, rr=rr, k=k_out,
                          B=B, reduce=reduce_))
        kprev = k_out
    final_k = kprev

    out = [None] * d
    true_k = [None] * d
    logs = jnp.zeros((), dtype)
    R = jnp.ones((1, 1), dtype)          # true-shape carry (kprev, rl)

    def chol_qr(X):
        ueps = float(jnp.finfo(dtype).eps)
        return chol_orth_cols(X, (10 * X.shape[0] * ueps, 10 * ueps,
                                  10 * ueps), want_r=True)

    def ns_qr(X, colmask):
        """GEMM-only QR: Q = Newton-Schulz polar (same column space, no
        cholesky+trsm on the sequential chain),
        R = Q^T X; exact X = Q R at convergence since range(Q) =
        range(X).  Non-converged sites (deficient live block) fall back
        to the shifted-CholQR path via lax.cond."""
        q0, ok = _ns_orth_cols(X, 64, dtype, colmask=colmask)

        def good(_):
            return q0, q0.T @ X

        def bad(_):
            return chol_qr(X)

        return jax.lax.cond(ok, good, bad, None)

    idx = 0
    while idx < d - 1:
        st = sched[idx]
        B, n = st["B"], st["n"]
        j = idx
        while (j < d - 1 and sched[j]["B"] == B and sched[j]["n"] == n
               and not sched[j]["reduce"] and orth in ("cholqr", "ns")):
            j += 1
        if j - idx >= min_run:
            seg = jnp.stack([_pad_to(cores[t], (B, n, B))
                             for t in range(idx, j)])
            Rp = _pad_to(R, (B, B))
            if orth == "ns":
                # per-site live-column masks ride the scan as data
                cmasks = jnp.stack([
                    (jnp.arange(B) < sched[t]["rr"]).astype(dtype)
                    for t in range(idx, j)])
            else:
                cmasks = jnp.zeros((j - idx, B), dtype)  # unused

            def body(carry, inp, _B=B, _n=n, _orth=orth):
                Rc, lg = carry
                core, cm = inp
                cur = jnp.einsum("ka,anb->knb", Rc, core,
                                 preferred_element_type=dtype
                                 ).reshape(_B * _n, _B)
                if _orth == "ns":
                    q, R2 = ns_qr(cur, cm)
                else:
                    q, R2 = chol_qr(cur)
                nrm = jnp.linalg.norm(R2) + tiny
                return (R2 / nrm, lg + jnp.log(nrm)), q.reshape(_B, _n, _B)

            (Rp, logs), qs = jax.lax.scan(body, (Rp, logs), (seg, cmasks))
            for t in range(idx, j):
                out[t] = qs[t - idx]
                true_k[t] = (sched[t]["kprev"], sched[t]["k"])
            # true carry leaving the run: (k_{j-1}, rr_{j-1}); rr_{j-1}
            # equals the next core's left dim (TT bond consistency)
            R = Rp[:sched[j - 1]["k"], :sched[j - 1]["rr"]]
            idx = j
        else:
            kprev, rl, rr, k = st["kprev"], st["rl"], st["rr"], st["k"]
            cur = jnp.einsum("ka,anb->knb", R, cores[idx],
                             preferred_element_type=dtype
                             ).reshape(kprev * n, rr)
            if st["reduce"] or orth not in ("cholqr", "ns"):
                q, R2 = jnp.linalg.qr(cur)
            elif orth == "ns":
                q, R2 = ns_qr(cur, None)
            else:
                q, R2 = chol_qr(cur)
            out[idx] = _pad_to(q.reshape(kprev, n, k), (st["B"], n, st["B"]))
            true_k[idx] = (kprev, k)
            nrm = jnp.linalg.norm(R2) + tiny
            logs = logs + jnp.log(nrm)
            R = R2[:k] / nrm
            idx += 1
    last = jnp.einsum("ka,anb->knb", R, cores[d - 1],
                      preferred_element_type=dtype)
    out[d - 1] = last
    true_k[d - 1] = (final_k, int(cores[d - 1].shape[2]))
    return out, true_k, logs


def _trunc_step_subspace(cur, keep, keep_cap: int, dtype, tiny,
                         power_iters: int = 3):
    """Deterministic GEMM-only truncation: subspace (power) iteration on
    the Gram matrix G = cur cur^T from the deterministic start G[:, :k],
    then a Cholesky LQ split — NO SVD/eigh anywhere.  The sequential bond
    chain pays each bond's factorization latency in turn, and an SVD or
    eigh is an iterative solver where GEMM + (k,k) Cholesky + trsm are
    short direct steps.

    Quality: cur ~= V (V^T cur) with V spanning the dominant subspace
    after `power_iters` iterations on G (convergence ratio
    (sigma_{k+1}/sigma_k)^{2*iters}; near-degenerate crossings cost
    nothing in Frobenius error since the competing directions carry
    equal weight).  Validated against exact-SVD rounding on the test
    oracles; use method='svd' when exact reference semantics matter
    more than wall-clock.  No eps support (needs singular values)."""
    from jax.scipy.linalg import solve_triangular
    B, M = cur.shape
    G = cur @ cur.T                                       # (B, B) GEMM
    col_mask = (jnp.arange(keep_cap, dtype=jnp.int32)
                < jnp.asarray(keep, jnp.int32)).astype(dtype)
    eye_k = jnp.eye(keep_cap, dtype=dtype)
    eps_s = jnp.asarray(10 * jnp.finfo(dtype).eps, dtype)

    orth_cols = chol_orth_cols

    V = orth_cols(G[:, :keep_cap] * col_mask[None, :])
    for _ in range(power_iters):
        V = orth_cols((G @ V) * col_mask[None, :])
    # one extra CholQR pass: each single shifted pass leaves ~u*kappa^2
    # orthogonality error which would bleed into cur ~= V (V^T cur)
    V = orth_cols(V) * col_mask[None, :]
    vt_raw = V.T @ cur                                    # (k, M)
    Gr = vt_raw @ vt_raw.T
    shift = eps_s * jnp.max(jnp.diagonal(Gr)) + tiny
    L = jnp.linalg.cholesky(Gr + shift * eye_k)
    Q = solve_triangular(L, vt_raw, lower=True)           # row-orthonormal
    Q = Q * col_mask[:, None]
    US = (V @ L) * col_mask[None, :]                      # cur ~= US @ Q
    return US, Q


def _ns_orth_cols(X, max_it: int, dtype, colmask=None,
                  tol_mult: float = 64.0):
    """Column-orthonormalize by scaled Newton-Schulz polar iteration —
    PURE GEMM.

    X <- X (1.5 I - 0.5 X^T X) converges to the nearest partial isometry
    with the SAME column space for sigma in (0, sqrt(3)); the Frobenius
    prescale puts sigma_max <= 1.  Early exit on max|X^T X - D| below
    tol (while_loop), where D = diag(colmask) — padded dead columns are
    exactly zero and must converge to zero, not to 1 (``colmask`` is the
    live-column indicator; None = all live).  Returns (Q, ok) where
    ok=False flags a non-converged (rank-deficient live block or
    too-ill-conditioned) input."""
    tol = jnp.asarray(tol_mult * jnp.finfo(dtype).eps, dtype)
    alpha = jnp.linalg.norm(X) + jnp.asarray(1e-30, dtype)
    k = X.shape[1]
    eye = jnp.eye(k, dtype=dtype)
    target = eye if colmask is None else eye * colmask[None, :]

    def cond(c):
        _X, err, it = c
        return jnp.logical_and(err > tol, it < max_it)

    def body(c):
        X, _e, it = c
        S = X.T @ X
        X = X @ (1.5 * eye - 0.5 * S)
        err = jnp.max(jnp.abs(X.T @ X - target))
        return (X, err, it + 1)

    X0 = X / alpha
    err0 = jnp.max(jnp.abs(X0.T @ X0 - target))
    Q, err, _ = jax.lax.while_loop(cond, body, (X0, err0, 0))
    return Q, err <= tol


def _ns_polar_rows(Y, max_it: int, dtype, rowmask=None,
                   tol_mult: float = 64.0):
    """Row-orthonormal polar factor of Y (k, M) by Newton-Schulz —
    same iteration as _ns_orth_cols on Y^T, kept row-shaped: the
    rowspace is preserved, so cur @ (polar(V^T cur))^T @ polar(V^T cur)
    is exactly the projection onto rowspace(V^T cur).  ``rowmask``
    marks live rows (padded dead rows converge to zero, see
    _ns_orth_cols)."""
    tol = jnp.asarray(tol_mult * jnp.finfo(dtype).eps, dtype)
    alpha = jnp.linalg.norm(Y) + jnp.asarray(1e-30, dtype)
    k = Y.shape[0]
    eye = jnp.eye(k, dtype=dtype)
    target = eye if rowmask is None else eye * rowmask[:, None]

    def cond(c):
        _Y, err, it = c
        return jnp.logical_and(err > tol, it < max_it)

    def body(c):
        Y, _e, it = c
        S = Y @ Y.T
        Y = (1.5 * eye - 0.5 * S) @ Y
        err = jnp.max(jnp.abs(Y @ Y.T - target))
        return (Y, err, it + 1)

    Y0 = Y / alpha
    err0 = jnp.max(jnp.abs(Y0 @ Y0.T - target))
    Q, err, _ = jax.lax.while_loop(cond, body, (Y0, err0, 0))
    return Q, err <= tol


def _gemm_exact_body(cur, col_mask, dtype, tiny, max_outer: int,
                     max_ns: int, polish_steps: int, stall_need: int):
    """Core of the certified GEMM-only truncation (see
    _trunc_step_gemm_exact): returns (vt0, vt_bal, okp, converged, it)
    — vt0 is the Newton-Schulz polar extraction (valid iff okp), vt_bal
    the row-balanced projection it was built from (the caller's
    Householder-LQ fallback input, _finish_gemm_exact).  Pure GEMM +
    elementwise + reductions + jax control flow."""
    B, M = cur.shape
    keep_cap = col_mask.shape[0]
    G = cur @ cur.T
    trG = jnp.trace(G)
    stag_tol = jnp.asarray(8 * jnp.finfo(dtype).eps, dtype)
    noise_floor = jnp.asarray(4 * jnp.finfo(dtype).eps, dtype)

    # start basis: G's leading columns plus a FIXED hash perturbation —
    # a deterministic start that is exactly orthogonal to a dominant
    # eigendirection (possible for structured/block G) is a stable fixed
    # point of power iteration and would self-certify at the wrong
    # subspace; the perturbation guarantees generic overlap while the
    # iteration washes its noise out
    ii = jax.lax.broadcasted_iota(jnp.int32, (B, keep_cap), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (B, keep_cap), 1)
    # int32-safe constants (x64-off mode has no int64 promotion)
    hsh = (((ii * 40503 + jj * 9973 + 12345) % 65536)
           .astype(dtype) / 65536.0 - 0.5)
    gmax = jnp.max(jnp.abs(G)) + tiny
    V0raw = (G[:, :keep_cap] + 1e-3 * gmax * hsh) * col_mask[None, :]

    def balance(W):
        # column balancing before Newton-Schulz: halves log(kappa) for
        # filtered bases, cutting the NS inner-iteration count
        nrm = jnp.sqrt(jnp.sum(W * W, axis=0))
        return W / jnp.maximum(nrm, tiny)[None, :]

    def orth(W):
        Q, ok = _ns_orth_cols(balance(W) * col_mask[None, :], max_ns,
                              dtype, colmask=col_mask)
        return Q * col_mask[None, :], ok

    V0, _ = orth(V0raw)
    gscale = trG + tiny
    Gn = G / gscale          # overflow-safe power steps

    def tau_of(V):
        return jnp.sum(V * (G @ V))

    live = jnp.sum((jnp.diagonal(G) > 0).astype(dtype))
    keep_f = jnp.maximum(jnp.sum(col_mask), 1.0)

    def cond(c):
        _V, _tau, _Iprev, _Ipprev, stall, it = c
        return jnp.logical_and(stall < stall_need, it < max_outer)

    def body(c):
        V, tau, I_prev, I_pprev, stall, it = c
        # Alternate outers: EVEN = plain degree-2 power (contracts
        # unconditionally; the only steps allowed to certify), ODD =
        # degree-2 Chebyshev on [0, b] (a sqrt-rate accelerator; if b
        # mis-estimates lambda_keep it can suppress wanted directions,
        # so it never feeds the certificate and the monotone safeguard
        # discards a regressing step).  b targets the cut from the
        # smallest column Rayleigh quotient of the current basis, with
        # the residual spectral mean as a floor.  Degree stays at 2:
        # higher filter degrees condition the basis beyond what f32
        # orthogonalization can recover (observed with a degree-6
        # filter: NS never converged, the safeguard froze V at a 1e-4
        # tau deficit).
        power = (it % 2) == 0
        GV = Gn @ V

        def power_step(_):
            return Gn @ GV

        def cheb_step(_):
            ray = jnp.sum(V * GV, axis=0) * gscale   # column Rayleigh
            ray = jnp.where(col_mask > 0, ray, jnp.inf)
            resid = jnp.maximum(trG - tau, 0.0)
            b_floor = (0.5 * resid / jnp.maximum(live - keep_f, 1.0)
                       + jnp.asarray(jnp.finfo(dtype).eps, dtype) * trG
                       + tiny)
            b = jnp.maximum(0.9 * jnp.min(ray), b_floor)
            y1 = (2.0 * gscale / b) * GV - V
            return 2.0 * ((2.0 * gscale / b) * (Gn @ y1) - y1) - V

        W = jax.lax.cond(power, power_step, cheb_step, None)
        V2, ok = orth(W)
        tau2 = tau_of(V2)
        better = tau2 >= tau
        V2 = jnp.where(better, V2, V)
        tau2 = jnp.where(better, tau2, tau)
        I_t = jnp.maximum(tau2 - tau, 0.0)
        # conservative rate: the max of the last two POWER-step ratios —
        # a fast mode decaying in front of a slow one makes the
        # single-step ratio (and hence the Aitken bound) underestimate
        # the remaining deficit during the transition (observed:
        # 1e-8..8e-8 oracle mismatches with the 1-ratio bound); mixing
        # Chebyshev improvements into the ratios would corrupt it, so
        # the I-carries only update on power outers
        rho1 = I_t / jnp.maximum(I_prev, tiny)
        rho2 = I_prev / jnp.maximum(I_pprev, tiny)
        rho = jnp.clip(jnp.maximum(rho1, rho2), 0.0, 1.0 - 1e-6)
        bound = I_t * rho / (1.0 - rho)
        tau_s = jnp.maximum(tau2, tiny)
        # two ways to certify: the Aitken bound is at roundoff, OR the
        # improvement itself sits at the arithmetic noise floor (in f32
        # the tau updates quantize and the clipped-rho bound explodes on
        # pure noise — nothing more is extractable at this precision)
        certified = jnp.logical_and(
            ok, jnp.logical_or(
                I_t <= noise_floor * tau_s,
                jnp.maximum(bound, I_t) <= stag_tol * tau_s))
        # global capture-complete certificate: tau is a TRUE monotone
        # lower bound on the captured energy, so tau >= (1-16eps) tr(G)
        # bounds the truncation error at the noise floor REGARDLESS of
        # how the basis got there (covers the overranked-representation
        # case, where the kept tail is representation noise whose
        # near-parallel power images no orthogonalizer can certify)
        certified = jnp.logical_or(
            certified, trG - tau2 <= 16.0 * jnp.finfo(dtype).eps * trG)
        # only power outers may certify (a mis-aimed Chebyshev step has
        # flat improvements for the wrong reason); Chebyshev outers
        # leave the stall count and the rate history untouched
        stall = jnp.where(power,
                          jnp.where(certified, stall + 1, 0), stall)
        I_prev2 = jnp.where(power, I_t, I_prev)
        I_pprev2 = jnp.where(power, I_prev, I_pprev)
        return (V2, tau2, I_prev2, I_pprev2, stall, it + 1)

    big = jnp.asarray(jnp.finfo(dtype).max / 4, dtype)
    V, tau, _I, _Ip, stall, it = jax.lax.while_loop(
        cond, body, (V0, tau_of(V0), big, big, jnp.zeros((), jnp.int32),
                     jnp.zeros((), jnp.int32)))
    converged = stall >= stall_need

    # angle polish: the energy certificate bounds the DEFICIT, but the
    # final-tensor mismatch of the sequential chain is first-order in
    # the subspace ANGLE fed downstream (measured: halving the exit
    # deficit only sqrt-halved the end-to-end mismatch).  A few extra
    # fixed power steps keep contracting the angles of every direction
    # with a real gap — near-degenerate pairs don't contract, but their
    # downstream effect is gauge-like (second-order) anyway.
    def polish(i, c):
        V, tau = c
        V2, ok2 = orth(Gn @ (Gn @ V))
        tau2 = tau_of(V2)
        good = jnp.logical_and(ok2, tau2 >= tau * (1.0 - stag_tol))
        return (jnp.where(good, V2, V), jnp.where(good, tau2, tau))

    V, tau = jax.lax.fori_loop(0, polish_steps, polish, (V, tau))

    vt_raw = V.T @ cur                                    # (keep_cap, M)
    # row-balance before the polar: kept directions can span many
    # orders (an overranked representation keeps near-zero directions),
    # putting kappa beyond f32 Newton-Schulz range — scaling rows
    # preserves the ROWSPACE, and the projection cur vt^T vt depends on
    # nothing else, so the balance is mathematically free
    rn = jnp.sqrt(jnp.sum(vt_raw * vt_raw, axis=1))
    vt_bal = vt_raw / jnp.maximum(rn, tiny)[:, None]
    vt0, okp = _ns_polar_rows(vt_bal, max_ns, dtype, rowmask=col_mask)
    return vt0, vt_bal, okp, converged, it


def _finish_gemm_exact(vt0, vt_bal, okp, col_mask):
    """XLA-level completion of the certified GEMM truncation: when the
    Newton-Schulz polar failed (okp=False), extract orthonormal rows by
    Householder LQ.  Near-parallel balanced rows (kept directions at
    representation-noise scale) or exactly-dead rows break the NS polar;
    QR of vt_bal^T gives orthonormal rows spanning rowspace(vt_raw) with
    junk-orthonormal completion — the same gauge freedom the reference
    SVD's zero-sigma rows have.  Only sound when the certificate already
    bounds the leftover mass (the caller's converged flag gates the
    gemm-vs-svd dispatch), since completion rows may overlap leftover
    cur rowspace at that noise scale."""
    def qr_extract(_):
        q, _r = jnp.linalg.qr(vt_bal.T)
        k = q.shape[1]
        qt = q.T
        if k < vt_bal.shape[0]:
            qt = jnp.pad(qt, ((0, vt_bal.shape[0] - k), (0, 0)))
        return qt

    vt = jax.lax.cond(okp, lambda _: vt0, qr_extract, None)
    return vt * col_mask[:, None]


def _gemm_exact_tuning(dtype):
    """(max_outer, max_ns, polish_steps, stall_need) per dtype: the f64
    oracle bar (rtol 1e-8 vs the SVD chain) needs the long polish and a
    3-deep certificate; the f32 bench path only needs f32-floor quality
    and its wall is set by the iteration count."""
    if jnp.finfo(dtype).eps > 1e-10:       # f32 / bf16
        return 128, 48, 6, 2
    return 256, 64, 16, 3


def _trunc_step_gemm_exact(cur, keep, keep_cap: int, dtype, tiny):
    """Exact-to-working-precision deterministic truncation with ZERO
    factorization calls — degree-2 power (subspace) iteration on the
    Gram matrix with Newton-Schulz re-orthonormalization, alternated
    with degree-2 Chebyshev accelerator steps, iterated until the
    remaining-capture BOUND certifies machine-precision optimality.

    Exactness claim (the Eckart-Young certificate): the rank-keep
    truncation error is ||cur||^2 - tr(V^T G V), minimized exactly by
    the dominant invariant subspace; the outer loop monotonically
    increases tr(V^T G V), the per-step improvements I_t of a power
    iteration decay geometrically, and the Aitken extrapolation
    I_t * rho/(1-rho) (rho = max of the last two power-step ratios)
    bounds the remaining deficit.  Termination requires that bound at
    roundoff level for ``stall_need`` consecutive power steps — the same
    converged-to-roundoff standard an iterative LAPACK/XLA SVD applies
    internally.  Validated against the jnp.linalg.svd chain at rtol 1e-8
    on the object round() oracles (tests/test_kernels.py).

    Exactly degenerate crossings (sigma_k == sigma_{k+1}) stall the
    ANGLES but contribute zero energy deficit — any SVD's own cut among
    them is equally roundoff-arbitrary.  Semi-clustered gaps that the
    iteration cannot resolve within ``max_outer`` steps never certify
    and re-dispatch to the exact SVD via lax.cond, as do rank-deficient
    inputs (keep above the true rank — Newton-Schulz cannot complete an
    orthonormal basis).

    No eps support (needs singular values); the eps path stays 'svd'."""
    col_mask = (jnp.arange(keep_cap, dtype=jnp.int32)
                < jnp.asarray(keep, jnp.int32)).astype(dtype)
    vt0, vt_bal, okp, ok, _it = _gemm_exact_body(
        cur, col_mask, dtype, tiny, *_gemm_exact_tuning(dtype))
    vt = _finish_gemm_exact(vt0, vt_bal, okp, col_mask)

    def gemm_out(_):
        US = (cur @ vt.T) * col_mask[None, :]
        return US, vt

    def svd_fallback(_):
        return _trunc_step(cur, keep, keep_cap, 0.0, "svd", dtype, tiny)

    return jax.lax.cond(ok, gemm_out, svd_fallback, None)


def _trunc_step_full_cols(cur, keep, keep_cap: int, dtype):
    """Non-truncating bond with keep == #live columns (prefix layout):
    the reference SVD keeps EVERYTHING, so any exact factorization is
    gauge-equivalent on the represented tensor — take vt = I (orthonormal
    rows for free), US = the matching column slice of cur.  Zero cost."""
    Bl, M = cur.shape
    mask = (jnp.arange(keep_cap, dtype=jnp.int32)
            < jnp.asarray(keep, jnp.int32)).astype(dtype)
    vt = jnp.eye(keep_cap, M, dtype=dtype) * mask[:, None]
    US = cur[:, :keep_cap] * mask[None, :]
    return US, vt


def _trunc_step_full_rows(cur, keep, keep_cap: int, dtype, tiny):
    """Non-truncating bond with keep == #live rows: exact CholQR-LQ
    split cur = L (L^{-1} cur).  cur = US @ vt holds EXACTLY for any
    invertible L (the shift only perturbs vt's orthonormality, at the
    same u*kappa^2 quality as _trunc_step_subspace's tail), and the
    reference's SVD at this bond keeps everything — gauge-equivalent.

    Rank-DEFICIENT live rows (the hidden-rank-cut case CholQR cannot
    factor: vt rows for null directions come out near-zero instead of
    orthonormal-completed, breaking the canonical-format contract) are
    detected from diag(L) and re-dispatched to a Householder LQ
    (lax.cond — the QR branch only executes when hit)."""
    from jax.scipy.linalg import solve_triangular
    Bl, M = cur.shape
    mask = (jnp.arange(Bl, dtype=jnp.int32)
            < jnp.asarray(keep, jnp.int32)).astype(dtype)
    G = cur @ cur.T
    eps_s = jnp.asarray(10 * jnp.finfo(dtype).eps, dtype)
    gmax = jnp.max(jnp.diagonal(G))
    shift = eps_s * gmax + tiny

    def chol_split(c):
        L = jnp.linalg.cholesky(G + shift * jnp.eye(Bl, dtype=dtype))
        vt = solve_triangular(L, c, lower=True)
        return L, vt, jnp.min(jnp.diagonal(L) ** 2)

    L0, vt0, mindiag = chol_split(cur)
    # live-row deficiency: a diagonal pivot at the shift floor (dead pad
    # rows legitimately sit there, so restrict the test to live rows)
    live_diag = jnp.where(mask > 0, jnp.diagonal(L0) ** 2, gmax + shift)
    deficient = jnp.min(live_diag) < 16.0 * shift

    def qr_split(_):
        q, r = jnp.linalg.qr(cur.T)
        k = q.shape[1]                     # min(M, Bl)
        return (jnp.pad(r.T, ((0, 0), (0, Bl - k))),
                jnp.pad(q.T, ((0, Bl - k), (0, 0))))

    US, vt = jax.lax.cond(deficient, qr_split,
                          lambda _: (L0, vt0), None)
    vt = vt * mask[:, None]
    US = US * mask[None, :]
    if Bl >= keep_cap:
        return US[:, :keep_cap], vt[:keep_cap]
    pad = keep_cap - Bl
    return (jnp.pad(US, ((0, 0), (0, pad))),
            jnp.pad(vt, ((0, pad), (0, 0))))


def _trunc_step(cur, keep, keep_cap: int, eps, method: str, dtype, tiny,
                mode: str = "trunc"):
    """One truncation step on the (Bl, M) padded matricization.  ``keep``
    is the (possibly traced, per-scan-step) true kept rank, ``keep_cap``
    its static bucket.  Returns (US (Bl, keep_cap), vt (keep_cap, M)) with
    entries beyond ``keep`` exactly zero.

    ``mode`` (static, from the sweep schedule): "full_cols"/"full_rows"
    mark bonds where the reference SVD keeps the full rank — the split is
    then an exact factorization and gauge-equivalent CholQR/identity
    splits replace the SVD (the bench ramp bonds each paid a full SVD
    call for a no-op truncation)."""
    if mode == "full_cols":
        return _trunc_step_full_cols(cur, keep, keep_cap, dtype)
    if mode == "full_rows":
        return _trunc_step_full_rows(cur, keep, keep_cap, dtype, tiny)
    if method == "gemm_exact":
        return _trunc_step_gemm_exact(cur, keep, keep_cap, dtype, tiny)
    if method == "subspace":
        return _trunc_step_subspace(cur, keep, keep_cap, dtype, tiny)
    if method == "gram":
        G = cur @ cur.T
        lam, V = jnp.linalg.eigh(G)                    # ascending
        lam = lam[::-1]
        V = V[:, ::-1]
        s = jnp.sqrt(jnp.maximum(lam, 0.0))
        W = s.shape[0]
    else:
        # the call runs at the true bucket shape: zero-padded columns
        # would only add work to the factorization
        u, s, vt_full = jnp.linalg.svd(cur, full_matrices=False)
        W = s.shape[0]
    mask = (jnp.arange(W, dtype=jnp.int32)
            < jnp.asarray(keep, jnp.int32)).astype(dtype)
    if eps > 0.0:
        mask = mask * (s > jnp.asarray(eps, dtype) * s[0]).astype(dtype)
    s = s * mask
    if method == "gram":
        inv_s = jnp.where(s > tiny, 1.0 / jnp.maximum(s, tiny), 0.0)
        vt = (V.T @ cur) * inv_s[:, None]
        vt = vt * mask[:, None]
        US = V * s[None, :]
    else:
        vt = vt_full * mask[:, None]
        US = u * s[None, :]
    if W >= keep_cap:
        return US[:, :keep_cap], vt[:keep_cap]
    pad = keep_cap - W
    return (jnp.pad(US, ((0, 0), (0, pad))),
            jnp.pad(vt, ((0, pad), (0, 0))))


def _round_sweep_segmented(cores, max_ranks, eps: float = 0.0,
                           method: str = "svd", min_run: int = 3,
                           orth: str = "cholqr", min_bucket: int = 32):
    """Deterministic rounding (reference round(vector<maxRanks>, eps),
    ttNetwork.cpp:644-658 + round_edge tensorNetwork.cpp:678) with
    power-of-2 bucketed shapes: equal-bucket runs compile as ONE lax.scan
    body (~4 factorization shapes total, vs 2*log2(r) distinct ramp
    shapes, each its own compile), padding is exactly zero
    on dead bond slots, and per-bond kept ranks ride the scan as data so
    a non-uniform ``max_ranks`` vector costs nothing.  Orthogonalization
    is shifted CholeskyQR3 (GEMM-only, exact factorization — see
    `_qr_sweep_segmented`); truncation per bond is an exact SVD
    (method='svd') or Gram+eigh (method='gram').  Returns PADDED cores;
    the wrapper slices to the static true shapes."""
    d = len(cores)
    dtype = cores[0].dtype
    tiny = jnp.asarray(1e-30, dtype)
    if d == 1:
        return list(cores)
    if method == "gemm_exact" and orth == "cholqr":
        # the certified GEMM-only truncation pairs with the GEMM-only
        # Newton-Schulz orthogonalization sweep (same exactness
        # guarantees as CholQR3, no Cholesky on the sequential chain)
        orth = "ns"
    qs, true_k, logs = _qr_sweep_segmented(cores, min_run, orth, min_bucket)

    # ---- static schedule for the right->left truncation sweep ----
    # entering carry width k_in; per site: true rl / right-bond rb
    # (true_k[i]), kept rank, and the power-of-2 buckets of each
    n_of = [int(c.shape[1]) for c in cores]
    sched = []
    k_in = int(cores[d - 1].shape[2])        # right boundary
    for i in range(d - 1, 0, -1):
        rl, rb = true_k[i]
        n = n_of[i]
        keep = min(int(max_ranks[i - 1]), rl, n * k_in)
        Bk = max(_p2(k_in), min_bucket)
        # static per-bond mode: bonds where the reference SVD keeps the
        # full rank take exact gauge-equivalent splits instead of an SVD
        # (_trunc_step modes; eps rounding still needs singular values).
        # "full_cols" additionally needs the live columns of the padded
        # (Bl, n*Bk) matricization to be a prefix, i.e. Bk == k_in.
        if eps == 0.0 and keep == n * k_in and Bk == k_in:
            mode = "full_cols"
        elif eps == 0.0 and keep == rl:
            mode = "full_rows"
        else:
            mode = "trunc"
        sched.append(dict(i=i, rl=rl, rb=rb, n=n, k_in=k_in, keep=keep,
                          mode=mode,
                          Bl=max(_p2(rl), min_bucket),
                          Bb=max(_p2(rb), min_bucket),
                          Bk=Bk,
                          Bkeep=max(_p2(keep), min_bucket)))
        k_in = keep

    out = [None] * d
    out_shapes = [None] * d

    def site_core(i, Bl, Bb):
        rl, rb = true_k[i]
        c = qs[i][:rl, :, :rb] if qs[i].shape != (rl, n_of[i], rb) else qs[i]
        return _pad_to(c, (Bl, n_of[i], Bb))

    # invariant: between segments the carry US holds its TRUE shape
    # (rb_of_next_site, k_in_of_next_site); padding happens on entry to a
    # segment, slicing (exactly-zero pad slots) on exit
    US = jnp.eye(int(cores[d - 1].shape[2]), dtype=dtype)

    pos = 0
    while pos < d - 1:
        st = sched[pos]
        n = st["n"]
        # a scan run needs uniform buckets: square site buckets and a
        # carry bucket that reproduces itself (Bk == Bkeep)
        scannable = st["Bl"] == st["Bb"] and st["Bk"] == st["Bkeep"]
        j = pos
        if scannable:
            while (j < d - 1 and sched[j]["n"] == n
                   and sched[j]["Bl"] == st["Bl"]
                   and sched[j]["Bb"] == st["Bl"]
                   and sched[j]["Bk"] == st["Bk"]
                   and sched[j]["Bkeep"] == st["Bk"]
                   and sched[j]["mode"] == st["mode"]):
                j += 1
        if scannable and j - pos >= min_run:
            B, Bk = st["Bl"], st["Bk"]
            run = sched[pos:j]
            seg = jnp.stack([site_core(s["i"], B, B) for s in run])
            keeps = jnp.asarray([s["keep"] for s in run], jnp.int32)
            USc0 = _pad_to(US, (B, Bk))

            def body(carry, inp, _B=B, _n=n, _Bk=Bk, _mode=st["mode"]):
                USc, lg = carry
                core, kp = inp
                cur = jnp.einsum("anb,bk->ank", core, USc,
                                 preferred_element_type=dtype
                                 ).reshape(_B, _n * _Bk)
                US2, vt = _trunc_step(cur, kp, _Bk, eps, method,
                                      dtype, tiny, mode=_mode)
                nrm = jnp.linalg.norm(US2) + tiny
                return (US2 / nrm, lg + jnp.log(nrm)), \
                    vt.reshape(_Bk, _n, _Bk)

            (USend, logs), vts = jax.lax.scan(body, (USc0, logs),
                                              (seg, keeps))
            for t, s in enumerate(run):
                out[s["i"]] = vts[t]
                out_shapes[s["i"]] = (s["keep"], n, s["k_in"])
            last = run[-1]
            US = USend[:last["rl"], :last["keep"]]
            pos = j
        else:
            s = st
            cur = jnp.einsum("anb,bk->ank", site_core(s["i"], s["rl"],
                                                      s["rb"]), US,
                             preferred_element_type=dtype
                             ).reshape(s["rl"], n * s["k_in"])
            # unrolled sites run at TRUE shapes, so the full_cols prefix
            # condition holds trivially (no column padding)
            umode = s["mode"]
            if umode == "full_cols" or (eps == 0.0
                                        and s["keep"] == n * s["k_in"]):
                umode = "full_cols"
            US2, vt = _trunc_step(cur, s["keep"], s["keep"], eps, method,
                                  dtype, tiny, mode=umode)
            out[s["i"]] = vt.reshape(s["keep"], n, s["k_in"])
            out_shapes[s["i"]] = (s["keep"], n, s["k_in"])
            nrm = jnp.linalg.norm(US2) + tiny
            logs = logs + jnp.log(nrm)
            US = US2 / nrm
            pos += 1
    # first core: absorb the final carry
    rl0, rb0 = true_k[0]
    out[0] = jnp.einsum("anb,bk->ank", site_core(0, rl0, rb0), US,
                        preferred_element_type=dtype)
    out_shapes[0] = (rl0, n_of[0], sched[-1]["keep"])
    per_core = jnp.exp(logs / d)
    # out_shapes is recomputed host-side by _segmented_out_shapes (static
    # values cannot cross the jit boundary)
    return [c * per_core for c in out]


def _segmented_out_shapes(shapes, max_ranks):
    """Static true-shape schedule of `_round_sweep_segmented`'s output."""
    d = len(shapes)
    if d == 1:
        return [tuple(int(s) for s in shapes[0])]
    kprev = 1
    true_lr = []
    for i in range(d - 1):
        rl, n, rr = shapes[i]
        k = min(kprev * n, rr)
        true_lr.append((kprev, k))
        kprev = k
    true_lr.append((kprev, shapes[d - 1][2]))
    out = [None] * d
    k_in = shapes[d - 1][2]
    for i in range(d - 1, 0, -1):
        rl, rb = true_lr[i]
        n = shapes[i][1]
        keep = min(int(max_ranks[i - 1]), rl, n * k_in)
        out[i] = (keep, n, k_in)
        k_in = keep
    out[0] = (true_lr[0][0], shapes[0][1], k_in)
    return out


@lru_cache(maxsize=64)
def make_round_sweep_segmented(shapes: Tuple[Tuple[int, ...], ...],
                               max_ranks: Tuple[int, ...], eps: float,
                               method: str, dtype_str: str):
    return jit_f32(partial(_round_sweep_segmented, max_ranks=max_ranks,
                           eps=eps, method=method), dtype_str)


def tt_round_sweep_segmented(cores: Sequence[jnp.ndarray], max_ranks,
                             eps: float = 0.0, method: str = "svd"):
    """Deterministic rounding at true shapes with a per-edge rank vector.
    ``max_ranks``: int (uniform) or length-(d-1) sequence.  Returns cores
    at their truncated TRUE shapes (no padding); with eps > 0 the
    eps-dropped directions are exactly zero and trimmed on host."""
    d = len(cores)
    if isinstance(max_ranks, (int, np.integer)):
        max_ranks = [int(max_ranks)] * (d - 1)
    max_ranks = tuple(int(r) for r in max_ranks)
    if method in ("subspace", "gemm_exact") and eps > 0.0:
        raise ValueError(f"method={method!r} has no singular values to "
                         "apply eps to; use method='svd' for eps rounding")
    shapes = tuple(tuple(c.shape) for c in cores)
    fn = make_round_sweep_segmented(shapes, max_ranks, float(eps), method,
                                    str(jnp.asarray(cores[0]).dtype))
    padded = fn(tuple(jnp.asarray(c) for c in cores))
    out_shapes = _segmented_out_shapes(shapes, max_ranks)
    out = [c[:s[0], :s[1], :s[2]] for c, s in zip(padded, out_shapes)]
    if eps > 0.0:
        # trim exactly-zeroed eps-dropped bonds (host-side, like
        # tt_round_sweep_uniform)
        host = [np.asarray(c) for c in out]
        for j in range(d - 1):
            nz = np.flatnonzero(np.any(host[j + 1] != 0.0, axis=(1, 2)))
            k = int(nz[-1]) + 1 if nz.size else 1
            if k < host[j + 1].shape[0]:
                host[j + 1] = host[j + 1][:k]
                host[j] = host[j][:, :, :k]
        return [jnp.asarray(c) for c in host]
    return list(out)


# ---------------------------------------------------------------------------
# On-device timing: N chained iterations inside ONE XLA program.  A
# fori_loop with a data dependency amortizes the per-call dispatch over N
# iterations and defeats CSE.
# ---------------------------------------------------------------------------

def make_timed_loop(kernel, iters: int):
    """Returns jitted fn(inputs)->scalar running `kernel` iters times with a
    serial data dependency. kernel: (cores_tuple) -> cores_tuple."""

    def loop(cores):
        def body(_, carry):
            cores_c, acc = carry
            # perturb EVERY input by an acc-dependent epsilon to create a
            # loop-carried data dependency without changing values
            # meaningfully.  Perturbing only the first input is NOT enough:
            # kernels that never read it (the ALS half-sweep replaces core 0
            # without reading it) become loop-invariant and XLA hoists the
            # whole body out of the chain — measured: identical wall at 1,
            # 21 and 101 iterations.
            pert = tuple(c + acc * 1e-30 for c in cores_c)
            out = kernel(pert)
            acc2 = jnp.sum(out[-1]).astype(cores_c[0].dtype)
            return (cores_c, acc2)

        _, acc = jax.lax.fori_loop(
            0, iters, body, (tuple(cores), jnp.zeros((), cores[0].dtype)))
        return acc

    return jax.jit(loop)


# ---------------------------------------------------------------------------
# Randomized TT rounding (GEMM-dominated)
# ---------------------------------------------------------------------------

def _round_randomized(cores: Tuple[jnp.ndarray, ...], seeds: jnp.ndarray,
                      target_rank: int, oversample: int,
                      qr_method: str = "householder",
                      precision=None, gram_precision=None):
    """Randomized rounding to fixed target rank (Al Daas/Ballard-style
    'randomize-then-orthogonalize').

    All heavy work is GEMM: right-to-left sketch build W_i = G_i (x) R_i
    (random rank-l TT), then left-to-right QR of (M_i W_i) with the small
    (r n x l) panels.  No SVD sweep; error is quasi-optimal in expectation.
    This is a new design — the reference only has the deterministic
    QR+SVD chain (tensorNetwork.cpp:678).

    ``precision`` sets the matmul precision of the bulk GEMMs (sketch
    build, panel build Y = G W, projection/carry updates): None→trace
    default (jit_f32 kernels trace HIGHEST, true f32), 'high' and
    'default' let the backend use its reduced-precision matmul modes
    (on NVIDIA tensor cores: TF32).  The kept
    SUBSPACE is statistically robust to sketch/panel noise (quasi-
    optimality is an expectation over the Gaussian sketch, so extra
    mantissa noise perturbs WHICH near-optimal basis is found, not how
    good it is), but the projection GEMMs write the output VALUES, whose
    relative error floors at the pass precision (~4e-3 for one bf16
    pass).  ``gram_precision`` controls the cholqr1 Gram + orthonormal-
    ization separately: panel orthogonality degrades as u_gram * kappa^2
    and errors compound along the chain, so it should stay >= 'high'
    when precision is lowered.  Measured by
    benchmarks/bf16_round_study.py."""
    d = len(cores)
    l = target_rank + oversample
    dtype = cores[0].dtype
    key = jax.random.PRNGKey(0)
    keys = jax.random.split(jax.random.fold_in(key, 0), d)
    pP, pG = precision, gram_precision

    # random TT cores R_i: (l, n, l) (boundaries 1)
    # sketches W[i]: (r_i, l) = contraction of G_{i+1..d-1} with R_{i+1..d-1}
    W = [None] * d
    W[d - 1] = jnp.ones((cores[d - 1].shape[2], 1), dtype=dtype)
    for i in range(d - 2, -1, -1):
        rl, n, rr = cores[i + 1].shape
        lw = W[i + 1].shape[1]
        l_left = l if i > -1 else 1
        R = jax.random.normal(keys[i], (l_left, n, lw), dtype=dtype) \
            / jnp.sqrt(jnp.asarray(l, dtype=dtype))
        # W[i][a, p] = sum_{n, b, q} G[a n b] W[i+1][b q] R[p n q]
        GW = jnp.einsum("anb,bq->anq", cores[i + 1], W[i + 1], precision=pP)
        Wi = jnp.einsum("anq,pnq->ap", GW, R, precision=pP)
        # only the column span of W matters -> safe to renormalize
        W[i] = Wi / (jnp.linalg.norm(Wi) + jnp.asarray(1e-30, dtype))

    out = list(cores)
    log_scale = jnp.zeros((), dtype=dtype)
    carry = None  # (k, r) projection to apply to the next core
    for i in range(d - 1):
        G = out[i] if carry is None else jnp.einsum(
            "ka,anb->knb", carry, out[i], precision=pP)
        rl, n, rr = G.shape
        Y = jnp.einsum("anb,bl->anl", G, W[i], precision=pP).reshape(
            rl * n, -1)
        if (qr_method in ("cholqr1", "cholqr1_invl")
                and rl * n >= Y.shape[1]):
            # one shifted Gram+chol+trsm pass — sound for the tall
            # well-conditioned sketch panels (see _round_randomized_scan's
            # cholqr1 note); short/boundary panels keep Householder
            from jax.scipy.linalg import solve_triangular
            lc = Y.shape[1]
            Gm = jnp.matmul(Y.T, Y, precision=pG)
            shift = (jnp.asarray(10 * Y.shape[0] * jnp.finfo(dtype).eps,
                                 dtype) * jnp.max(jnp.diagonal(Gm))
                     + jnp.asarray(1e-30, dtype))
            Lc = jnp.linalg.cholesky(Gm + shift * jnp.eye(lc, dtype=dtype))
            if qr_method == "cholqr1_invl":
                # trsm on the SMALL side: invert L against the (l, l)
                # identity, then apply as a GEMM.  The per-bond trsm RHS
                # count drops from rl*n (1024+) to l; the (m, l) x (l, l)
                # apply is a GEMM.  Same algebra as cholqr1 up to
                # rounding (L^{-T} formed once vs back-substitution per
                # column); quality measured identical
                # (benchmarks/round_structure_study.py).
                invLT = solve_triangular(Lc, jnp.eye(lc, dtype=dtype),
                                         lower=True).T
                q = jnp.matmul(Y, invLT, precision=pG)
            else:
                q = solve_triangular(Lc, Y.T, lower=True).T
        elif qr_method == "none":
            # timing-study skeleton ONLY: skips orthonormalization entirely
            # (output is NOT a valid rounding).  Used by
            # benchmarks/round_structure_study.py to measure the pure-GEMM
            # floor of the sweep.
            q = Y
        else:
            q, _ = jnp.linalg.qr(Y)
        k = min(target_rank, q.shape[1])
        q = q[:, :k]
        out[i] = q.reshape(rl, n, k)
        carry = jnp.einsum("ank,anb->kb", out[i].reshape(rl, n, k), G,
                           precision=pP)
        nrm = jnp.linalg.norm(carry) + jnp.asarray(1e-30, dtype)
        log_scale = log_scale + jnp.log(nrm)
        carry = carry / nrm
    final = jnp.einsum("ka,anb->knb", carry, out[d - 1], precision=pP)
    per_core = jnp.exp(log_scale / d)
    return tuple(c * per_core for c in out[:d - 1]) + (final * per_core,)


def _cholqr2(cur, tiny):
    """Shifted CholeskyQR2 of a tall (m, r) matrix — the 2-pass variant of
    `_cholqr3` for inputs known to be well-conditioned (randomized sketch
    panels: kappa = O(1) w.h.p. by Marchenko-Pastur).  Rank-deficient
    panels are safe: the shift keeps Cholesky alive and null directions map
    to ~zero (not junk) columns of Q, which the pad-to-max-rank discipline
    treats as inactive bonds."""
    from jax.scipy.linalg import solve_triangular
    dtype = cur.dtype
    m, r = cur.shape
    eye = jnp.eye(r, dtype=dtype)
    eps_m = jnp.asarray(10 * m * jnp.finfo(dtype).eps, dtype)
    eps_s = jnp.asarray(10 * jnp.finfo(dtype).eps, dtype)

    def step(X, rel):
        G = X.T @ X
        shift = rel * jnp.max(jnp.diagonal(G)) + tiny
        L = jnp.linalg.cholesky(G + shift * eye)
        return solve_triangular(L, X.T, lower=True).T

    return step(step(cur, eps_m), eps_s)


def _round_randomized_scan(stacked: jnp.ndarray, target_rank: int,
                           oversample: int, qr_method: str = "householder"):
    """Scan-uniform randomized rounding: padded (d, r, n, r) stack, sketch
    build and orthogonalization sweep are both lax.scan's (one compiled QR).
    Bond dims stay l = target+oversample padded; columns >= target_rank are
    masked to zero (pad-to-max-rank discipline).

    qr_method: 'householder' (jnp.linalg.qr) or 'cholqr' (shifted
    CholeskyQR2 — pure GEMM + (l, l) Cholesky/trsm, no Householder panels;
    sound here because sketch panels are well-conditioned w.h.p.)."""
    d, r, n, _ = stacked.shape
    dtype = stacked.dtype
    l = target_rank + oversample
    tiny = jnp.asarray(1e-30, dtype)
    key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, d)

    # sketches W[i] (r, l): right-to-left scan over cores d-1..1
    def sketch_body(W, inp):
        core, k = inp
        # drawn in f32 for every dtype: the f32 and f64 kernels then
        # sketch the same subspace and differ only by their arithmetic
        R = jax.random.normal(k, (l, n, l), dtype=jnp.float32).astype(dtype)
        GW = jnp.einsum("anb,bq->anq", core, W)
        Wn = jnp.einsum("anq,pnq->ap", GW, R)
        Wn = Wn / (jnp.linalg.norm(Wn) + tiny)
        return Wn, Wn

    W_init = jnp.zeros((r, l), dtype=dtype).at[:, 0].set(
        jnp.zeros((r,), dtype).at[0].set(1.0))
    # W for the LAST bond: only lane 0 active (boundary rank 1)
    _, Ws = jax.lax.scan(sketch_body, W_init, (stacked[1:][::-1], keys[1:]))
    Ws = Ws[::-1]  # Ws[i] pairs with core i (bond i -> right)

    col_mask = (jnp.arange(l, dtype=jnp.int32) < target_rank).astype(dtype)

    def sweep_body(carry, inp):
        C, logs = carry          # C: (l, r) projection
        core, W = inp
        G = jnp.einsum("ka,anb->knb", C, core)          # (l, n, r)
        Y = jnp.einsum("anb,bl->anl", G, W).reshape(l * n, l)
        if qr_method == "cholqr":
            q = _cholqr2(Y, tiny)
        elif qr_method == "cholqr1":
            # single shifted pass: RANDOM-TT sketch panels are
            # well-conditioned w.h.p., so one Gram+chol+trsm reaches
            # u*kappa^2 ~ u orthogonality with GEMMs and one small
            # Cholesky instead of the Householder panel chain (the
            # sweep's sequential bottleneck).  CAVEAT: unsafe for structured inputs whose
            # panels carry large kappa (measured: fused Laplace-MPO apply
            # panels lose to 0.26 rel err at f32) — default to
            # 'householder' unless the input class is known benign.
            from jax.scipy.linalg import solve_triangular
            Gm = Y.T @ Y
            shift = (jnp.asarray(10 * Y.shape[0] * jnp.finfo(dtype).eps,
                                 dtype) * jnp.max(jnp.diagonal(Gm)) + tiny)
            Lc = jnp.linalg.cholesky(Gm + shift * jnp.eye(l, dtype=dtype))
            q = solve_triangular(Lc, Y.T, lower=True).T
        else:
            q, _ = jnp.linalg.qr(Y)
        q = q * col_mask[None, :]
        Q = q.reshape(l, n, l)
        C2 = jnp.einsum("ank,anb->kb", Q, G)            # (l, r)
        nrm = jnp.linalg.norm(C2) + tiny
        return (C2 / nrm, logs + jnp.log(nrm)), Q

    C0 = jnp.zeros((l, r), dtype=dtype).at[0, 0].set(1.0)
    (Cfin, logs), Qs = jax.lax.scan(
        sweep_body, (C0, jnp.zeros((), dtype)), (stacked[:-1], Ws))
    final = jnp.einsum("ka,anb->knb", Cfin, stacked[d - 1])  # (l, n, r)
    scale = jnp.exp(logs / d)
    return Qs * scale, final * scale


def _round_streaming_scan(stacked: jnp.ndarray, target_rank: int,
                          psi_oversample: int):
    """Streaming two-sided (generalized Nyström) TT rounding — NO sequential
    factorization anywhere (new design; streaming sketch idea of
    'Streaming Tensor Train Approximation', arXiv 2208.02600; reference's
    only rounding is the sequential QR+SVD chain, tensorNetwork.cpp:678).

    Motivation: the randomize-then-orthogonalize sweep spends most of its
    time in the d-1 sequential (2n*l, l) Householder QR panels, not in the
    two GEMM scans.  Here the sequential work is ONLY the two independent
    sketch scans (pure GEMM);
    everything else is one batched tail.

    Math.  With left sketches  L_j = Psi_j X_{<=j}  (l' x r, random
    per-site Gaussians Phi contracted left-to-right), right sketches
    W_j = X_{>j} Omega_j  (r x l, right-to-left), and cross matrices
    Z_j = Psi_j X Omega_j = L_j W_j  (l' x l), the chained generalized
    Nyström identity gives the rank-l TT

        X  ~=  (X_0 W_1) Z_1^+ (L_1 X_1 W_2) Z_2^+ ... Z_{d-1}^+ (L_{d-1} X_{d-1})

    exactly (full-rank case) and quasi-optimally under truncation.  The
    pseudo-inverses are lambda-regularized normal equations
    (Z^T Z + lambda I)^{-1} Z^T  — one BATCHED Cholesky + solve over all
    d-1 bonds, no eigh/SVD/Householder-QR.  Oversampling lives in the Psi
    side (l' = l + psi_oversample > l = target) as generalized Nyström
    requires.

    Conditioning: after the two norm-normalized GEMM scans, ALL carries
    are re-orthonormalized by ONE fused batched shifted-CholeskyQR pass
    (W stacks column-wise, L stacks row-wise via transpose, width-padded
    into a single batch) — the sequential scans stay pure GEMM and the
    whole fix costs one batched chol + one batched trsm.  Validity: only
    the column space of W matters (right-mixing telescopes through the
    chain), and a left-mixing T L of the L carries cancels exactly
    through the pinv (pinv(T Z) M' = pinv(Z) T^-1 T M = pinv(Z) M for
    full-column-rank Z).  Without this fix the carries' conditioning
    degrades exponentially along the chain (measured: cond(Z) up to 4e17
    at d=10 → ~1e-5 damping errors; 0.156 relative error on the d=20
    f32 representable-rank oracle).  With it: 7.98e-13 (f64, d=10) /
    9e-4 (f32, d=20) — identical to orthonormalizing inside the scan,
    measured, and one pass matches two on every oracle.

    Accuracy contract: the sketch width on the W side IS the output rank
    l (no W-side slack — psi oversampling lives on the Psi/L side and
    only stabilizes the pinv; it does NOT improve truncation quality).
    Exact on representable ranks (8e-13 relative, f64, d=10); under
    truncation the error is a single-digit multiple of the optimal SVD
    error (measured 4-10x over random instances at l = target, vs the
    randomized sweep's 2-3x whose sketch oversamples then truncates the
    basis).  Use `tt_round_randomized_uniform` when truncation quality
    matters more than avoiding the sequential QR chain.  Result is NOT
    canonicalized (same contract as gram_parallel)."""
    d, r, n, _ = stacked.shape
    dtype = stacked.dtype
    l = target_rank
    lp = l + psi_oversample
    tiny = jnp.asarray(1e-30, dtype)
    key = jax.random.PRNGKey(0)
    kW, kL = jax.random.split(key)
    keysW = jax.random.split(kW, d)
    keysL = jax.random.split(kL, d)

    # ---- right sketches W_j (r, l), bonds 1..d-1 (pure-GEMM scan) ----
    def w_body(W, inp):
        core, k = inp
        Om = jax.random.normal(k, (l, n, l), dtype=dtype)
        GW = jnp.einsum("anb,bq->anq", core, W,
                        preferred_element_type=dtype)
        Wn = jnp.einsum("anq,pnq->ap", GW, Om,
                        preferred_element_type=dtype)
        Wn = Wn / (jnp.linalg.norm(Wn) + tiny)
        return Wn, Wn

    W_init = jnp.zeros((r, l), dtype=dtype).at[0, 0].set(1.0)
    _, Ws = jax.lax.scan(w_body, W_init, (stacked[1:][::-1], keysW[1:]))
    Ws = Ws[::-1]                       # Ws[k] = W_{k+1} (bond k+1)

    # ---- left sketches L_j (l', r), bonds 1..d-1 (pure-GEMM scan) ----
    def l_body(L, inp):
        core, k = inp
        Phi = jax.random.normal(k, (lp, n, lp), dtype=dtype)
        T = jnp.einsum("pa,anb->pnb", L, core,
                       preferred_element_type=dtype)
        Ln = jnp.einsum("qnp,pnb->qb", Phi, T,
                        preferred_element_type=dtype)
        Ln = Ln / (jnp.linalg.norm(Ln) + tiny)
        return Ln, Ln

    L_init = jnp.zeros((lp, r), dtype=dtype).at[0, 0].set(1.0)
    _, Ls = jax.lax.scan(l_body, L_init, (stacked[:-1], keysL[:-1]))
    # Ls[k] = L_{k+1} (bond k+1), k = 0..d-2

    # ---- batched carry re-conditioning (ONE fused shifted-CholeskyQR
    # pass).  W carries (r, l) get column-QR (right-mixing of a sketch is
    # free — it telescopes through the pinv chain); L carries are wide
    # (lp, r) whenever lp < r, so they get ROW-QR (= column-QR of L^T),
    # a left-mixing T L that cancels exactly through pinv(Z) M for
    # full-column-rank Z since pinv(T Z) = pinv(Z) T^-1.  Both families
    # are width-padded and concatenated into a single batched
    # chol+trsm — measured: one pass gives the same error as two on all
    # oracles (7.98e-13 f64 repr-rank d=10; 9e-4 f32 d=20). ----
    from jax.scipy.linalg import solve_triangular

    def _cholqr1_batched(X):
        b, mm, w = X.shape
        G = jnp.einsum("kpa,kpb->kab", X, X, preferred_element_type=dtype)
        diag = jnp.max(jnp.einsum("kaa->ka", G), axis=-1)
        shift = (jnp.asarray(10 * mm * jnp.finfo(dtype).eps, dtype)
                 * diag + tiny)
        Gs = G + shift[:, None, None] * jnp.eye(w, dtype=dtype)[None]
        Lc = jnp.linalg.cholesky(Gs)
        Qt = solve_triangular(Lc, jnp.transpose(X, (0, 2, 1)), lower=True)
        return jnp.transpose(Qt, (0, 2, 1))

    width = max(l, lp)                   # both carry stacks are (d-1, r, *)
    Wp = jnp.pad(Ws, ((0, 0), (0, 0), (0, width - l)))
    Lp = jnp.pad(jnp.transpose(Ls, (0, 2, 1)),
                 ((0, 0), (0, 0), (0, width - lp)))
    allc = _cholqr1_batched(jnp.concatenate([Wp, Lp], axis=0))
    nw = Ws.shape[0]
    Ws = allc[:nw, :, :l]
    Ls = jnp.transpose(allc[nw:, :, :lp], (0, 2, 1))

    # ---- batched tail: Z, M, regularized pinv solves ----
    Zs = jnp.einsum("kpa,kal->kpl", Ls, Ws,
                    preferred_element_type=dtype)          # (d-1, l', l)
    # M_k = L_k X_k W_{k+1} for cores k = 1..d-2
    Ms = jnp.einsum("kpa,kanb,kbl->kpnl", Ls[:-1], stacked[1:-1], Ws[1:],
                    preferred_element_type=dtype)          # (d-2, l', n, l)
    Mlast = jnp.einsum("pa,anb->pnb", Ls[-1], stacked[-1],
                       preferred_element_type=dtype)       # (l', n, r)
    # last core's logical right boundary is rank 1 (pad-to-max discipline):
    # slice/pad its right leg to l BEFORE flattening so modes stay aligned
    if r >= l:
        Mlast_l = Mlast[:, :, :l]
    else:
        Mlast_l = jnp.pad(Mlast, ((0, 0), (0, 0), (0, l - r)))
    rhs = jnp.concatenate([Ms.reshape(d - 2, lp, n * l),
                           Mlast_l.reshape(1, lp, n * l)], axis=0)

    eps_rel = jnp.asarray(10.0 * lp * jnp.finfo(dtype).eps, dtype)
    G = jnp.einsum("kpl,kpm->klm", Zs, Zs,
                   preferred_element_type=dtype)           # (d-1, l, l)
    shift = eps_rel * jnp.max(jnp.einsum("kll->kl", G), axis=-1) + tiny
    G = G + shift[:, None, None] * jnp.eye(l, dtype=dtype)[None]
    ZtM = jnp.einsum("kpl,kpm->klm", Zs, rhs,
                     preferred_element_type=dtype)         # (d-1, l, n*l)
    Lc = jnp.linalg.cholesky(G)
    from jax.scipy.linalg import solve_triangular
    sol = solve_triangular(Lc, ZtM, lower=True)
    Cs = solve_triangular(jnp.transpose(Lc, (0, 2, 1)), sol,
                          lower=False)                     # (d-1, l, n*l)

    first = jnp.einsum("anb,bl->anl", stacked[0], Ws[0],
                       preferred_element_type=dtype)       # (r, n, l)
    mids = Cs[:-1].reshape(d - 2, l, n, l)
    last = Cs[-1].reshape(l, n, l)   # right leg: cols >= 1 are dead padding
    return first, mids, last


@lru_cache(maxsize=32)
def make_streaming_round_scan(shape: Tuple[int, ...], target_rank: int,
                              psi_oversample: int, dtype_str: str):
    return jit_f32(partial(_round_streaming_scan, target_rank=target_rank,
                           psi_oversample=psi_oversample), dtype_str)


def tt_round_streaming_uniform(cores: Sequence[jnp.ndarray], target_rank: int,
                               psi_oversample: int = 32):
    """Pad, run the streaming (two-sided sketch) kernel, clip the boundary
    legs.  See `_round_streaming_scan`.

    Unlike the QR-based kernels, the Nyström cores are dense across all
    `target_rank` coordinates (there is no orthogonal basis concentrating
    the boundary-forced low ranks in the leading slots), so EVERY interior
    bond is returned at exactly `target_rank` — a valid but non-minimal
    representation near the chain ends.  Run the object layer's `round()`
    (or any canonicalization sweep) afterwards if minimal ranks matter."""
    if len(cores) == 1:
        return [jnp.asarray(cores[0])]   # no bonds to round
    stacked, r = pad_cores([np.asarray(c) for c in cores])
    d, _, n, _ = stacked.shape
    fn = make_streaming_round_scan(tuple(stacked.shape), int(target_rank),
                                   int(psi_oversample), str(stacked.dtype))
    first, mids, last = fn(stacked)
    res = [first[:1, :cores[0].shape[1], :]]
    for i in range(1, d - 1):
        res.append(mids[i - 1][:, :cores[i].shape[1], :])
    res.append(last[:, :cores[d - 1].shape[1], :1])
    return res


@lru_cache(maxsize=32)
def make_randomized_round_scan(shape: Tuple[int, ...], target_rank: int,
                               oversample: int, dtype_str: str,
                               qr_method: str = "householder"):
    return jit_f32(partial(_round_randomized_scan, target_rank=target_rank,
                           oversample=oversample, qr_method=qr_method),
                   dtype_str)


def tt_round_randomized_uniform(cores: Sequence[jnp.ndarray], target_rank: int,
                                oversample: int = 8,
                                qr_method: str = "householder"):
    """Pad, run the scan kernel, unpad to logical ranks (<= target)."""
    stacked, r = pad_cores([np.asarray(c) for c in cores])
    d, _, n, _ = stacked.shape
    fn = make_randomized_round_scan(tuple(stacked.shape), int(target_rank),
                                    int(oversample), str(stacked.dtype),
                                    qr_method)
    Qs, final = fn(stacked)
    res = []
    for i in range(d):
        rl = 1 if i == 0 else res_rank(i, d, n, target_rank)
        rr = 1 if i == d - 1 else res_rank(i + 1, d, n, target_rank)
        if i < d - 1:
            core = Qs[i][:rl, :cores[i].shape[1], :rr]
        else:
            core = final[:rl, :cores[i].shape[1], :rr]
        res.append(core)
    return res


def tt_round_eps_fast(cores: Sequence[jnp.ndarray], max_rank: int,
                      eps: float, oversample: int = 8,
                      qr_method: str = "householder"):
    """Fast eps-adaptive rounding (reference semantics of
    round(maxRanks, eps), ttNetwork.cpp:644-685): randomized
    preconditioning down to ``max_rank``, then
    the EXACT eps-truncating svd scan on the now-small cores, instead of
    the direct svd-eps scan at full rank (the sequential chain's SVDs
    then run at the small rank).  Error: eps-optimal on the randomized
    stage's quasi-optimal
    rank-l image (the stage-1 error, 2-3x the optimal rank-l error, adds
    in quadrature).  qr_method defaults to Householder — cholqr1 is
    unsafe for structured inputs (see the caveat in
    _round_randomized_scan; measured 0.29 rel err on an f32 Laplace-apply
    image vs 5.8e-6 with Householder)."""
    mid = tt_round_randomized_uniform(cores, int(max_rank),
                                      oversample=int(oversample),
                                      qr_method=qr_method)
    return tt_round_sweep_uniform(mid, int(max_rank), method="svd",
                                  eps=float(eps))


@lru_cache(maxsize=64)
def make_randomized_round(shapes: Tuple[Tuple[int, ...], ...], target_rank: int,
                          oversample: int, dtype_str: str):
    return jax.jit(partial(_round_randomized, target_rank=target_rank,
                           oversample=oversample))


def tt_round_randomized(cores: Sequence[jnp.ndarray], target_rank: int,
                        oversample: int = 8):
    shapes = tuple(tuple(c.shape) for c in cores)
    fn = make_randomized_round(shapes, int(target_rank), int(oversample),
                               str(cores[0].dtype))
    return fn(tuple(cores), jnp.zeros((1,), dtype=jnp.int32))


def randomized_round_flops(shapes, target_rank: int, oversample: int) -> float:
    l = target_rank + oversample
    shapes = [tuple(s) for s in shapes]
    d = len(shapes)
    total = 0.0
    # sketch build
    w = 1
    for i in range(d - 2, -1, -1):
        rl, n, rr = shapes[i + 1]
        total += 2.0 * rl * n * rr * w      # GW
        total += 2.0 * rl * n * w * l       # contraction with R
        w = l
    # sweep
    carry = None
    for i in range(d - 1):
        rl, n, rr = shapes[i]
        if carry is not None:
            total += 2.0 * carry * rl * n * rr
            rl = carry
        total += 2.0 * rl * n * rr * l      # Y = G W
        total += _qr_flops(rl * n, l)
        k = min(target_rank, rl * n, l)
        total += 2.0 * k * rl * n * rr      # carry update
        carry = k
    rl, n, rr = shapes[d - 1]
    total += 2.0 * carry * rl * n * rr
    return total


# ---------------------------------------------------------------------------
# ALS sweep (SPD): one full left->right half-sweep in a single XLA program
# ---------------------------------------------------------------------------

def _als_half_sweep(x_cores, A_cores, b_cores, assume="pos"):
    """Single-site ALS half-sweep (energy-functional local problems);
    x assumed canonicalized at 0.  Returns updated x cores (core at d-1).

    ``assume`` picks the local solver: "pos" = Cholesky (symmetric
    operators), "gen" = LU.  The reference runtime-detects symmetry of
    every local operator and falls back to PLU
    (blasLapackWrapper.cpp:542-585) — that is what lets its ALS_SPD run
    on non-symmetric operators (e.g. the cascade master-equation
    generator, doc cascade.md); here the choice is made ONCE per
    operator on the host (TTOperator symmetry check) so the compiled
    program stays branch-free."""
    d = len(x_cores)
    dtype = x_cores[0].dtype
    # right environments
    op_right = [None] * (d + 1)
    rhs_right = [None] * (d + 1)
    op_right[d] = jnp.ones((1, 1, 1), dtype=dtype)
    rhs_right[d] = jnp.ones((1, 1), dtype=dtype)
    for k in range(d - 1, 0, -1):
        xc, Ac, bc = x_cores[k], A_cores[k], b_cores[k]
        op_right[k] = jnp.einsum("umU,amnb,vnV,UbV->uav", xc, Ac, xc,
                                 op_right[k + 1])
        rhs_right[k] = jnp.einsum("umU,bmB,UB->ub", xc, bc, rhs_right[k + 1])

    x_cores = list(x_cores)
    op_left = jnp.ones((1, 1, 1), dtype=dtype)
    rhs_left = jnp.ones((1, 1), dtype=dtype)
    for k in range(d):
        Ac, bc = A_cores[k], b_cores[k]
        Aloc = jnp.einsum("uav,amnb,UbV->umUvnV", op_left, Ac, op_right[k + 1])
        bloc = jnp.einsum("ub,bmB,UB->umU", rhs_left, bc, rhs_right[k + 1])
        shape = bloc.shape
        nn = shape[0] * shape[1] * shape[2]
        sol = jax.scipy.linalg.solve(
            Aloc.reshape(nn, nn), bloc.reshape(nn), assume_a=assume)
        core = sol.reshape(shape)
        if k < d - 1:
            rl, n, rr = core.shape
            q, r = jnp.linalg.qr(core.reshape(rl * n, rr))
            kk = q.shape[1]
            x_cores[k] = q.reshape(rl, n, kk)
            x_cores[k + 1] = jnp.einsum("ab,bnc->anc", r, x_cores[k + 1])
            op_left = jnp.einsum("uav,umU,amnb,vnV->UbV", op_left,
                                 x_cores[k], Ac, x_cores[k])
            rhs_left = jnp.einsum("ub,umU,bmB->UB", rhs_left, x_cores[k], bc)
        else:
            x_cores[k] = core
    return tuple(x_cores)


def _als_half_sweep_cg(x_cores, A_cores, b_cores, cg_iters: int = 24):
    """Single-site SPD ALS half-sweep with MATRIX-FREE CG local solves:
    the local operator is never materialized — each CG iteration applies
    it through the environments (three small einsums).  For rank r the
    dense path forms an (r*n*r)^2 matrix and Cholesky-factorizes it
    (O(r^6 n^3 / 3) flops, O(r^4 n^2) memory): prohibitive past r ~ 64.
    Here cost is O(cg_iters * r^3 n^2 a) flops and O(r^2 n a) memory —
    THE enabler for large-rank single-site sweeps.  The local systems are
    SPD with modest condition (the left/right bases are orthonormal), so
    a fixed small iteration count reaches f32-level accuracy; x assumed
    canonicalized at 0 (als.cpp:483-564 semantics, lapack_solver swapped
    for CG)."""
    d = len(x_cores)
    dtype = x_cores[0].dtype
    tiny = jnp.asarray(1e-30, dtype)
    op_right = [None] * (d + 1)
    rhs_right = [None] * (d + 1)
    op_right[d] = jnp.ones((1, 1, 1), dtype=dtype)
    rhs_right[d] = jnp.ones((1, 1), dtype=dtype)
    for k in range(d - 1, 0, -1):
        xc, Ac, bc = x_cores[k], A_cores[k], b_cores[k]
        op_right[k] = jnp.einsum("umU,amnb,vnV,UbV->uav", xc, Ac, xc,
                                 op_right[k + 1])
        rhs_right[k] = jnp.einsum("umU,bmB,UB->ub", xc, bc, rhs_right[k + 1])

    x_cores = list(x_cores)
    op_left = jnp.ones((1, 1, 1), dtype=dtype)
    rhs_left = jnp.ones((1, 1), dtype=dtype)
    for k in range(d):
        Ac, bc, xc = A_cores[k], b_cores[k], x_cores[k]
        opR = op_right[k + 1]

        def apply_loc(v, opL=op_left, Ak=Ac, opRk=opR):
            t = jnp.einsum("uav,vnV->uanV", opL, v)
            t = jnp.einsum("amnb,uanV->umbV", Ak, t)
            return jnp.einsum("UbV,umbV->umU", opRk, t)

        bloc = jnp.einsum("ub,bmB,UB->umU", rhs_left, bc, rhs_right[k + 1])
        # CG from the current core (warm start: the sweep's previous
        # iterate is already close after the first full sweep)
        rvec = bloc - apply_loc(xc)
        pvec = rvec
        rs = jnp.sum(rvec * rvec)

        def cg_body(_, state, apply_loc=apply_loc):
            xv, rv, pv, rs = state
            Ap = apply_loc(pv)
            denom = jnp.sum(pv * Ap)
            alpha = jnp.where(denom > tiny, rs / jnp.maximum(denom, tiny),
                              0.0)
            xv = xv + alpha * pv
            rv = rv - alpha * Ap
            rs2 = jnp.sum(rv * rv)
            beta = jnp.where(rs > tiny, rs2 / jnp.maximum(rs, tiny), 0.0)
            return (xv, rv, rv + beta * pv, rs2)

        core, _, _, _ = jax.lax.fori_loop(0, cg_iters, cg_body,
                                          (xc, rvec, pvec, rs))
        if k < d - 1:
            rl, n, rr = core.shape
            q, r = jnp.linalg.qr(core.reshape(rl * n, rr))
            x_cores[k] = q.reshape(rl, n, q.shape[1])
            x_cores[k + 1] = jnp.einsum("ab,bnc->anc", r, x_cores[k + 1])
            op_left = jnp.einsum("uav,umU,amnb,vnV->UbV", op_left,
                                 x_cores[k], Ac, x_cores[k])
            rhs_left = jnp.einsum("ub,umU,bmB->UB", rhs_left, x_cores[k], bc)
        else:
            x_cores[k] = core
    return tuple(x_cores)


def _asd_half_sweep(x_cores, A_cores, b_cores):
    """Single-site SPD ASD half-sweep (als.cpp:73-92 ASD_solver): one
    exact-stepsize gradient step per site instead of the local solve —
    x_k += alpha * (b_loc - A_loc x_k), alpha = <g,g>/<g,A_loc g>.  The
    local operator is never materialized (matrix-free applies through
    the environments)."""
    d = len(x_cores)
    dtype = x_cores[0].dtype
    tiny = jnp.asarray(1e-30, dtype)
    op_right = [None] * (d + 1)
    rhs_right = [None] * (d + 1)
    op_right[d] = jnp.ones((1, 1, 1), dtype=dtype)
    rhs_right[d] = jnp.ones((1, 1), dtype=dtype)
    for k in range(d - 1, 0, -1):
        xc, Ac, bc = x_cores[k], A_cores[k], b_cores[k]
        op_right[k] = jnp.einsum("umU,amnb,vnV,UbV->uav", xc, Ac, xc,
                                 op_right[k + 1])
        rhs_right[k] = jnp.einsum("umU,bmB,UB->ub", xc, bc, rhs_right[k + 1])

    x_cores = list(x_cores)
    op_left = jnp.ones((1, 1, 1), dtype=dtype)
    rhs_left = jnp.ones((1, 1), dtype=dtype)
    for k in range(d):
        Ac, bc, xc = A_cores[k], b_cores[k], x_cores[k]
        opR = op_right[k + 1]

        def apply_loc(v, opL=op_left, Ak=Ac, opRk=opR):
            t = jnp.einsum("uav,vnV->uanV", opL, v)
            t = jnp.einsum("amnb,uanV->umbV", Ak, t)
            return jnp.einsum("UbV,umbV->umU", opRk, t)

        bloc = jnp.einsum("ub,bmB,UB->umU", rhs_left, bc, rhs_right[k + 1])
        grad = bloc - apply_loc(xc)
        Ag = apply_loc(grad)
        denom = jnp.sum(grad * Ag)
        alpha = jnp.where(denom > tiny,
                          jnp.sum(grad * grad) / jnp.maximum(denom, tiny),
                          0.0)
        core = xc + alpha * grad
        if k < d - 1:
            rl, n, rr = core.shape
            q, r = jnp.linalg.qr(core.reshape(rl * n, rr))
            x_cores[k] = q.reshape(rl, n, q.shape[1])
            x_cores[k + 1] = jnp.einsum("ab,bnc->anc", r, x_cores[k + 1])
            op_left = jnp.einsum("uav,umU,amnb,vnV->UbV", op_left,
                                 x_cores[k], Ac, x_cores[k])
            rhs_left = jnp.einsum("ub,umU,bmB->UB", rhs_left, x_cores[k], bc)
        else:
            x_cores[k] = core
    return tuple(x_cores)


def _als_half_sweep_rl(x_cores, A_cores, b_cores, assume="pos"):
    """Right-to-left SPD half-sweep; x assumed canonicalized at d-1.
    Returns updated cores with the core at 0 (mirror of _als_half_sweep)."""
    d = len(x_cores)
    dtype = x_cores[0].dtype
    op_left = [None] * d
    rhs_left = [None] * d
    op_left[0] = jnp.ones((1, 1, 1), dtype=dtype)
    rhs_left[0] = jnp.ones((1, 1), dtype=dtype)
    for k in range(0, d - 1):
        xc, Ac, bc = x_cores[k], A_cores[k], b_cores[k]
        op_left[k + 1] = jnp.einsum("uav,umU,amnb,vnV->UbV", op_left[k],
                                    xc, Ac, xc)
        rhs_left[k + 1] = jnp.einsum("ub,umU,bmB->UB", rhs_left[k], xc, bc)

    x_cores = list(x_cores)
    op_right = jnp.ones((1, 1, 1), dtype=dtype)
    rhs_right = jnp.ones((1, 1), dtype=dtype)
    for k in range(d - 1, -1, -1):
        Ac, bc = A_cores[k], b_cores[k]
        Aloc = jnp.einsum("uav,amnb,UbV->umUvnV", op_left[k], Ac, op_right)
        bloc = jnp.einsum("ub,bmB,UB->umU", rhs_left[k], bc, rhs_right)
        shape = bloc.shape
        nn = shape[0] * shape[1] * shape[2]
        sol = jax.scipy.linalg.solve(
            Aloc.reshape(nn, nn), bloc.reshape(nn), assume_a=assume)
        core = sol.reshape(shape)
        if k > 0:
            rl, n, rr = core.shape
            # RQ via QR of transposed matricization: rows orthonormal
            q, r = jnp.linalg.qr(core.reshape(rl, n * rr).T)
            kk = q.shape[1]
            x_cores[k] = q.T.reshape(kk, n, rr)
            x_cores[k - 1] = jnp.einsum("anb,bc->anc", x_cores[k - 1], r.T)
            op_right = jnp.einsum("umU,amnb,vnV,UbV->uav", x_cores[k],
                                  A_cores[k], x_cores[k], op_right)
            rhs_right = jnp.einsum("umU,bmB,UB->ub", x_cores[k], b_cores[k],
                                   rhs_right)
        else:
            x_cores[k] = core
    return tuple(x_cores)


def _als_half_sweep_nonspd(x_cores, A_cores, b_cores):
    """Normal-equations (A^T A x = A^T b) left->right half-sweep for
    unsymmetric operators (als.cpp choose_energy_functional non-SPD path);
    x assumed canonicalized at 0."""
    d = len(x_cores)
    dtype = x_cores[0].dtype
    op_right = [None] * (d + 1)
    rhs_right = [None] * (d + 1)
    op_right[d] = jnp.ones((1, 1, 1, 1), dtype=dtype)
    rhs_right[d] = jnp.ones((1, 1, 1), dtype=dtype)
    for k in range(d - 1, 0, -1):
        xc, Ac, bc = x_cores[k], A_cores[k], b_cores[k]
        op_right[k] = jnp.einsum("umU,pzmq,rznt,vnV,UqtV->uprv", xc, Ac, Ac,
                                 xc, op_right[k + 1])
        rhs_right[k] = jnp.einsum("bzB,azmq,umU,BqU->bau", bc, Ac, xc,
                                  rhs_right[k + 1])

    x_cores = list(x_cores)
    op_left = jnp.ones((1, 1, 1, 1), dtype=dtype)
    rhs_left = jnp.ones((1, 1, 1), dtype=dtype)
    for k in range(d):
        Ac, bc = A_cores[k], b_cores[k]
        Aloc = jnp.einsum("uprv,pzmq,rznt,UqtV->umUvnV", op_left, Ac, Ac,
                          op_right[k + 1])
        bloc = jnp.einsum("bau,bzB,azmq,BqU->umU", rhs_left, bc, Ac,
                          rhs_right[k + 1])
        shape = bloc.shape
        nn = shape[0] * shape[1] * shape[2]
        sol = jax.scipy.linalg.solve(
            Aloc.reshape(nn, nn), bloc.reshape(nn), assume_a="pos")
        core = sol.reshape(shape)
        if k < d - 1:
            rl, n, rr = core.shape
            q, r = jnp.linalg.qr(core.reshape(rl * n, rr))
            x_cores[k] = q.reshape(rl, n, q.shape[1])
            x_cores[k + 1] = jnp.einsum("ab,bnc->anc", r, x_cores[k + 1])
            op_left = jnp.einsum("uprv,umU,pzmq,rznt,vnV->UqtV", op_left,
                                 x_cores[k], Ac, Ac, x_cores[k])
            rhs_left = jnp.einsum("bau,bzB,azmq,umU->BqU", rhs_left, bc, Ac,
                                  x_cores[k])
        else:
            x_cores[k] = core
    return tuple(x_cores)


def _tt_log_norm_qr(cores):
    """log(||TT||_F) via a log-scaled left-to-right QR orthogonalization
    sweep — NO Gram quadratic form, so no cancellation: the norm is read
    off the final (orthogonal-basis) carry to O(eps) relative accuracy."""
    dtype = cores[0].dtype
    tiny = jnp.asarray(1e-30, dtype)
    R = jnp.ones((1, 1), dtype)
    logs = jnp.zeros((), dtype)
    for core in cores[:-1]:
        rl, n, rr = core.shape
        k = R.shape[0]
        cur = jnp.einsum("ka,anb->knb", R, core,
                         preferred_element_type=dtype).reshape(k * n, rr)
        _, R = jnp.linalg.qr(cur)
        nrm = jnp.linalg.norm(R) + tiny
        logs = logs + jnp.log(nrm)
        R = R / nrm
    last = jnp.einsum("ka,anb->knb", R, cores[-1],
                      preferred_element_type=dtype)
    return logs + jnp.log(jnp.linalg.norm(last) + tiny)


def tt_residual_rel(x_cores, A_cores, b_cores):
    """Relative TT residual ||Ax-b||_F/||b||_F on device, one scalar out.

    The difference z = Ax - b is built in TT BLOCK form per site (kron of
    A and x cores stacked with -b; the product A·x is never materialized
    as a dense tensor) and its norm computed by the cancellation-free
    orthogonalization sweep `_tt_log_norm_qr` — unlike the
    <Ax,Ax>-2<Ax,b>+<b,b> quadratic form (floor sqrt(eps)*||b||), this
    measures residuals down to ~eps*||b|| (~1e-7 relative in f32,
    ~1e-15 in f64).  Reference residual: als.cpp:291,426-475."""
    d = len(x_cores)
    dtype = x_cores[0].dtype
    z_cores = []
    for k in range(d):
        xc, Ac, bc = x_cores[k], A_cores[k], b_cores[k]
        al, m, _n2, ar = Ac.shape
        xl, _, xr = xc.shape
        bl, _, br = bc.shape
        ax = jnp.einsum("amnb,unU->aumbU", Ac, xc,
                        preferred_element_type=dtype
                        ).reshape(al * xl, m, ar * xr)
        if d == 1:
            z_cores.append(ax - bc)
            continue
        if k == 0:
            z_cores.append(jnp.concatenate([ax, -bc], axis=2))
        elif k == d - 1:
            z_cores.append(jnp.concatenate([ax, bc], axis=0))
        else:
            top = jnp.concatenate(
                [ax, jnp.zeros((al * xl, m, br), dtype)], axis=2)
            bot = jnp.concatenate(
                [jnp.zeros((bl, m, ar * xr), dtype), bc], axis=2)
            z_cores.append(jnp.concatenate([top, bot], axis=0))
    log_z = _tt_log_norm_qr(z_cores)
    log_b = _tt_log_norm_qr(list(b_cores))
    return jnp.exp(log_z - log_b)


@lru_cache(maxsize=64)
def make_als_sweep_res(shapes_key: Tuple, dtype_str: str,
                       direction: str = "lr", spd: bool = True,
                       solver: str = "lapack", local_assume: str = "pos"):
    """Fused half-sweep + relative residual: ONE XLA program per
    half-sweep, ONE scalar fetched — no host round-trip of the cores."""
    if solver == "asd":
        body = _asd_half_sweep
    elif solver == "cg":
        body = _als_half_sweep_cg        # lr only; driver site-reverses
    elif not spd:
        body = _als_half_sweep_nonspd
    else:
        raw = _als_half_sweep if direction == "lr" else _als_half_sweep_rl
        body = partial(raw, assume=local_assume)

    def fused(x_cores, A_cores, b_cores):
        out = body(x_cores, A_cores, b_cores)
        return out, tt_residual_rel(out, A_cores, b_cores)

    return jit_f32(fused, dtype_str)


@lru_cache(maxsize=16)
def make_als_multi_sweep_res(shapes_key: Tuple, dtype_str: str,
                             n_half_sweeps: int, spd: bool = True,
                             local_assume: str = "pos"):
    """N alternating-direction half-sweeps + per-sweep relative residual,
    ALL inside one XLA program — one dispatch for a whole solve phase.  Returns (cores, res_history
    (n,)).  x must enter canonicalized at core 0."""

    def multi(x_cores, A_cores, b_cores):
        res_hist = []
        cores = x_cores
        for s in range(n_half_sweeps):
            if spd:
                body = _als_half_sweep if s % 2 == 0 else _als_half_sweep_rl
                cores = body(cores, A_cores, b_cores, assume=local_assume)
            else:
                cores = _als_half_sweep_nonspd(cores, A_cores, b_cores)
            res_hist.append(tt_residual_rel(cores, A_cores, b_cores))
        return cores, jnp.stack(res_hist)

    return jit_f32(multi, dtype_str)


@lru_cache(maxsize=16)
def make_als_run(shapes_key: Tuple, dtype_str: str, max_sweeps: int,
                 local_assume: str = "pos"):
    """The WHOLE fixed-rank SPD ALS solve as ONE XLA program: a
    lax.while_loop alternating lr/rl half-sweeps (lax.cond on the sweep
    parity — no data reversal, so the ragged per-site core shapes stay a
    stable carry) with the fused relative residual and the driver's
    two-back stagnation test in-program (|last-res|<eps or |last2-res|<eps,
    als.py _solve_fast).  One dispatch replaces one dispatch + one scalar
    fetch per half-sweep.

    ``parity0`` continues the lr/rl alternation and ``last0``/``last20``
    the two-back stagnation history across re-dispatches when the static
    ``max_sweeps`` bucket is exhausted (pass +inf on the first call);
    ``remaining`` trims the loop below the bucket.  Returns
    (cores, res_hist, count): hist[i] is the relative residual AFTER
    half-sweep i, valid for i < count."""

    def run(x_cores, A_cores, b_cores, conv_eps, parity0, remaining,
            last0, last20):
        dtype = x_cores[0].dtype
        limit = jnp.minimum(jnp.asarray(max_sweeps, jnp.int32),
                            remaining.astype(jnp.int32))

        def cond(carry):
            _cs, _h, i, _l, _l2, stop = carry
            return jnp.logical_and(i < limit, jnp.logical_not(stop))

        def body(carry):
            cores, hist, i, last, last2, _stop = carry
            cores = jax.lax.cond(
                (parity0 + i) % 2 == 0,
                lambda cs: _als_half_sweep(cs, A_cores, b_cores,
                                           assume=local_assume),
                lambda cs: _als_half_sweep_rl(cs, A_cores, b_cores,
                                              assume=local_assume),
                cores)
            res = tt_residual_rel(cores, A_cores, b_cores)
            hist = hist.at[i].set(res)
            stop = jnp.logical_or(jnp.abs(last - res) < conv_eps,
                                  jnp.abs(last2 - res) < conv_eps)
            return (cores, hist, i + 1, res, last, stop)

        hist0 = jnp.full((max_sweeps,), jnp.inf, dtype)
        carry = (tuple(x_cores), hist0, jnp.zeros((), jnp.int32),
                 last0.astype(dtype), last20.astype(dtype),
                 jnp.zeros((), jnp.bool_))
        cores, hist, i, _l, _l2, _s = jax.lax.while_loop(cond, body, carry)
        return cores, hist, i

    return jit_f32(run, dtype_str)


@lru_cache(maxsize=16)
def make_als_run_rev(shapes_key: Tuple, dtype_str: str, max_sweeps: int,
                     solver: str = "nonspd"):
    """Device-resident whole-solve driver for the reversal-style ALS
    paths — non-SPD normal equations (``solver="nonspd"``), ASD
    (``"asd"``) and matrix-free CG (``"cg"``) — whose half-sweep kernels
    only exist in lr form: odd half-sweeps run the lr kernel on the
    site-REVERSED system, with both reversals traced inside the
    lax.cond branch (the host loop paid reversal dispatches + one scalar
    fetch per half-sweep; als.py:220-246).

    Same carry/stop protocol as make_als_run: ``parity0`` continues the
    alternation across re-dispatches, ``last0``/``last20`` the two-back
    stagnation history, ``remaining`` trims the static bucket.  Cores
    enter canonicalized at 0 and leave at d-1 (even executed parity) or
    0 (odd), exactly like the host loop's reversal bookkeeping."""
    if solver == "asd":
        body_sweep = _asd_half_sweep
    elif solver == "cg":
        body_sweep = _als_half_sweep_cg
    else:
        body_sweep = _als_half_sweep_nonspd

    def rev_tt(cs):
        return tuple(jnp.transpose(c, (2, 1, 0)) for c in reversed(cs))

    def rev_op(cs):
        return tuple(jnp.transpose(c, (3, 1, 2, 0)) for c in reversed(cs))

    def run(x_cores, A_cores, b_cores, conv_eps, parity0, remaining,
            last0, last20):
        dtype = x_cores[0].dtype
        limit = jnp.minimum(jnp.asarray(max_sweeps, jnp.int32),
                            remaining.astype(jnp.int32))
        A_rev = rev_op(A_cores)
        b_rev = rev_tt(b_cores)

        def cond(carry):
            _cs, _h, i, _l, _l2, stop = carry
            return jnp.logical_and(i < limit, jnp.logical_not(stop))

        def body(carry):
            cores, hist, i, last, last2, _stop = carry
            cores = jax.lax.cond(
                (parity0 + i) % 2 == 0,
                lambda cs: body_sweep(cs, A_cores, b_cores),
                lambda cs: rev_tt(body_sweep(rev_tt(cs), A_rev, b_rev)),
                cores)
            res = tt_residual_rel(cores, A_cores, b_cores)
            hist = hist.at[i].set(res)
            stop = jnp.logical_or(jnp.abs(last - res) < conv_eps,
                                  jnp.abs(last2 - res) < conv_eps)
            return (cores, hist, i + 1, res, last, stop)

        hist0 = jnp.full((max_sweeps,), jnp.inf, dtype)
        carry = (tuple(x_cores), hist0, jnp.zeros((), jnp.int32),
                 last0.astype(dtype), last20.astype(dtype),
                 jnp.zeros((), jnp.bool_))
        cores, hist, i, _l, _l2, _s = jax.lax.while_loop(cond, body, carry)
        return cores, hist, i

    return jit_f32(run, dtype_str)


@lru_cache(maxsize=64)
def make_als_sweep(shapes_key: Tuple, dtype_str: str, direction: str = "lr",
                   spd: bool = True, solver: str = "lapack",
                   local_assume: str = "pos"):
    if solver == "asd":
        # ASD: lr kernel only (the driver site-reverses for rl sweeps)
        return jit_f32(_asd_half_sweep, dtype_str)
    if solver == "cg":
        # matrix-free CG local solves: lr only, driver site-reverses
        return jit_f32(_als_half_sweep_cg, dtype_str)
    if not spd:
        return jit_f32(_als_half_sweep_nonspd, dtype_str)
    return jit_f32(partial(_als_half_sweep if direction == "lr"
                           else _als_half_sweep_rl, assume=local_assume),
                   dtype_str)


@lru_cache(maxsize=32)
def make_als_sweep_batched(shapes_key: Tuple, dtype_str: str,
                           direction: str = "lr", batched_A: bool = False,
                           local_assume: str = "pos"):
    """Throughput-mode SPD ALS: one jitted program sweeping a BATCH of
    independent (x, b) systems (optionally per-instance operators A).

    The site chain of a single ALS sweep is sequential with small per-site
    ops, so the matrix units idle between them; vmapping B instances turns every
    per-site env-contraction / local solve / QR into a batched op and
    multiplies useful work per dispatch by B without changing the sweep
    math.  This is the device analogue of the reference benchmark protocol's
    10-solves-per-run loop (benchmark.cxx:215-267), executed as one XLA
    program instead of 10 host iterations."""
    body = partial(_als_half_sweep if direction == "lr"
                   else _als_half_sweep_rl, assume=local_assume)
    a_axes = 0 if batched_A else None
    fn = jax.vmap(body, in_axes=(0, a_axes, 0))
    return jit_f32(fn, dtype_str)


def als_half_sweep_batched(x_batch, A_cores, b_batch,
                           direction: str = "lr"):
    """Run one SPD half-sweep over a batch of systems sharing operator A.

    x_batch / b_batch: sequences of per-site arrays with a leading batch
    axis ((B, rl, n, rr) / (B, rl, n, rr)); every instance must share the
    same core shapes (same ranks) — the batch is one jit specialization."""
    shapes_key = (tuple(tuple(c.shape) for c in x_batch),
                  tuple(tuple(c.shape) for c in A_cores),
                  tuple(tuple(c.shape) for c in b_batch))
    fn = make_als_sweep_batched(shapes_key, str(x_batch[0].dtype), direction)
    return fn(tuple(x_batch), tuple(A_cores), tuple(b_batch))


def als_sweep_flops(x_shapes, A_shapes) -> float:
    """Rough FLOP count of one half-sweep (envs + local solves)."""
    d = len(x_shapes)
    total = 0.0
    for k in range(d):
        rl, n, rr = x_shapes[k]
        al, m, m2, ar = A_shapes[k]
        # env update (two sides amortized): ~ 2 * (r^2 a n^2 r + ...)
        total += 4.0 * rl * rr * al * ar * n * n
        # local operator assembly + solve
        loc = rl * n * rr
        total += 2.0 * loc * loc * max(al, ar) + (2.0 / 3.0) * loc ** 3
    return total


# Public speed presets for the randomized rounding sweep, exposed through
# TTNetwork.round_fast(speed=...) and used verbatim by bench.py's
# bf16-frontier row (one source of truth).  Measured by
# benchmarks/bf16_round_study.py.  GUARDRAIL: gram_precision must
# stay >= 'high' whenever the bulk precision is lowered — cholqr1 panel
# orthogonality degrades as u_gram * kappa^2 and the loss compounds along
# the chain (measured 4.6x truncation-error blowup at gram='default' on
# the decaying-spectrum instance; tests/test_tt.py pins the preset).
SPEED_PRESETS = {
    "exact": {"precision": None, "gram_precision": None},
    "bf16_frontier": {"precision": "default", "gram_precision": "high"},
}


@lru_cache(maxsize=32)
def make_randomized_round_unrolled(shapes_key: Tuple, target_rank: int,
                                   oversample: int, dtype_str: str,
                                   precision: str = None,
                                   gram_precision: str = None):
    """Jitted unrolled true-shape randomized rounding sweep with cholqr1
    panels (the bench headline kernel; see _round_randomized).  One
    compile per exact shape tuple — use the padded scan factory
    (make_randomized_round_scan) when shapes vary.  ``precision`` /
    ``gram_precision`` lower the bulk-GEMM / Gram matmul precision (see
    _round_randomized; trade-offs measured by benchmarks/bf16_round_study.py)."""
    def fn(cores):
        return _round_randomized(cores, None, target_rank, oversample,
                                 qr_method="cholqr1", precision=precision,
                                 gram_precision=gram_precision)
    return jit_f32(fn, dtype_str)
