"""Matrix factorizations on matricized tensors.

Re-design of xerus' factorization layer (src/xerus/tensor.cpp:1361-1704,
src/xerus/blasLapackWrapper.cpp:218-651) on top of jnp.linalg.  All
factorizations split the tensor's modes at ``split_pos`` into an
(lhsSize x rhsSize) matrix.

Truncation semantics match the reference exactly:
* SVD (tensor.cpp:1424-1475): hard cap ``max_rank`` (0 = none), then drop
  sigma_j <= eps * sigma_0; S carries |factor|, a negative factor flips Vt.
* QC/CQ rank rule (blasLapackWrapper.cpp:262-361): first r with
  |R[r,r]| < 16*eps_machine*R[0,0].  XLA has no pivoted QR, so QC is
  implemented as thin SVD with the same rank rule applied to sigma — an
  orthogonal-times-rest factorization with identical rank decisions for
  numerically well-separated spectra.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import config, require
from ..misc.performance import pa_section
from .tensor import Tensor, Representation, _prod
from .contract import contract


def _split_sizes(t: Tensor, split_pos: int) -> Tuple[int, int, int]:
    require(0 <= split_pos <= t.degree(), "split position out of range")
    lhs = _prod(t.dimensions[:split_pos])
    rhs = _prod(t.dimensions[split_pos:])
    return lhs, rhs, min(lhs, rhs)


def _host_operand(a):
    """Pin a factorization operand to the CPU device.

    The object-layer factorizations carry the reference's f64 LAPACK
    (host) semantics (blasLapackWrapper.cpp:218-651), including its
    failure behaviour (the gesdd/gesvd fallback below).  An operand that
    is already device-committed drags the jitted factorization onto the
    accelerator REGARDLESS of any surrounding ``xe.host()`` scope (jax
    placement follows committed operands, not ``default_device``).
    Pinning here keeps every dense object-layer factorization on host
    LAPACK, whatever the caller forgot."""
    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError:
        return a          # no CPU backend registered: leave placement alone
    devs = getattr(a, "devices", None)
    if devs is not None and all(d.platform == "cpu" for d in a.devices()):
        return a
    return jax.device_put(a, cpu)


@jax.jit
def _svd_jit(a):
    return jnp.linalg.svd(a, full_matrices=False)


def _svd_robust(a):
    """Thin SVD that survives LAPACK gesdd non-convergence.

    XLA's CPU SVD custom-call wraps gesdd and returns nan silently when
    the divide-and-conquer iteration fails (no info flag surfaces through
    jnp.linalg.svd).  Observed in round 4 on a REAL object-layer matrix —
    a 96x48 f64 DMRG-residual unfolding (committed regression fixtures
    tests/data/gesdd_failure_*.npy, captured via
    XERUS_TPU_CAPTURE_GESDD_DIR) — where the QC rank rule read
    nan singular values as 'rank 1' and silently truncated the tensor.
    On nan output, retry with scipy's gesvd driver (plain QR-iteration
    bidiagonal SVD, the slower-but-robust classic), matching the
    reference's LAPACK usage which treats info>0 as an error rather than
    an answer (blasLapackWrapper.cpp:218-270)."""
    u, s, vt = _svd_jit(a)
    s_host = np.asarray(s)
    if not np.isnan(s_host).any():
        return u, s, vt
    cap_dir = os.environ.get("XERUS_TPU_CAPTURE_GESDD_DIR")
    if cap_dir:
        # Preserve the failing matrix as a regression fixture
        # (tests/test_factorizations.py::test_gesdd_failure_fixture_if_present).
        a_np = np.asarray(a)
        os.makedirs(cap_dir, exist_ok=True)
        np.save(os.path.join(
            cap_dir, f"gesdd_failure_{a_np.shape[0]}x{a_np.shape[1]}.npy"),
            a_np)
    try:
        from scipy.linalg import svd as _scipy_svd
        u2, s2, vt2 = _scipy_svd(np.asarray(a), full_matrices=False,
                                 lapack_driver="gesvd")
    except ImportError:
        # numpy's svd is the same gesdd class, but a fresh process-level
        # LAPACK entry occasionally succeeds where XLA's custom-call
        # failed; better than raising mid-solve with no signal.
        u2, s2, vt2 = np.linalg.svd(np.asarray(a), full_matrices=False)
    require(not np.isnan(s2).any(),
            "SVD failed to converge (gesdd AND gesvd): input likely "
            "contains non-finite values")
    # Pin the fallback results like the operands: bare jnp.asarray would
    # place them on the session default device, dragging downstream
    # object-layer math onto the accelerator.  device_put from numpy goes
    # host->CPU directly.
    try:
        cpu = jax.devices("cpu")[0]
        return (jax.device_put(u2, cpu), jax.device_put(s2, cpu),
                jax.device_put(vt2, cpu))
    except RuntimeError:
        return jnp.asarray(u2), jnp.asarray(s2), jnp.asarray(vt2)


@jax.jit
def _qr_jit(a):
    return jnp.linalg.qr(a, mode="reduced")


def calculate_svd(t: Tensor, split_pos: int, max_rank: int = 0,
                  eps: float = 0.0) -> Tuple[Tensor, Tensor, Tensor]:
    """(U, S, Vt) with U: dims[:split]+[r], S: r x r sparse-diag, Vt: [r]+dims[split:]."""
    require(0.0 <= eps < 1.0, "epsilon must fulfill 0 <= eps < 1")
    lhs_size, rhs_size, rank = _split_sizes(t, split_pos)
    a = _host_operand(t.to_jax(apply_factor=False)).reshape(lhs_size, rhs_size)
    with pa_section("Dense LAPACK", "Singular Value Decomposition",
                    f"{lhs_size}x{rhs_size}"):
        u, s, vt = _svd_robust(a)
        s_host = np.asarray(s)

    if max_rank:
        rank = min(rank, int(max_rank))
    # eps-truncation relative to sigma_0 (tensor.cpp:1468-1473)
    for j in range(1, rank):
        if s_host[j] <= eps * s_host[0]:
            rank = j
            break
    rank = max(rank, 1)

    U = Tensor.from_jax(u[:, :rank].reshape(t.dimensions[:split_pos] + [rank]))
    Vt = Tensor.from_jax(vt[:rank, :].reshape([rank] + t.dimensions[split_pos:]))
    S = Tensor([rank, rank], Representation.Sparse)
    f = abs(t.factor)
    for i in range(rank):
        S._sparse[i * rank + i] = f * float(s_host[i])
    if t.factor < 0.0:
        Vt.factor = -1.0
    return U, S, Vt


def _sparse_factorization_output(t: Tensor, split_pos: int, rank: int,
                                 lhs_flat, rhs_flat,
                                 rhs_factor: float) -> Tuple[Tensor, Tensor]:
    """Build the (lhs, rhs) sparse tensors of a sparse factorization and
    densify when desirable (tensor.cpp:1495-1570 output handling)."""
    lhs = Tensor(t.dimensions[:split_pos] + [rank], Representation.Sparse)
    lhs._sparse = lhs_flat
    rhs = Tensor([rank] + t.dimensions[split_pos:], Representation.Sparse)
    rhs._sparse = rhs_flat
    rhs.factor = rhs_factor
    lhs.use_dense_representation_if_desirable()
    rhs.use_dense_representation_if_desirable()
    return lhs, rhs


def calculate_qr(t: Tensor, split_pos: int) -> Tuple[Tensor, Tensor]:
    lhs_size, rhs_size, rank = _split_sizes(t, split_pos)
    if t.is_sparse():
        # native George-Heath sparse QR (SPQR path of tensor.cpp:1495-1503);
        # plain QR must come out full-rank — structurally deficient inputs
        # take the dense route instead (the reference INTERNAL_CHECKs here)
        from .sparse_qr import sparse_qc
        pos, vals = t.sparse_coo()
        out = sparse_qc(pos, vals, lhs_size, rhs_size, 0.0)
        if out is not None and out[2] == rank:
            return _sparse_factorization_output(t, split_pos, rank, out[0],
                                                out[1], t.factor)
    a = _host_operand(t.to_jax(apply_factor=False)).reshape(lhs_size, rhs_size)
    with pa_section("Dense LAPACK", "QR Factorisation",
                    f"{lhs_size}x{rhs_size}"):
        q, r = _qr_jit(a)
    Q = Tensor.from_jax(q.reshape(t.dimensions[:split_pos] + [rank]))
    R = Tensor.from_jax(r.reshape([rank] + t.dimensions[split_pos:]))
    R.factor = t.factor
    return Q, R


def calculate_rq(t: Tensor, split_pos: int) -> Tuple[Tensor, Tensor]:
    """A = R @ Q with Q having orthonormal rows (blasLapackWrapper.cpp:473-489).

    Implemented via QR of the anti-transpose: with J the reversal permutation,
    A = R Q  <=>  (J A^T J) = (J Q^T J)(J R^T J) is a standard QR.  We use the
    simpler flip identity: qr(flip(A).T) gives RQ of A after flips.
    """
    lhs_size, rhs_size, rank = _split_sizes(t, split_pos)
    a = _host_operand(t.to_jax(apply_factor=False)).reshape(lhs_size, rhs_size)
    # RQ via QR of reversed transpose: A[::-1,:].T -> QR -> transpose back.
    with pa_section("Dense LAPACK", "RQ Factorisation",
                    f"{lhs_size}x{rhs_size}"):
        q0, r0 = _qr_jit(a[::-1, :].T)
    # A[::-1] = r0.T @ q0.T ; reverse rows back: R rows reversed, and to keep
    # R upper-left-trapezoid reverse r0's columns/rows consistently.
    R = r0.T[::-1, ::-1]       # lhs_size x rank, upper-trapezoid
    Q = q0.T[::-1, :]          # rank x rhs_size, orthonormal rows
    Rt = Tensor.from_jax(R.reshape(t.dimensions[:split_pos] + [rank]))
    Qt = Tensor.from_jax(Q.reshape([rank] + t.dimensions[split_pos:]))
    Rt.factor = t.factor
    return Rt, Qt


_QC_RANK_EPS_MULT = 16.0

# QC/CQ dense method: 'svd' (default) or 'qrp' (genuine column-pivoted
# Householder QR, ops/pivoted_qr.py — the reference's dgeqp3 path,
# blasLapackWrapper.cpp:262-361).  Measured on the host CPU: the jitted
# pivoted loop loses to one LAPACK/XLA SVD call (f64 256x256: 93 ms vs
# 15 ms), so
# the SVD rank rule stays the winner; 'qrp' is kept for exact dgeqp3
# semantics (identical rank decisions, tested in test_factorizations).
_QC_METHOD = os.environ.get("XERUS_TPU_QC_METHOD", "svd")


def _qc_dense_factor(a, lhs_size: int, rhs_size: int):
    """Rank-revealing split of a dense (lhs, rhs) matrix: returns
    (basis, coeff, rank) with a = basis[:, :rank] @ coeff[:rank] and
    basis having orthonormal columns."""
    if _QC_METHOD == "qrp":
        from ..ops.pivoted_qr import qrp
        q, r, perm = qrp(a)
        diag = np.abs(np.asarray(jnp.diagonal(r)))
        cutoff = (_QC_RANK_EPS_MULT
                  * float(np.finfo(config.value_dtype).eps) * float(diag[0]))
        rank = max(int(np.sum(diag >= cutoff)), 1) if diag[0] > 0 else 1
        inv = jnp.argsort(perm)
        return q, r[:, inv], rank
    u, s, vt = _svd_robust(a)
    rank = _revealed_rank(np.asarray(s))
    return u, s[:, None] * vt, rank


def _revealed_rank(s_host: np.ndarray) -> int:
    """Rank rule of blasLapackWrapper.cpp:268-273 applied to singular values."""
    if s_host.size == 0:
        return 1
    # a nan spectrum must never silently read as 'rank 1' (nan >= cutoff
    # is False for every entry) — that was the failure mode that let a
    # gesdd non-convergence truncate a tensor to rank 1 without a word
    require(not np.isnan(s_host).any(),
            "rank-revealing factorization received nan singular values")
    cutoff = _QC_RANK_EPS_MULT * float(np.finfo(config.value_dtype).eps) * float(s_host[0])
    rank = int(np.sum(s_host >= cutoff)) if s_host[0] > 0 else 1
    return max(rank, 1)


def calculate_qc(t: Tensor, split_pos: int) -> Tuple[Tensor, Tensor]:
    """Rank-revealing A = Q C, Q with orthonormal columns (tensor.cpp:1528).

    Sparse inputs route through the native sparse QR with the Heath rank
    rule (|R_jj| >= 16*eps*max) — SPQR parity (tensor.cpp:1532-1539); note
    SPQR's detection is the same heuristic class, not a pivoted RRQR."""
    lhs_size, rhs_size, _ = _split_sizes(t, split_pos)
    if t.is_sparse():
        from .sparse_qr import sparse_qc
        pos, vals = t.sparse_coo()
        tol = _QC_RANK_EPS_MULT * float(np.finfo(config.value_dtype).eps)
        out = sparse_qc(pos, vals, lhs_size, rhs_size, tol)
        if out is not None:
            return _sparse_factorization_output(t, split_pos, out[2], out[0],
                                                out[1], t.factor)
    a = _host_operand(t.to_jax(apply_factor=False)).reshape(lhs_size, rhs_size)
    with pa_section("Dense LAPACK", "QRP Factorisation",
                    f"{lhs_size}x{rhs_size}"):
        basis, coeff, rank = _qc_dense_factor(a, lhs_size, rhs_size)
    Q = Tensor.from_jax(basis[:, :rank].reshape(
        t.dimensions[:split_pos] + [rank]))
    C = Tensor.from_jax(coeff[:rank, :].reshape(
        [rank] + t.dimensions[split_pos:]))
    C.factor = t.factor
    return Q, C


def calculate_cq(t: Tensor, split_pos: int) -> Tuple[Tensor, Tensor]:
    """Rank-revealing A = C Q, Q with orthonormal rows (tensor.cpp:1548)."""
    lhs_size, rhs_size, _ = _split_sizes(t, split_pos)
    if t.is_sparse():
        from .sparse_qr import sparse_cq
        pos, vals = t.sparse_coo()
        tol = _QC_RANK_EPS_MULT * float(np.finfo(config.value_dtype).eps)
        out = sparse_cq(pos, vals, lhs_size, rhs_size, tol)
        if out is not None:
            c_flat, q_flat, rank = out
            C = Tensor(t.dimensions[:split_pos] + [rank],
                       Representation.Sparse)
            C._sparse = c_flat
            Q = Tensor([rank] + t.dimensions[split_pos:],
                       Representation.Sparse)
            Q._sparse = q_flat
            C.factor = t.factor
            C.use_dense_representation_if_desirable()
            Q.use_dense_representation_if_desirable()
            return C, Q
    a = _host_operand(t.to_jax(apply_factor=False)).reshape(lhs_size, rhs_size)
    with pa_section("Dense LAPACK", "QRP Factorisation",
                    f"{lhs_size}x{rhs_size}"):
        basis, coeff, rank = _qc_dense_factor(a.T, rhs_size, lhs_size)
    C = Tensor.from_jax(coeff[:rank, :].T.reshape(
        t.dimensions[:split_pos] + [rank]))
    Q = Tensor.from_jax(basis[:, :rank].T.reshape(
        [rank] + t.dimensions[split_pos:]))
    C.factor = t.factor
    return C, Q


def pseudo_inverse(t: Tensor, split_pos: int) -> Tensor:
    """Moore-Penrose inverse via SVD (tensor.cpp:1568-1580)."""
    U, S, Vt = calculate_svd(t, split_pos, 0, config.epsilon)
    S.modify_diagonal_entries(lambda a: 1.0 / a)
    inv = contract(Vt, S, 1, lhs_trans=True)
    return contract(inv, U, 1, rhs_trans=True)


# ---------------------------------------------------------------------------
# Linear solves (tensor.cpp:1583-1704, blasLapackWrapper.cpp:501-651)
# ---------------------------------------------------------------------------

@jax.jit
def _solve_sym_psd(a, b):
    """Cholesky attempt; the caller falls back on failure (NaN check)."""
    L = jnp.linalg.cholesky(a)
    return jax.scipy.linalg.cho_solve((L, True), b)


@jax.jit
def _solve_lu(a, b):
    return jnp.linalg.solve(a, b)


@jax.jit
def _lstsq(a, b):
    out, *_ = jnp.linalg.lstsq(a, b)
    return out


def _solve_matrix(a, b):
    """Dense solve with the reference's structure detection: symmetric ->
    try Cholesky (SPD fast path), fall back to LU / least squares
    (blasLapackWrapper.cpp:538-651)."""
    m, n = a.shape
    if m == n:
        a_host = np.asarray(a)
        scale = float(np.abs(a_host).max()) or 1.0
        symmetric = np.allclose(a_host, a_host.T, rtol=0, atol=1e-13 * scale)
        if symmetric:
            with pa_section("Dense LAPACK", "Solve (Cholesky)",
                            f"{m}x{n}x{b.shape[-1] if b.ndim > 1 else 1}"):
                x = _solve_sym_psd(a, b)
                ok = bool(jnp.all(jnp.isfinite(x)))
            if ok:
                return x
        with pa_section("Dense LAPACK", "Solve (PLU)",
                        f"{m}x{n}x{b.shape[-1] if b.ndim > 1 else 1}"):
            x = _solve_lu(a, b)
            ok = bool(jnp.all(jnp.isfinite(x)))
        if ok:
            return x
    with pa_section("Dense LAPACK", "Solve Least Squares",
                    f"{m}x{n}"):
        return _lstsq(a, b)


def _try_sparse_solve(A: Tensor, B: Tensor, deg_m: int, m: int, n: int,
                      p: int) -> Optional[Tensor]:
    """Sparse path shared by solve/solve_least_squares: the reference's
    SuiteSparseQR solve (tensor.cpp:1608-1630 ->
    cholmod_wrapper.cpp:173-225).  Returns None when inapplicable."""
    if not (A.is_sparse() and p == 1):
        return None
    from .sparse_qr import sparse_solve_ls
    pos, vals = A.sparse_coo()
    bh = np.asarray(B.to_jax(apply_factor=False)).reshape(m)
    xh = sparse_solve_ls(pos, vals, m, n, bh, float(config.epsilon))
    if xh is None:
        return None
    out_dims = A.dimensions[deg_m:] + B.dimensions[deg_m:]
    X = Tensor.from_ndarray(xh.reshape(out_dims) if out_dims
                            else xh.reshape(()))
    X.factor = B.factor / A.factor
    return X


def solve(A: Tensor, B: Tensor, extra_degree: int = 0) -> Tensor:
    """Solve A x = b (tensor.cpp:1654-1704).  ``extra_degree`` trailing modes
    of B are independent right-hand sides."""
    deg_m = B.degree() - extra_degree
    deg_n = A.degree() - deg_m
    require(deg_n >= 0 and A.degree() == deg_m + deg_n, "solve: inconsistent dims")
    m = _prod(A.dimensions[:deg_m])
    n = _prod(A.dimensions[deg_m:])
    p = _prod(B.dimensions[deg_m:])
    X = _try_sparse_solve(A, B, deg_m, m, n, p)
    if X is not None:
        return X
    a = _host_operand(A.to_jax(apply_factor=False)).reshape(m, n)
    b = _host_operand(B.to_jax(apply_factor=False)).reshape(m, p)
    x = _solve_matrix(a, b)
    out_dims = A.dimensions[deg_m:] + B.dimensions[deg_m:]
    X = Tensor.from_jax(x.reshape(out_dims) if out_dims else x.reshape(()))
    X.factor = B.factor / A.factor
    return X


def solve_least_squares(A: Tensor, B: Tensor, extra_degree: int = 0) -> Tensor:
    """min ||A X - B||_F (tensor.cpp:1583-1652)."""
    deg_m = B.degree() - extra_degree
    deg_n = A.degree() - deg_m
    require(deg_n >= 0 and A.degree() == deg_m + deg_n, "lstsq: inconsistent dims")
    m = _prod(A.dimensions[:deg_m])
    n = _prod(A.dimensions[deg_m:])
    p = _prod(B.dimensions[deg_m:])
    X = _try_sparse_solve(A, B, deg_m, m, n, p)
    if X is not None:
        return X
    a = _host_operand(A.to_jax(apply_factor=False)).reshape(m, n)
    b = _host_operand(B.to_jax(apply_factor=False)).reshape(m, p)
    with pa_section("Dense LAPACK", "Solve Least Squares",
                    f"{m}x{n} * {p}"):
        x = _lstsq(a, b)
    out_dims = A.dimensions[deg_m:] + B.dimensions[deg_m:]
    X = Tensor.from_jax(x.reshape(out_dims) if out_dims else x.reshape(()))
    X.factor = B.factor / A.factor
    return X
