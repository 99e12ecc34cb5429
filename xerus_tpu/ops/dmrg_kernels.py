"""Whole-sweep jitted two-site DMRG ground-state kernel.

Fast path for the eigensolver (algorithms/eigensolver.py): a full
left->right half-sweep of two-site local eigenproblems compiled into ONE XLA
program.  Ranks stay FIXED at the given value (pad-to-max-rank discipline,
SURVEY.md §7): the SVD split keeps exactly `rank` singular directions via a
static mask, so shapes are uniform and the eigh/SVD bodies compile once per
distinct shape.

Padding to a uniform rank necessarily zero-pads the boundary frames (bond k
has true rank <= n^k), so the padded local operators gain spurious ZERO
eigenvalues.  When the target ground energy is negative these never win; for
ground energies >= 0 (e.g. PSD operators) the drivers apply a spectral shift
(A - s*P with P the carried true-subspace projector, s > lambda_min,
auto-estimated via a lambda_max phase) so the shifted ground is negative.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import List, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp


def _cpu_scope():
    """Object-level f64 work (move_core/frob_norm/padding) runs on CPU —
    see config.host()."""
    from ..config import host
    return host()


def _dmrg_eig_half_sweep(x_cores, A_cores):
    """Two-site ground-state half-sweep (lr); x canonicalized at 0.
    Returns (new cores, energy of the last local problem)."""
    d = len(x_cores)
    dtype = x_cores[0].dtype

    op_right = [jnp.ones((1, 1, 1), dtype=dtype)]
    for k in range(d - 1, 1, -1):
        xc, Ac = x_cores[k], A_cores[k]
        op_right.append(jnp.einsum("umU,amnb,vnV,UbV->uav", xc, Ac, xc,
                                   op_right[-1]))

    x_cores = list(x_cores)
    op_left = jnp.ones((1, 1, 1), dtype=dtype)
    energy = jnp.zeros((), dtype)
    for k in range(d - 1):
        A1, A2 = A_cores[k], A_cores[k + 1]
        R = op_right[d - 2 - k]
        Aloc = jnp.einsum("uav,amnb,bMNc,UcV->umMUvnNV", op_left, A1, A2, R)
        u_, m_, M_, U_ = Aloc.shape[:4]
        nn = u_ * m_ * M_ * U_
        w, v = jnp.linalg.eigh(Aloc.reshape(nn, nn))
        energy = w[0]
        ground = v[:, 0].reshape(u_, m_ * M_, U_).reshape(u_ * m_, M_ * U_)
        # split with rank kept EXACTLY at the bond dimension of x (static)
        r_bond = x_cores[k].shape[2]
        uu, ss, vt = jnp.linalg.svd(ground.reshape(u_ * m_, M_ * U_),
                                    full_matrices=False)
        keep = min(r_bond, uu.shape[1])
        mask = (jnp.arange(uu.shape[1], dtype=jnp.int32) < keep).astype(dtype)
        uu = uu * mask[None, :]
        sv = (ss * mask)[:, None] * vt
        # pad/trim to the static bond dimension
        if uu.shape[1] >= r_bond:
            uu = uu[:, :r_bond]
            sv = sv[:r_bond, :]
        else:
            uu = jnp.pad(uu, ((0, 0), (0, r_bond - uu.shape[1])))
            sv = jnp.pad(sv, ((0, r_bond - sv.shape[0]), (0, 0)))
        x_cores[k] = uu.reshape(u_, m_, r_bond)
        x_cores[k + 1] = sv.reshape(r_bond, M_, U_)
        if k < d - 2:
            op_left = jnp.einsum("uav,umU,amnb,vnV->UbV", op_left,
                                 x_cores[k], A1, x_cores[k])
    return tuple(x_cores), energy


def _right_prj_envs(x_stack, shifted: bool):
    """Right identity/projector environments for the spectral shift:
    prj[u,v] at two-site step k is the frame gram of sites k+2..d-1 —
    exactly diag(true-rank mask) for right-orthonormal padded frames, the
    local representation of the global identity on the TRUE subspace.
    Same boundary/offset convention as the operator Renvs.  Returns
    (prj0, Rprjs); Rprjs is a zero placeholder when not shifted."""
    d, r = x_stack.shape[0], x_stack.shape[1]
    dtype = x_stack.dtype
    prj0 = jnp.zeros((r, r), dtype=dtype).at[0, 0].set(1.0)
    if not shifted:
        return prj0, jnp.zeros((d - 1, r, r), dtype=dtype)   # unused

    def prj_r_body(prj, xc):
        new = jnp.einsum("umU,vmV,UV->uv", xc, xc, prj)
        return new, new

    _, prjs_rev = jax.lax.scan(prj_r_body, prj0, x_stack[1:][::-1])
    Rprjs = jnp.concatenate([prjs_rev[::-1][1:], prj0[None]], axis=0)
    return prj0, Rprjs


def _dmrg_eig_half_sweep_scan(x_stack, A_stack, shift=None, *, rank: int):
    """Scan-based two-site ground-state half-sweep over PADDED uniform
    stacks: x_stack (d, r, n, r), A_stack (d, a, n, n, a).  Compiles ONE
    eigh/SVD body instead of d-1 (pad-to-max-rank discipline).

    Unshifted (shift=None), valid when the target ground energy is
    NEGATIVE: zero-padded frame directions contribute spurious zero
    eigenvalues which then never win.  A TRACED scalar ``shift`` >
    lambda_min lifts that restriction by solving (A - shift*P) with P the
    carried true-subspace projector (see _dmrg_lobpcg_half_sweep_scan);
    traced (not baked static) so one compile serves every shift value.
    Reported energies are the
    SHIFTED Ritz values (true energy = reported + shift); the driver adds
    the shift back.  Returns (x_stack_out, energy)."""
    d, r, n, _ = x_stack.shape
    a = A_stack.shape[1]
    dtype = x_stack.dtype
    shifted = shift is not None

    # right environments (uniform (r, a, r)), scan right-to-left
    def env_r_body(env, inp):
        xc, Ac = inp
        new = jnp.einsum("umU,amnb,vnV,UbV->uav", xc, Ac, xc, env)
        return new, new

    env0 = jnp.zeros((r, a, r), dtype=dtype).at[0, 0, 0].set(1.0)
    _, envs_rev = jax.lax.scan(env_r_body, env0,
                               (x_stack[1:][::-1], A_stack[1:][::-1]))
    envs = envs_rev[::-1]   # envs[k] covers sites k+1..d-1 (for k=0..d-2)
    # two-site step k needs the env over sites k+2..d-1: shift by one and
    # close with the boundary env
    Renvs = jnp.concatenate([envs[1:], env0[None]], axis=0)

    prj0, Rprjs = _right_prj_envs(x_stack, shifted)

    mask = (jnp.arange(r, dtype=jnp.int32) < rank).astype(dtype)

    def sweep_body(carry, inp):
        op_left, prj_left = carry
        A1, A2, R, Rprj = inp
        Aloc = jnp.einsum("uav,amnb,bMNc,UcV->umMUvnNV", op_left, A1, A2, R)
        if shifted:
            eyen = jnp.eye(n, dtype=dtype)
            Aloc = Aloc - shift.astype(dtype) * jnp.einsum(
                "uv,mn,MN,UV->umMUvnNV", prj_left, eyen, eyen, Rprj)
        nn = r * n * n * r
        w, v = jnp.linalg.eigh(Aloc.reshape(nn, nn))
        energy = w[0]
        ground = v[:, 0].reshape(r * n, n * r)
        uu, ss, vt = jnp.linalg.svd(ground, full_matrices=False)
        k = min(rank, uu.shape[1])
        m2 = (jnp.arange(uu.shape[1], dtype=jnp.int32) < k).astype(dtype)
        uu = uu * m2[None, :]
        sv = (ss * m2)[:, None] * vt
        # pad/trim to bond dim r
        uu = uu[:, :r] if uu.shape[1] >= r else jnp.pad(
            uu, ((0, 0), (0, r - uu.shape[1])))
        sv = sv[:r, :] if sv.shape[0] >= r else jnp.pad(
            sv, ((0, r - sv.shape[0]), (0, 0)))
        U = uu.reshape(r, n, r)
        op_left2 = jnp.einsum("uav,umU,amnb,vnV->UbV", op_left, U, A1, U)
        if shifted:
            prj_left2 = jnp.einsum("uv,umU,vmV->UV", prj_left, U, U)
        else:
            prj_left2 = prj_left
        return (op_left2, prj_left2), (U, sv.reshape(r, n, r), energy)

    left0 = jnp.zeros((r, a, r), dtype=dtype).at[0, 0, 0].set(1.0)
    _, (Us, svs, energies) = jax.lax.scan(
        sweep_body, (left0, prj0), (A_stack[:-1], A_stack[1:], Renvs, Rprjs))
    out = jnp.concatenate([Us, svs[-1][None]], axis=0)
    return out, energies[-1]


@lru_cache(maxsize=32)
def make_dmrg_sweep_scan(shape_key, rank: int, dtype_str: str,
                         shifted: bool = False):
    """shifted=False: fn(x_stack, A_stack).  shifted=True: fn(x_stack,
    A_stack, shift) with shift a TRACED scalar (one compile, any value)."""
    from .tt_kernels import jit_f32
    body = partial(_dmrg_eig_half_sweep_scan, rank=rank)
    if shifted:
        return jit_f32(lambda x, A, s: body(x, A, jnp.asarray(s)), dtype_str)
    return jit_f32(lambda x, A: body(x, A), dtype_str)


# ---------------------------------------------------------------------------
# Matrix-free LOBPCG local solves: the two-site local operator is never
# materialized — each apply is a chain of small einsum contractions through
# the environment/MPO cores (O(a^2 n^2 r^3) instead of the dense eigh's
# O((r n)^6)).  This is the modern DMRG design (Davidson/LOBPCG local
# solves); the reference's eigensolver materializes the local matrix
# (xals.cpp / exact local solve), which is O((r n)^6) work per site.
# ---------------------------------------------------------------------------

def _local_apply(L, A1, A2, R, v):
    """y[u,m,M,U] = sum L[u,a,v] A1[a,m,n,b] A2[b,M,N,c] R[U,c,V] v[v,n,N,V]."""
    t = jnp.einsum("uav,vnNV->uanNV", L, v)
    t = jnp.einsum("amnb,uanNV->umbNV", A1, t)
    t = jnp.einsum("bMNc,umbNV->umMcV", A2, t)
    return jnp.einsum("UcV,umMcV->umMU", R, t)


def _lobpcg_smallest(apply, v0, iters: int):
    """k=1 LOBPCG without preconditioner on the matrix-free local operator
    ``apply`` (a matvec closure).  Valid for ground energies < 0
    (degenerate/zero-padded basis directions contribute Rayleigh quotient
    0 and never win; the half-sweep driver's spectral shift arranges
    this).  Keeps iterates in the 4-D local shape (no flat-vector
    reshapes inside the loop).  Returns (ground vector, energy)."""
    dtype = v0.dtype
    tiny = jnp.asarray(1e-30, dtype)

    def normalize(x):
        n = jnp.sqrt(jnp.sum(x * x))
        return jnp.where(n > tiny, x / jnp.maximum(n, tiny), x), n

    x, _ = normalize(v0)
    p = jnp.zeros_like(x)
    lam0 = jnp.zeros((), dtype)

    def body(carry, _):
        x, p, _ = carry
        Ax = apply(x)
        lam = jnp.sum(x * Ax)
        w = Ax - lam * x
        # orthonormalize [x, w, p] (x is unit; CGS with degeneracy guards)
        w = w - jnp.sum(w * x) * x
        w, nw = normalize(w)
        q = p - jnp.sum(p * x) * x
        q = q - jnp.sum(q * w) * w
        q, nq = normalize(q)
        basis = jnp.stack([x, w, q])                 # (3, ...)
        Ab = jnp.stack([Ax, apply(w), apply(q)])
        T = jnp.einsum("i...,j...->ij", basis, Ab)
        T = 0.5 * (T + T.T)
        # degenerate directions (zero w or p) must never win the Ritz step;
        # the penalty must stay modest — an eigh that squares the matrix
        # norm internally (QDWH) would overflow 1e30 in f32 to NaN
        valid = jnp.stack([jnp.ones((), dtype),
                           (nw > tiny).astype(dtype),
                           (nq > tiny).astype(dtype)])
        big = 1e4 * (jnp.max(jnp.abs(T)) + 1.0)
        T = T + jnp.diag((1.0 - valid) * big)
        evals, evecs = jnp.linalg.eigh(T)
        c = evecs[:, 0] * valid
        xn = jnp.einsum("i,i...->...", c, basis)
        pn = jnp.einsum("i,i...->...", c.at[0].set(0.0), basis)
        xn, _ = normalize(xn)
        return (xn, pn, evals[0]), None

    (x, _, lam), _ = jax.lax.scan(body, (x, p, lam0), None, length=iters)
    return x, lam


def _lanczos_smallest(apply, v0, m: int):
    """Fixed-m Lanczos with full reorthogonalization on the matrix-free
    local operator ``apply`` (a matvec closure).  m applies build an m-dim
    Krylov space — far better extreme-eigenvalue convergence per apply
    than the 3-vector LOBPCG.  Degenerate steps (invariant subspace
    reached, beta ~ 0) are masked and penalized out of the small eigh.
    Returns (ground vector, energy)."""
    dtype = v0.dtype
    tiny = jnp.asarray(1e-30, dtype)
    shape = v0.shape

    def normalize(x):
        n = jnp.sqrt(jnp.sum(x * x))
        return jnp.where(n > tiny, x / jnp.maximum(n, tiny), x * 0.0), n

    v, _ = normalize(v0)
    V = jnp.zeros((m,) + shape, dtype)
    alphas = jnp.zeros((m,), dtype)
    valid = jnp.zeros((m,), dtype)
    betas = jnp.zeros((m,), dtype)          # betas[j] couples j-1 <-> j
    beta_prev = jnp.zeros((), dtype)
    v_prev = jnp.zeros_like(v)
    alive = jnp.ones((), dtype)

    for j in range(m):
        V = V.at[j].set(v * alive)
        valid = valid.at[j].set(alive)
        w = apply(v)
        a_j = jnp.sum(w * v)
        alphas = alphas.at[j].set(a_j * alive)
        w = w - a_j * v - beta_prev * v_prev
        # full reorthogonalization (rows of V beyond j are zero)
        proj = jnp.einsum("k...,...->k", V, w)
        w = w - jnp.einsum("k,k...->...", proj, V)
        v_prev = v
        w, nb = normalize(w)
        alive = alive * (nb > 1e-7).astype(dtype)
        if j + 1 < m:
            betas = betas.at[j + 1].set(nb * alive)
        beta_prev = nb * alive
        v = w

    T = (jnp.diag(alphas) + jnp.diag(betas[1:], 1) + jnp.diag(betas[1:], -1))
    big = 1e4 * (jnp.max(jnp.abs(T)) + 1.0)
    T = T + jnp.diag((1.0 - valid) * big)
    evals, evecs = jnp.linalg.eigh(T)
    c = evecs[:, 0] * valid
    ground = jnp.einsum("k,k...->...", c, V)
    ground, _ = normalize(ground)
    return ground, evals[0]


def _dmrg_lobpcg_half_sweep_scan(x_stack, A_stack, shift=None, *,
                                 rank: int,
                                 lobpcg_iters: int = 24,
                                 solver: str = "lobpcg"):
    """Scan half-sweep with LOBPCG local solves (warm-started from the
    current two-site block) instead of the dense eigh.  Same padding /
    masked-SVD-split contract as _dmrg_eig_half_sweep_scan.

    A TRACED scalar ``shift`` solves (A - shift*I) instead of A (energies
    come back shifted by -shift; the driver adds it back).  In the local
    frames the global identity is exactly the projector P onto the TRUE
    (non-padded) subspace — carried through the sweep like the operator
    environments — so padded null directions KEEP eigenvalue 0 while
    every true eigenvalue drops by shift.  With shift > lambda_min the
    true ground beats the spurious zero modes, which otherwise capture
    the f32 Krylov iterations whenever the ground energy is >= 0
    (measured: unshifted f32 lanczos/lobpcg on a PSD Laplace MPO collapse
    to 0).  shift=None compiles the unshifted kernel (no projector
    carry)."""
    d, r, n, _ = x_stack.shape
    a = A_stack.shape[1]
    dtype = x_stack.dtype
    shifted = shift is not None

    def env_r_body(env, inp):
        xc, Ac = inp
        new = jnp.einsum("umU,amnb,vnV,UbV->uav", xc, Ac, xc, env)
        return new, new

    env0 = jnp.zeros((r, a, r), dtype=dtype).at[0, 0, 0].set(1.0)
    _, envs_rev = jax.lax.scan(env_r_body, env0,
                               (x_stack[1:][::-1], A_stack[1:][::-1]))
    envs = envs_rev[::-1]
    Renvs = jnp.concatenate([envs[1:], env0[None]], axis=0)

    prj0, Rprjs = _right_prj_envs(x_stack, shifted)

    def sweep_body(carry, inp):
        op_left, prj_left, x1 = carry
        A1, A2, R, Rprj, x2 = inp
        v0 = jnp.einsum("umb,bMU->umMU", x1, x2)

        def apply(v):
            w = _local_apply(L=op_left, A1=A1, A2=A2, R=R, v=v)
            if shifted:
                pv = jnp.einsum("uw,wmMW,WU->umMU", prj_left, v, Rprj)
                w = w - shift.astype(dtype) * pv
            return w

        if solver == "lanczos":
            ground, energy = _lanczos_smallest(apply, v0, lobpcg_iters)
        else:
            ground, energy = _lobpcg_smallest(apply, v0, lobpcg_iters)
        uu, ss, vt = jnp.linalg.svd(ground.reshape(r * n, n * r),
                                    full_matrices=False)
        k = min(rank, uu.shape[1])
        m2 = (jnp.arange(uu.shape[1], dtype=jnp.int32) < k).astype(dtype)
        uu = uu * m2[None, :]
        sv = (ss * m2)[:, None] * vt
        uu = uu[:, :r] if uu.shape[1] >= r else jnp.pad(
            uu, ((0, 0), (0, r - uu.shape[1])))
        sv = sv[:r, :] if sv.shape[0] >= r else jnp.pad(
            sv, ((0, r - sv.shape[0]), (0, 0)))
        U = uu.reshape(r, n, r)
        nxt = sv.reshape(r, n, r)
        op_left2 = jnp.einsum("uav,umU,amnb,vnV->UbV", op_left, U, A1, U)
        if shifted:
            prj_left2 = jnp.einsum("uv,umU,vmV->UV", prj_left, U, U)
        else:
            prj_left2 = prj_left
        return (op_left2, prj_left2, nxt), (U, nxt, energy)

    left0 = jnp.zeros((r, a, r), dtype=dtype).at[0, 0, 0].set(1.0)
    (_, _, last), (Us, svs, energies) = jax.lax.scan(
        sweep_body, (left0, prj0, x_stack[0]),
        (A_stack[:-1], A_stack[1:], Renvs, Rprjs, x_stack[1:]))
    out = jnp.concatenate([Us, last[None]], axis=0)
    return out, energies[-1]


@lru_cache(maxsize=32)
def make_dmrg_sweep_lobpcg(shape_key, rank: int, dtype_str: str,
                           lobpcg_iters: int, solver: str = "lobpcg",
                           shifted: bool = False):
    """shifted=False: fn(x_stack, A_stack).  shifted=True: fn(x_stack,
    A_stack, shift) with shift a TRACED scalar (one compile, any value)."""
    from .tt_kernels import jit_f32
    body = partial(_dmrg_lobpcg_half_sweep_scan, rank=rank,
                   lobpcg_iters=lobpcg_iters, solver=solver)
    if shifted:
        return jit_f32(lambda x, A, s: body(x, A, jnp.asarray(s)), dtype_str)
    return jit_f32(lambda x, A: body(x, A), dtype_str)


@lru_cache(maxsize=32)
def make_dmrg_run(shape_key, rank: int, dtype_str: str, solver: str,
                  lobpcg_iters: int, shifted: bool, max_sweeps: int):
    """The WHOLE ground-state solve as ONE XLA program: a lax.while_loop
    whose body is (half-sweep + core normalization + convergence check +
    site reversal), mirroring the dmrg_groundstate_scan host loop exactly.

    Rationale: the host loop paid one dispatch + one scalar fetch +
    reversal dispatches per half-sweep, which at small ranks costs more
    than the half-sweep's device work.  One dispatch runs up to ``remaining`` half-sweeps with the energy
    convergence test in-program.

    The host loop reverses only between sweeps (not after a converged
    one) and un-reverses at the end if needed; here reversal is
    unconditional in the body, so the final state is un-reversed when the
    executed sweep count is odd — identical final orientation.

    ``energy0`` carries the convergence reference across re-dispatches
    when the static ``max_sweeps`` bucket is exhausted (pass +inf on the
    first call).  Returns (x_stack, energy, count)."""
    from .tt_kernels import jit_f32
    if solver in ("lobpcg", "lanczos"):
        body_fn = partial(_dmrg_lobpcg_half_sweep_scan, rank=rank,
                          lobpcg_iters=lobpcg_iters, solver=solver)
    elif solver == "eigh":
        body_fn = partial(_dmrg_eig_half_sweep_scan, rank=rank)
    else:
        raise ValueError(f"unknown local solver {solver!r}; "
                         "expected 'eigh', 'lanczos' or 'lobpcg'")

    def run(x_stack, A_stack, shift, conv_eps, remaining, energy0):
        d = x_stack.shape[0]
        dtype = x_stack.dtype
        limit = jnp.minimum(jnp.asarray(max_sweeps, jnp.int32),
                            remaining.astype(jnp.int32))

        def cond(carry):
            _xs, _As, _e, i, stop = carry
            return jnp.logical_and(i < limit, jnp.logical_not(stop))

        def body(carry):
            xs, As, energy, i, _stop = carry
            if shifted:
                xs, e = body_fn(xs, As, shift)
            else:
                xs, e = body_fn(xs, As)
            e = e + shift
            last = xs[d - 1]
            nl = jnp.linalg.norm(last)
            xs = xs.at[d - 1].set(last / jnp.maximum(nl, 1e-30))
            stop = jnp.abs(e - energy) < conv_eps
            return (_rev_x_stack(xs), _rev_A_stack(As), e, i + 1, stop)

        carry = (x_stack, A_stack, energy0.astype(dtype),
                 jnp.zeros((), jnp.int32), jnp.zeros((), jnp.bool_))
        xs, _As, e, i, _stop = jax.lax.while_loop(cond, body, carry)
        xs = jax.lax.cond(i % 2 == 1, _rev_x_stack, lambda s: s, xs)
        return xs, e, i

    return jit_f32(run, dtype_str)


def _pad_operator_stack(A_np, dtype):
    """Zero-pad MPO cores to a uniform (d, a, n, n, a) stack (shared by the
    eigen / linear-solve / multistart drivers)."""
    d = len(A_np)
    n = A_np[0].shape[1]
    a = max(max(c.shape[0], c.shape[3]) for c in A_np)
    A_stack = np.zeros((d, a, n, n, a), dtype=dtype)
    for k, c in enumerate(A_np):
        A_stack[k, :c.shape[0], :, :, :c.shape[3]] = c
    return jnp.asarray(A_stack)


def _rev_x_stack(s):
    """Site-reverse a (d, r, n, r) stack (or (B, d, r, n, r) batched)."""
    if s.ndim == 5:
        return jnp.transpose(s[:, ::-1], (0, 1, 4, 3, 2))
    return jnp.transpose(s[::-1], (0, 3, 2, 1))


def _rev_A_stack(s):
    return jnp.transpose(s[::-1], (0, 4, 2, 3, 1))


def _estimate_shift(fn0, x0, A_stack, reduce_fn=float):
    """Auto spectral-shift (lambda_max) phase: two UNSHIFTED half-sweeps
    on -A (negate exactly ONE MPO core — negating the whole stack flips
    (-1)^d, a no-op for even d) with a throwaway copy of the state.  -A's
    ground is -lambda_max, which is negative (unshifted-kernel-valid)
    exactly when a shift is needed; the returned Rayleigh-quotient energy
    gives lam_hat <= lambda_max.  Returns 1.1*lam_hat, or 0.0 when the
    spectrum is non-positive (ground already negative, no shift needed).
    Shared by dmrg_groundstate_scan and dmrg_groundstate_multistart."""
    xs, As, e_neg = x0, jnp.asarray(A_stack).at[0].multiply(-1.0), np.inf
    for _ in range(2):
        xs, e = fn0(xs, As)
        e_neg = reduce_fn(e)
        xs, As = _rev_x_stack(xs), _rev_A_stack(As)
    lam_hat = -e_neg
    return 1.1 * lam_hat if lam_hat > 0 else 0.0


def _unpad_to_components(stack_np, d, n, rank, Tensor, res_rank):
    comps = []
    for i in range(d):
        rl = 1 if i == 0 else res_rank(i, d, n, int(rank))
        rr = 1 if i == d - 1 else res_rank(i + 1, d, n, int(rank))
        comps.append(Tensor.from_ndarray(
            np.asarray(stack_np[i][:rl, :, :rr], np.float64)))
    return comps


def _cg_solve_local(L, A1, A2, R, rhs, v0, iters: int):
    """Matrix-free CG on the SPD two-site local system (warm-started from
    the current block).  Fixed iteration count (compiled); breakdown
    guards keep degenerate directions inert in f32."""
    dtype = v0.dtype
    tiny = jnp.asarray(1e-30, dtype)
    x = v0
    r = rhs - _local_apply(L, A1, A2, R, x)
    p = r
    rs = jnp.sum(r * r)

    def body(carry, _):
        x, r, p, rs = carry
        Ap = _local_apply(L, A1, A2, R, p)
        denom = jnp.sum(p * Ap)
        alpha = jnp.where(denom > tiny, rs / jnp.maximum(denom, tiny), 0.0)
        x2 = x + alpha * p
        r2 = r - alpha * Ap
        rs2 = jnp.sum(r2 * r2)
        beta = jnp.where(rs > tiny, rs2 / jnp.maximum(rs, tiny), 0.0)
        p2 = r2 + beta * p
        return (x2, r2, p2, rs2), None

    (x, r, _, _), _ = jax.lax.scan(body, (x, r, p, rs), None, length=iters)
    return x


def _dmrg_solve_half_sweep_scan(x_stack, A_stack, b_stack, rank: int,
                                cg_iters: int = 32):
    """Two-site DMRG HALF-SWEEP for the SPD linear system A x = b — the
    jitted fast path of the reference's ALSVariant with sites=2
    (als.h:210-223 DMRG_SPD; the single-site fast path lives in
    ops/tt_kernels.py).  Same padding / masked-SVD-split contract as the
    ground-state kernel; local solves are matrix-free CG warm-started
    from the current block.  Returns (new x_stack, local residual-norm^2
    of the last site solve)."""
    d, r, n, _ = x_stack.shape
    a = A_stack.shape[1]
    rb = b_stack.shape[1]
    dtype = x_stack.dtype

    def env_r_body(carry, inp):
        opE, rhsE = carry
        xc, Ac, bc = inp
        opE2 = jnp.einsum("umU,amnb,vnV,UbV->uav", xc, Ac, xc, opE)
        rhsE2 = jnp.einsum("umU,bmB,UB->ub", xc, bc, rhsE)
        return (opE2, rhsE2), (opE2, rhsE2)

    op0 = jnp.zeros((r, a, r), dtype=dtype).at[0, 0, 0].set(1.0)
    rhs0 = jnp.zeros((r, rb), dtype=dtype).at[0, 0].set(1.0)
    _, (op_envs_rev, rhs_envs_rev) = jax.lax.scan(
        env_r_body, (op0, rhs0),
        (x_stack[1:][::-1], A_stack[1:][::-1], b_stack[1:][::-1]))
    op_envs = op_envs_rev[::-1]
    rhs_envs = rhs_envs_rev[::-1]
    Rops = jnp.concatenate([op_envs[1:], op0[None]], axis=0)
    Rrhs = jnp.concatenate([rhs_envs[1:], rhs0[None]], axis=0)

    def sweep_body(carry, inp):
        op_left, rhs_left, x1 = carry
        A1, A2, Rop, b1, b2, Rr, x2 = inp
        v0 = jnp.einsum("umb,bMU->umMU", x1, x2)
        rhs = jnp.einsum("up,pmq,qMs,Us->umMU", rhs_left, b1, b2, Rr)
        y = _cg_solve_local(op_left, A1, A2, Rop, rhs, v0, cg_iters)
        res = rhs - _local_apply(op_left, A1, A2, Rop, y)
        uu, ss, vt = jnp.linalg.svd(y.reshape(r * n, n * r),
                                    full_matrices=False)
        k = min(rank, uu.shape[1])
        m2 = (jnp.arange(uu.shape[1], dtype=jnp.int32) < k).astype(dtype)
        uu = uu * m2[None, :]
        sv = (ss * m2)[:, None] * vt
        uu = uu[:, :r] if uu.shape[1] >= r else jnp.pad(
            uu, ((0, 0), (0, r - uu.shape[1])))
        sv = sv[:r, :] if sv.shape[0] >= r else jnp.pad(
            sv, ((0, r - sv.shape[0]), (0, 0)))
        U = uu.reshape(r, n, r)
        nxt = sv.reshape(r, n, r)
        op_left2 = jnp.einsum("uav,umU,amnb,vnV->UbV", op_left, U, A1, U)
        rhs_left2 = jnp.einsum("up,umU,pmq->Uq", rhs_left, U, b1)
        return (op_left2, rhs_left2, nxt), (U, jnp.sum(res * res))

    left_op0 = jnp.zeros((r, a, r), dtype=dtype).at[0, 0, 0].set(1.0)
    left_rhs0 = jnp.zeros((r, rb), dtype=dtype).at[0, 0].set(1.0)
    (_, _, last), (Us, res2) = jax.lax.scan(
        sweep_body, (left_op0, left_rhs0, x_stack[0]),
        (A_stack[:-1], A_stack[1:], Rops, b_stack[:-1], b_stack[1:], Rrhs,
         x_stack[1:]))
    out = jnp.concatenate([Us, last[None]], axis=0)
    return out, res2[-1]


@lru_cache(maxsize=32)
def make_dmrg_solve_sweep(shape_key, rank: int, dtype_str: str,
                          cg_iters: int):
    from .tt_kernels import jit_f32
    return jit_f32(partial(_dmrg_solve_half_sweep_scan, rank=rank,
                           cg_iters=cg_iters), dtype_str)


def dmrg_solve(A, x, b, max_rank: int = 0, num_half_sweeps: int = 8,
               conv_eps: float = 1e-10, cg_iters: int = 32) -> float:
    """Object-level two-site SPD solver driver (the reference's DMRG_SPD,
    als.h:219): pads to uniform stacks, alternates direction by stack
    reversal, truncates at ``max_rank`` (0 = keep the padded max — ranks
    may GROW up to it, the two-site advantage over ALS).  Returns the
    final relative residual (computed at object level)."""
    from ..core.tensor import Tensor
    from .tt_kernels import pad_cores
    from .tt_kernels import res_rank
    with _cpu_scope():
        x.move_core(0)
        x_stack, r = pad_cores(
            [np.asarray(c.to_ndarray()) for c in x.components])
        A_np = [np.asarray(c.to_ndarray()) for c in A.components]
        b_np = [np.asarray(c.to_ndarray()) for c in b.components]
    rank = int(max_rank) or int(r)
    if rank > r:
        # allow rank growth beyond x's current ranks: re-pad the stack
        pad = rank - int(r)
        x_stack = np.pad(np.asarray(x_stack),
                         ((0, 0), (0, pad), (0, 0), (0, pad)))
        r = rank
    x_stack = jnp.asarray(x_stack)
    d = len(A_np)
    n = A_np[0].shape[1]
    rb = max(max(c.shape[0], c.shape[2]) for c in b_np)
    dt = np.asarray(x_stack).dtype
    A_stack = _pad_operator_stack(A_np, dt)
    b_stack = np.zeros((d, rb, n, rb), dtype=dt)
    for k, bc in enumerate(b_np):
        b_stack[k, :bc.shape[0], :, :bc.shape[2]] = bc
    b_stack = jnp.asarray(b_stack)

    fn = make_dmrg_solve_sweep(tuple(x_stack.shape), int(rank),
                               str(x_stack.dtype), int(cg_iters))
    prev = np.inf
    reversed_state = False
    for sweep in range(num_half_sweeps):
        x_stack, res2 = fn(x_stack, A_stack, b_stack)
        res2 = float(res2)
        if abs(prev - res2) < conv_eps * max(res2, 1e-30):
            prev = res2
            break
        prev = res2
        x_stack = _rev_x_stack(x_stack)
        A_stack = _rev_A_stack(A_stack)
        b_stack = _rev_x_stack(b_stack)
        reversed_state = not reversed_state
    if reversed_state:
        x_stack = _rev_x_stack(x_stack)
    stack_np = np.asarray(x_stack)
    with _cpu_scope():
        x.components = _unpad_to_components(stack_np, d, n, rank, Tensor,
                                            res_rank)
        x.canonicalized = False
        x.move_core(0)
        from ..tt.ttnetwork import apply_operator
        resid = (apply_operator(A, x) - b).frob_norm() / max(b.frob_norm(),
                                                             1e-300)
    return float(resid)


@lru_cache(maxsize=32)
def make_dmrg_sweep_batched(shape_key, rank: int, dtype_str: str,
                            lobpcg_iters: int, solver: str = "lanczos",
                            batched_A: bool = False,
                            shifted: bool = False):
    """Throughput-mode DMRG: one jitted program running a BATCH of
    independent ground-state half-sweeps (optionally per-instance
    operators).  Same rationale as make_als_sweep_batched
    (ops/tt_kernels.py): the site chain is sequential with small per-site
    ops, so vmapping B instances multiplies useful GEMM work per dispatch
    by B without changing the sweep math.  Use cases: multi-start ground
    state search (independent random initializations raced in one
    program) and the benchmark throughput protocol."""
    from .tt_kernels import jit_f32
    body = partial(_dmrg_lobpcg_half_sweep_scan, rank=rank,
                   lobpcg_iters=lobpcg_iters, solver=solver)
    if shifted:
        fn = jax.vmap(lambda x, A, s: body(x, A, jnp.asarray(s)),
                      in_axes=(0, 0 if batched_A else None, None))
    else:
        fn = jax.vmap(lambda x, A: body(x, A),
                      in_axes=(0, 0 if batched_A else None))
    return jit_f32(fn, dtype_str)


def dmrg_half_sweep_batched(x_stacks, A_stack, rank: int,
                            solver: str = "lanczos",
                            lobpcg_iters: int = 32):
    """One batched DMRG half-sweep.  x_stacks: (B, d, r, n, r) padded
    instance stacks (shared core shapes = one jit specialization);
    A_stack: (d, a, n, n, a) shared operator.  Returns (new_stacks,
    energies (B,))."""
    fn = make_dmrg_sweep_batched(tuple(x_stacks.shape), int(rank),
                                 str(x_stacks.dtype), int(lobpcg_iters),
                                 solver)
    return fn(x_stacks, A_stack)


def dmrg_groundstate_multistart(A, x, num_starts: int = 4,
                                num_half_sweeps: int = 8,
                                conv_eps: float = 1e-10,
                                solver: str = "lanczos",
                                lobpcg_iters: int = 32,
                                shift=None) -> float:
    """Multi-start ground-state race: ``num_starts`` independent random
    initializations (the first being x itself) run as ONE batched
    program per half-sweep (make_dmrg_sweep_batched); the lowest-energy
    instance wins and is written back into x.  Protects against local
    minima of the fixed-rank sweep at the cost of a single batched
    dispatch — the device answer to restart loops."""
    from ..core.tensor import Tensor
    from .tt_kernels import pad_cores
    from .tt_kernels import res_rank
    with _cpu_scope():
        x.move_core(0)
        nrm = x.frob_norm()
        if nrm > 0:
            x /= nrm
        stacks = [pad_cores([np.asarray(c.to_ndarray())
                             for c in x.components])[0]]
        r = stacks[0].shape[1]
        dims = list(x.dimensions)
        from ..tt.ttnetwork import TTTensor as _TT
        for _ in range(num_starts - 1):
            g = _TT.random(dims, int(r))
            g.move_core(0)
            g /= g.frob_norm()
            s, _ = pad_cores([np.asarray(c.to_ndarray())
                              for c in g.components])
            stacks.append(s)
        A_np = [np.asarray(c.to_ndarray()) for c in A.components]
    x_stacks = np.stack(stacks)
    d = len(A_np)
    n = A_np[0].shape[1]
    A_stack = _pad_operator_stack(A_np, x_stacks.dtype)
    x_stacks = jnp.asarray(x_stacks)

    def factory(shifted):
        return make_dmrg_sweep_batched(tuple(x_stacks.shape), int(r),
                                       str(x_stacks.dtype),
                                       int(lobpcg_iters), solver,
                                       shifted=shifted)

    sdt = np.asarray(x_stacks).dtype
    if shift is None:
        shift = _estimate_shift(factory(False), x_stacks, A_stack,
                                reduce_fn=lambda es: float(jnp.min(es)))
    shift = float(shift)
    shifted = shift != 0.0
    fn = factory(shifted)
    best_prev = np.inf
    reversed_state = False
    energies = jnp.full((num_starts,), np.inf, dtype=x_stacks.dtype)
    for sweep in range(num_half_sweeps):
        if shifted:
            x_stacks, energies = fn(x_stacks, A_stack, sdt.type(shift))
        else:
            x_stacks, energies = fn(x_stacks, A_stack)
        energies = energies + shift
        # normalize each instance's core (last stack entry)
        last = x_stacks[:, d - 1]
        nl = jnp.sqrt(jnp.sum(last * last, axis=(1, 2, 3), keepdims=True))
        x_stacks = x_stacks.at[:, d - 1].set(
            last / jnp.maximum(nl, 1e-30))
        best = float(jnp.min(energies))
        if abs(best - best_prev) < conv_eps:
            best_prev = best
            break
        best_prev = best
        x_stacks = _rev_x_stack(x_stacks)
        A_stack = _rev_A_stack(A_stack)
        reversed_state = not reversed_state
    if reversed_state:
        x_stacks = _rev_x_stack(x_stacks)
    winner = int(jnp.argmin(energies))
    stack_np = np.asarray(x_stacks[winner])
    with _cpu_scope():
        x.components = _unpad_to_components(stack_np, d, n, int(r), Tensor,
                                            res_rank)
        x.canonicalized = False
        x.move_core(0)
        nrm = x.frob_norm()
        if nrm > 0:
            x /= nrm
    return best_prev


def dmrg_groundstate_scan(A, x, num_half_sweeps: int = 8,
                          conv_eps: float = 1e-10, solver: str = "eigh",
                          lobpcg_iters: int = 24, shift=None):
    """Scan-kernel driver: pads x and A to uniform stacks, alternates
    direction by stack reversal.  solver: 'eigh' (dense local eigh) or
    'lobpcg'/'lanczos' (matrix-free).

    ``shift`` handles the padded-frame zero-mode contract (the unshifted
    kernels require ground energy < 0 — spurious zero eigenvalues from
    padding otherwise capture the solve, measured on PSD operators):

    - shift=None (default, AUTO): estimate lambda_max by running two
      UNSHIFTED half-sweeps on -A with a throwaway state (_estimate_shift
      — -A's ground -lambda_max is negative exactly when a shift is
      needed), then solve (A - 1.1*lambda_hat * P) with the shifted
      kernel only if lambda_hat > 0.  Negative-ground problems thus
      never compile or run the projector-carrying variant; the shift is
      a traced scalar, so the shifted compile serves every value.
    - shift=0.0: explicit known-negative-ground contract; skips the
      estimation dispatches.
    - shift=s > 0: use s directly (caller knows an upper bound)."""
    from ..core.tensor import Tensor
    from .tt_kernels import pad_cores
    with _cpu_scope():
        x.move_core(0)
        nrm = x.frob_norm()
        if nrm > 0:
            x /= nrm
        x_stack, r = pad_cores(
            [np.asarray(c.to_ndarray()) for c in x.components])
        A_np = [np.asarray(c.to_ndarray()) for c in A.components]
    d = len(A_np)
    n = A_np[0].shape[1]
    A_stack = _pad_operator_stack(A_np, x_stack.dtype)
    energy = np.inf

    def factory(shifted):
        if solver in ("lobpcg", "lanczos"):
            return make_dmrg_sweep_lobpcg(tuple(x_stack.shape), int(r),
                                          str(x_stack.dtype),
                                          int(lobpcg_iters), solver,
                                          shifted=shifted)
        if solver == "eigh":
            return make_dmrg_sweep_scan(tuple(x_stack.shape), int(r),
                                        str(x_stack.dtype), shifted=shifted)
        raise ValueError(f"unknown local solver {solver!r}; "
                         "expected 'eigh', 'lanczos' or 'lobpcg'")

    sdt = np.asarray(x_stack).dtype
    if shift is None:
        # the estimation phase never needs the shift itself, so it runs
        # the UNSHIFTED kernel — negative-ground problems then never pay
        # the projector-carrying variant (or its compile) at all
        shift = _estimate_shift(factory(False), x_stack, A_stack)
    shift = float(shift)
    shifted = shift != 0.0
    # device-resident loop: ALL half-sweeps + normalizations + the energy
    # convergence test as ONE while_loop program (make_dmrg_run) — the
    # per-sweep host loop paid one dispatch + scalar fetch + reversal
    # dispatches per half-sweep
    CAP = 64  # static compile bucket; `remaining` trims it
    run = make_dmrg_run(tuple(x_stack.shape), int(r), str(x_stack.dtype),
                        solver, int(lobpcg_iters), shifted, CAP)
    total = 0
    while total < num_half_sweeps:
        x_stack, e, cnt = run(x_stack, A_stack, sdt.type(shift),
                              sdt.type(conv_eps),
                              jnp.asarray(num_half_sweeps - total,
                                          jnp.int32),
                              sdt.type(energy if np.isfinite(energy)
                                       else np.inf))
        cnt = int(cnt)
        total += max(cnt, 1)
        energy = float(e)
        if cnt < min(num_half_sweeps - (total - cnt), CAP):
            break  # in-program convergence fired
        # hit the CAP bucket without converging: the state orientation is
        # already restored (un-reversed) by the program; dispatch again
    # unpad to logical ranks capped at r
    from .tt_kernels import res_rank
    stack_np = np.asarray(x_stack)
    with _cpu_scope():
        x.components = _unpad_to_components(stack_np, d, n, int(r), Tensor,
                                            res_rank)
        x.canonicalized = False
        x.move_core(0)
        nrm = x.frob_norm()
        if nrm > 0:
            x /= nrm
    return energy


@lru_cache(maxsize=32)
def make_dmrg_sweep(shapes_key, dtype_str: str):
    from .tt_kernels import jit_f32
    return jit_f32(_dmrg_eig_half_sweep, dtype_str)


def dmrg_groundstate_fast(A, x, num_half_sweeps: int = 8,
                          conv_eps: float = 1e-10):
    """Object-level driver: alternating jitted half-sweeps via site reversal;
    returns (energy, x updated in place)."""
    from ..core.tensor import Tensor
    with _cpu_scope():
        x.move_core(0)
        nrm = x.frob_norm()
        if nrm > 0:
            x /= nrm
        cores_np = [np.asarray(c.to_ndarray()) for c in x.components]
        A_np = [np.asarray(c.to_ndarray()) for c in A.components]
    cores = tuple(jnp.asarray(c) for c in cores_np)
    A_cores = tuple(jnp.asarray(c) for c in A_np)

    def rev_tt(cs):
        return tuple(jnp.transpose(c, (2, 1, 0)) for c in reversed(cs))

    def rev_op(cs):
        return tuple(jnp.transpose(c, (3, 1, 2, 0)) for c in reversed(cs))

    energy = np.inf
    reversed_state = False
    for sweep in range(num_half_sweeps):
        shapes_key = tuple(tuple(c.shape) for c in cores)
        fn = make_dmrg_sweep(shapes_key, str(cores[0].dtype))
        cores, e = fn(cores, A_cores)
        e = float(e)
        # normalize (keeps f32 healthy over many sweeps)
        last = cores[-1]
        n = jnp.linalg.norm(last)
        cores = cores[:-1] + (last / jnp.maximum(n, 1e-30),)
        if abs(e - energy) < conv_eps:
            energy = e
            break
        energy = e
        cores = rev_tt(cores)
        A_cores = rev_op(A_cores)
        reversed_state = not reversed_state
    if reversed_state:
        cores = rev_tt(cores)
    cores_np = [np.asarray(c) for c in cores]
    with _cpu_scope():
        x.components = [Tensor.from_ndarray(c) for c in cores_np]
        x.canonicalized = False
        x.move_core(0)
        n = x.frob_norm()
        if n > 0:
            x /= n
    return energy
