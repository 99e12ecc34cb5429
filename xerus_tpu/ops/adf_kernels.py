"""Whole-iteration jitted ADF kernel (single-point measurements).

One full ADF iteration — backward-stack rebuild, residual, per-core
projected-gradient steps with slice-wise optimal step sizes, and core moves —
compiled into ONE XLA program.  Index selection uses one-hot matmuls instead
of gathers (every step a GEMM), the projected
gradient and the slice-wise norms are the same one-hot GEMMs transposed.
Semantics match algorithms/adf.py's host-driven loop (itself a re-design of
src/xerus/algorithms/adf.cpp).
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import List, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp


def _site(onehot, core):
    """(M, n) x (rl, n, rr) -> (M, rl, rr) selected slices."""
    return jnp.einsum("mn,anb->mab", onehot, core)


def _adf_iteration(cores, onehots, values):
    """Returns (new_cores, residual_norm_at_start)."""
    d = len(cores)
    M = values.shape[0]
    dtype = cores[0].dtype

    B = [None] * (d + 1)
    B[d] = jnp.ones((M, 1), dtype=dtype)
    for k in range(d - 1, 0, -1):
        B[k] = jnp.einsum("mab,mb->ma", _site(onehots[k], cores[k]), B[k + 1])

    F = jnp.ones((M, 1), dtype=dtype)
    cores = list(cores)
    residual0 = jnp.zeros((), dtype)
    for cp in range(d):
        pred = jnp.einsum("ma,mab,mb->m", F, _site(onehots[cp], cores[cp]),
                          B[cp + 1])
        res = values - pred
        if cp == 0:
            residual0 = jnp.linalg.norm(res)
        outer = jnp.einsum("m,ma,mb->mab", res, F, B[cp + 1])
        grad_by_slice = jnp.einsum("mn,mab->nab", onehots[cp], outer)
        grad = jnp.transpose(grad_by_slice, (1, 0, 2))
        Ggath = jnp.einsum("mn,nab->mab", onehots[cp], grad_by_slice)
        val = jnp.einsum("ma,mab,mb->m", F, Ggath, B[cp + 1])
        norms = jnp.einsum("mn,m->n", onehots[cp], val * val)
        PyR = jnp.sum(grad_by_slice * grad_by_slice, axis=(1, 2))
        alpha = jnp.where(norms > 0, PyR / jnp.maximum(norms, 1e-300), 0.0)
        new_core = cores[cp] + alpha[None, :, None] * grad
        if cp + 1 < d:
            rl, n, rr = new_core.shape
            q, r = jnp.linalg.qr(new_core.reshape(rl * n, rr))
            cores[cp] = q.reshape(rl, n, q.shape[1])
            cores[cp + 1] = jnp.einsum("ab,bnc->anc", r, cores[cp + 1])
            F = jnp.einsum("ma,mab->mb", F, _site(onehots[cp], cores[cp]))
        else:
            cores[cp] = new_core
    return tuple(cores), residual0


def _adf_iteration_rankone(cores, Ws, values):
    """Rank-one-measurement variant: per-mode weight matrices Ws[k] (M, n_k)
    select GENERAL rank-one functionals; the step size is global (slot 0,
    adf.cpp:468-487 RankOne specialization)."""
    d = len(cores)
    M = values.shape[0]
    dtype = cores[0].dtype

    B = [None] * (d + 1)
    B[d] = jnp.ones((M, 1), dtype=dtype)
    for k in range(d - 1, 0, -1):
        B[k] = jnp.einsum("mab,mb->ma", _site(Ws[k], cores[k]), B[k + 1])

    F = jnp.ones((M, 1), dtype=dtype)
    cores = list(cores)
    residual0 = jnp.zeros((), dtype)
    for cp in range(d):
        pred = jnp.einsum("ma,mab,mb->m", F, _site(Ws[cp], cores[cp]),
                          B[cp + 1])
        res = values - pred
        if cp == 0:
            residual0 = jnp.linalg.norm(res)
        outer = jnp.einsum("m,ma,mb->mab", res, F, B[cp + 1])
        grad = jnp.einsum("mab,mn->anb", outer, Ws[cp])
        val = jnp.einsum("ma,mab,mb->m", F, _site(Ws[cp], grad), B[cp + 1])
        denom = jnp.sum(val * val)
        PyR = jnp.sum(grad * grad)
        alpha = jnp.where(denom > 0, PyR / jnp.maximum(denom, 1e-300), 0.0)
        new_core = cores[cp] + alpha * grad
        if cp + 1 < d:
            rl, n, rr = new_core.shape
            q, r = jnp.linalg.qr(new_core.reshape(rl * n, rr))
            cores[cp] = q.reshape(rl, n, q.shape[1])
            cores[cp + 1] = jnp.einsum("ab,bnc->anc", r, cores[cp + 1])
            F = jnp.einsum("ma,mab->mb", F, _site(Ws[cp], cores[cp]))
        else:
            cores[cp] = new_core
    return tuple(cores), residual0


@lru_cache(maxsize=32)
def make_adf_iteration(shapes_key, dtype_str: str, rank_one: bool = False):
    from .tt_kernels import jit_f32
    return jit_f32(_adf_iteration_rankone if rank_one else _adf_iteration,
                   dtype_str)


@lru_cache(maxsize=32)
def make_adf_multi_iteration(shapes_key, dtype_str: str, k: int,
                             rank_one: bool = False):
    """K chained ADF iterations (update sweep + left re-canonicalization)
    as ONE XLA program, returning (cores_after_K, residual_history).

    Rationale: one ADF iteration at the BASELINE completion size is far
    less device work than the per-iteration driver's two dispatches + a
    convergence-check sync.  Chaining K iterations
    in a lax.scan (shape-stable: valid-TT QR ranks are invariant) costs
    one dispatch per K iterations; the host applies the reference's
    per-iteration stagnation logic (adf.cpp:541-566) to the returned
    residual history, so stopping DECISIONS see every iteration — only
    the cores may overshoot the stopping point by up to K-1 iterations
    (harmless for a descent method; documented in ADFVariant.__call__).
    history[i] is the residual norm at the START of inner iteration i,
    matching the per-iteration kernel's residual0."""
    from .tt_kernels import jit_f32
    base = _adf_iteration_rankone if rank_one else _adf_iteration
    return jit_f32(_make_multi_body(base, k), dtype_str)


@lru_cache(maxsize=32)
def make_adf_device_run(shapes_key, dtype_str: str, max_iters: int,
                        rank_one: bool = False, mesh=None):
    """The WHOLE fixed-rank ADF solve as ONE XLA program: a lax.while_loop
    whose body is (iteration + left re-canonicalization) and whose carried
    stopping logic replicates the host driver exactly (adf.cpp:541-566):
    stop when the start-of-iteration residual drops below ``target`` or the
    product of the last four clamped residual-decrease ratios exceeds
    ``min_decrease**4``.

    Rationale: the chained-K factory (make_adf_multi_iteration) still pays
    one dispatch + sync per K iterations plus a possible K-1 overshoot;
    the while_loop form pays ONE dispatch per rank level and stops at the
    same iteration the K=1 host loop would (cores end exactly one update
    past the stopping measurement, identical to the K=1 path).

    ``res_dec0``/``last0`` enter as traced inputs so stagnation history is
    continuous across dispatches (rank bumps restart it on the host, same
    as the reference).  ``remaining`` bounds the loop below the static
    ``max_iters`` compile bucket without recompiling per cap.

    With ``mesh`` (point measurements only, same contract as the chained
    factories), the one-hots and values dp-shard over the measurement
    axis; cores and outputs stay replicated (GSPMD inserts the psums).

    Returns (cores, hist, count): hist[i] is the residual norm at the
    start of inner iteration i (unscaled, like the other factories),
    valid for i < count."""
    from .tt_kernels import jit_f32
    base = _adf_iteration_rankone if rank_one else _adf_iteration

    def run(cores, onehots, values, target, min_decrease, res_dec0, last0,
            remaining):
        dtype = values.dtype
        limit = jnp.minimum(jnp.asarray(max_iters, jnp.int32),
                            remaining.astype(jnp.int32))
        thresh = min_decrease ** 4

        def cond(carry):
            _cs, _h, i, _rd, _l, stop = carry
            return jnp.logical_and(i < limit, jnp.logical_not(stop))

        def body(carry):
            cs, hist, i, res_dec, last, _stop = carry
            new, res0 = base(cs, onehots, values)
            new = canonicalize_left_cores(new)
            hist = hist.at[i].set(res0)
            ratio = jnp.minimum(res0 / jnp.where(last > 0, last, 1.0), 1.0)
            res_dec = jnp.concatenate([ratio[None], res_dec[:3]])
            stop = jnp.logical_or(res0 < target,
                                  jnp.prod(res_dec) > thresh)
            return (new, hist, i + 1, res_dec, res0, stop)

        hist0 = jnp.full((max_iters,), -1.0, dtype)
        carry = (tuple(cores), hist0, jnp.zeros((), jnp.int32),
                 res_dec0.astype(dtype), last0.astype(dtype),
                 jnp.zeros((), jnp.bool_))
        cs, hist, i, _rd, _l, _s = jax.lax.while_loop(cond, body, carry)
        return cs, hist, i

    if mesh is None:
        return jit_f32(run, dtype_str)

    from jax.sharding import NamedSharding, PartitionSpec as P
    rep = NamedSharding(mesh, P())
    ms = NamedSharding(mesh, P("dp"))

    def sharded(cores, onehots, values, *rest):
        onehots = tuple(jax.lax.with_sharding_constraint(o, ms)
                        for o in onehots)
        values = jax.lax.with_sharding_constraint(values, ms)
        return run(cores, onehots, values, *rest)

    n_cores = len(shapes_key)
    jfn = jax.jit(sharded, out_shardings=((rep,) * n_cores, rep, rep))
    if dtype_str != "float32":
        return jfn

    def wrapped(*args, **kwargs):
        with jax.enable_x64(False), jax.default_matmul_precision("highest"):
            return jfn(*args, **kwargs)

    return wrapped


def _bond_masks(ranks, caps):
    """Per-bond live masks from the traced rank vector: mask[k][j] = 1.0
    iff j < ranks[k] (caps are the static pad buckets)."""
    return [(jnp.arange(c, dtype=jnp.int32) < ranks[k]) for k, c in
            enumerate(caps)]


def _adf_iteration_masked(cores, onehots, values, ranks, caps, dtype,
                          rank_one: bool = False):
    """One ADF iteration at PADDED shapes with live-rank masks.
    ``rank_one`` switches to the rank-one-measurement gradient/global
    step size (the _adf_iteration_rankone semantics); the masking
    discipline is identical — gradients inherit exact zeros on dead
    slots from the masked stacks.

    Invariant: every core enters with exactly-zero dead bond slots
    (beyond ``ranks``).  The stacks, gradients and step sizes then stay
    exactly zero on dead slots automatically (every contraction factors
    through a masked core); the ONLY place junk can appear is the Q of
    each QR (Householder completes an orthonormal basis in the dead
    columns), so Q columns are re-masked after every factorization.  The
    matching R rows are zero already (R[j, l] = 0 for l < j by
    triangularity and R[:, dead] = Q^T A[:, dead] = 0), so masking is an
    exact identity on the represented tensor."""
    d = len(cores)
    M = values.shape[0]
    bm = _bond_masks(ranks, caps)
    colmask = [m.astype(dtype) for m in bm]

    B = [None] * (d + 1)
    B[d] = jnp.ones((M, 1), dtype=dtype)
    for k in range(d - 1, 0, -1):
        B[k] = jnp.einsum("mab,mb->ma", _site(onehots[k], cores[k]), B[k + 1])

    F = jnp.ones((M, 1), dtype=dtype)
    cores = list(cores)
    residual0 = jnp.zeros((), dtype)
    for cp in range(d):
        pred = jnp.einsum("ma,mab,mb->m", F, _site(onehots[cp], cores[cp]),
                          B[cp + 1])
        res = values - pred
        if cp == 0:
            residual0 = jnp.linalg.norm(res)
        outer = jnp.einsum("m,ma,mb->mab", res, F, B[cp + 1])
        if rank_one:
            grad = jnp.einsum("mab,mn->anb", outer, onehots[cp])
            val = jnp.einsum("ma,mab,mb->m", F, _site(onehots[cp], grad),
                             B[cp + 1])
            denom = jnp.sum(val * val)
            alpha_g = jnp.where(denom > 0,
                                jnp.sum(grad * grad)
                                / jnp.maximum(denom, 1e-300), 0.0)
            new_core = cores[cp] + alpha_g * grad
        else:
            grad_by_slice = jnp.einsum("mn,mab->nab", onehots[cp], outer)
            grad = jnp.transpose(grad_by_slice, (1, 0, 2))
            Ggath = jnp.einsum("mn,nab->mab", onehots[cp], grad_by_slice)
            val = jnp.einsum("ma,mab,mb->m", F, Ggath, B[cp + 1])
            norms = jnp.einsum("mn,m->n", onehots[cp], val * val)
            PyR = jnp.sum(grad_by_slice * grad_by_slice, axis=(1, 2))
            alpha = jnp.where(norms > 0,
                              PyR / jnp.maximum(norms, 1e-300), 0.0)
            new_core = cores[cp] + alpha[None, :, None] * grad
        if cp + 1 < d:
            rl, n, rr = new_core.shape
            q, r = jnp.linalg.qr(new_core.reshape(rl * n, rr))
            q = q * colmask[cp][None, :]
            cores[cp] = q.reshape(rl, n, q.shape[1])
            cores[cp + 1] = jnp.einsum("ab,bnc->anc", r, cores[cp + 1])
            F = jnp.einsum("ma,mab->mb", F, _site(onehots[cp], cores[cp]))
        else:
            cores[cp] = new_core
    return tuple(cores), residual0


def _canonicalize_left_masked(cs, ranks, caps, dtype):
    """Right-to-left QR sweep at padded shapes; Q columns re-masked (see
    _adf_iteration_masked)."""
    bm = _bond_masks(ranks, caps)
    cs = list(cs)
    for i in range(len(cs) - 1, 0, -1):
        rl, n, rr = cs[i].shape
        q, r = jnp.linalg.qr(cs[i].reshape(rl, n * rr).T)
        q = q * bm[i - 1].astype(dtype)[None, :]
        cs[i] = q.T.reshape(q.shape[1], n, rr)
        cs[i - 1] = jnp.einsum("anb,bk->ank", cs[i - 1], r.T)
    return tuple(cs)


def _bump_cores(cores, ranks, caps, key, scale, dtype):
    """In-program rank bump (adf.cpp:589-601): add ``scale`` times a
    random rank-1 TT, embedded block-diagonally in the dead pad slots.

    Per bond k the rank-1 term occupies slot index ranks[k] when the
    bond is below its cap (growing it by one) and rides slot 0 when the
    bond is capped.  The reference instead rounds the bumped tensor back
    to max_ranks — for capped bonds that folds the perturbation into the
    kept subspace; riding slot 0 is the same "random kick at scale
    eps*||x||" semantics without a device SVD.  Each slice is normalized
    so the added term has unit Frobenius norm (rank-1 TT norm factors
    over slices); ``scale`` carries the magnitude."""
    d = len(cores)
    keys = jax.random.split(key, d)
    new = []
    for k, core in enumerate(cores):
        capL, n, capR = core.shape
        g = jax.random.normal(keys[k], (n,), dtype)
        g = g / (jnp.linalg.norm(g) + 1e-30)
        if k == 0:
            eL = jnp.ones((1,), dtype)
            g = g * scale
        else:
            slotL = jnp.where(ranks[k - 1] < caps[k - 1], ranks[k - 1], 0)
            eL = (jnp.arange(capL, dtype=jnp.int32) == slotL).astype(dtype)
        if k == d - 1:
            eR = jnp.ones((1,), dtype)
        else:
            slotR = jnp.where(ranks[k] < caps[k], ranks[k], 0)
            eR = (jnp.arange(capR, dtype=jnp.int32) == slotR).astype(dtype)
        new.append(core + eL[:, None, None] * g[None, :, None]
                   * eR[None, None, :])
    caps_v = jnp.asarray(caps, jnp.int32)
    return tuple(new), jnp.minimum(ranks + 1, caps_v)


@lru_cache(maxsize=32)
def make_adf_adaptive_run(shapes_key, dtype_str: str, max_iters: int,
                          caps: Tuple[int, ...], bump_scale: float,
                          seed: int = 0, rank_one: bool = False):
    """The WHOLE rank-adaptive ADF solve (adf.cpp:541-601) as ONE XLA
    program: fixed-rank while_loop solves AND the rank bumps between
    them run device-resident, with cores padded to the ``caps`` rank
    vector and live ranks carried as data (VERDICT r2 item #5 — the
    host-pinned bump paid object-level round math plus a fresh
    while_loop compile/dispatch per rank level).

    ``shapes_key`` are the PADDED core shapes (capL, n, capR).  The
    stagnation logic per rank level matches make_adf_device_run; when a
    fixed-rank level stagnates above ``target`` with ranks below
    ``caps``, the body injects a scale-``bump_scale*||x||`` random
    rank-1 term into the dead pad slots (_bump_cores), resets the
    stagnation window, and keeps iterating — no host round trip.

    Returns (cores, ranks, hist, count)."""
    from .tt_kernels import jit_f32

    def run(cores, onehots, values, target, min_decrease, ranks0, last0,
            remaining):
        dtype = values.dtype
        d = len(cores)
        limit = jnp.minimum(jnp.asarray(max_iters, jnp.int32),
                            remaining.astype(jnp.int32))
        thresh = min_decrease ** 4
        caps_v = jnp.asarray(caps, jnp.int32)
        key0 = jax.random.PRNGKey(seed)

        def cond(carry):
            i, done = carry[2], carry[7]
            return jnp.logical_and(i < limit, jnp.logical_not(done))

        def body(carry):
            cs, hist, i, res_dec, last, ranks, key, _done = carry
            new, res0 = _adf_iteration_masked(cs, onehots, values, ranks,
                                              caps, dtype, rank_one)
            new = _canonicalize_left_masked(new, ranks, caps, dtype)
            hist = hist.at[i].set(res0)
            ratio = jnp.minimum(res0 / jnp.where(last > 0, last, 1.0), 1.0)
            res_dec = jnp.concatenate([ratio[None], res_dec[:3]])
            level_stop = jnp.logical_or(res0 < target,
                                        jnp.prod(res_dec) > thresh)
            at_max = jnp.all(ranks >= caps_v)
            done = jnp.logical_and(level_stop,
                                   jnp.logical_or(res0 < target, at_max))
            do_bump = jnp.logical_and(level_stop, jnp.logical_not(done))

            def bump(args):
                cs_b, ranks_b, rd_b, key_b = args
                key_b, sub = jax.random.split(key_b)
                norm_x = jnp.linalg.norm(cs_b[0])  # left-canonical
                cs2, ranks2 = _bump_cores(cs_b, ranks_b, caps, sub,
                                          bump_scale * norm_x, dtype)
                return cs2, ranks2, jnp.zeros_like(rd_b), key_b

            new, ranks, res_dec, key = jax.lax.cond(
                do_bump, bump, lambda a: a, (new, ranks, res_dec, key))
            return (new, hist, i + 1, res_dec, res0, ranks, key, done)

        hist0 = jnp.full((max_iters,), -1.0, dtype)
        carry = (tuple(cores), hist0, jnp.zeros((), jnp.int32),
                 jnp.zeros((4,), dtype), last0.astype(dtype),
                 ranks0.astype(jnp.int32), key0, jnp.zeros((), jnp.bool_))
        out = jax.lax.while_loop(cond, body, carry)
        cs, hist, i, _rd, _l, ranks, _k, _dn = out
        return cs, ranks, hist, i

    return jit_f32(run, dtype_str)


def canonicalize_left_cores(cs):
    """Right-to-left QR sweep moving the core to component 0 (jittable;
    the in-program equivalent of TTNetwork.move_core(0)).  Shared by the
    ADF driver's per-iteration loop and the chained multi-iteration
    kernels."""
    cs = list(cs)
    for i in range(len(cs) - 1, 0, -1):
        rl, n, rr = cs[i].shape
        q, r = jnp.linalg.qr(cs[i].reshape(rl, n * rr).T)
        cs[i] = q.T.reshape(q.shape[1], n, rr)
        cs[i - 1] = jnp.einsum("anb,bk->ank", cs[i - 1], r.T)
    return tuple(cs)


def _make_multi_body(base, k: int):
    """K chained (iteration + left re-canonicalization) steps as a
    lax.scan; shared by the plain and dp-sharded multi factories."""

    def multi(cores, onehots, values):
        def body(cs, _):
            out, res = base(cs, onehots, values)
            return canonicalize_left_cores(out), res

        out, hist = jax.lax.scan(body, tuple(cores), None, length=k)
        return out, hist

    return multi


@lru_cache(maxsize=32)
def make_adf_multi_iteration_sharded(mesh, shapes_key, dtype_str: str,
                                     k: int):
    """dp-sharded K-chained ADF iterations: the measurement axis of the
    one-hots/values shards over the mesh (as make_adf_iteration_sharded)
    while the K-step chain runs as ONE program (as
    make_adf_multi_iteration) — so a mesh caller still amortizes the
    per-dispatch latency over K iterations.  Point measurements only
    (same contract as the single-iteration sharded factory)."""
    return _jit_dp_sharded(_make_multi_body(_adf_iteration, k), mesh,
                           len(shapes_key), dtype_str)


def _jit_dp_sharded(body, mesh, n_cores: int, dtype_str: str):
    """Shared scaffolding for the dp-sharded ADF factories: one-hot
    matrices and values shard over the measurement axis; cores and the
    outputs stay replicated (GSPMD inserts the psum for the segment-
    summed gradients).  SURVEY.md §2.6a.

    Follows the jit_f32 discipline for f32 stacks (ops/tt_kernels.py):
    traces under x64-off with HIGHEST matmul precision (reduced-precision
    matmuls stall convergence)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    rep = NamedSharding(mesh, P())
    ms = NamedSharding(mesh, P("dp"))

    def fn(cores, onehots, values):
        onehots = tuple(jax.lax.with_sharding_constraint(o, ms)
                        for o in onehots)
        values = jax.lax.with_sharding_constraint(values, ms)
        return body(cores, onehots, values)

    jfn = jax.jit(fn, out_shardings=((rep,) * n_cores, rep))
    if dtype_str != "float32":
        return jfn

    def wrapped(*args, **kwargs):
        with jax.enable_x64(False), jax.default_matmul_precision("highest"):
            return jfn(*args, **kwargs)

    return wrapped


@lru_cache(maxsize=32)
def make_adf_iteration_sharded(mesh, shapes_key, dtype_str: str):
    """dp-sharded single iteration (see _jit_dp_sharded).  lru_cached on
    (mesh, shapes, dtype) — a fresh jit per iteration would re-compile
    every ADF step."""
    return _jit_dp_sharded(_adf_iteration, mesh, len(shapes_key), dtype_str)


def build_onehots(positions: np.ndarray, dims: Sequence[int], dtype):
    """Per-mode one-hot matrices (M, n_k) from integer positions (M, d)."""
    M, d = positions.shape
    out = []
    for k in range(d):
        oh = np.zeros((M, int(dims[k])), dtype=dtype)
        oh[np.arange(M), positions[:, k]] = 1.0
        out.append(jnp.asarray(oh))
    return tuple(out)
