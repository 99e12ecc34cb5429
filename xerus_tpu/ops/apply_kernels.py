"""Fused MPO application + randomized rounding (zip-up) in one XLA program.

The reference applies an operator lazily via TTStack and then rounds
(src/xerus/ttStack.cpp:197 + tensorNetwork.cpp:678): the product TT with
bond rank a*r is materialized and the full rounding chain runs on it.
Here the two fuse: the randomized-rounding sketch and projection scans
contract the A- and x-cores DIRECTLY, so the (a*r, n, a*r) product cores
are never materialized (for a=3 MPO on r=256, d=32 that stack alone is
~150 MB) and every step stays GEMM-shaped.

Math: identical to `_round_randomized_scan` (ops/tt_kernels.py) applied
to the product cores Y_k[(al rl), m, (ar rr)] = sum_c A_k[al, m, c, ar]
x_k[rl, c, rr]; each sketch/projection contraction is factored through A
and x, costing O(a^2 n^2 r l + a r^2 n l) per site instead of the
O(a^2 r^2 n^2) needed to build Y_k.  Quasi-optimal accuracy contract of
the randomized sweep (2-3x optimal under truncation, exact on
representable ranks).
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import List, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .tt_kernels import jit_f32, _cholqr2, res_rank


def _apply_round_scan(A_stack: jnp.ndarray, x_stack: jnp.ndarray,
                      target_rank: int, oversample: int,
                      qr_method: str = "cholqr1"):
    """A_stack: (d, a, n, n, a) padded MPO cores; x_stack: (d, r, n, r).
    Returns (Qs (d-1, l, n, l), final (l, n, r*a->unused), log-scale
    distributed) — cores of the rounded product, bond dim l."""
    d, a, n, _, _ = A_stack.shape
    r = x_stack.shape[1]
    dtype = x_stack.dtype
    l = target_rank + oversample
    tiny = jnp.asarray(1e-30, dtype)
    key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, d)

    # ---- right-to-left sketches W_k (a, r, l) for bond k ----
    def sketch_body(W, inp):
        Ak, xk, k = inp
        Om = jax.random.normal(k, (l, n, l), dtype=dtype)
        t1 = jnp.einsum("rcs,bsq->rcbq", xk, W,
                        preferred_element_type=dtype)      # (r, n_in, a, l)
        t2 = jnp.einsum("amcb,rcbq->armq", Ak, t1,
                        preferred_element_type=dtype)      # (a, r, n_out, l)
        Wn = jnp.einsum("armq,pmq->arp", t2, Om,
                        preferred_element_type=dtype)      # (a, r, l)
        Wn = Wn / (jnp.linalg.norm(Wn) + tiny)
        return Wn, Wn

    W_init = jnp.zeros((a, r, l), dtype=dtype).at[0, 0, 0].set(1.0)
    _, Ws = jax.lax.scan(sketch_body, W_init,
                         (A_stack[1:][::-1], x_stack[1:][::-1], keys[1:]))
    Ws = Ws[::-1]                       # Ws[k] pairs with site k (bond k+1)

    # ---- left-to-right orthogonalization sweep ----
    col_mask = (jnp.arange(l, dtype=jnp.int32) < target_rank).astype(dtype)

    def sweep_body(carry, inp):
        C, logs = carry                 # (l, a, r) projection of bond k
        Ak, xk, W = inp
        u1 = jnp.einsum("kas,scr->kacr", C, xk,
                        preferred_element_type=dtype)      # (l, a, n_in, r)
        G = jnp.einsum("amcb,kacr->kmbr", Ak, u1,
                       preferred_element_type=dtype)       # (l, n_out, a, r)
        Y = jnp.einsum("kmbr,brq->kmq", G, W,
                       preferred_element_type=dtype).reshape(l * n, l)
        if qr_method == "cholqr1":
            from jax.scipy.linalg import solve_triangular
            Gm = Y.T @ Y
            shift = (jnp.asarray(10 * Y.shape[0] * jnp.finfo(dtype).eps,
                                 dtype) * jnp.max(jnp.diagonal(Gm)) + tiny)
            Lc = jnp.linalg.cholesky(Gm + shift * jnp.eye(l, dtype=dtype))
            q = solve_triangular(Lc, Y.T, lower=True).T
        elif qr_method == "cholqr":
            q = _cholqr2(Y, tiny)
        else:
            q, _ = jnp.linalg.qr(Y)
        q = q * col_mask[None, :]
        Q = q.reshape(l, n, l)
        C2 = jnp.einsum("kmp,kmbr->pbr", Q, G,
                        preferred_element_type=dtype)      # (l, a, r)
        nrm = jnp.linalg.norm(C2) + tiny
        return (C2 / nrm, logs + jnp.log(nrm)), Q

    C0 = jnp.zeros((l, a, r), dtype=dtype).at[0, 0, 0].set(1.0)
    (Cfin, logs), Qs = jax.lax.scan(
        sweep_body, (C0, jnp.zeros((), dtype)),
        (A_stack[:-1], x_stack[:-1], Ws))
    # last site: F = C . Y_d, right boundary rank 1 (slot 0 of (a, r))
    u1 = jnp.einsum("kas,scr->kacr", Cfin, x_stack[d - 1],
                    preferred_element_type=dtype)
    F = jnp.einsum("amcb,kacr->kmbr", A_stack[d - 1], u1,
                   preferred_element_type=dtype)           # (l, n, a, r)
    final = F[:, :, 0, 0]                                  # (l, n)
    scale = jnp.exp(logs / d)
    return Qs * scale, final * scale


@lru_cache(maxsize=32)
def make_apply_round(shapeA, shapeX, target_rank: int, oversample: int,
                     dtype_str: str, qr_method: str):
    return jit_f32(partial(_apply_round_scan, target_rank=target_rank,
                           oversample=oversample, qr_method=qr_method),
                   dtype_str)


def apply_operator_rounded_cores(A_cores: Sequence, x_cores: Sequence,
                                 target_rank: int, oversample: int = 8,
                                 qr_method: str = "auto") -> List:
    """Kernel-level fused apply+round: A (list of (al, m, c, ar) MPO
    cores), x (list of (rl, c, rr) cores) -> rounded product cores at
    bond dim <= target_rank."""
    A_np = [np.asarray(c) for c in A_cores]
    x_np = [np.asarray(c) for c in x_cores]
    if qr_method == "auto":
        # Householder: cholqr1's u*kappa^2 floor is unsafe for STRUCTURED
        # operators (measured: Laplace apply panels give 0.26 rel err at
        # f32 vs 9.6e-7 Householder — unlike the random-TT rounding
        # panels where both match).  cholqr1 remains opt-in for measured
        # well-conditioned inputs.
        qr_method = "householder"
    d = len(A_np)
    a = max(max(c.shape[0], c.shape[3]) for c in A_np)
    n = A_np[0].shape[1]
    r = max(max(c.shape[0], c.shape[2]) for c in x_np)
    dtype = x_np[0].dtype
    A_stack = np.zeros((d, a, n, n, a), dtype=dtype)
    x_stack = np.zeros((d, r, n, r), dtype=dtype)
    for k in range(d):
        c = A_np[k]
        A_stack[k, :c.shape[0], :, :, :c.shape[3]] = c
        xc = x_np[k]
        x_stack[k, :xc.shape[0], :, :xc.shape[2]] = xc
    fn = make_apply_round(tuple(A_stack.shape), tuple(x_stack.shape),
                          int(target_rank), int(oversample), str(dtype),
                          qr_method)
    Qs, final = fn(jnp.asarray(A_stack), jnp.asarray(x_stack))
    # logical bond caps: product rank a_k*r_k, physical n^k / n^(d-k)
    res = []
    for k in range(d):
        prod_l = A_np[k].shape[0] * x_np[k].shape[0]
        prod_r = A_np[k].shape[3] * x_np[k].shape[2]
        rl = 1 if k == 0 else min(int(target_rank), prod_l,
                                  res_rank(k, d, n, int(target_rank)))
        rr = 1 if k == d - 1 else min(int(target_rank), prod_r,
                                      res_rank(k + 1, d, n,
                                               int(target_rank)))
        if k < d - 1:
            res.append(Qs[k][:rl, :, :rr])
        else:
            res.append(final[:rl, :, None][:, :, :rr])
    return res


def apply_operator_rounded(op, x, target_rank: int, oversample: int = 8):
    """Object-level fused apply+round: returns round(op @ x) at rank
    <= target_rank without materializing the rank-a*r product
    (TTStack+round semantics, ttStack.cpp:197; new kernel)."""
    from ..config import host
    from ..core.tensor import Tensor
    with host():
        A_cores = [np.asarray(c.to_ndarray()) for c in op.components]
        x_cores = [np.asarray(c.to_ndarray()) for c in x.components]
    out = apply_operator_rounded_cores(A_cores, x_cores, target_rank,
                                       oversample)
    with host():
        comps = [Tensor.from_ndarray(np.asarray(c, np.float64))
                 for c in out]
        res = type(x)._make(comps)
        res.canonicalized = False
        res.move_core(0)
    return res
