"""Ozaki-scheme split GEMM: f64-quality matmul from exact f32/bf16 GEMMs.

The double-word path's `df_matmul` (ops/df32.py) forms the full (m, k, n)
broadcast product and tree-reduces it — numerically excellent but O(m*k*n)
memory and elementwise-bound.  The Ozaki scheme (Ozaki/Ogita/Oishi/Rump, Numer.
Algorithms 59, 2012) instead splits each factor into slices with few enough
mantissa bits that every pairwise slice GEMM is EXACT in ordinary f32
accumulation; the slice products are then summed in double-word arithmetic.
All heavy work becomes plain GEMMs — the slices (<= 8 mantissa bits) are
bf16-representable, so bf16 matrix units with an f32 accumulator run them
exactly.  (That the accumulation of a given device's bf16 GEMM is exact in
f32 is an assumption each backend has to meet; tests/test_df32.py checks
it where the suite runs.)

Error budget for df inputs (hi, lo) with slice width delta and s slices:
  - hi x hi slice products: exact (2*delta + ceil(log2 k) <= 24)
  - remainder/lo correction GEMMs in f32: relative error 2^-24 on terms of
    magnitude 2^(-s*delta) resp. 2^-24 -> ~2^-48 overall, i.e. df quality.

This implements ROADMAP item "Ozaki-scheme df GEMM"; the reference has no
analogue (xerus is f64 CPU LAPACK throughout) — this reaches its f64
precision from f32/bf16 GEMMs, see also ops/df32.py.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .df32 import df_add


def _slice_width(k: int) -> int:
    """Mantissa bits per slice: exact pairwise f32 accumulation over k terms
    needs 2*delta + ceil(log2 k) <= 24; bf16 representability needs
    delta <= 8."""
    return max(1, min(8, (24 - int(np.ceil(np.log2(max(k, 2))))) // 2))


def ozaki_split(A: jnp.ndarray, axis: int, delta: int, s: int):
    """Error-free split A = sum(slices) + remainder along the contraction
    axis.  Each slice keeps the top `delta` unconsumed mantissa bits
    relative to the per-row max; extraction via the round-to-nearest trick
    S = (R + sigma) - sigma is exact, as is the remainder update R - S."""
    dtype = A.dtype
    slices = []
    R = A
    for _ in range(s):
        mu = jnp.max(jnp.abs(R), axis=axis, keepdims=True)
        # sigma = 2^(ceil(log2 mu) + 24 - delta); guard mu=0 rows
        e = jnp.ceil(jnp.log2(jnp.maximum(mu, jnp.finfo(dtype).tiny)))
        sigma = jnp.exp2(e + (24 - delta)).astype(dtype)
        S = (R + sigma) - sigma
        R = R - S
        slices.append(S)
    return slices, R


def _gemm_f32(a, b):
    return jax.lax.dot_general(
        a, b, (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)


def _gemm_exact(a, b):
    """Exact product of slice matrices: <=8 mantissa bits each, so bf16
    inputs with the f32 accumulator lose nothing."""
    return jax.lax.dot_general(
        a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
        (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)


def ozaki_matmul(Ah: jnp.ndarray, Al: jnp.ndarray,
                 Bh: jnp.ndarray, Bl: jnp.ndarray,
                 num_slices: int = 0) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """df (m,k) @ df (k,n) -> df (m,n) via the Ozaki split scheme.

    s*s exact slice GEMMs + 4 f32 correction GEMMs + s*s elementwise df
    adds; O(m*n) memory (vs df_matmul's O(m*k*n) broadcast)."""
    k = Ah.shape[1]
    delta = _slice_width(k)
    s = num_slices or int(np.ceil(24 / delta))

    A_sl, Ra = ozaki_split(Ah, axis=1, delta=delta, s=s)
    B_sl, Rb = ozaki_split(Bh, axis=0, delta=delta, s=s)

    # accumulate smallest-magnitude terms first (corrections, then slice
    # products by descending i+j) so df_add renormalization never swallows
    # low-order mass under a dominant partial sum
    ch = jnp.zeros((Ah.shape[0], Bh.shape[1]), dtype=Ah.dtype)
    cl = jnp.zeros_like(ch)
    corrections = (
        _gemm_f32(Al, Bl),          # ~2^-49
        _gemm_f32(Ra, Bh),          # remainder of A times full B-hi
        _gemm_f32(Ah - Ra, Rb),     # consumed part of A times B remainder
        _gemm_f32(Al, Bh),
        _gemm_f32(Ah, Bl),
    )
    for t in corrections:
        ch, cl = df_add(ch, cl, t, jnp.zeros_like(t))
    order = sorted(((i, j) for i in range(s) for j in range(s)),
                   key=lambda ij: -(ij[0] + ij[1]))
    for i, j in order:
        t = _gemm_exact(A_sl[i], B_sl[j])
        ch, cl = df_add(ch, cl, t, jnp.zeros_like(t))
    return ch, cl


def ozaki_matmul_f32(A: jnp.ndarray, B: jnp.ndarray,
                     num_slices: int = 0) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Plain-f32 inputs -> df-accurate product (hi, lo)."""
    z = jnp.zeros_like
    return ozaki_matmul(A, z(A), B, z(B), num_slices)
