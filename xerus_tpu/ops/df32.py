"""Double-word float32 ("double-float") arithmetic.

f64-quality (1e-10-level) residuals from float32 arithmetic, for devices
whose f32 rate far exceeds their f64 rate.  A double-word number is an
unevaluated sum hi + lo of two float32s with |lo| <= ulp(hi)/2, giving
~49 bits of significand — enough for 1e-12-level linear-algebra residuals.
Where native float64 is fast, the plain f64 kernels are the simpler route;
which one wins a given solve is a measurement (PERF.md).

Primitives use error-free transformations that need only IEEE round-to-
nearest f32 add/mul.  CAUTION: the compiler DOES contract mul-then-add
chains into FMAs (LLVM on CPU and GPU), which silently breaks the
arithmetic Veltkamp split — the mantissa split is therefore done by bit
masking (`_split`), which no contraction can touch:
  two_sum   — Knuth 2Sum (add/sub only: contraction-immune)
  two_prod  — masked-split product (no FMA required, FMA-tolerant)
Reductions are pairwise trees of df_add, so accumulation error stays
O(log K) in df precision instead of O(sqrt K) in f32.

This is a new design (the reference simply links double-precision LAPACK,
SURVEY.md §2.2).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

def two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def fast_two_sum(a, b):
    """Requires |a| >= |b| (or a == 0)."""
    s = a + b
    err = b - (s - a)
    return s, err


def _split(a):
    """Exact high/low mantissa split via bit masking.

    NOT the arithmetic Veltkamp split (c = a*(2^12+1); hi = c - (c - a)):
    under jit, LLVM/XLA FMA-contracts `c - a` into fma(a, SPLITTER, -a),
    which skips the rounding of c that the split depends on — jitted
    df_mul silently degraded to f32 accuracy (~2e-8) while eager stayed
    at 1e-15.  Masking the low half of the mantissa is exact by
    construction and gives the compiler nothing to contract: hi keeps 12
    of f32's 24 significant bits (26 of f64's 53), and lo = a - hi is
    exact, so all half-products in two_prod fit the mantissa."""
    if a.dtype == jnp.float64:
        # Clear 27 low bits: hi keeps 26 of f64's 53 significant bits, so
        # hi*hi needs 52 bits and hi*lo at most 53 — both exact.  (Masking
        # only 26 bits would leave 27-bit highs whose products need 54.)
        ai = jax.lax.bitcast_convert_type(a, jnp.int64)
        hi = jax.lax.bitcast_convert_type(
            ai & np.int64(~((1 << 27) - 1)), jnp.float64)
    else:
        ai = jax.lax.bitcast_convert_type(a, jnp.int32)
        hi = jax.lax.bitcast_convert_type(
            ai & np.int32(~((1 << 12) - 1)), jnp.float32)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Contraction-proof compensated product: p + err = a*b + O(u^2*|ab|).

    NEVER returns a bare multiply as p.  The classic form (p = a*b;
    err = (ah*bh - p) + ...) is broken by compilation: XLA duplicates the
    cheap multiply into every consumer fusion and LLVM FMA-contracts
    `p + x` there into fma(a, b, x), so consumers (fast_two_sum in
    df_mul) see a DIFFERENT p than the one returned and the EFT identity
    fails at 2^-24 (verified against the optimized HLO; neither
    lax.optimization_barrier nor --xla_allow_excess_precision=false
    stops it on the CPU backend).

    Instead: split both factors exactly by bit masking and EFT-sum the
    four half-products.  Every product here is EXACTLY representable
    (12+12 mantissa bits), so any fma(x, y, z) the compiler forms equals
    round(xy + z) = round(round(xy) + z) — contraction becomes a no-op —
    and the returned p is an fadd result, which nothing can contract
    into a consumer."""
    ah, al = _split(a)
    bh, bl = _split(b)
    q1 = ah * bh            # each exact in f32
    q2 = ah * bl
    q3 = al * bh
    q4 = al * bl
    s, e1 = two_sum(q2, q3)
    p, e2 = two_sum(q1, s)
    err = e1 + e2 + q4      # O(u)-small terms; rounding costs O(u^2*|ab|)
    return p, err


# ---------------------------------------------------------------------------
# df numbers: pairs (hi, lo) of equal-shape f32 arrays
# ---------------------------------------------------------------------------

def df_from_f64(x) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Split host float64 data into (hi, lo) float32 pairs."""
    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return jnp.asarray(hi), jnp.asarray(lo)


def df_to_f64(hi, lo) -> np.ndarray:
    return np.asarray(hi, dtype=np.float64) + np.asarray(lo, dtype=np.float64)


def df_add(xh, xl, yh, yl):
    sh, se = two_sum(xh, yh)
    te = se + (xl + yl)
    return fast_two_sum(sh, te)


def df_neg(xh, xl):
    return -xh, -xl


def df_sub(xh, xl, yh, yl):
    return df_add(xh, xl, -yh, -yl)


def df_mul(xh, xl, yh, yl):
    ph, pe = two_prod(xh, yh)
    pe = pe + (xh * yl + xl * yh)
    return fast_two_sum(ph, pe)


def df_scale(xh, xl, s):
    """Multiply by an exact f32 scalar."""
    ph, pe = two_prod(xh, s)
    pe = pe + xl * s
    return fast_two_sum(ph, pe)


def df_reduce_sum(xh, xl, axis: int):
    """Pairwise-tree sum along one axis in df precision."""
    n = xh.shape[axis]
    # pad to a power of two with zeros
    p = 1
    while p < n:
        p *= 2
    if p != n:
        pad = [(0, 0)] * xh.ndim
        pad[axis] = (0, p - n)
        xh = jnp.pad(xh, pad)
        xl = jnp.pad(xl, pad)
    while xh.shape[axis] > 1:
        m = xh.shape[axis] // 2
        a_h = jax.lax.slice_in_dim(xh, 0, m, axis=axis)
        b_h = jax.lax.slice_in_dim(xh, m, 2 * m, axis=axis)
        a_l = jax.lax.slice_in_dim(xl, 0, m, axis=axis)
        b_l = jax.lax.slice_in_dim(xl, m, 2 * m, axis=axis)
        xh, xl = df_add(a_h, a_l, b_h, b_l)
    return jnp.squeeze(xh, axis), jnp.squeeze(xl, axis)


def df_matvec(Ah, Al, xh, xl):
    """df matrix (m,k) @ df vector (k,) -> df (m,)."""
    ph, pl = df_mul(Ah, Al, xh[None, :], xl[None, :])
    return df_reduce_sum(ph, pl, axis=1)


# above this broadcast size (m*k*n elements) the Ozaki split-GEMM path
# (ops/ozaki.py: exact bf16 slice GEMMs, ~4e-15 max rel err vs this path's
# ~5e-16) replaces the O(m*k*n) broadcast
OZAKI_MATMUL_THRESHOLD = 1 << 21


def df_matmul(Ah, Al, Bh, Bl, block_k: int = 0):
    """df (m,k) @ df (k,n) -> df (m,n).

    Small problems: broadcast products + pairwise tree sum (O(m*k*n)
    memory, best accuracy).  Large problems: Ozaki split GEMM."""
    m, k = Ah.shape
    n = Bh.shape[1]
    # Ozaki wins when the contraction is GEMM-shaped; for skinny k its
    # fixed overhead (splits + 14 kernel dispatches) loses to the
    # broadcast tree (the skinny contractions of the df ALS half-sweep)
    if (m * k * n >= OZAKI_MATMUL_THRESHOLD and k >= 128
            and Ah.dtype == jnp.float32):
        from .ozaki import ozaki_matmul
        return ozaki_matmul(Ah, Al, Bh, Bl)
    ph, pl = df_mul(Ah[:, :, None], Al[:, :, None], Bh[None, :, :],
                    Bl[None, :, :])
    return df_reduce_sum(ph, pl, axis=1)


def df_contract_last_first(Ah, Al, Bh, Bl):
    """Contract last axis of A with first axis of B (general tensordot-1)."""
    ash = Ah.shape
    bsh = Bh.shape
    k = ash[-1]
    a2h = Ah.reshape(-1, k)
    a2l = Al.reshape(-1, k)
    b2h = Bh.reshape(k, -1)
    b2l = Bl.reshape(k, -1)
    oh, ol = df_matmul(a2h, a2l, b2h, b2l)
    out_shape = ash[:-1] + bsh[1:]
    return oh.reshape(out_shape), ol.reshape(out_shape)


# ---------------------------------------------------------------------------
# Refined linear solve: f32 Cholesky + df iterative refinement
# ---------------------------------------------------------------------------

def df_solve_spd_refined(Ah, Al, bh, bl, iterations: int = 3):
    """Solve A x = b (SPD) to ~df accuracy: factorize hi in f32, then
    refine with df residuals.  Converges when kappa(A) * 2^-24 < 1.

    The Cholesky factor is only a PRECONDITIONER — its accuracy does not
    limit the final residual (the df refinement corrects it), so it runs
    at DEFAULT matmul precision even when the surrounding kernel traces
    under HIGHEST (jit_f32)."""
    with jax.default_matmul_precision("default"):
        cf = jax.scipy.linalg.cho_factor(Ah)

    def body(_, x):
        xh, xl = x
        # r = b - A x  in df
        axh, axl = df_matvec(Ah, Al, xh, xl)
        rh, rl = df_sub(bh, bl, axh, axl)
        # correction in f32 from the hi residual
        with jax.default_matmul_precision("default"):
            d = jax.scipy.linalg.cho_solve(cf, rh + rl)
        return df_add(xh, xl, d, jnp.zeros_like(d))

    with jax.default_matmul_precision("default"):
        x0 = jax.scipy.linalg.cho_solve(cf, bh)
    x = (x0, jnp.zeros_like(x0))
    return jax.lax.fori_loop(0, iterations, body, x)
