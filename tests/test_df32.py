"""Double-word float32 arithmetic tests (accuracy vs float64)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import xerus_tpu  # configures x64 for the f64 references
from xerus_tpu.ops import df32
from xerus_tpu.ops.df32 import df_from_f64, df_to_f64


def _rand(shape, seed=0, scale=1.0):
    rng = np.random.Generator(np.random.PCG64(seed))
    return rng.normal(size=shape) * scale


def test_two_sum_exact():
    a = jnp.asarray(np.float32(1.0))
    b = jnp.asarray(np.float32(1e-8))
    s, e = df32.two_sum(a, b)
    assert float(s) + float(e) == pytest.approx(1.0 + 1e-8, abs=0)
    assert float(e) != 0.0  # the error term captures the lost bits


def test_two_prod_accuracy():
    rng = np.random.Generator(np.random.PCG64(1))
    a = jnp.asarray(rng.normal(size=100).astype(np.float32))
    b = jnp.asarray(rng.normal(size=100).astype(np.float32))
    p, e = df32.two_prod(a, b)
    exact = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    got = np.asarray(p, np.float64) + np.asarray(e, np.float64)
    # the contraction-proof formulation is u^2-accurate, not error-free
    # (see two_prod docstring); 2^-45 |ab| covers the e1+e2+q4 rounding
    assert np.max(np.abs(got - exact) / np.abs(exact)) < 2.0 ** -45


def test_df_mul_jit_matches_eager():
    """Regression: compiled df_mul must keep df accuracy.

    XLA duplicates cheap multiplies into consumer fusions and LLVM
    FMA-contracts `p + x` there; with the classic Veltkamp two_prod this
    silently degraded jitted df_mul to f32 accuracy (~2e-8) while eager
    stayed at 1e-15 — the exact failure seen in tt_round_df.  Guards the
    contraction-proof two_prod formulation."""
    rng = np.random.Generator(np.random.PCG64(7))
    x = rng.normal(size=(64, 8))
    y = rng.normal(size=8)
    xh, xl = df32.df_from_f64(x)
    yh, yl = df32.df_from_f64(y)

    def f(xh, xl, yh, yl):
        return df32.df_mul(xh, xl, yh[None, :], yl[None, :])

    for fn in (f, jax.jit(f)):
        zh, zl = fn(xh, xl, yh, yl)
        err = np.max(np.abs(df32.df_to_f64(zh, zl) - x * y)
                     / np.maximum(np.abs(x * y), 1e-30))
        assert err < 1e-13


def test_df_roundtrip():
    x = _rand((50,), 2)
    hi, lo = df32.df_from_f64(x)
    back = df32.df_to_f64(hi, lo)
    assert np.max(np.abs(back - x)) < 1e-14


def test_df_add_mul_accuracy():
    x = _rand((1000,), 3)
    y = _rand((1000,), 4)
    xh, xl = df32.df_from_f64(x)
    yh, yl = df32.df_from_f64(y)
    sh, sl = df32.df_add(xh, xl, yh, yl)
    assert np.max(np.abs(df32.df_to_f64(sh, sl) - (x + y))) < 1e-13
    ph, pl = df32.df_mul(xh, xl, yh, yl)
    assert np.max(np.abs(df32.df_to_f64(ph, pl) - (x * y))
                  / np.maximum(np.abs(x * y), 1e-30)) < 1e-13


def test_df_reduce_sum_beats_f32():
    x = _rand((4097,), 5)
    xh, xl = df32.df_from_f64(x)
    sh, sl = df32.df_reduce_sum(xh, xl, 0)
    exact = np.sum(x)
    df_err = abs(float(df32.df_to_f64(sh, sl)) - exact)
    f32_err = abs(float(np.sum(x.astype(np.float32))) - exact)
    assert df_err < 1e-11
    assert df_err < f32_err / 10


def test_df_matvec_accuracy():
    A = _rand((200, 300), 6)
    x = _rand((300,), 7)
    Ah, Al = df32.df_from_f64(A)
    xh, xl = df32.df_from_f64(x)
    yh, yl = df32.df_matvec(Ah, Al, xh, xl)
    exact = A @ x
    rel = np.linalg.norm(df32.df_to_f64(yh, yl) - exact) / np.linalg.norm(exact)
    assert rel < 1e-12


def test_df_matmul_accuracy():
    A = _rand((60, 80), 8)
    B = _rand((80, 40), 9)
    Ah, Al = df32.df_from_f64(A)
    Bh, Bl = df32.df_from_f64(B)
    Ch, Cl = df32.df_matmul(Ah, Al, Bh, Bl)
    exact = A @ B
    rel = np.linalg.norm(df32.df_to_f64(Ch, Cl) - exact) / np.linalg.norm(exact)
    assert rel < 1e-12


def test_refined_spd_solve_hits_1e10():
    """f32 Cholesky + df refinement must reach ~1e-12 relative residual on a
    moderately conditioned SPD system — the accuracy the f32-only solve
    cannot reach (~1e-6)."""
    n = 300
    g = _rand((n, n), 10)
    A = g @ g.T + n * np.eye(n)
    b = _rand((n,), 11)
    Ah, Al = df32.df_from_f64(A)
    bh, bl = df32.df_from_f64(b)
    xh, xl = df32.df_solve_spd_refined(Ah, Al, bh, bl, iterations=3)
    x = df32.df_to_f64(xh, xl)
    resid = np.linalg.norm(A @ x - b) / np.linalg.norm(b)
    assert resid < 1e-10
    # f32-only baseline for contrast
    x32 = np.linalg.solve(A.astype(np.float32), b.astype(np.float32))
    resid32 = np.linalg.norm(A @ x32.astype(np.float64) - b) / np.linalg.norm(b)
    assert resid < resid32 / 100


@pytest.mark.parametrize("shape", [(128, 256), (130, 190)])
def test_df_matvec_matches_f64(shape):
    """df matvec against the numpy f64 product, aligned and unaligned."""
    A = _rand(shape, 20)
    x = _rand((shape[1],), 21)
    Ah, Al = df32.df_from_f64(A)
    xh, xl = df32.df_from_f64(x)
    oh, ol = jax.jit(df32.df_matvec)(Ah, Al, xh, xl)
    exact = A @ x
    rel = np.linalg.norm(df32.df_to_f64(oh, ol) - exact) / np.linalg.norm(exact)
    assert rel < 1e-12


def test_refined_spd_solve_large_system():
    """df_solve_spd_refined on a 1100x1100 system (above 2^20 entries, the
    size of the ALS local systems at rank 30) against numpy f64."""
    n = 1100
    g = _rand((n, n), 12) / np.sqrt(n)
    A = g @ g.T + np.eye(n)
    b = _rand((n,), 13)
    Ah, Al = df32.df_from_f64(A)
    bh, bl = df32.df_from_f64(b)
    xh, xl = jax.jit(df32.df_solve_spd_refined)(Ah, Al, bh, bl)
    x = df32.df_to_f64(xh, xl)
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-10
    assert (np.linalg.norm(x - np.linalg.solve(A, b))
            / np.linalg.norm(x)) < 1e-9


def test_ozaki_matmul_df_accuracy():
    """Ozaki split GEMM (ops/ozaki.py) must deliver df-quality products
    including under wild per-row dynamic range (stresses the per-row
    sigma extraction)."""
    from xerus_tpu.ops.ozaki import ozaki_matmul, ozaki_matmul_f32
    rng = np.random.default_rng(3)
    for (m, k, n) in [(64, 64, 64), (96, 300, 80)]:
        A64 = rng.normal(size=(m, k)) * np.exp2(
            rng.integers(-20, 20, size=(m, 1)).astype(float))
        B64 = rng.normal(size=(k, n))
        Ah, Al = df_from_f64(A64)
        Bh, Bl = df_from_f64(B64)
        Ch, Cl = jax.jit(ozaki_matmul)(Ah, Al, Bh, Bl)
        ref = A64 @ B64
        scale = (np.abs(A64) @ np.abs(B64)).max()
        err = np.abs(df_to_f64(np.asarray(Ch), np.asarray(Cl)) - ref).max()
        assert err / scale < 1e-13
    # f32-input convenience wrapper
    A32 = rng.normal(size=(50, 70)).astype(np.float32)
    B32 = rng.normal(size=(70, 40)).astype(np.float32)
    Ch, Cl = jax.jit(ozaki_matmul_f32)(jnp.asarray(A32), jnp.asarray(B32))
    ref = A32.astype(np.float64) @ B32.astype(np.float64)
    err = np.abs(df_to_f64(np.asarray(Ch), np.asarray(Cl)) - ref).max()
    assert err / np.abs(ref).max() < 1e-12


def test_df_matmul_ozaki_dispatch_consistent():
    """The size-gated Ozaki dispatch inside df_matmul must agree with the
    broadcast path to df accuracy."""
    from xerus_tpu.ops import df32 as m
    rng = np.random.default_rng(4)
    A64 = rng.normal(size=(128, 200))
    B64 = rng.normal(size=(200, 128))
    Ah, Al = df_from_f64(A64)
    Bh, Bl = df_from_f64(B64)
    old = m.OZAKI_MATMUL_THRESHOLD
    try:
        m.OZAKI_MATMUL_THRESHOLD = 1            # force ozaki
        Ch, Cl = m.df_matmul(Ah, Al, Bh, Bl)
        m.OZAKI_MATMUL_THRESHOLD = 1 << 60      # force broadcast
        Dh, Dl = m.df_matmul(Ah, Al, Bh, Bl)
    finally:
        m.OZAKI_MATMUL_THRESHOLD = old
    a = df_to_f64(np.asarray(Ch), np.asarray(Cl))
    b = df_to_f64(np.asarray(Dh), np.asarray(Dl))
    assert np.abs(a - b).max() / np.abs(b).max() < 1e-13


def _spd(n, kappa, seed=7):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = np.logspace(0, -np.log10(kappa), n)
    return (Q * lam) @ Q.T


def test_df_cholesky_factorization_residual():
    """Blocked df Cholesky (ops/df_cholesky.py) reaches df-level
    factorization residuals far past the f32 kappa ~ 2^24 wall."""
    from xerus_tpu.ops.df_cholesky import df_cholesky
    for n, kappa in [(96, 1e4), (128, 1e12)]:
        A = _spd(n, kappa)
        Ah, Al = df_from_f64(A)
        Lh, Ll = df_cholesky(jnp.asarray(Ah), jnp.asarray(Al))
        L = df_to_f64(np.asarray(Lh), np.asarray(Ll))
        res = np.linalg.norm(L @ L.T - A) / np.linalg.norm(A)
        assert res < 1e-12, (n, kappa, res)


def test_df_solve_spd_chol_beyond_f32_wall():
    """At kappa=1e10 the plain f32 factorization NaNs (negative pivots);
    the df-Cholesky solve still reaches ~df residuals."""
    from xerus_tpu.ops.df_cholesky import df_solve_spd_chol
    rng = np.random.default_rng(3)
    n, kappa = 128, 1e10
    A = _spd(n, kappa)
    x_true = rng.normal(size=n)
    b = A @ x_true
    Ah, Al = df_from_f64(A)
    bh, bl = df_from_f64(b)
    xh, xl = df_solve_spd_chol(jnp.asarray(Ah), jnp.asarray(Al),
                               jnp.asarray(bh), jnp.asarray(bl))
    x = df_to_f64(np.asarray(xh), np.asarray(xl))
    res = np.linalg.norm(A @ x - b) / np.linalg.norm(b)
    assert res < 1e-10, res
    # the old path really does fail here
    oh, ol = df32.df_solve_spd_refined(jnp.asarray(Ah), jnp.asarray(Al),
                                       jnp.asarray(bh), jnp.asarray(bl))
    assert not np.isfinite(df_to_f64(np.asarray(oh), np.asarray(ol))).all()


def test_df_cholesky_nondivisible_block():
    """n not a multiple of the block size exercises the identity-tail
    padding path."""
    from xerus_tpu.ops.df_cholesky import df_cholesky
    A = _spd(100, 1e6)
    Ah, Al = df_from_f64(A)
    Lh, Ll = df_cholesky(jnp.asarray(Ah), jnp.asarray(Al), block=64)
    L = df_to_f64(np.asarray(Lh), np.asarray(Ll))
    assert L.shape == (100, 100)
    assert np.linalg.norm(L @ L.T - A) / np.linalg.norm(A) < 1e-12


def test_df_eigh_f64_quality():
    """df symmetric eigendecomposition (ops/df_eigh.py): f32 eigh + Ogita-
    Aishima refinement with Ozaki GEMMs reaches ~1e-14 eigenvalues and
    residuals across wide spectra (f32 alone: ~5e-8)."""
    from xerus_tpu.ops.df_eigh import df_eigh
    rng = np.random.default_rng(1)
    for n, spread in [(64, 1.0), (128, 4.0)]:
        Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        lam_true = np.sort(rng.uniform(-1, 1, size=n)) * 10 ** spread
        A = (Q * lam_true) @ Q.T
        Ah, Al = df_from_f64(A)
        wh, wl, Vh, Vl = df_eigh(jnp.asarray(Ah), jnp.asarray(Al))
        w = df_to_f64(np.asarray(wh), np.asarray(wl))
        V = df_to_f64(np.asarray(Vh), np.asarray(Vl))
        scale = np.abs(lam_true).max()
        assert np.abs(np.sort(w) - lam_true).max() / scale < 1e-12
        assert (np.linalg.norm(A @ V - V * w[None, :])
                / np.linalg.norm(A)) < 1e-10
        assert np.linalg.norm(V.T @ V - np.eye(n)) < 1e-8


def test_df_eigh_degenerate_cluster():
    """Exactly repeated eigenvalues: the cluster branch keeps V orthonormal
    and the residual at df level (any orthonormal cluster basis is valid)."""
    from xerus_tpu.ops.df_eigh import df_eigh
    rng = np.random.default_rng(5)
    n = 48
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = np.concatenate([np.full(8, 2.0), np.linspace(3, 50, n - 8)])
    A = (Q * lam) @ Q.T
    Ah, Al = df_from_f64(A)
    wh, wl, Vh, Vl = df_eigh(jnp.asarray(Ah), jnp.asarray(Al))
    w = df_to_f64(np.asarray(wh), np.asarray(wl))
    V = df_to_f64(np.asarray(Vh), np.asarray(Vl))
    assert np.abs(np.sort(w) - np.sort(lam)).max() / 50 < 1e-12
    assert np.linalg.norm(A @ V - V * w[None, :]) / np.linalg.norm(A) < 1e-10
    assert np.linalg.norm(V.T @ V - np.eye(n)) < 1e-8


def test_df_svd_separated_spectrum():
    """Gram-route df SVD (ops/df_eigh.py df_svd): separated singular
    values come back df-accurate relative to sigma_max (f32: ~3e-8)."""
    from xerus_tpu.ops.df_eigh import df_svd
    rng = np.random.default_rng(2)
    for m, n, spread in [(96, 64, 2.0), (256, 128, 3.0)]:
        U0, _ = np.linalg.qr(rng.normal(size=(m, n)))
        V0, _ = np.linalg.qr(rng.normal(size=(n, n)))
        s_true = np.linspace(1.0, 10.0 ** -spread, n)
        A = (U0 * s_true) @ V0.T
        Ah, Al = df_from_f64(A)
        Uh, Ul, sh, sl, Vh, Vl = df_svd(jnp.asarray(Ah), jnp.asarray(Al))
        s = df_to_f64(np.asarray(sh), np.asarray(sl))
        U = df_to_f64(np.asarray(Uh), np.asarray(Ul))
        V = df_to_f64(np.asarray(Vh), np.asarray(Vl))
        assert np.abs(s - s_true).max() < 1e-11
        rec = (U * s) @ V.T
        assert np.linalg.norm(rec - A) / np.linalg.norm(A) < 1e-11
        assert np.linalg.norm(V.T @ V - np.eye(n)) < 1e-8


def test_df_svd_clustered_tail_degrades_gracefully():
    """Outside the contract (log-uniform clustered tail) the result stays
    finite and bounded — cluster-width sigma resolution, no blowup."""
    from xerus_tpu.ops.df_eigh import df_svd
    rng = np.random.default_rng(4)
    m, n = 128, 64
    U0, _ = np.linalg.qr(rng.normal(size=(m, n)))
    V0, _ = np.linalg.qr(rng.normal(size=(n, n)))
    s_true = np.sort(10 ** rng.uniform(-4, 0, size=n))[::-1]
    A = (U0 * s_true) @ V0.T
    Ah, Al = df_from_f64(A)
    Uh, Ul, sh, sl, Vh, Vl = df_svd(jnp.asarray(Ah), jnp.asarray(Al))
    s = df_to_f64(np.asarray(sh), np.asarray(sl))
    U = df_to_f64(np.asarray(Uh), np.asarray(Ul))
    V = df_to_f64(np.asarray(Vh), np.asarray(Vl))
    assert np.isfinite(U).all() and np.isfinite(V).all()
    rec = (U * s) @ V.T
    assert np.linalg.norm(rec - A) / np.linalg.norm(A) < 1e-2
    # the DOMINANT spectrum is still df-accurate
    assert np.abs(s[:16] - s_true[:16]).max() < 1e-11


def test_df_svd_jw_small_sigma_accuracy():
    """Jordan-Wielandt df SVD (df_svd_jw): small singular values come
    back with ~1e-8 * sigma_max ABSOLUTE accuracy (the Gram route's
    documented floor there is ~2e-5 * sigma_max); dominant spectrum is
    df-accurate; live blocks stay orthonormal to the measured contract."""
    from xerus_tpu.ops.df_eigh import df_svd, df_svd_jw
    rng = np.random.default_rng(7)
    m, n = 48, 40
    s_true = np.logspace(0, -12, n)
    U0, _ = np.linalg.qr(rng.normal(size=(m, n)))
    V0, _ = np.linalg.qr(rng.normal(size=(n, n)))
    A = (U0 * s_true) @ V0.T
    Ah, Al = df_from_f64(A)
    Uh, Ul, sh, sl, Vh, Vl = df_svd_jw(jnp.asarray(Ah), jnp.asarray(Al))
    s = df_to_f64(np.asarray(sh), np.asarray(sl))
    U = df_to_f64(np.asarray(Uh), np.asarray(Ul))
    V = df_to_f64(np.asarray(Vh), np.asarray(Vl))
    # absolute sigma accuracy across the WHOLE spectrum
    assert np.abs(s - s_true).max() < 5e-8
    # dominant spectrum df-accurate
    assert np.abs(s[:12] - s_true[:12]).max() < 1e-11
    # the Gram route misses small sigmas by orders of magnitude more
    _, _, gh, gl, _, _ = df_svd(jnp.asarray(Ah), jnp.asarray(Al))
    g = df_to_f64(np.asarray(gh), np.asarray(gl))
    k = 25                              # sigma ~ 1e-8
    assert np.abs(s[k] - s_true[k]) < 1e-2 * np.abs(g[k] - s_true[k])
    # vector contract: orthonormal blocks for sigma >= 1e-6 * sigma_max
    live = s > 1e-6 * s.max()
    Ulive = U[:, live]
    Vlive = V[:, live]
    assert np.linalg.norm(Ulive.T @ Ulive - np.eye(live.sum()), ord=2) < 5e-3
    assert np.linalg.norm(Vlive.T @ Vlive - np.eye(live.sum()), ord=2) < 5e-3
    # reconstruction on the live part
    rec = (U * s) @ V.T
    assert np.linalg.norm(rec - A) / np.linalg.norm(A) < 1e-6


@pytest.mark.slow
def test_tt_round_df_matches_f64_oracle():
    """Double-word TT rounding (ops/df_rounding.py): matches the f64
    object-level round() and resolves eps thresholds invisible to f32."""
    from xerus_tpu.ops.df_rounding import tt_round_df_from_f64
    from xerus_tpu import TTTensor
    import xerus_tpu as xe_

    def dense(cs):
        out = np.asarray(cs[0])
        for c in cs[1:]:
            out = np.tensordot(out, np.asarray(c), axes=([out.ndim - 1], [0]))
        return out.squeeze()

    xe_.set_seed(11)
    a = TTTensor.random([3] * 7, 3); a /= a.frob_norm()
    b = TTTensor.random([3] * 7, 3); b /= b.frob_norm()
    t = a + 1e-9 * b
    cores64 = [np.asarray(c.to_ndarray()) for c in t.components]
    t2 = TTTensor._make([xe_.Tensor.from_ndarray(c.copy()) for c in cores64])
    t2.round(3)
    oracle = dense([np.asarray(c.to_ndarray()) for c in t2.components])
    got = dense(tt_round_df_from_f64(cores64, 3))
    assert np.linalg.norm(got - oracle) / np.linalg.norm(oracle) < 1e-11
    # eps=1e-7 must drop the 1e-9 tail (below f32 resolution entirely)
    out2 = tt_round_df_from_f64(cores64, 6, eps=1e-7)
    assert max(c.shape[0] for c in out2[1:]) == 3
    exact = dense(cores64)
    assert np.linalg.norm(dense(out2) - exact) < 1e-8
