"""Mixed-precision (double-word f32) ALS tests: f64-quality residuals with
no float64 compute."""

import numpy as np
import pytest
import jax.numpy as jnp

import xerus_tpu as xe
from xerus_tpu import TTTensor
from xerus_tpu.examples import laplace_operator
from xerus_tpu.ops.mixed_precision import als_spd_mixed, df_qr, df_tensordot
from xerus_tpu.ops.df32 import df_from_f64, df_to_f64


def test_df_qr_orthogonality_and_reconstruction():
    rng = np.random.Generator(np.random.PCG64(1))
    a = rng.normal(size=(40, 8))
    ah, al = df_from_f64(a)
    (qh, ql), (rh, rl) = df_qr(ah, al)
    Q = df_to_f64(qh, ql)
    R = df_to_f64(rh, rl)
    assert np.max(np.abs(Q.T @ Q - np.eye(8))) < 1e-13
    assert np.max(np.abs(Q @ R - a)) < 1e-12
    assert np.max(np.abs(np.tril(R, -1))) < 1e-13


def test_df_qr_rank_deficient():
    rng = np.random.Generator(np.random.PCG64(2))
    base = rng.normal(size=(20, 2))
    a = np.concatenate([base, base[:, :1] * 2.0, base], axis=1)  # rank 2
    ah, al = df_from_f64(a)
    (qh, ql), (rh, rl) = df_qr(ah, al)
    Q = df_to_f64(qh, ql)
    R = df_to_f64(rh, rl)
    # frame stays orthonormal despite deficiency; reconstruction exact
    assert np.max(np.abs(Q.T @ Q - np.eye(5))) < 1e-12
    assert np.max(np.abs(Q @ R - a)) < 1e-12


def test_df_tensordot_matches_f64():
    rng = np.random.Generator(np.random.PCG64(3))
    a = rng.normal(size=(4, 5, 6))
    b = rng.normal(size=(6, 5, 3))
    out = df_tensordot(df_from_f64(a), df_from_f64(b), axes=([2, 1], [0, 1]))
    ref = np.tensordot(a, b, axes=([2, 1], [0, 1]))
    got = df_to_f64(*out)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-13


@pytest.mark.slow
def test_mixed_als_reaches_f64_quality():
    """The flagship claim: 1e-12-level residual with zero f64 arithmetic
    (float64 here is only used to build inputs and VERIFY the result)."""
    d = 6
    A = laplace_operator([2] * d)
    b = TTTensor.ones([2] * d)
    b /= b.frob_norm()
    x = TTTensor.random([2] * d, 6)
    cores = als_spd_mixed(A, x, b, num_half_sweeps=4)
    xt = TTTensor._make([xe.Tensor.from_ndarray(c) for c in cores])
    Am = A.to_tensor().to_ndarray().reshape(2 ** d, 2 ** d)
    xv = xt.to_tensor().to_ndarray().reshape(-1)
    bv = b.to_tensor().to_ndarray().reshape(-1)
    resid = np.linalg.norm(Am @ xv - bv) / np.linalg.norm(bv)
    assert resid < 1e-12


@pytest.mark.slow
def test_fused_f32_df_run_reaches_f64_floor():
    """make_als_f32_df_run: the WHOLE mixed-precision solve (f32
    while_loop to the plateau + in-program df seed + df finish) as one
    program must reach the f64-quality floor, stop the f32 phase only on
    even sweep counts (the df phase needs the core at site 0), and report
    the f32 residual history."""
    import jax.numpy as jnp
    import xerus_tpu as xe
    from xerus_tpu.examples import laplace_operator
    from xerus_tpu.ops.mixed_precision import (make_als_f32_df_run,
                                               df_from_f64, df_to_f64)
    from xerus_tpu.core.tensor import Tensor
    from xerus_tpu.tt.ttnetwork import TTTensor, apply_operator

    xe.set_seed(0xBAADF00D + 3)
    dims = [2] * 8
    Aop = laplace_operator(dims)
    b = TTTensor.ones(dims)
    x0 = TTTensor.random(dims, 5)
    x0.move_core(0)
    f32 = lambda cs: tuple(jnp.asarray(np.asarray(c.to_ndarray(),
                                                  np.float32)) for c in cs)
    x32, A32, b32 = (f32(x0.components), f32(Aop.components),
                     f32(b.components))
    A_df = tuple(df_from_f64(np.asarray(c.to_ndarray(), np.float64))
                 for c in Aop.components)
    b_df = tuple(df_from_f64(np.asarray(c.to_ndarray(), np.float64))
                 for c in b.components)
    fn = make_als_f32_df_run(tuple(tuple(c.shape) for c in x32),
                             "float32", 12, 2)
    out, hist, cnt = fn(x32, A32, b32, A_df, b_df)
    cnt = int(cnt)
    assert cnt % 2 == 0 and 0 < cnt <= 12
    assert all(np.isfinite(v) for v in np.asarray(hist)[:cnt])
    out64 = [df_to_f64(np.asarray(h), np.asarray(l)) for (h, l) in out]
    xx = TTTensor._make([Tensor.from_ndarray(c) for c in out64])
    res = float((apply_operator(Aop, xx) - b).frob_norm() / b.frob_norm())
    assert res < 1e-12, res


@pytest.mark.slow
def test_fused_f32_df_run_odd_cap_stays_finite():
    """An ODD max_f32_sweeps cap must not leave the core at site d-1 when
    the f32 loop exits at the cap — the df phase assumes the core at 0
    and returned silent NaNs (the effective cap rounds down to even)."""
    import jax.numpy as jnp
    import xerus_tpu as xe
    from xerus_tpu.examples import laplace_operator
    from xerus_tpu.ops.mixed_precision import (make_als_f32_df_run,
                                               df_from_f64, df_to_f64)

    xe.set_seed(3)
    dims = [2] * 6
    Aop = laplace_operator(dims)
    from xerus_tpu.tt.ttnetwork import TTTensor
    b = TTTensor.ones(dims)
    x0 = TTTensor.random(dims, 3)
    x0.move_core(0)
    f32 = lambda cs: tuple(jnp.asarray(np.asarray(c.to_ndarray(),
                                                  np.float32)) for c in cs)
    x32, A32, b32 = (f32(x0.components), f32(Aop.components),
                     f32(b.components))
    A_df = tuple(df_from_f64(np.asarray(c.to_ndarray(), np.float64))
                 for c in Aop.components)
    b_df = tuple(df_from_f64(np.asarray(c.to_ndarray(), np.float64))
                 for c in b.components)
    for cap in (1, 3):
        fn = make_als_f32_df_run(tuple(tuple(c.shape) for c in x32),
                                 "float32", cap, 2)
        out, hist, cnt = fn(x32, A32, b32, A_df, b_df)
        assert int(cnt) % 2 == 0
        for h, l in out:
            assert bool(jnp.all(jnp.isfinite(h))), f"NaN at cap={cap}"
