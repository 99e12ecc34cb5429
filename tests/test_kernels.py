"""Jitted hot-path kernels vs the object layer (consistency oracles)."""

import numpy as np
import pytest
import jax.numpy as jnp

import xerus_tpu as xe
from xerus_tpu import TTTensor
from xerus_tpu.ops.tt_kernels import tt_round_sweep, round_flops, _als_half_sweep


def test_round_sweep_matches_object_layer():
    tt = TTTensor.random([3] * 6, 8)
    target = 4
    cores = [c.to_jax() for c in tt.components]
    out = tt_round_sweep(cores, target)
    fast = TTTensor._make([xe.Tensor.from_jax(c) for c in out])
    obj = tt.copy()
    obj.round(target)
    # both are quasi-best rank-4 approximations; norms of difference to the
    # original must agree closely
    orig = tt.to_tensor().to_ndarray()
    err_fast = np.linalg.norm(fast.to_tensor().to_ndarray() - orig)
    err_obj = np.linalg.norm(obj.to_tensor().to_ndarray() - orig)
    assert np.isclose(err_fast, err_obj, rtol=1e-8)


def test_round_sweep_exact_when_rank_sufficient():
    tt = TTTensor.random([2] * 8, 4)
    cores = [c.to_jax() for c in tt.components]
    out = tt_round_sweep(cores, 8)  # target above actual rank: exact
    fast = TTTensor._make([xe.Tensor.from_jax(c) for c in out])
    assert np.allclose(fast.to_tensor().to_ndarray(),
                       tt.to_tensor().to_ndarray(), atol=1e-10)


def test_round_flops_positive_and_scales():
    shapes_small = [(1, 2, 4)] + [(4, 2, 4)] * 4 + [(4, 2, 1)]
    shapes_big = [(1, 2, 8)] + [(8, 2, 8)] * 4 + [(8, 2, 1)]
    f_small = round_flops(shapes_small, 2)
    f_big = round_flops(shapes_big, 4)
    assert 0 < f_small < f_big


def test_als_half_sweep_reduces_residual():
    from xerus_tpu.examples import laplace_operator
    dims = [2] * 6
    A = laplace_operator(dims)
    b = TTTensor.ones(dims)
    x = TTTensor.random(dims, 4)
    x.canonicalize_left()
    x_cores = tuple(c.to_jax() for c in x.components)
    A_cores = tuple(c.to_jax() for c in A.components)
    b_cores = tuple(c.to_jax() for c in b.components)
    out = _als_half_sweep(x_cores, A_cores, b_cores)
    new_x = TTTensor._make([xe.Tensor.from_jax(c) for c in out])
    A_mat = A.to_tensor().to_ndarray().reshape(64, 64)
    b_vec = np.ones(64)
    start = np.linalg.norm(A_mat @ x.to_tensor().to_ndarray().reshape(-1) - b_vec)
    end = np.linalg.norm(A_mat @ new_x.to_tensor().to_ndarray().reshape(-1) - b_vec)
    assert end < 0.1 * start


def test_scan_round_matches_unrolled():
    from xerus_tpu.ops.tt_kernels import tt_round_sweep_uniform
    tt = TTTensor.random([2] * 10, 8)
    cores = [c.to_jax() for c in tt.components]
    orig = tt.to_tensor().to_ndarray()
    det = tt_round_sweep(cores, 4)
    uni = tt_round_sweep_uniform(cores, 4)
    det_tt = TTTensor._make([xe.Tensor.from_jax(c) for c in det])
    uni_tt = TTTensor._make([xe.Tensor.from_jax(c) for c in uni])
    uni_tt.require_correct_format()
    err_det = np.linalg.norm(det_tt.to_tensor().to_ndarray() - orig)
    err_uni = np.linalg.norm(uni_tt.to_tensor().to_ndarray() - orig)
    assert np.isclose(err_det, err_uni, rtol=1e-8)


def test_scan_round_exact_when_rank_sufficient():
    from xerus_tpu.ops.tt_kernels import tt_round_sweep_uniform
    tt = TTTensor.random([2] * 8, 4)
    cores = [c.to_jax() for c in tt.components]
    out = tt_round_sweep_uniform(cores, 8)
    fast = TTTensor._make([xe.Tensor.from_jax(c) for c in out])
    assert np.allclose(fast.to_tensor().to_ndarray(),
                       tt.to_tensor().to_ndarray(), atol=1e-9)


def test_scan_randomized_round():
    from xerus_tpu.ops.tt_kernels import tt_round_randomized_uniform
    tt = TTTensor.random([2] * 10, 8)
    cores = [c.to_jax() for c in tt.components]
    orig = tt.to_tensor().to_ndarray()
    out = tt_round_randomized_uniform(cores, 8, oversample=4)  # rank suffices
    got = TTTensor._make([xe.Tensor.from_jax(c) for c in out])
    got.require_correct_format()
    assert np.allclose(got.to_tensor().to_ndarray(), orig, atol=1e-8)
    # truncating case: quasi-optimal (within 4x of deterministic)
    det = tt_round_sweep(cores, 4)
    err_det = np.linalg.norm(TTTensor._make(
        [xe.Tensor.from_jax(c) for c in det]).to_tensor().to_ndarray() - orig)
    rnd = tt_round_randomized_uniform(cores, 4, oversample=4)
    err_rnd = np.linalg.norm(TTTensor._make(
        [xe.Tensor.from_jax(c) for c in rnd]).to_tensor().to_ndarray() - orig)
    assert err_rnd < 4 * err_det
    # cholqr orthogonalization: same sketch, same subspace, same error
    chl = tt_round_randomized_uniform(cores, 4, oversample=4,
                                      qr_method="cholqr")
    err_chl = np.linalg.norm(TTTensor._make(
        [xe.Tensor.from_jax(c) for c in chl]).to_tensor().to_ndarray() - orig)
    assert np.isclose(err_chl, err_rnd, rtol=1e-3)


def test_gram_round_matches_svd():
    from xerus_tpu.ops.tt_kernels import tt_round_sweep_uniform
    tt = TTTensor.random([2] * 10, 8)
    cores = [c.to_jax() for c in tt.components]
    orig = tt.to_tensor().to_ndarray()
    a = tt_round_sweep_uniform(cores, 4, method="svd")
    b = tt_round_sweep_uniform(cores, 4, method="gram")
    err_a = np.linalg.norm(TTTensor._make(
        [xe.Tensor.from_jax(c) for c in a]).to_tensor().to_ndarray() - orig)
    err_b = np.linalg.norm(TTTensor._make(
        [xe.Tensor.from_jax(c) for c in b]).to_tensor().to_ndarray() - orig)
    assert np.isclose(err_a, err_b, rtol=1e-6)


def test_scan_round_eps_truncation():
    """eps-rounding in the scan kernel (data-dependent mask)."""
    from xerus_tpu.ops.tt_kernels import tt_round_sweep_uniform
    a = TTTensor.random([3] * 6, 2)
    a /= a.frob_norm()
    b = TTTensor.random([3] * 6, 2)
    b /= b.frob_norm()
    c = a + 1e-8 * b   # genuinely rank 4, two directions carry ~1e-8 mass
    assert max(c.ranks()) == 4
    cores = [x.to_jax() for x in c.components]
    out = tt_round_sweep_uniform(cores, 4, eps=1e-6)
    got = TTTensor._make([xe.Tensor.from_jax(x) for x in out])
    # values match a; eps drops the tiny directions AND trims bond ranks
    assert np.allclose(got.to_tensor().to_ndarray(),
                       a.to_tensor().to_ndarray(), atol=1e-7)
    assert got.ranks() == [2] * 5
    # eps=0 keeps everything
    out0 = tt_round_sweep_uniform(cores, 4, eps=0.0)
    g0 = TTTensor._make([xe.Tensor.from_jax(x) for x in out0])
    assert max(g0.ranks()) == 4


def test_cholqr_round_matches_svd():
    """CholeskyQR3 orthogonalization variant (GEMM-only, no Householder)
    must give the same truncation error; also exercise float32 where the
    padded Gram matrices are singular (the shifted-Cholesky path)."""
    from xerus_tpu.ops.tt_kernels import tt_round_sweep_uniform
    tt = TTTensor.random([2] * 10, 8)
    cores = [c.to_jax() for c in tt.components]
    orig = tt.to_tensor().to_ndarray()
    a = tt_round_sweep_uniform(cores, 4, method="svd")
    b = tt_round_sweep_uniform(cores, 4, method="cholqr")
    err_a = np.linalg.norm(TTTensor._make(
        [xe.Tensor.from_jax(c) for c in a]).to_tensor().to_ndarray() - orig)
    err_b = np.linalg.norm(TTTensor._make(
        [xe.Tensor.from_jax(c) for c in b]).to_tensor().to_ndarray() - orig)
    assert np.isclose(err_a, err_b, rtol=1e-6)
    # f32 with zero-padded (singular) bonds
    import jax.numpy as jnp
    cores32 = [jnp.asarray(np.asarray(c), jnp.float32) for c in cores]
    c32 = tt_round_sweep_uniform(cores32, 4, method="cholqr")
    assert all(bool(jnp.all(jnp.isfinite(c))) for c in c32)
    err_c = np.linalg.norm(TTTensor._make(
        [xe.Tensor.from_ndarray(np.asarray(c, np.float64)) for c in c32]
        ).to_tensor().to_ndarray() - orig)
    assert np.isclose(err_c, err_a, rtol=1e-3)


def test_gram_parallel_round():
    """All-bonds-at-once Gram rounding (arXiv 2011.06532): exact on
    representable ranks, quasi-optimal on truncating ranks, f32-safe on
    zero-padded (exactly singular) interface Gram matrices."""
    from xerus_tpu.ops.tt_kernels import tt_round_sweep_uniform

    # exact recovery: true rank 3 embedded in a rank-8 representation
    a = TTTensor.random([2] * 8, 3)
    a /= a.frob_norm()
    z = TTTensor.random([2] * 8, 5)
    z /= z.frob_norm()
    emb = a + 1e-9 * z
    assert max(emb.ranks()) == 8
    cores = [c.to_jax() for c in emb.components]
    out = tt_round_sweep_uniform(cores, 4, method="gram_parallel")
    got = TTTensor._make([xe.Tensor.from_jax(c) for c in out])
    got.require_correct_format()
    assert np.allclose(got.to_tensor().to_ndarray(),
                       a.to_tensor().to_ndarray(), atol=1e-8)

    # truncating case: within 1.5x of the sequential-optimal error
    tt = TTTensor.random([2] * 10, 8)
    cores = [c.to_jax() for c in tt.components]
    orig = tt.to_tensor().to_ndarray()
    sv = tt_round_sweep_uniform(cores, 4, method="svd")
    gp = tt_round_sweep_uniform(cores, 4, method="gram_parallel")
    err_s = np.linalg.norm(TTTensor._make(
        [xe.Tensor.from_jax(c) for c in sv]).to_tensor().to_ndarray() - orig)
    err_p = np.linalg.norm(TTTensor._make(
        [xe.Tensor.from_jax(c) for c in gp]).to_tensor().to_ndarray() - orig)
    assert err_p < 1.5 * err_s

    # f32 with zero-padded (singular) bonds: finite and accurate
    cores32 = [jnp.asarray(np.asarray(c), jnp.float32) for c in cores]
    p32 = tt_round_sweep_uniform(cores32, 4, method="gram_parallel")
    assert all(bool(jnp.all(jnp.isfinite(c))) for c in p32)
    err32 = np.linalg.norm(TTTensor._make(
        [xe.Tensor.from_ndarray(np.asarray(c, np.float64)) for c in p32]
        ).to_tensor().to_ndarray() - orig)
    assert err32 < 1.5 * err_s + 1e-4 * np.linalg.norm(orig)


def test_subspace_parallel_round():
    """GEMM-only all-bonds-at-once rounding (batched shifted Cholesky +
    subspace power iteration — no SVD/eigh): exact on representable
    ranks, quasi-optimal on truncating ranks, f32-safe on zero-padded
    (exactly singular) interface Gram matrices."""
    from xerus_tpu.ops.tt_kernels import tt_round_sweep_uniform

    # exact recovery: true rank 3 embedded in a rank-8 representation
    a = TTTensor.random([2] * 8, 3)
    a /= a.frob_norm()
    z = TTTensor.random([2] * 8, 5)
    z /= z.frob_norm()
    emb = a + 1e-9 * z
    cores = [c.to_jax() for c in emb.components]
    out = tt_round_sweep_uniform(cores, 4, method="subspace_parallel")
    got = TTTensor._make([xe.Tensor.from_jax(c) for c in out])
    assert np.allclose(got.to_tensor().to_ndarray(),
                       a.to_tensor().to_ndarray(), atol=1e-8)

    # truncating case: within 1.5x of the sequential-optimal error
    tt = TTTensor.random([2] * 10, 8)
    cores = [c.to_jax() for c in tt.components]
    orig = tt.to_tensor().to_ndarray()
    sv = tt_round_sweep_uniform(cores, 4, method="svd")
    sp = tt_round_sweep_uniform(cores, 4, method="subspace_parallel")
    err_s = np.linalg.norm(TTTensor._make(
        [xe.Tensor.from_jax(c) for c in sv]).to_tensor().to_ndarray() - orig)
    err_p = np.linalg.norm(TTTensor._make(
        [xe.Tensor.from_jax(c) for c in sp]).to_tensor().to_ndarray() - orig)
    assert err_p < 1.5 * err_s

    # f32 with zero-padded (singular) bonds: finite and accurate
    cores32 = [jnp.asarray(np.asarray(c), jnp.float32) for c in cores]
    p32 = tt_round_sweep_uniform(cores32, 4, method="subspace_parallel")
    assert all(bool(jnp.all(jnp.isfinite(c))) for c in p32)
    err32 = np.linalg.norm(TTTensor._make(
        [xe.Tensor.from_ndarray(np.asarray(c, np.float64)) for c in p32]
        ).to_tensor().to_ndarray() - orig)
    assert err32 < 1.5 * err_s + 1e-4 * np.linalg.norm(orig)

    # relative eps on the Rayleigh sigma estimates: the 1e-9 noise
    # direction is cut, recovering a's true rank-3 bonds
    ecores = [c.to_jax() for c in emb.components]
    oute = tt_round_sweep_uniform(ecores, 4, eps=1e-6,
                                  method="subspace_parallel")
    gote = TTTensor._make([xe.Tensor.from_jax(c) for c in oute])
    assert max(gote.ranks()) == 3
    assert np.allclose(gote.to_tensor().to_ndarray(),
                       a.to_tensor().to_ndarray(), atol=1e-7)


def test_als_half_sweep_batched_matches_serial():
    """Throughput-mode vmapped ALS half-sweep == per-instance serial sweeps."""
    import jax.numpy as jnp
    from xerus_tpu.ops.tt_kernels import als_half_sweep_batched
    from xerus_tpu.examples import laplace_operator

    dims = [2] * 6
    A = laplace_operator(dims)
    A_cores = tuple(c.to_jax() for c in A.components)
    B = 3
    xs, bs = [], []
    for _ in range(B):
        x = TTTensor.random(dims, 4)
        x.canonicalize_left()
        b = TTTensor.random(dims, 2)
        xs.append([c.to_jax() for c in x.components])
        bs.append([c.to_jax() for c in b.components])
    x_batch = [jnp.stack([xs[i][k] for i in range(B)]) for k in range(6)]
    b_batch = [jnp.stack([bs[i][k] for i in range(B)]) for k in range(6)]
    out = als_half_sweep_batched(x_batch, A_cores, b_batch)
    for i in range(B):
        serial = _als_half_sweep(tuple(xs[i]), A_cores, tuple(bs[i]))
        got = TTTensor._make([xe.Tensor.from_jax(c[i]) for c in out])
        want = TTTensor._make([xe.Tensor.from_jax(c) for c in serial])
        assert np.allclose(got.to_tensor().to_ndarray(),
                           want.to_tensor().to_ndarray(), atol=1e-10)


def test_streaming_round():
    """Two-sided-sketch (generalized Nyström) rounding: exact on
    representable ranks, quasi-optimal on truncating ranks, f32-safe."""
    from xerus_tpu.ops.tt_kernels import (tt_round_streaming_uniform,
                                          tt_round_sweep_uniform)
    a = TTTensor.random([2] * 8, 3)
    cores = [c.to_jax() for c in a.components]
    out = tt_round_streaming_uniform(cores, 6)
    got = TTTensor._make([xe.Tensor.from_jax(c) for c in out])
    got.require_correct_format()
    # carries are CholeskyQR2-orthonormalized -> cond(Z)=1, so the
    # representable-rank case reconstructs to near machine precision (f64)
    assert np.allclose(got.to_tensor().to_ndarray(),
                       a.to_tensor().to_ndarray(),
                       atol=1e-10 * float(a.frob_norm()))

    tt = TTTensor.random([2] * 10, 8)
    orig = tt.to_tensor().to_ndarray()
    cs = [c.to_jax() for c in tt.components]
    sv = tt_round_sweep_uniform(cs, 4, method="svd")
    e_s = np.linalg.norm(TTTensor._make(
        [xe.Tensor.from_jax(c) for c in sv]).to_tensor().to_ndarray() - orig)
    st = tt_round_streaming_uniform(cs, 4)
    e_t = np.linalg.norm(TTTensor._make(
        [xe.Tensor.from_jax(c) for c in st]).to_tensor().to_ndarray() - orig)
    assert e_t < 6 * e_s

    cs32 = [jnp.asarray(np.asarray(c), jnp.float32) for c in cs]
    st32 = tt_round_streaming_uniform(cs32, 4)
    assert all(bool(jnp.all(jnp.isfinite(c))) for c in st32)
    e32 = np.linalg.norm(TTTensor._make(
        [xe.Tensor.from_ndarray(np.asarray(c, np.float64)) for c in st32]
        ).to_tensor().to_ndarray() - orig)
    assert e32 < 6 * e_s + 1e-3 * np.linalg.norm(orig)


def test_randomized_round_cholqr1_matches_householder_quality():
    """Single-pass shifted-CholeskyQR panels (the bench's randomized
    sweep) must match Householder's
    truncation quality; representable ranks reconstruct to the u*kappa^2
    contract."""
    from xerus_tpu.ops.tt_kernels import tt_round_randomized_uniform

    a = TTTensor.random([2] * 10, 8)
    orig = a.to_tensor().to_ndarray()
    cs = [c.to_jax() for c in a.components]

    rh = tt_round_randomized_uniform(cs, 4, qr_method="householder")
    e_h = np.linalg.norm(TTTensor._make(
        [xe.Tensor.from_jax(c) for c in rh]).to_tensor().to_ndarray() - orig)
    rc = tt_round_randomized_uniform(cs, 4, qr_method="cholqr1")
    e_c = np.linalg.norm(TTTensor._make(
        [xe.Tensor.from_jax(c) for c in rc]).to_tensor().to_ndarray() - orig)
    assert e_c < 1.2 * e_h + 1e-12

    rr = tt_round_randomized_uniform(cs, 8, qr_method="cholqr1")
    t = TTTensor._make([xe.Tensor.from_jax(c) for c in rr])
    err = np.linalg.norm(t.to_tensor().to_ndarray() - orig)
    assert err < 1e-5 * np.linalg.norm(orig)

    # f32 with zero-padded bonds stays finite (shifted Cholesky)
    cs32 = [jnp.asarray(np.asarray(c), jnp.float32) for c in cs]
    r32 = tt_round_randomized_uniform(cs32, 4, qr_method="cholqr1")
    assert all(bool(jnp.all(jnp.isfinite(c))) for c in r32)


def test_randomized_round_precision_knobs():
    """precision/gram_precision on _round_randomized (the bf16-pass
    study knobs, VERDICT r3 #4): None must stay bit-identical to the
    explicit 'highest' trace under the jit_f32 discipline (backward
    compat with every existing call site), and lowered precisions must
    stay quasi-optimal.  On CPU all f32 matmul precisions execute as
    true f32, so 'default' is a pure API/trace test here; the measured
    precision trade-offs are measured by benchmarks/bf16_round_study.py."""
    import jax
    from xerus_tpu.ops.tt_kernels import _round_randomized

    rng = np.random.default_rng(11)
    shapes = [(1, 2, 4), (4, 2, 16), (16, 2, 16), (16, 2, 4), (4, 2, 1)]
    cs = tuple(jnp.asarray(rng.standard_normal(s), jnp.float32)
               for s in shapes)
    with jax.enable_x64(False), jax.default_matmul_precision("highest"):
        base = _round_randomized(cs, None, 8, 4, qr_method="cholqr1")
        expl = _round_randomized(cs, None, 8, 4, qr_method="cholqr1",
                                 precision="highest",
                                 gram_precision="highest")
        low = _round_randomized(cs, None, 8, 4, qr_method="cholqr1",
                                precision="default",
                                gram_precision="high")
    for b, e in zip(base, expl):
        assert jnp.array_equal(b, e), "None must equal explicit highest"

    def dense(cores):
        t = np.asarray(cores[0], np.float64)
        for c in cores[1:]:
            t = np.einsum("...a,anb->...nb", t, np.asarray(c, np.float64))
        return t.reshape(-1)

    x = dense(cs)
    for out in (base, low):
        err = np.linalg.norm(dense(out) - x) / np.linalg.norm(x)
        # rank 8 >= true max bond rank: representable, error at the f32
        # cholqr1 floor (u*kappa^2 single-pass orthogonality, ~2e-5 here)
        assert err < 1e-4, err


def test_randomized_round_cholqr1_invl_parity():
    """cholqr1_invl (trsm against the (l, l) identity, panel apply as a
    GEMM — benchmarks/round_structure_study.py) computes the
    same algebra as cholqr1: same output ranks, same truncation, same
    values up to f32 rounding of the L^{-T} formation order."""
    import jax
    from xerus_tpu.ops.tt_kernels import _round_randomized

    rng = np.random.default_rng(23)
    shapes = [(1, 2, 8), (8, 2, 32), (32, 2, 32), (32, 2, 8), (8, 2, 1)]
    cs = tuple(jnp.asarray(rng.standard_normal(s), jnp.float32)
               for s in shapes)
    with jax.enable_x64(False), jax.default_matmul_precision("highest"):
        a = _round_randomized(cs, None, 8, 4, qr_method="cholqr1")
        b = _round_randomized(cs, None, 8, 4, qr_method="cholqr1_invl")
    assert [x.shape for x in a] == [x.shape for x in b]

    def dense(cores):
        t = np.asarray(cores[0], np.float64)
        for c in cores[1:]:
            t = np.einsum("...a,anb->...nb", t, np.asarray(c, np.float64))
        return t.reshape(-1)

    fa, fb = dense(a), dense(b)
    assert np.linalg.norm(fa - fb) / np.linalg.norm(fa) < 1e-5


def test_apply_operator_rounded_fused():
    """Fused MPO apply + randomized rounding (ops/apply_kernels.py): the
    (a*r)-rank product is never materialized; exact on representable
    targets, quasi-optimal under truncation, f32-safe."""
    from xerus_tpu.ops.apply_kernels import apply_operator_rounded
    from xerus_tpu.examples import laplace_operator, heisenberg_mpo

    d = 8
    L = laplace_operator([2] * d)
    x = TTTensor.random([2] * d, 3)
    exact = xe.apply_operator(L, x)
    want = exact.to_tensor().to_ndarray()

    got = apply_operator_rounded(L, x, 8)
    got.require_correct_format()
    assert np.linalg.norm(got.to_tensor().to_ndarray() - want) \
        < 1e-9 * np.linalg.norm(want)

    ref = exact.copy()
    ref.round(4)
    e_ref = np.linalg.norm(ref.to_tensor().to_ndarray() - want)
    g4 = apply_operator_rounded(L, x, 4)
    e_g = np.linalg.norm(g4.to_tensor().to_ndarray() - want)
    assert e_g < 4 * e_ref + 1e-12

    H = heisenberg_mpo(d)
    y = apply_operator_rounded(H, x, 12)
    yw = xe.apply_operator(H, x).to_tensor().to_ndarray()
    assert np.linalg.norm(y.to_tensor().to_ndarray() - yw) \
        < 1e-9 * np.linalg.norm(yw)

    # f32 kernel path stays finite and accurate at its precision
    from xerus_tpu.ops.apply_kernels import apply_operator_rounded_cores
    A32 = [np.asarray(c.to_ndarray(), np.float32) for c in L.components]
    x32 = [np.asarray(c.to_ndarray(), np.float32) for c in x.components]
    out = apply_operator_rounded_cores(A32, x32, 8)
    t32 = TTTensor._make([xe.Tensor.from_ndarray(np.asarray(c, np.float64))
                          for c in out])
    err = np.linalg.norm(t32.to_tensor().to_ndarray() - want)
    assert err < 1e-4 * np.linalg.norm(want)


def test_gram_round_eps_truncation():
    """eps mask in the Gram-eigh scan (sigma from sqrt(eigenvalues))
    matches the svd scan's data-dependent rank trimming."""
    from xerus_tpu.ops.tt_kernels import tt_round_sweep_uniform
    a = TTTensor.random([3] * 6, 2)
    a /= a.frob_norm()
    b = TTTensor.random([3] * 6, 2)
    b /= b.frob_norm()
    c = a + 1e-8 * b
    cores = [x.to_jax() for x in c.components]
    out = tt_round_sweep_uniform(cores, 4, method="gram", eps=1e-6)
    got = TTTensor._make([xe.Tensor.from_jax(x) for x in out])
    assert np.allclose(got.to_tensor().to_ndarray(),
                       a.to_tensor().to_ndarray(), atol=1e-6)
    assert got.ranks() == [2] * 5


@pytest.mark.slow
def test_tt_residual_rel_device():
    """Device-side ||Ax-b||/||b|| (block-TT + orthogonalization sweep)
    matches the object-level residual, including far below the
    sqrt(eps)-floor of the naive quadratic form (als.cpp:291 semantics)."""
    import jax.numpy as jnp
    import xerus_tpu as xe
    from xerus_tpu.ops.tt_kernels import tt_residual_rel
    from xerus_tpu.tt.ttnetwork import apply_operator
    from xerus_tpu.examples import laplace_operator

    dims = [2] * 6
    A = laplace_operator(dims)
    b = xe.TTTensor.random(dims, 3)
    b /= b.frob_norm()
    x = xe.TTTensor.random(dims, 3)
    dev = float(tt_residual_rel(
        tuple(c.to_jax() for c in x.components),
        tuple(c.to_jax() for c in A.components),
        tuple(c.to_jax() for c in b.components)))
    true = float((apply_operator(A, x) - b).frob_norm() / b.frob_norm())
    assert abs(dev - true) < 1e-10 * max(true, 1.0)

    # tiny-residual regime (below the sqrt(eps) quadratic-form floor):
    # make the solution representable at the sweep rank, solve, measure
    x_true = xe.TTTensor.random(dims, 3)
    x_true /= x_true.frob_norm()
    b2 = apply_operator(A, x_true)
    x2 = xe.TTTensor.random(dims, 3)
    xe.ALS_SPD(A, x2, b2, 1e-14)
    dev = float(tt_residual_rel(
        tuple(c.to_jax() for c in x2.components),
        tuple(c.to_jax() for c in A.components),
        tuple(c.to_jax() for c in b2.components)))
    true = float((apply_operator(A, x2) - b2).frob_norm() / b2.frob_norm())
    assert true < 1e-12            # genuinely converged
    assert dev < 10 * true + 1e-14  # device readout follows it down


def test_als_multi_sweep_res_matches_single_sweeps():
    """N chained alternating half-sweeps + residual history in one program
    == N single-sweep kernel calls (the e2e solve drivers' fast path)."""
    import jax.numpy as jnp
    import xerus_tpu as xe
    from xerus_tpu.ops.tt_kernels import (make_als_multi_sweep_res,
                                          make_als_sweep, tt_residual_rel)
    from xerus_tpu.examples import laplace_operator

    dims = [2] * 6
    A = laplace_operator(dims)
    x = xe.TTTensor.random(dims, 3)
    x.canonicalize_left()
    b = xe.TTTensor.ones(dims)
    xc = tuple(c.to_jax() for c in x.components)
    Ac = tuple(c.to_jax() for c in A.components)
    bc = tuple(c.to_jax() for c in b.components)

    shapes = tuple(tuple(c.shape) for c in xc)
    multi = make_als_multi_sweep_res(shapes, "float64", 4)
    out, hist = multi(xc, Ac, bc)
    assert hist.shape == (4,)

    cur = xc
    for s in range(4):
        fn = make_als_sweep(shapes, "float64", "lr" if s % 2 == 0 else "rl")
        cur = fn(cur, Ac, bc)
    import numpy as np
    for a_, b_ in zip(out, cur):
        assert np.allclose(np.asarray(a_), np.asarray(b_), atol=1e-12)
    assert abs(float(hist[-1])
               - float(tt_residual_rel(cur, Ac, bc))) < 1e-12


@pytest.mark.slow
def test_df_als_multi_sweep_reaches_f64_quality():
    """Chained df32 half-sweeps (one program) refine an f32-converged
    start to ~f64-level residual (mixed_precision.make_df_als_multi_sweep)."""
    import numpy as np
    import jax.numpy as jnp
    import xerus_tpu as xe
    from xerus_tpu.ops.mixed_precision import make_df_als_multi_sweep
    from xerus_tpu.ops.df32 import df_from_f64, df_to_f64
    from xerus_tpu.examples import laplace_operator
    from xerus_tpu.tt.ttnetwork import apply_operator
    from xerus_tpu.core.tensor import Tensor

    dims = [2] * 6
    A = laplace_operator(dims)
    x = xe.TTTensor.random(dims, 4)
    x.canonicalize_left()
    b = xe.TTTensor.ones(dims)
    x64 = [np.asarray(c.to_ndarray(), np.float64) for c in x.components]
    shapes = tuple(tuple(c.shape) for c in x64)
    fn = make_df_als_multi_sweep(shapes, "float32", 4)
    x_df = tuple(df_from_f64(c) for c in x64)
    A_df = tuple(df_from_f64(np.asarray(c.to_ndarray(), np.float64))
                 for c in A.components)
    b_df = tuple(df_from_f64(np.asarray(c.to_ndarray(), np.float64))
                 for c in b.components)
    out = fn(x_df, A_df, b_df)
    x.components = [Tensor.from_ndarray(df_to_f64(h, l)) for (h, l) in out]
    res = float((apply_operator(A, x) - b).frob_norm() / b.frob_norm())
    assert res < 1e-11, res


@pytest.mark.slow
def test_subspace_round_quality_and_exactness():
    """Deterministic GEMM-only subspace truncation (method='subspace'):
    exact on representable ranks, within a few percent of the exact-SVD
    truncation error otherwise (ops/tt_kernels._trunc_step_subspace)."""
    from xerus_tpu.ops.tt_kernels import tt_round_sweep_segmented

    tt = TTTensor.random([2] * 10, 8)
    cores = [c.to_jax() for c in tt.components]
    orig = tt.to_tensor().to_ndarray()
    # representable: exact
    out = tt_round_sweep_segmented(cores, 8, method="subspace")
    got = TTTensor._make([xe.Tensor.from_jax(c) for c in out])
    assert np.allclose(got.to_tensor().to_ndarray(), orig, atol=1e-10)
    # truncating: near-optimal
    ex = tt_round_sweep_segmented(cores, 4, method="svd")
    sub = tt_round_sweep_segmented(cores, 4, method="subspace")
    e_ex = np.linalg.norm(TTTensor._make(
        [xe.Tensor.from_jax(c) for c in ex]).to_tensor().to_ndarray() - orig)
    e_sub = np.linalg.norm(TTTensor._make(
        [xe.Tensor.from_jax(c) for c in sub]).to_tensor().to_ndarray() - orig)
    assert e_sub < 1.1 * e_ex + 1e-12
    # object-level route incl. per-edge vector
    t = tt.copy()
    t.round_fast([2, 3, 4, 4, 4, 4, 4, 3, 2], method="subspace")
    t.require_correct_format()
    assert t.ranks() == [2, 3, 4, 4, 4, 4, 4, 3, 2]
    with pytest.raises(ValueError):
        tt_round_sweep_segmented(cores, 4, method="subspace", eps=1e-6)


@pytest.mark.slow
def test_gemm_exact_round_matches_svd_chain():
    """method='gemm_exact' (zero-factorization certified truncation,
    ops/tt_kernels._trunc_step_gemm_exact) must match the exact-SVD
    chain at the object round() oracle tolerance — this is the
    reference-semantics deterministic rounding path (ttNetwork.cpp:644)
    rebuilt from GEMMs only (VERDICT r2 item #2)."""
    from xerus_tpu.ops.tt_kernels import tt_round_sweep_segmented

    for dims, r, tgt in ([[3] * 6, 8, 4], [[2] * 10, 8, 4], [[4] * 5, 12, 5]):
        tt = TTTensor.random(dims, r)
        cores = [c.to_jax() for c in tt.components]
        orig = tt.to_tensor().to_ndarray()
        ex = tt_round_sweep_segmented(cores, tgt, method="svd")
        ge = tt_round_sweep_segmented(cores, tgt, method="gemm_exact")
        e_ex = np.linalg.norm(TTTensor._make(
            [xe.Tensor.from_jax(c) for c in ex]
        ).to_tensor().to_ndarray() - orig)
        e_ge = np.linalg.norm(TTTensor._make(
            [xe.Tensor.from_jax(c) for c in ge]
        ).to_tensor().to_ndarray() - orig)
        assert np.isclose(e_ge, e_ex, rtol=1e-8), (e_ge, e_ex)

    # representable rank: exact reproduction + valid canonical format
    tt = TTTensor.random([2] * 8, 4)
    cores = [c.to_jax() for c in tt.components]
    out = tt_round_sweep_segmented(cores, 4, method="gemm_exact")
    got = TTTensor._make([xe.Tensor.from_jax(c) for c in out])
    got.require_correct_format()
    assert np.allclose(got.to_tensor().to_ndarray(),
                       tt.to_tensor().to_ndarray(), atol=1e-10)

    # rank-deficient input (keep above true rank): the Newton-Schulz
    # extraction cannot complete an orthonormal basis — the lax.cond
    # SVD fallback must kick in and reproduce the tensor exactly
    a = TTTensor.random([3] * 5, 3)
    b = a + 0.0 * TTTensor.random([3] * 5, 5)
    cores = [c.to_jax() for c in b.components]
    out = tt_round_sweep_segmented(cores, 5, method="gemm_exact")
    got = TTTensor._make([xe.Tensor.from_jax(c) for c in out])
    assert np.allclose(got.to_tensor().to_ndarray(),
                       a.to_tensor().to_ndarray(), atol=1e-10)

    # eps rounding needs singular values: refuse like 'subspace'
    with pytest.raises(ValueError):
        tt_round_sweep_segmented(cores, 4, method="gemm_exact", eps=1e-6)


def test_chol_orth_cols_contract():
    """Shared shifted-CholQR helper (ops/tt_kernels.chol_orth_cols):
    orthonormal columns, want_r reproduces X, multi-pass tightens
    orthogonality on ill-conditioned input."""
    import jax.numpy as jnp
    from xerus_tpu.ops.tt_kernels import chol_orth_cols

    rng = np.random.default_rng(7)
    X = jnp.asarray(rng.normal(size=(40, 8)))
    Q = chol_orth_cols(X)
    assert np.allclose(np.asarray(Q.T @ Q), np.eye(8), atol=1e-10)
    Q2, R = chol_orth_cols(X, want_r=True)
    assert np.allclose(np.asarray(Q2 @ R), np.asarray(X), atol=1e-10)
    # ill-conditioned: single pass leaves u*kappa^2 error, three passes fix
    U, _ = np.linalg.qr(rng.normal(size=(40, 8)))
    V, _ = np.linalg.qr(rng.normal(size=(8, 8)))
    Xb = jnp.asarray(U @ np.diag(np.logspace(0, -6, 8)) @ V.T)
    ueps = float(np.finfo(np.float64).eps)
    Q3 = chol_orth_cols(Xb, (10 * 40 * ueps, 10 * ueps, 10 * ueps))
    assert np.linalg.norm(np.asarray(Q3.T @ Q3) - np.eye(8)) < 1e-9


def test_randomized_round_unrolled_cholqr1_matches_householder():
    """The unrolled true-shape randomized sweep (_round_randomized) with
    cholqr1 panels truncates identically to its householder form — the
    bench headline kernel (boundary panels keep householder; tall
    well-conditioned sketch panels take the one-pass shifted
    Gram+chol+trsm route)."""
    from xerus_tpu.ops.tt_kernels import _round_randomized

    rng = np.random.default_rng(5)
    d, n, r, target = 8, 2, 16, 8
    cs = []
    for i in range(d):
        rl = 1 if i == 0 else min(r, 2 ** i, 2 ** (d - i))
        rr = 1 if i == d - 1 else min(r, 2 ** (i + 1), 2 ** (d - i - 1))
        cs.append(jnp.asarray(
            rng.normal(size=(rl, n, rr)).astype(np.float32)) / np.sqrt(r))

    def densify(cores):
        acc = np.asarray(cores[0], np.float64)
        for c in cores[1:]:
            acc = np.tensordot(acc, np.asarray(c, np.float64),
                               axes=([-1], [0]))
        return acc.reshape(-1)

    ref = densify(cs)
    errs = {}
    for method in ("householder", "cholqr1"):
        out = _round_randomized(tuple(cs), None, target, 8,
                                qr_method=method)
        assert max(c.shape[2] for c in out[:-1]) <= target
        errs[method] = np.linalg.norm(densify(out) - ref) / np.linalg.norm(ref)
    # same sketch, same projections -> identical truncation error
    assert abs(errs["cholqr1"] - errs["householder"]) < 1e-6, errs
    assert errs["householder"] < 0.2, errs


def test_pad_cores_roundtrip():
    from xerus_tpu.ops.tt_kernels import pad_cores
    tt = TTTensor.random([3, 4, 3], 2)
    stacked, r = pad_cores([np.asarray(c.to_ndarray()) for c in tt.components])
    assert stacked.shape == (3, r, 4, r)
    # first core occupies the top-left corner
    c0 = np.asarray(tt.components[0].to_ndarray())
    assert np.allclose(np.asarray(stacked)[0, :1, :3, :2], c0)


@pytest.mark.parametrize("kind", ["generic", "cliff", "overranked"])
def test_gemm_exact_step_matches_svd_truncation(kind):
    """The certified GEMM-only truncation step (XLA branch) at the bench's
    interior-bond shape cur=(256, 512), keep_cap=128, against the optimal
    rank-keep truncation from numpy's f64 SVD (Eckart-Young).  f32
    arithmetic: the truncation errors must agree at f32 roundoff, and on
    spectra with a clear subspace (cliff / overranked) so must the
    reconstructions."""
    import jax
    from xerus_tpu.ops import tt_kernels as tk
    B, M, cap, keep = 256, 512, 128, 96
    rng = np.random.default_rng(7)
    if kind == "generic":
        A = rng.standard_normal((B, M)) * rng.uniform(0.1, 1.0, size=(B, 1))
    elif kind == "cliff":
        U, _ = np.linalg.qr(rng.standard_normal((B, B)))
        V, _ = np.linalg.qr(rng.standard_normal((M, B)))
        s = np.concatenate([np.linspace(10.0, 1.0, keep),
                            np.full(B - keep, 1e-6)])
        A = (U * s) @ V.T
    else:
        # true rank far below keep: polar failure + Householder-LQ finish
        A = rng.standard_normal((B, 7)) @ rng.standard_normal((7, M))
    cur = jnp.asarray(A, jnp.float32)
    with jax.enable_x64(False):
        us, vt = tk._trunc_step_gemm_exact(cur, keep, cap, jnp.float32, 1e-30)
    assert us.shape == (B, cap) and vt.shape == (cap, M)
    A64 = np.asarray(cur, np.float64)
    u, s, wt = np.linalg.svd(A64, full_matrices=False)
    best = (u[:, :keep] * s[:keep]) @ wt[:keep]
    rec = np.asarray(us, np.float64) @ np.asarray(vt, np.float64)
    nrm2 = np.sum(s ** 2)
    err = np.linalg.norm(A64 - rec) ** 2 / nrm2
    err_opt = np.sum(s[keep:] ** 2) / nrm2
    assert abs(err - err_opt) < 5e-6, (kind, err, err_opt)
    # entries beyond keep are exactly zero
    assert not np.any(np.asarray(vt)[keep:])
    if kind != "generic":
        assert np.linalg.norm(rec - best) / np.linalg.norm(A64) < 5e-6, kind
