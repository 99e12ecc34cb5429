"""ALS/DMRG/ASD tests (intent of als.cxx: identity-operator oracle, Poisson
solve, convergence of all preset variants)."""

import numpy as np
import pytest

import xerus_tpu as xe
from xerus_tpu import Tensor, TTTensor, TTOperator
from xerus_tpu.examples import laplace_operator, poisson_rhs


def test_als_identity_operator():
    """ALS on the identity operator must reproduce b (als.cxx:28-61)."""
    dims = [2] * 5
    A = TTOperator.identity(dims + dims)
    b = TTTensor.random(dims, 2)
    b /= b.frob_norm()
    x = TTTensor.random(dims, 2)
    resid = xe.ALS_SPD(A, x, b, 1e-10)
    assert resid < 1e-8
    assert np.allclose(x.to_tensor().to_ndarray(), b.to_tensor().to_ndarray(),
                       atol=1e-7)


def test_als_without_operator():
    dims = [3] * 4
    b = TTTensor.random(dims, 3)
    x = TTTensor.random(dims, 3)
    resid = xe.ALS(x, b, 1e-10)
    assert resid < 1e-8


def test_als_spd_poisson():
    dims = [4] * 6
    A = laplace_operator(dims)
    b = poisson_rhs(dims)
    b /= b.frob_norm()
    x = TTTensor.random(dims, 4)
    resid = xe.ALS_SPD(A, x, b, 1e-12)
    # check true residual against dense solve
    A_mat = A.to_tensor().to_ndarray().reshape(4 ** 6, 4 ** 6)
    x_vec = x.to_tensor().to_ndarray().reshape(-1)
    b_vec = b.to_tensor().to_ndarray().reshape(-1)
    true_resid = np.linalg.norm(A_mat @ x_vec - b_vec) / np.linalg.norm(b_vec)
    assert true_resid < 1e-8
    assert abs(resid - true_resid) < 1e-8


def test_als_nonspd_matches():
    """Non-SPD path (normal equations) on an unsymmetric operator."""
    dims = [3] * 3
    rng = xe.misc.randomEngine
    A = TTOperator.random(dims + dims, 2)
    # make it well conditioned: A + 5*I
    ident = TTOperator.identity(dims + dims)
    A += 5.0 * ident
    b = TTTensor.random(dims, 2)
    x = TTTensor.random(dims, 4)
    resid = xe.ALS(A, x, b, 1e-12)
    A_mat = A.to_tensor().to_ndarray().reshape(27, 27)
    x_vec = x.to_tensor().to_ndarray().reshape(-1)
    b_vec = b.to_tensor().to_ndarray().reshape(-1)
    assert np.linalg.norm(A_mat @ x_vec - b_vec) / np.linalg.norm(b_vec) < 1e-6


def test_dmrg_adapts_rank():
    """DMRG with rank-deficient start must reach the solution by adapting
    within targetRank."""
    dims = [2] * 6
    A = TTOperator.identity(dims + dims)
    b = TTTensor.random(dims, 3)
    b /= b.frob_norm()
    x = TTTensor.random(dims, 3)
    resid = xe.DMRG_SPD(A, x, b, 1e-10)
    assert resid < 1e-8


def test_asd_descends():
    dims = [3] * 4
    A = laplace_operator(dims)
    b = poisson_rhs(dims)
    b /= b.frob_norm()
    x = TTTensor.random(dims, 3)
    start_resid = (xe.apply_operator(A, x) - b).frob_norm()
    variant = xe.ALSVariant(1, 40, "asd", assume_spd=True)
    resid = variant(A, x, b, 40)
    end_resid = (xe.apply_operator(A, x) - b).frob_norm()
    assert end_resid < start_resid * 0.5


def test_als_perfdata():
    dims = [3] * 3
    A = TTOperator.identity(dims + dims)
    b = TTTensor.random(dims, 2)
    x = TTTensor.random(dims, 2)
    perf = xe.PerformanceData()
    xe.ALS_SPD(A, x, b, 1e-10, perf)
    assert len(perf.data) > 0
    assert perf.data[-1].residual < 1e-8
    assert any(p.flags for p in perf.data)


def test_als_preserves_core_position():
    dims = [3] * 4
    A = TTOperator.identity(dims + dims)
    b = TTTensor.random(dims, 2)
    x = TTTensor.random(dims, 2)
    x.move_core(2)
    xe.ALS_SPD(A, x, b, 1e-10)
    assert x.canonicalized and x.corePosition == 2


@pytest.mark.slow
def test_als_quickstart_qtt_poisson():
    """The quickstart problem: 2^9 QTT Poisson solve, checked against a dense
    solve (doc/jekyll/_posts/1000-12-10-quickstart.md)."""
    d = 9
    dims = [2] * d
    A = xe.examples.laplace_operator(dims)
    b = TTTensor.ones(dims)
    x = TTTensor.random(dims, 4)
    xe.ALS_SPD(A, x, b, 1e-12)
    n = 2 ** d
    A_mat = A.to_tensor().to_ndarray().reshape(n, n)
    ref = np.linalg.solve(A_mat, np.ones(n))
    got = x.to_tensor().to_ndarray().reshape(n)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-6


@pytest.mark.slow
def test_north_star_d32_poisson_rank30():
    """The BASELINE.json target problem: d=32 QTT Poisson at rank 30,
    relative residual at 1e-10 level (f64 CPU validation of the device
    kernel path — ALS fast path runs the same _als_half_sweep).
    Takes minutes on CPU; run with `pytest -m slow`."""
    d = 32
    dims = [2] * d
    A = laplace_operator(dims)
    b = poisson_rhs(dims)
    b /= b.frob_norm()
    x = TTTensor.random(dims, 30)
    resid = xe.ALS_SPD(A, x, b, 1e-14)
    assert resid < 1e-10


def test_dmrg_solve_kernel_rank_growth():
    """Whole-sweep jitted two-site DMRG linear solver (the reference's
    DMRG_SPD variant, als.h:219): matrix-free CG local solves, masked SVD
    splits; ranks GROW to the cap and the Poisson system solves to
    machine precision."""
    from xerus_tpu.ops.dmrg_kernels import dmrg_solve
    from xerus_tpu.examples import laplace_operator

    d = 10
    L = laplace_operator([2] * d)
    truth = TTTensor.random([2] * d, 4)
    b = xe.apply_operator(L, truth)
    b.round(8)
    x = TTTensor.random([2] * d, 2)
    res = dmrg_solve(L, x, b, max_rank=8, num_half_sweeps=12)
    assert res < 1e-10
    assert max(x.ranks()) == 8          # grew from 2 (two-site advantage)
    err = (x - truth).frob_norm() / truth.frob_norm()
    assert float(err) < 1e-10


@pytest.mark.slow
def test_asd_spd_fast_path_converges():
    """Jitted ASD half-sweep (ops/tt_kernels.py _asd_half_sweep — the
    als.cpp:73-92 gradient step with exact stepsize, matrix-free local
    applies): the ASD_SPD preset now routes through the whole-sweep
    kernel and converges on the Poisson system."""
    d = 10
    L = laplace_operator([2] * d)
    truth = TTTensor.random([2] * d, 3)
    b = xe.apply_operator(L, truth)
    b.round(6)
    x = TTTensor.random([2] * d, 6)
    xe.ASD_SPD(L, x, b, 400)
    x.require_correct_format()
    resid = (xe.apply_operator(L, x) - b).frob_norm() / b.frob_norm()
    assert float(resid) < 1e-6


@pytest.mark.slow
def test_als_cg_matrix_free_local_solver():
    """local_solver='cg' (matrix-free local solves, never materializes
    the (r n r)^2 local operator — an extension) converges like
    the lapack path on the SPD Poisson system."""
    dims = [2] * 8
    A = laplace_operator(dims)
    b = TTTensor.ones(dims)
    b /= b.frob_norm()
    x = TTTensor.random(dims, 5)
    resid = xe.ALS_SPD_CG(A, x, b, 1e-10)
    from xerus_tpu.tt.ttnetwork import apply_operator
    true = float((apply_operator(A, x) - b).frob_norm() / b.frob_norm())
    assert true < 1e-7, true


def test_device_loop_matches_host_loop_reversal_paths():
    """make_als_run_rev (whole-solve while_loop for the lr-only kernels:
    non-SPD normal equations, ASD, CG) must match the per-sweep host loop
    exactly.  The host loop is forced via an instrumented PerformanceData
    (error_function callbacks need the iterate on host)."""
    from xerus_tpu.examples import laplace_operator

    dims = [3] * 3
    ident = TTOperator.identity(dims + dims)
    A = TTOperator.random(dims + dims, 2)
    A += 5.0 * ident
    b = TTTensor.random(dims, 2)

    for variant, op in ((xe.ALSVariant(1, 6, "lapack", assume_spd=False), A),
                        (xe.ALSVariant(1, 6, "asd", assume_spd=True), ident),
                        (xe.ALSVariant(1, 6, "cg", assume_spd=True), ident)):
        x0 = TTTensor.random(dims, 3)
        x_host, x_dev = x0.copy(), x0.copy()
        perf = xe.PerformanceData(error_function=lambda t: 0.0)
        r_host = variant(op, x_host, b, perf_data=perf)   # host loop
        r_dev = variant(op, x_dev, b)                     # device loop
        assert abs(r_host - r_dev) < 1e-10 * max(1.0, abs(r_host)), \
            (variant.local_solver, r_host, r_dev)
        assert len(perf.data) > 0
        for ch, cd in zip(x_host.components, x_dev.components):
            assert np.allclose(ch.to_ndarray(), cd.to_ndarray(),
                               atol=1e-9), variant.local_solver


def test_spd_variant_nonsymmetric_operator_lu_dispatch():
    """ALS_SPD on a NON-symmetric operator must still solve the system:
    the reference's local solver runtime-detects symmetry and falls back
    to PLU (blasLapackWrapper.cpp:542-585); our fast path decides once
    per operator via TTOperator.is_symmetric.  With Cholesky local
    solves this test produces O(1) residuals."""
    from xerus_tpu.examples import laplace_operator

    dims = [3] * 3
    lap = laplace_operator(dims)
    assert lap.is_symmetric()

    A = TTOperator.random(dims + dims, 2)
    A += 8.0 * TTOperator.identity(dims + dims)  # well-conditioned
    assert not A.is_symmetric()

    b = TTTensor.random(dims, 2)
    x = TTTensor.random(dims, 4)
    res = xe.ALS_SPD(A, x, b, 12)
    assert res < 1e-8, res

    # oracle: dense solve
    n = int(np.prod(dims))
    Ad = A.to_tensor().to_ndarray().reshape(n, n)
    bd = b.to_tensor().to_ndarray().reshape(n)
    ref = np.linalg.solve(Ad, bd)
    xd = x.to_tensor().to_ndarray().reshape(n)
    assert np.linalg.norm(xd - ref) / np.linalg.norm(ref) < 1e-7


def test_spd_variant_symmetric_indefinite_cholesky_fallback():
    """A symmetric-INDEFINITE operator passes is_symmetric, so the fast
    path first dispatches Cholesky local solves, which NaN (jnp returns
    NaN rather than raising).  The engine must detect the non-finite
    residual and re-dispatch with the general solver — the reference
    solves this case via LDL^T (blasLapackWrapper.cpp:586-651)."""
    dims = [2] * 4
    A = TTOperator.identity(dims + dims)
    # site 0 becomes diag(1,-1): A = diag(1,-1) (x) I (x) I (x) I —
    # symmetric, indefinite, orthogonal (so perfectly conditioned)
    core = np.zeros((1, 2, 2, 1))
    core[0, 0, 0, 0] = 1.0
    core[0, 1, 1, 0] = -1.0
    A.set_component(0, Tensor.from_ndarray(core))
    assert A.is_symmetric()

    b = TTTensor.random(dims, 2)
    b /= b.frob_norm()
    x = TTTensor.random(dims, 3)
    res = xe.ALS_SPD(A, x, b, 16)
    assert np.isfinite(res), "fallback did not fire: NaN residual"

    n = int(np.prod(dims))
    Ad = A.to_tensor().to_ndarray().reshape(n, n)
    bd = b.to_tensor().to_ndarray().reshape(n)
    xd = x.to_tensor().to_ndarray().reshape(n)
    assert np.all(np.isfinite(xd)), "NaN cores leaked into x"
    assert np.linalg.norm(Ad @ xd - bd) < 1e-8


def test_is_symmetric_shape_guards_and_cache():
    """is_symmetric returns False (does not raise) for TTTensors and
    non-square operators, and memoizes per component list (ADVICE r2)."""
    dims = [3] * 3
    t = TTTensor.random(dims, 2)
    assert t.is_symmetric() is False  # not an operator

    A = TTOperator.random([2, 3] + [3, 2], 2)  # non-square
    assert A.is_symmetric() is False

    from xerus_tpu.examples import laplace_operator
    lap = laplace_operator(dims)
    assert lap.is_symmetric()
    assert lap._symmetric_cache is not None
    # poison the cached verdict: a cache hit must return the poisoned
    # value, proving the TT subtraction is not recomputed
    lap._symmetric_cache = (1e-12, lap._symmetric_cache[1], "poisoned")
    assert lap.is_symmetric() == "poisoned"
    # replacing a component invalidates (identity comparison fails)
    lap.set_component(0, lap.get_component(0).copy())
    assert lap.is_symmetric() is True  # recomputed, still symmetric


def test_full_rank_boundary_node_elision_is_gauge_neutral():
    """The reference's prepare_x_for_als (als.cpp:105-182) gauges
    full-rank boundary nodes to reshape-identities and skips them in the
    sweep.  We deliberately do not elide (PARITY.md §2.4); this test
    pins the divergence as gauge-only: starting ALS from the identical
    tensor in BOTH gauges converges to the same solution."""
    dims = [2] * 4
    from xerus_tpu.examples import laplace_operator
    A = laplace_operator(dims)
    b = TTTensor.random(dims, 2)
    b /= b.frob_norm()

    # max-possible ranks: node 0 (rank 2 = dim product) and node 1
    # (rank 4 = 2*2) are "full-rank nodes" the reference would elide
    x = TTTensor.random(dims, [2, 4, 2])
    x_elided = x.copy()
    c0 = x_elided.get_component(0).to_ndarray()     # (1, 2, 2)
    c1 = x_elided.get_component(1).to_ndarray()     # (2, 2, 4)
    merged = np.einsum("ac,cnr->anr", c0[0], c1)
    x_elided.set_component(0, Tensor.from_ndarray(
        np.eye(2).reshape(1, 2, 2)))
    x_elided.set_component(1, Tensor.from_ndarray(merged))
    # same represented tensor, different gauge
    assert np.allclose(x.to_tensor().to_ndarray(),
                       x_elided.to_tensor().to_ndarray(), atol=1e-12)

    res1 = xe.ALS_SPD(A, x, b, 1e-13)
    res2 = xe.ALS_SPD(A, x_elided, b, 1e-13)

    n = int(np.prod(dims))
    Ad = A.to_tensor().to_ndarray().reshape(n, n)
    bd = b.to_tensor().to_ndarray().reshape(n)
    oracle = np.linalg.solve(Ad, bd)
    for xv, res in ((x, res1), (x_elided, res2)):
        xd = xv.to_tensor().to_ndarray().reshape(n)
        assert np.linalg.norm(xd - oracle) / np.linalg.norm(oracle) < 1e-8
