"""Multi-device sharding tests on the 8-virtual-CPU mesh (SURVEY.md §4)."""

import numpy as np
import pytest
import jax

import xerus_tpu as xe
from xerus_tpu import TTTensor
from xerus_tpu.parallel import (default_mesh, sharded_adf_gradient,
                                sharded_als_local_solve, sharded_tt_inner,
                                multichip_training_step)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return default_mesh(8)


def test_default_mesh_shape(mesh):
    assert mesh.devices.size == 8
    assert set(mesh.axis_names) == {"dp", "tp"}


def test_sharded_tt_inner_matches_dense(mesh):
    a = TTTensor.random([4] * 5, 3)
    b = TTTensor.random([4] * 5, 3)
    got = float(sharded_tt_inner([c.to_jax() for c in a.components],
                                 [c.to_jax() for c in b.components], mesh))
    ref = np.sum(a.to_tensor().to_ndarray() * b.to_tensor().to_ndarray())
    assert np.isclose(got, ref, rtol=1e-10)


def test_sharded_adf_gradient_matches_serial(mesh):
    d, n, r, M = 4, 3, 2, 24
    tt = TTTensor.random([n] * d, r)
    rng = xe.misc.randomEngine
    P = rng.integers(0, n, size=(M, d))
    v = rng.normal(size=(M,))
    cores = [c.to_jax() for c in tt.components]
    grad = np.asarray(sharded_adf_gradient(cores, P, v, mesh))
    # serial reference
    arr = tt.to_tensor().to_ndarray()
    # gradient wrt core0: for each measurement, residual * backward vector
    ref = np.zeros_like(grad)
    for m in range(M):
        B = np.ones(1)
        for k in range(d - 1, 0, -1):
            B = np.asarray(tt.components[k].to_ndarray())[:, P[m, k], :] @ B
        pred = float(np.asarray(tt.components[0].to_ndarray())[0, P[m, 0], :] @ B)
        ref[0, P[m, 0], :] += (v[m] - pred) * B
    assert np.allclose(grad, ref, atol=1e-10)


def test_sharded_als_local_solve_matches_serial(mesh):
    from xerus_tpu.examples import laplace_operator
    dims = [2] * 5
    A = laplace_operator(dims)
    x = TTTensor.random(dims, 2)
    b = TTTensor.ones(dims)
    x_cores = [c.to_jax() for c in x.components]
    A_cores = [c.to_jax() for c in A.components]
    b_cores = [c.to_jax() for c in b.components]
    got = np.asarray(sharded_als_local_solve(x_cores, A_cores, b_cores, mesh))
    # serial reference via the ALS engine's local system
    from xerus_tpu.algorithms.als import _ALSData, ALS_SPD
    x2 = x.copy()
    data = _ALSData(ALS_SPD, A, x2, b)
    Aloc = np.asarray(data.local_operator())
    bloc = np.asarray(data.local_rhs())
    nn = bloc.size
    ref = np.linalg.solve(Aloc.reshape(nn, nn), bloc.reshape(nn)).reshape(bloc.shape)
    assert np.allclose(got, ref, atol=1e-8)


def test_multichip_training_step_runs(mesh):
    grad, sol, ip = multichip_training_step(mesh)
    assert np.all(np.isfinite(grad))
    assert np.all(np.isfinite(sol))
    assert np.isfinite(ip)


def test_graft_entry_dryrun():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", "/root/repo/__graft_entry__.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    fn, args = m.entry()
    out = jax.jit(fn)(*args)
    assert np.all(np.isfinite(np.asarray(out)))
    m.dryrun_multichip(8)


def test_sharded_adf_iteration_matches_serial(mesh):
    from xerus_tpu.ops.adf_kernels import (_adf_iteration, build_onehots,
                                           make_adf_iteration_sharded)
    d, n, r, M = 5, 3, 3, 48
    tt = TTTensor.random([n] * d, r)
    rng = xe.misc.randomEngine
    P = rng.integers(0, n, size=(M, d))
    vals = np.asarray(rng.normal(size=(M,)))
    cores = tuple(c.to_jax() for c in tt.components)
    onehots = build_onehots(P, [n] * d, np.float64)
    import jax.numpy as jnp
    vals_j = jnp.asarray(vals)
    ref_cores, ref_resid = _adf_iteration(cores, onehots, vals_j)
    fn = make_adf_iteration_sharded(mesh, tuple(c.shape for c in cores),
                                    "float64")
    with mesh:
        got_cores, got_resid = fn(cores, onehots, vals_j)
    assert np.isclose(float(got_resid), float(ref_resid), rtol=1e-12)
    for a, b in zip(got_cores, ref_cores):
        assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-12)


def test_tt_round_tsqr_matches_serial():
    """Rank-sharded TSQR+Gram rounding (parallel/tsqr_round.py) must agree
    with the serial scan kernel on the 8-device mesh."""
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from xerus_tpu.parallel.tsqr_round import tt_round_tsqr
    from xerus_tpu.ops.tt_kernels import tt_round_sweep_uniform

    mesh1d = Mesh(np.array(jax.devices()), ("tp",))
    d, n, target = 8, 2, 6
    a = TTTensor.random([n] * d, 12)
    b = TTTensor.random([n] * d, 3)
    t = a + b
    cores = [c.to_jax() for c in t.components]
    ref_cores = tt_round_sweep_uniform(cores, target, method="gram")
    got_cores = tt_round_tsqr(cores, target, mesh1d)

    def dense(cs):
        out = np.asarray(cs[0])
        for c in cs[1:]:
            out = np.tensordot(out, np.asarray(c), axes=([out.ndim - 1], [0]))
        return out.squeeze()

    ref = dense(ref_cores)
    got = dense(got_cores)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-10
    # truncation error equals the serial kernel's (same kept spectrum)
    exact = t.to_tensor().to_ndarray()
    e_got = np.linalg.norm(got - exact)
    e_ref = np.linalg.norm(ref - exact)
    assert abs(e_got - e_ref) / e_ref < 1e-8


def test_uq_adf_dp_sharded_matches_serial(mesh):
    """uq_adf(mesh=...) shards the sample axis over dp; the result must
    match the unsharded run exactly (same arithmetic, GSPMD-inserted
    psums)."""
    from xerus_tpu import Tensor
    from xerus_tpu.algorithms import randvar_to_position

    dims = [4, 3, 3]
    truth = TTTensor.random(dims, 2)
    truth /= truth.frob_norm()
    rng = np.random.default_rng(21)
    rvs, sols = [], []
    arr = truth.to_tensor().to_ndarray()
    for _ in range(64):
        rv = [float(rng.normal()), float(rng.normal())]
        w1 = randvar_to_position(rv[0], 3)
        w2 = randvar_to_position(rv[1], 3)
        sols.append(Tensor.from_ndarray(np.einsum("abc,b,c->a", arr, w1, w2)))
        rvs.append(rv)
    x0 = TTTensor.random(dims, 2)
    xa = x0.copy()
    xb = x0.copy()
    xe.uq_adf(xa, rvs, sols, max_iterations=40)
    xe.uq_adf(xb, rvs, sols, max_iterations=40, mesh=mesh)
    a = xa.to_tensor().to_ndarray()
    b = xb.to_tensor().to_ndarray()
    assert np.linalg.norm(a - b) / np.linalg.norm(a) < 1e-10


def test_site_sharded_entrywise_product(mesh):
    """Site-axis-sharded Hadamard product == dense oracle, including a
    site count that is not a multiple of the device count
    (parallel/site_ops.py; reference omp loop ttNetwork.cpp:1288-1300)."""
    from xerus_tpu.parallel.site_ops import tt_entrywise_product_sharded
    for d in (6, 11):
        a = TTTensor.random([2] * d, 3)
        b = TTTensor.random([2] * d, 2)
        out = tt_entrywise_product_sharded(
            [c.to_jax() for c in a.components],
            [c.to_jax() for c in b.components], mesh)
        got = TTTensor._make([xe.Tensor.from_jax(c) for c in out])
        got.require_correct_format()
        want = a.to_tensor().to_ndarray() * b.to_tensor().to_ndarray()
        assert np.allclose(got.to_tensor().to_ndarray(), want, atol=1e-12)
        # ranks multiply per bond
        assert all(out[k].shape[2] == a.components[k].dimensions[2]
                   * b.components[k].dimensions[2] for k in range(d - 1))


def test_site_sharded_add(mesh):
    """Site-axis-sharded TT addition (block-diagonal embedding) == dense
    oracle; bond ranks add (ttNetwork.cpp:797-840 semantics)."""
    from xerus_tpu.parallel.site_ops import tt_add_sharded
    for d in (6, 11):
        a = TTTensor.random([2] * d, 3)
        b = TTTensor.random([2] * d, 2)
        out = tt_add_sharded([c.to_jax() for c in a.components],
                             [c.to_jax() for c in b.components], mesh)
        got = TTTensor._make([xe.Tensor.from_jax(c) for c in out])
        got.require_correct_format()
        want = a.to_tensor().to_ndarray() + b.to_tensor().to_ndarray()
        assert np.allclose(got.to_tensor().to_ndarray(), want, atol=1e-12)
        assert all(out[k].shape[2] == a.components[k].dimensions[2]
                   + b.components[k].dimensions[2] for k in range(d - 1))


@pytest.mark.slow
def test_sharded_batched_sweeps_match_unsharded(mesh):
    """dp-sharded batched ALS/DMRG == unsharded batched kernels."""
    import jax.numpy as jnp
    from xerus_tpu.parallel.sharded_ops import (
        sharded_als_half_sweep_batched, sharded_dmrg_half_sweep_batched)
    from xerus_tpu.ops.tt_kernels import als_half_sweep_batched
    from xerus_tpu.ops.dmrg_kernels import dmrg_half_sweep_batched
    from xerus_tpu.ops.tt_kernels import pad_cores
    from xerus_tpu.examples import laplace_operator, heisenberg_mpo

    d, B = 6, 4
    dims = [2] * d
    A = laplace_operator(dims)
    A_cores = tuple(c.to_jax() for c in A.components)
    xs, bs = [], []
    for _ in range(B):
        xi = TTTensor.random(dims, 3)
        xi.canonicalize_left()
        bi = TTTensor.random(dims, 2)
        xs.append([c.to_jax() for c in xi.components])
        bs.append([c.to_jax() for c in bi.components])
    x_batch = [jnp.stack([xs[i][k] for i in range(B)]) for k in range(d)]
    b_batch = [jnp.stack([bs[i][k] for i in range(B)]) for k in range(d)]
    want = als_half_sweep_batched(x_batch, A_cores, b_batch)
    got = sharded_als_half_sweep_batched(x_batch, A_cores, b_batch, mesh)
    for w, g in zip(want, got):
        assert np.allclose(np.asarray(w), np.asarray(g), atol=1e-11)

    H = heisenberg_mpo(d)
    A_np = [np.asarray(c.to_ndarray()) for c in H.components]
    a = max(max(c.shape[0], c.shape[3]) for c in A_np)
    A_stack = np.zeros((d, a, 2, 2, a))
    for k, c in enumerate(A_np):
        A_stack[k, :c.shape[0], :, :, :c.shape[3]] = c
    stacks = []
    for _ in range(B):
        x = TTTensor.random(dims, 8)
        x.move_core(0)
        x /= x.frob_norm()
        s, _ = pad_cores([np.asarray(c.to_ndarray()) for c in x.components])
        stacks.append(s)
    x_stacks = jnp.asarray(np.stack(stacks))
    w_out, w_e = dmrg_half_sweep_batched(x_stacks, jnp.asarray(A_stack), 8,
                                         lobpcg_iters=16)
    g_out, g_e = sharded_dmrg_half_sweep_batched(x_stacks, A_stack, 8, mesh,
                                                 lobpcg_iters=16)
    assert np.allclose(np.asarray(w_e), np.asarray(g_e), atol=1e-10)


def test_adf_mesh_matches_serial(mesh):
    """ADF(mesh=...) dp-shards every iteration's measurement axis; the
    result matches the unsharded solver bit-for-bit-ish (same program,
    GSPMD-partitioned)."""
    xe.set_seed(3)
    truth = TTTensor.random([4] * 5, 2)
    arr = truth.to_tensor().to_ndarray()
    rng = np.random.default_rng(0)
    meas = xe.SinglePointMeasurementSet()
    for p in rng.integers(0, 4, size=(400, 5)):
        meas.add([int(v) for v in p], float(arr[tuple(p)]))
    x1 = TTTensor.random([4] * 5, 2)
    x2 = x1.copy()
    adf = xe.ADFVariant(40, 1e-10, 0.999)
    adf(x1, meas)
    adf(x2, meas, mesh=mesh)
    a1 = x1.to_tensor().to_ndarray()
    a2 = x2.to_tensor().to_ndarray()
    assert np.linalg.norm(a1 - a2) < 1e-9 * np.linalg.norm(a1)


def test_tp_als_half_sweep_matches_serial():
    """Tensor-parallel single-instance ALS half-sweep (SURVEY.md §2.6(b),
    parallel/tp_als.py) == serial whole-sweep kernel, 1-D tp mesh."""
    from jax.sharding import Mesh
    from xerus_tpu.parallel.tp_als import tp_als_half_sweep
    from xerus_tpu.ops.tt_kernels import _als_half_sweep
    from xerus_tpu.examples import laplace_operator

    mesh1d = Mesh(np.array(jax.devices()[:8]), ("tp",))
    dims = [2] * 6
    A = laplace_operator(dims)
    x = TTTensor.random(dims, 3)
    x.canonicalize_left()        # core at 0 (the sweep kernels' contract)
    b = TTTensor.random(dims, 2)
    x_cores = [c.to_jax() for c in x.components]
    A_cores = [c.to_jax() for c in A.components]
    b_cores = [c.to_jax() for c in b.components]

    got = tp_als_half_sweep(x_cores, A_cores, b_cores, mesh1d,
                            cg_iters=200)
    want = _als_half_sweep(tuple(x_cores), tuple(A_cores), tuple(b_cores))

    def full(cores):
        out = np.asarray(cores[0])
        for c in cores[1:]:
            out = np.einsum("...a,anb->...nb", out, np.asarray(c))
        return out.squeeze(axis=(0, -1))

    fw, fg = full(want), full(got)
    assert np.linalg.norm(fw - fg) / np.linalg.norm(fw) < 1e-8


def test_tt_round_tsqr_subspace_matches_gram():
    """GEMM-only subspace truncation in the rank-sharded TSQR rounding
    (no eigh anywhere) matches the gram-eigh variant's error."""
    from jax.sharding import Mesh
    from xerus_tpu.parallel.tsqr_round import tt_round_tsqr

    mesh1d = Mesh(np.array(jax.devices()[:8]), ("tp",))
    t = TTTensor.random([2] * 8, 12) + TTTensor.random([2] * 8, 3)
    cores = [c.to_jax() for c in t.components]
    orig = t.to_tensor().to_ndarray()

    def full(cs):
        out = np.asarray(cs[0])
        for c in cs[1:]:
            out = np.einsum("...a,anb->...nb", out, np.asarray(c))
        return out.squeeze(axis=(0, -1))

    g = tt_round_tsqr(cores, 6, mesh1d, method="gram")
    s = tt_round_tsqr(cores, 6, mesh1d, method="subspace")
    e_g = np.linalg.norm(full(g) - orig)
    e_s = np.linalg.norm(full(s) - orig)
    assert e_s < 1.1 * e_g + 1e-12
    # representable rank: exact
    t2 = TTTensor.random([2] * 8, 4)
    c2 = [c.to_jax() for c in t2.components]
    s2 = tt_round_tsqr(c2, 8, mesh1d, method="subspace")
    assert np.allclose(full(s2), t2.to_tensor().to_ndarray(), atol=1e-9)


def test_sharded_multi_iteration_matches_replicated_chain(mesh):
    """mesh + check_every=K chains K dp-sharded iterations in one program
    (make_adf_multi_iteration_sharded); must equal the replicated K-chain
    bit-for-bit at f64 tolerance (the K>1-with-mesh path of
    algorithms/adf.py)."""
    from xerus_tpu.ops.adf_kernels import (build_onehots,
                                           make_adf_multi_iteration,
                                           make_adf_multi_iteration_sharded)
    import jax.numpy as jnp

    d, n, r, M, K = 5, 3, 3, 48, 4
    tt = TTTensor.random([n] * d, r)
    rng = xe.misc.randomEngine
    P = rng.integers(0, n, size=(M, d))
    vals = jnp.asarray(np.asarray(rng.normal(size=(M,))))
    cores = tuple(c.to_jax() for c in tt.components)
    onehots = build_onehots(P, [n] * d, np.float64)
    shapes_key = tuple(c.shape for c in cores)
    ref_cores, ref_hist = make_adf_multi_iteration(shapes_key, "float64",
                                                   K)(cores, onehots, vals)
    fn = make_adf_multi_iteration_sharded(mesh, shapes_key, "float64", K)
    with mesh:
        got_cores, got_hist = fn(cores, onehots, vals)
    assert np.allclose(np.asarray(got_hist), np.asarray(ref_hist),
                       rtol=1e-12)
    for a, b in zip(got_cores, ref_cores):
        assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-12)


def test_adf_variant_mesh_check_every(mesh):
    """End-to-end ADFVariant with BOTH mesh and check_every>1: the chained
    sharded path must reach the same completion quality as the
    per-iteration path (previously check_every was silently ignored when
    a mesh was passed)."""
    from xerus_tpu.algorithms.adf import ADFVariant
    from xerus_tpu.algorithms.measurements import SinglePointMeasurementSet

    d, n, r, M = 5, 3, 2, 200
    target = TTTensor.random([n] * d, r)
    ms = SinglePointMeasurementSet.random(M, target)

    x1 = TTTensor.random([n] * d, r)
    x2 = x1.copy()  # identical start
    adf = ADFVariant(40, 1e-10, 0.999)
    r1 = adf(x1, ms, mesh=mesh)
    r2 = adf(x2, ms, mesh=mesh, check_every=5)
    assert r2 < 1e-6
    assert abs(r1 - r2) < 1e-6


def test_adf_variant_mesh_device_loop(mesh):
    """check_every="device" with a mesh must dp-shard the measurement
    axis inside the while_loop program (previously the device branch
    silently ignored the mesh) and match the unsharded device loop
    exactly."""
    from xerus_tpu.algorithms.adf import ADFVariant
    from xerus_tpu.algorithms.measurements import SinglePointMeasurementSet

    d, n, r, M = 5, 3, 2, 200
    target = TTTensor.random([n] * d, r)
    ms = SinglePointMeasurementSet.random(M, target)

    x1 = TTTensor.random([n] * d, r)
    x2 = x1.copy()
    adf = ADFVariant(40, 1e-10, 0.999)
    r1 = adf(x1, ms, check_every="device")
    r2 = adf(x2, ms, mesh=mesh, check_every="device")
    assert abs(r1 - r2) < 1e-9 * max(1.0, abs(r1))
    for a, b in zip(x1.components, x2.components):
        assert np.allclose(a.to_ndarray(), b.to_ndarray(), atol=1e-8)


@pytest.mark.slow
def test_tp_als_solve_converges_like_serial():
    """FULL tp-sharded ALS solve to convergence (VERDICT r4 #3): the
    multi-sweep class of bug (env staleness, canonicalization drift
    across psum boundaries) is invisible to the one-half-sweep oracles.
    d=10 Poisson, rank 8, f32: the converged relative residual of
    parallel/tp_als.tp_als_solve over the 8-virtual-device mesh must
    match the serial alternating half-sweep chain's (same start, same
    sweep count).  Reference anchor: ALS convergence oracles,
    unitTests/als.cxx:28-61."""
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from xerus_tpu.parallel.tp_als import tp_als_solve, _reverse_chain
    from xerus_tpu.ops.tt_kernels import _als_half_sweep
    from xerus_tpu.examples import laplace_operator

    mesh1d = Mesh(np.array(jax.devices()[:8]), ("tp",))
    dims = [2] * 10
    A = laplace_operator(dims)
    xe.set_seed(7)
    x0 = TTTensor.random(dims, 8)
    x0.canonicalize_left()          # core at 0 (the sweep kernels' contract)
    b = TTTensor.ones(dims)

    f32 = lambda t: [jnp.asarray(np.asarray(c.to_ndarray(), np.float32))
                     for c in t.components]
    x_cores, A_cores, b_cores = f32(x0), f32(A), f32(b)

    def dense(cores):
        out = np.asarray(cores[0], np.float64)
        for c in cores[1:]:
            out = np.einsum("...a,anb->...nb", out,
                            np.asarray(c, np.float64))
        return out.squeeze(axis=(0, -1))

    A_dense = np.asarray(A.to_tensor().to_ndarray(),
                         np.float64).reshape(2 ** 10, 2 ** 10)
    b_dense = dense(b_cores).reshape(-1)

    def rel_res(cores):
        xd = dense(cores).reshape(-1)
        return (np.linalg.norm(A_dense @ xd - b_dense)
                / np.linalg.norm(b_dense))

    r_start = rel_res(x_cores)
    sweeps = 6
    got = tp_als_solve(x_cores, A_cores, b_cores, mesh1d,
                       num_half_sweeps=sweeps, cg_iters=200)
    r_tp = rel_res(got)

    xs, As, bs = tuple(x_cores), tuple(A_cores), tuple(b_cores)
    reversed_state = False
    for _ in range(sweeps):
        xs = _als_half_sweep(xs, As, bs)
        xs = tuple(_reverse_chain(xs))
        As = tuple(_reverse_chain(As, operator=True))
        bs = tuple(_reverse_chain(bs))
        reversed_state = not reversed_state
    if reversed_state:
        xs = _reverse_chain(xs)
    r_serial = rel_res(xs)

    assert r_tp < 0.05 * r_start            # actually converged
    # same ALS fixed point at matching residual (f32 CG vs f32 Cholesky
    # local solves: small solver-floor slack)
    assert r_tp < 1.25 * r_serial + 1e-5, (r_tp, r_serial)
    assert r_serial < 1.25 * r_tp + 1e-5, (r_tp, r_serial)


@pytest.mark.slow
def test_dryrun_multichip_16_devices_subprocess():
    """Mesh sizes beyond 8 must not hit divisibility walls (round-5 bug:
    tp=4 sharded unconditionally over a phys dim of 2 and device_put
    refused).  dryrun_multichip re-execs itself in a clean 16-device CPU
    subprocess when the live backend is smaller, so this is an
    end-to-end check of every demo sharding spec at dp4 x tp4."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", "/root/repo/__graft_entry__.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    m.dryrun_multichip(16)       # subprocess path (live backend has 8)


def test_tp_als_solve_odd_halfsweeps_orientation():
    """Odd num_half_sweeps ends mid-reversal; the final un-reversal must
    restore forward site order and original core shapes, and the residual
    must still improve (the reversal bookkeeping is the failure mode)."""
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from xerus_tpu.parallel.tp_als import tp_als_solve
    from xerus_tpu.examples import laplace_operator

    mesh1d = Mesh(np.array(jax.devices()[:8]), ("tp",))
    dims = [2] * 6
    A = laplace_operator(dims)
    xe.set_seed(11)
    x0 = TTTensor.random(dims, 3)
    x0.canonicalize_left()
    b = TTTensor.ones(dims)
    f32 = lambda t: [jnp.asarray(np.asarray(c.to_ndarray(), np.float32))
                     for c in t.components]
    xc, Ac, bc = f32(x0), f32(A), f32(b)

    out = tp_als_solve(xc, Ac, bc, mesh1d, num_half_sweeps=3, cg_iters=128)
    assert [tuple(np.asarray(c).shape) for c in out] \
        == [tuple(np.asarray(c).shape) for c in xc]

    def dense(cores):
        r = np.asarray(cores[0], np.float64)
        for c in cores[1:]:
            r = np.einsum("...a,anb->...nb", r, np.asarray(c, np.float64))
        return r.reshape(-1)

    Ad = np.asarray(A.to_tensor().to_ndarray(), np.float64).reshape(64, 64)
    bd = dense(bc)
    res0 = np.linalg.norm(Ad @ dense(xc) - bd) / np.linalg.norm(bd)
    res = np.linalg.norm(Ad @ dense(out) - bd) / np.linalg.norm(bd)
    assert res < 0.2 * res0, (res, res0)
