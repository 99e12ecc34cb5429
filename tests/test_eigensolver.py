"""DMRG/ALS ground-state eigensolver tests (BASELINE.json config 4)."""

import numpy as np
import pytest

import xerus_tpu as xe
from xerus_tpu import TTTensor
from xerus_tpu.examples import heisenberg_mpo, laplace_operator
from xerus_tpu.algorithms import smallest_eigenvalue


def test_heisenberg_mpo_structure():
    d = 6
    H = heisenberg_mpo(d)
    assert H.ranks() == [5] * (d - 1)
    Hm = H.to_tensor().to_ndarray().reshape(2 ** d, 2 ** d)
    assert np.allclose(Hm, Hm.T, atol=1e-14)
    # two-site check: H for d=2 is Jx/2(S+S- + S-S+) + Jz SzSz
    H2 = heisenberg_mpo(2).to_tensor().to_ndarray().reshape(4, 4)
    Sp = np.array([[0, 1], [0, 0.]]); Sm = Sp.T
    Sz = 0.5 * np.diag([1, -1.])
    ref = 0.5 * (np.kron(Sp, Sm) + np.kron(Sm, Sp)) + np.kron(Sz, Sz)
    assert np.allclose(H2, ref, atol=1e-14)


def test_dmrg_ground_state_matches_exact():
    d = 8
    H = heisenberg_mpo(d)
    Hm = H.to_tensor().to_ndarray().reshape(2 ** d, 2 ** d)
    exact = np.linalg.eigvalsh(Hm)[0]
    x = TTTensor.random([2] * d, 4)
    lam = smallest_eigenvalue(H, x, sites=2, max_rank=16)
    assert abs(lam - exact) < 1e-10
    xv = x.to_tensor().to_ndarray().reshape(-1)
    assert np.linalg.norm(Hm @ xv - lam * xv) < 1e-9
    assert np.isclose(np.linalg.norm(xv), 1.0, atol=1e-10)


def test_single_site_eigensolver():
    d = 6
    H = heisenberg_mpo(d)
    Hm = H.to_tensor().to_ndarray().reshape(2 ** d, 2 ** d)
    exact = np.linalg.eigvalsh(Hm)[0]
    # single-site cannot adapt rank: give it enough to represent the state
    x = TTTensor.random([2] * d, 8)
    lam = smallest_eigenvalue(H, x, sites=1, num_sweeps=30)
    assert abs(lam - exact) < 1e-8


def test_dmrg_adaptive_rank_grows():
    d = 10
    H = heisenberg_mpo(d)
    x = TTTensor.random([2] * d, 2)
    lam = smallest_eigenvalue(H, x, sites=2, max_rank=12, num_sweeps=6)
    assert max(x.ranks()) > 2  # rank adapted upward
    assert np.isfinite(lam)


def test_laplace_smallest_eigenvalue():
    """Laplace MPO smallest eigenvalue: known 1D spectrum composition."""
    d = 4
    n = 3
    A = laplace_operator([n] * d)
    Am = A.to_tensor().to_ndarray().reshape(n ** d, n ** d)
    exact = np.linalg.eigvalsh(Am)[0]
    x = TTTensor.random([n] * d, 4)
    lam = smallest_eigenvalue(A, x, sites=2, max_rank=8)
    assert abs(lam - exact) < 1e-9


def test_fast_dmrg_kernel_matches_exact():
    """Whole-sweep jitted DMRG kernel (ops/dmrg_kernels.py)."""
    from xerus_tpu.ops.dmrg_kernels import dmrg_groundstate_fast
    d = 8
    H = heisenberg_mpo(d)
    Hm = H.to_tensor().to_ndarray().reshape(2 ** d, 2 ** d)
    exact = np.linalg.eigvalsh(Hm)[0]
    x = TTTensor.random([2] * d, 16)
    lam = dmrg_groundstate_fast(H, x, num_half_sweeps=14, conv_eps=1e-13)
    assert abs(lam - exact) < 1e-10
    xv = x.to_tensor().to_ndarray().reshape(-1)
    assert np.linalg.norm(Hm @ xv - lam * xv) < 1e-9


def test_scan_dmrg_kernel_matches_exact():
    """Scan-based DMRG (one compiled eigh body, pad-to-max-rank)."""
    from xerus_tpu.ops.dmrg_kernels import dmrg_groundstate_scan
    d = 8
    H = heisenberg_mpo(d)
    Hm = H.to_tensor().to_ndarray().reshape(2 ** d, 2 ** d)
    exact = np.linalg.eigvalsh(Hm)[0]
    x = TTTensor.random([2] * d, 16)
    lam = dmrg_groundstate_scan(H, x, num_half_sweeps=14, conv_eps=1e-13)
    assert abs(lam - exact) < 1e-10
    xv = x.to_tensor().to_ndarray().reshape(-1)
    assert np.linalg.norm(Hm @ xv - lam * xv) < 1e-9


@pytest.mark.slow
def test_dmrg_scan_lanczos_and_lobpcg_match_exact():
    """Matrix-free local solvers (ops/dmrg_kernels.py _lanczos_smallest /
    _lobpcg_smallest) must reach the same ground state as the dense-eigh
    scan kernel; at full rank (d=8, rank 16) all three match exact
    diagonalization."""
    from xerus_tpu.ops.dmrg_kernels import dmrg_groundstate_scan
    d = 8
    H = heisenberg_mpo(d)
    Hm = H.to_tensor().to_ndarray().reshape(2 ** d, 2 ** d)
    e_exact = np.linalg.eigvalsh(Hm)[0]
    for solver, iters in [("lanczos", 32), ("lobpcg", 40)]:
        x = TTTensor.random([2] * d, 16)
        e = dmrg_groundstate_scan(H, x, num_half_sweeps=10, solver=solver,
                                  lobpcg_iters=iters)
        assert abs(e - e_exact) < 1e-8, (solver, e, e_exact)
    with pytest.raises(ValueError):
        dmrg_groundstate_scan(H, TTTensor.random([2] * d, 4),
                              solver="davidson")


def test_smallest_eigenvalue_lanczos_path():
    """Public entry xe.smallest_eigenvalue(solver='lanczos') routes to the
    matrix-free scan kernel, rank-bumping the start if needed."""
    d = 8
    H = heisenberg_mpo(d)
    Hm = H.to_tensor().to_ndarray().reshape(2 ** d, 2 ** d)
    e_exact = np.linalg.eigvalsh(Hm)[0]
    x = TTTensor.random([2] * d, 2)       # below max_rank: bump path
    lam = xe.smallest_eigenvalue(H, x, sites=2, num_sweeps=6,
                                 max_rank=16, solver="lanczos")
    assert abs(lam - e_exact) < 1e-7, (lam, e_exact)
    # non-uniform dims rejected
    with pytest.raises(ValueError):
        xe.smallest_eigenvalue(
            xe.TTOperator.identity([2, 3, 2, 3]),
            TTTensor.random([2, 3], 2), solver="lanczos")


@pytest.mark.slow
def test_dmrg_half_sweep_batched_matches_serial():
    """Throughput-mode vmapped DMRG half-sweep == per-instance serial
    sweeps (make_dmrg_sweep_batched, ops/dmrg_kernels.py)."""
    import jax.numpy as jnp
    from xerus_tpu.ops.dmrg_kernels import (dmrg_half_sweep_batched,
                                            make_dmrg_sweep_lobpcg)
    from xerus_tpu.ops.tt_kernels import pad_cores

    d, rank = 6, 8
    H = heisenberg_mpo(d)
    A_np = [np.asarray(c.to_ndarray()) for c in H.components]
    a = max(max(c.shape[0], c.shape[3]) for c in A_np)
    n = A_np[0].shape[1]
    A_stack = np.zeros((d, a, n, n, a))
    for k, c in enumerate(A_np):
        A_stack[k, :c.shape[0], :, :, :c.shape[3]] = c
    A_stack = jnp.asarray(A_stack)

    B = 3
    stacks = []
    for _ in range(B):
        x = TTTensor.random([2] * d, rank)
        x.move_core(0)
        x /= x.frob_norm()
        s, r = pad_cores([np.asarray(c.to_ndarray()) for c in x.components])
        stacks.append(jnp.asarray(s))
    x_stacks = jnp.stack(stacks)

    out, energies = dmrg_half_sweep_batched(x_stacks, A_stack, rank,
                                            solver="lanczos",
                                            lobpcg_iters=24)
    serial_fn = make_dmrg_sweep_lobpcg(tuple(stacks[0].shape), rank,
                                       str(stacks[0].dtype), 24, "lanczos")

    def state(stack):
        # contract the padded core stack to the full 2^d vector
        v = np.asarray(stack[0][:1])            # (1, n, r)
        for k in range(1, d):
            v = np.einsum("...a,anb->...nb", v, np.asarray(stack[k]))
        v = v[..., 0].reshape(-1)
        return v / np.linalg.norm(v)

    for i in range(B):
        want_stack, want_e = serial_fn(stacks[i], A_stack)
        # the cores carry gauge/Krylov-rotation freedom; the invariants are
        # the energy and the represented state (up to global sign)
        assert abs(float(energies[i]) - float(want_e)) < 1e-10
        overlap = abs(float(np.dot(state(out[i]), state(want_stack))))
        assert overlap > 1.0 - 1e-9, (i, overlap)


@pytest.mark.slow
def test_multistart_eigensolver_matches_exact():
    """num_starts > 1 races independent initializations in one batched
    program per half-sweep (dmrg_groundstate_multistart); the winner
    reaches the exact ground energy."""
    d = 8
    H = heisenberg_mpo(d)
    Hm = H.to_tensor().to_ndarray().reshape(2 ** d, 2 ** d)
    exact = np.linalg.eigvalsh(Hm)[0]
    x = TTTensor.random([2] * d, 16)
    e = smallest_eigenvalue(H, x, solver="lanczos", num_starts=4,
                            max_rank=16)
    assert abs(e - exact) < 1e-8
    xv = x.to_tensor().to_ndarray().reshape(-1)
    assert np.linalg.norm(Hm @ xv - e * xv) < 1e-8


@pytest.mark.slow
def test_shifted_dmrg_psd_operator_all_solvers():
    """PSD operator (ground energy > 0): the padded frames' spurious zero
    eigenvalues beat the true ground unless the kernel solves (A - s*P)
    with the carried true-subspace projector (ops/dmrg_kernels.py).  The
    auto shift (shift=None) estimates lambda_max by running the SAME
    compiled kernel on -A (one negated MPO core) and must recover the
    exact smallest eigenvalue for every scan solver."""
    from xerus_tpu.ops.dmrg_kernels import dmrg_groundstate_scan

    d, n = 6, 4
    A = laplace_operator([n] * d)
    Ad = A.to_tensor().to_ndarray().reshape(n ** d, n ** d)
    exact = np.linalg.eigvalsh(Ad)[0]
    assert exact > 0  # the regression scenario: PSD ground
    for solver in ("lanczos", "lobpcg", "eigh"):
        x = TTTensor.random([n] * d, 8)
        e = dmrg_groundstate_scan(A, x, num_half_sweeps=10, solver=solver,
                                  lobpcg_iters=32, shift=None)
        assert abs(e - exact) < 1e-9, (solver, e, exact)
        xv = x.to_tensor().to_ndarray().reshape(-1)
        assert np.linalg.norm(Ad @ xv - e * xv) < 1e-7, solver


def test_shifted_dmrg_explicit_shift_and_negative_ground():
    """shift=0.0 keeps the cheaper unshifted kernel (valid for negative
    ground energies — Heisenberg); an explicit shift > lambda_min works
    on the PSD Laplace without the estimation phase."""
    from xerus_tpu.ops.dmrg_kernels import dmrg_groundstate_scan

    d = 6
    H = heisenberg_mpo(d)
    Hm = H.to_tensor().to_ndarray().reshape(2 ** d, 2 ** d)
    exact_h = np.linalg.eigvalsh(Hm)[0]
    x = TTTensor.random([2] * d, 8)
    e = dmrg_groundstate_scan(H, x, num_half_sweeps=10, solver="lanczos",
                              lobpcg_iters=32, shift=0.0)
    assert abs(e - exact_h) < 1e-9

    n = 4
    A = laplace_operator([n] * d)
    Ad = A.to_tensor().to_ndarray().reshape(n ** d, n ** d)
    exact = np.linalg.eigvalsh(Ad)[0]
    lam_max = np.linalg.eigvalsh(Ad)[-1]
    x = TTTensor.random([n] * d, 8)
    e = dmrg_groundstate_scan(A, x, num_half_sweeps=10, solver="lanczos",
                              lobpcg_iters=32, shift=float(1.05 * lam_max))
    assert abs(e - exact) < 1e-9


@pytest.mark.slow
def test_shifted_multistart_psd():
    """Auto-shifted multistart race on the PSD Laplace."""
    from xerus_tpu.ops.dmrg_kernels import dmrg_groundstate_multistart

    d, n = 6, 4
    A = laplace_operator([n] * d)
    Ad = A.to_tensor().to_ndarray().reshape(n ** d, n ** d)
    exact = np.linalg.eigvalsh(Ad)[0]
    x = TTTensor.random([n] * d, 8)
    e = dmrg_groundstate_multistart(A, x, num_starts=3, num_half_sweeps=10,
                                    shift=None)
    assert abs(e - exact) < 1e-9


@pytest.mark.slow
def test_dmrg_device_run_matches_host_loop():
    """make_dmrg_run (the whole solve as ONE lax.while_loop program) must
    reproduce the per-sweep host loop exactly: same energy at every sweep
    prefix and the same final stack orientation."""
    import jax.numpy as jnp
    from xerus_tpu.examples import heisenberg_mpo
    from xerus_tpu.ops.dmrg_kernels import (
        make_dmrg_run, make_dmrg_sweep_lobpcg, _pad_operator_stack,
        _rev_x_stack, _rev_A_stack)
    from xerus_tpu.ops.tt_kernels import pad_cores

    d = 10
    H = heisenberg_mpo(d)
    g = TTTensor.random([2] * d, 6)
    g.move_core(0)
    g /= g.frob_norm()
    x_stack, r = pad_cores([np.asarray(c.to_ndarray())
                            for c in g.components])
    x_stack = jnp.asarray(x_stack.astype(np.float32))
    A_np = [np.asarray(c.to_ndarray()).astype(np.float32)
            for c in H.components]
    A_stack = _pad_operator_stack(A_np, np.float32)

    fn = make_dmrg_sweep_lobpcg(tuple(x_stack.shape), int(r), "float32",
                                24, "lanczos", shifted=False)
    xs, As = x_stack, A_stack
    hist = []
    for _ in range(6):
        xs, e = fn(xs, As)
        last = xs[d - 1]
        nl = jnp.linalg.norm(last)
        xs = xs.at[d - 1].set(last / jnp.maximum(nl, 1e-30))
        hist.append(float(e))
        xs = _rev_x_stack(xs)
        As = _rev_A_stack(As)

    run = make_dmrg_run(tuple(x_stack.shape), int(r), "float32", "lanczos",
                        24, False, 64)
    for rem in (1, 3, 6):
        xs2, e2, cnt = run(x_stack, A_stack, jnp.float32(0.0),
                           jnp.float32(1e-12), jnp.asarray(rem, jnp.int32),
                           jnp.float32(np.inf))
        assert int(cnt) == rem
        assert abs(float(e2) - hist[rem - 1]) <= 1e-6 * abs(hist[rem - 1])
    # final orientation: host loop ends reversed after an even count and
    # un-reverses; the program un-reverses odd counts internally
    xs_host = _rev_x_stack(xs) if (6 % 2 == 1) else xs
    assert np.allclose(np.asarray(xs_host), np.asarray(xs2), atol=1e-5)
