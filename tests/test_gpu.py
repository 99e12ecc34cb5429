"""Main-path kernels at real widths on an NVIDIA GPU.

Every test compares the card's result with a plain reference: the same
jitted kernel on the CPU device, or numpy/LAPACK in float64.  Without a
card every test skips (the ``gpu`` fixture decides, never at import);
``python chip_smoke.py`` runs them on the card as its phase 0.
"""

import numpy as np
import pytest

import xerus_tpu as xe
from xerus_tpu import TTTensor

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run `python chip_smoke.py` on a "
                    "machine with one)")
    return jax.devices()[0]


def _cpu():
    import jax
    return jax.devices("cpu")[0]


def _on(dev, fn, *args):
    """fn(*args) with every input placed on ``dev``; results to numpy."""
    import jax
    with jax.default_device(dev):
        out = fn(*jax.device_put(args, dev))
        return jax.tree.map(np.asarray, jax.block_until_ready(out))


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


def test_als_spd_solve_f64_matches_cpu(gpu):
    """d=32 rank-30 QTT Poisson solve (xe.ALS_SPD, dense 1800x1800 local
    Cholesky solves) in native f64 on the card and on the CPU device: both
    reach the 1e-10 residual and represent the same solution.  (The cores
    themselves are compared only through the represented tensor: the
    solution has far lower rank than 30, so the orthonormal frames carry
    arbitrary completions.)"""
    import jax
    from xerus_tpu.examples import laplace_operator
    dims = [2] * 32
    with xe.host():
        A = laplace_operator(dims)
        b = TTTensor.ones(dims)
        x0 = TTTensor.random(dims, 30)

    def solve(dev):
        x = x0.copy()
        with jax.default_device(dev):
            xe.ALS_SPD(A, x, b, 1e-12)
        with xe.host():
            return x, (xe.apply_operator(A, x) - b).frob_norm() / b.frob_norm()

    x_gpu, res_gpu = solve(gpu)
    x_cpu, res_cpu = solve(_cpu())
    assert res_gpu < 1e-10 and res_cpu < 1e-10
    with xe.host():
        assert (x_gpu - x_cpu).frob_norm() < 1e-9 * x_cpu.frob_norm()


def test_dmrg_lanczos_half_sweep_f64_matches_cpu(gpu):
    """d=32 rank-16 Heisenberg two-site Lanczos half-sweep in f64: the
    energy on the card matches the CPU device."""
    from xerus_tpu.examples import heisenberg_mpo
    from xerus_tpu.ops.dmrg_kernels import (make_dmrg_sweep_lobpcg,
                                            _pad_operator_stack)
    from xerus_tpu.ops.tt_kernels import pad_cores
    d, rank = 32, 16
    with xe.host():
        H = heisenberg_mpo(d)
        x = TTTensor.random([2] * d, rank)
        x.move_core(0)
        x /= x.frob_norm()
        stack, r = pad_cores([np.asarray(c.to_ndarray())
                              for c in x.components])
        A_stack = _pad_operator_stack(
            [np.asarray(c.to_ndarray()) for c in H.components], np.float64)
    stack = np.asarray(stack)
    fn = make_dmrg_sweep_lobpcg(tuple(stack.shape), int(r), "float64", 32,
                                "lanczos")
    _, e_gpu = _on(gpu, fn, stack, A_stack)
    _, e_cpu = _on(_cpu(), fn, stack, A_stack)
    assert abs(float(e_gpu) - float(e_cpu)) <= 1e-9 * abs(float(e_cpu))


def test_segmented_svd_round_f64_matches_lapack(gpu):
    """d=32 rank-256 -> 128 deterministic rounding in f64 on the card:
    truncation error equal to the numpy/LAPACK QR+SVD chain's."""
    import jax.numpy as jnp
    from xerus_tpu.ops.tt_kernels import tt_round_sweep_segmented
    rng = np.random.default_rng(0)
    cores = []
    d, rank = 32, 256
    for i in range(d):
        rl = 1 if i == 0 else min(rank, 2 ** i, 2 ** (d - i))
        rr = 1 if i == d - 1 else min(rank, 2 ** (i + 1), 2 ** (d - i - 1))
        cores.append(rng.standard_normal((rl, 2, rr)) / np.sqrt(rank))
    out = tt_round_sweep_segmented([jnp.asarray(c) for c in cores], 128)
    assert out[10].devices() == {gpu}
    got = [np.asarray(c) for c in out]
    # reference: right-to-left LAPACK SVD chain after a left QR sweep
    ref = [c.copy() for c in cores]
    for i in range(d - 1):
        rl, n, rr = ref[i].shape
        q, rmat = np.linalg.qr(ref[i].reshape(rl * n, rr))
        ref[i] = q.reshape(rl, n, -1)
        ref[i + 1] = np.einsum("ab,bnc->anc", rmat, ref[i + 1])
    for i in range(d - 1, 0, -1):
        rl, n, rr = ref[i].shape
        u, s, vt = np.linalg.svd(ref[i].reshape(rl, n * rr),
                                 full_matrices=False)
        k = min(128, s.size)
        ref[i] = vt[:k].reshape(k, n, rr)
        ref[i - 1] = np.einsum("anb,bk->ank", ref[i - 1], u[:, :k] * s[:k])

    def gram_norm(cs):
        env = np.ones((1, 1))
        log = 0.0
        for c in cs:
            env = np.einsum("uv,unU,vnV->UV", env, c, c)
            nrm = np.linalg.norm(env)
            env, log = env / nrm, log + np.log(nrm)
        return 0.5 * log

    assert abs(gram_norm(got) - gram_norm(ref)) < 1e-10


def test_evaluate_tt_at_points_large_m(gpu):
    """TT evaluation at 2^18 points (gather + contraction) against numpy
    f64 on a sample of them."""
    from xerus_tpu.algorithms.measurements import _evaluate_tt_at_points
    dims, rank, M = [4] * 10, 32, 1 << 18
    with xe.host():
        tt = TTTensor.random(dims, rank)
    rng = np.random.default_rng(1)
    P = rng.integers(0, 4, size=(M, len(dims)))
    vals = np.asarray(_evaluate_tt_at_points(tt, P))
    cores = [np.asarray(c.to_ndarray()) for c in tt.components]
    sub = rng.choice(M, 2048, replace=False)
    F = np.ones((sub.size, 1))
    for k, c in enumerate(cores):
        F = np.einsum("ma,amb->mb", F, c[:, P[sub, k], :])
    assert np.max(np.abs(vals[sub] - F[:, 0])) <= 1e-12 * np.max(np.abs(F))


def test_df_refined_solve_1800(gpu):
    """Double-word refined SPD solve at the ALS local-system size."""
    import jax
    from xerus_tpu.ops import df32
    n = 1800
    rng = np.random.default_rng(2)
    g = rng.standard_normal((n, n)) / np.sqrt(n)
    A = g @ g.T + np.eye(n)
    b = rng.standard_normal(n)
    xh, xl = jax.jit(df32.df_solve_spd_refined)(*df32.df_from_f64(A),
                                                *df32.df_from_f64(b))
    assert xh.devices() == {gpu}
    x = df32.df_to_f64(xh, xl)
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-10


def test_gemm_exact_step_matches_svd(gpu):
    """Certified GEMM-only truncation (XLA branch) at 256x512 on the card
    against the optimal truncation from numpy's f64 SVD."""
    import jax.numpy as jnp
    from xerus_tpu.ops import tt_kernels as tk
    B, M, cap, keep = 256, 512, 128, 96
    rng = np.random.default_rng(3)
    U, _ = np.linalg.qr(rng.standard_normal((B, B)))
    V, _ = np.linalg.qr(rng.standard_normal((M, B)))
    s = np.concatenate([np.linspace(10.0, 1.0, keep), np.full(B - keep, 1e-6)])
    cur = jnp.asarray((U * s) @ V.T, jnp.float32)
    step = tk.jit_f32(lambda c: tk._trunc_step_gemm_exact(
        c, keep, cap, jnp.float32, 1e-30))
    us, vt = step(cur)
    assert us.devices() == {gpu}
    A64 = np.asarray(cur, np.float64)
    sv = np.linalg.svd(A64, compute_uv=False)
    err = (np.linalg.norm(A64 - np.asarray(us, np.float64)
                          @ np.asarray(vt, np.float64)) ** 2
           / np.sum(sv ** 2))
    assert abs(err - np.sum(sv[keep:] ** 2) / np.sum(sv ** 2)) < 5e-6


def test_jit_f32_matmul_is_true_f32(gpu):
    """jit_f32 traces at precision 'highest': a 2048^2 f32 product on the
    card agrees with f64 to f32 roundoff (TF32 would miss by ~1e-3)."""
    import jax.numpy as jnp
    from xerus_tpu.ops.tt_kernels import jit_f32
    rng = np.random.default_rng(4)
    a = rng.standard_normal((2048, 2048))
    b = rng.standard_normal((2048, 2048))
    got = jit_f32(lambda x, y: x @ y)(jnp.asarray(a, jnp.float32),
                                      jnp.asarray(b, jnp.float32))
    assert got.dtype == jnp.float32 and got.devices() == {gpu}
    assert _rel(np.asarray(got, np.float64), a @ b) < 1e-5
