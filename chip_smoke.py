"""On-card smoke run of the public solver path on one NVIDIA GPU.

    python chip_smoke.py           # phases 0-6 on one card
    python chip_smoke.py --multi   # the multi-device paths on four cards

Phases (one process on the card at any time):

  0  on-card tests: ``python -m pytest -m gpu tests/`` as a child process,
     before this process touches a JAX backend;
  1  the device: name, count, JAX version, compile cache, power limit;
  2  QTT Poisson d=32 rank-30 ALS solve (``xe.ALS_SPD``, native f64) with
     the host-f64 residual, plus the double-word ``xe.als_spd_fused``;
  3  Heisenberg d=32 ground state (``xe.smallest_eigenvalue``, solver
     chosen automatically) against the same call on the CPU device;
  4  TT rounding d=32 rank 256 -> 128 (``round_fast``, f64) against the
     numpy/LAPACK chain, and the f32 randomized kernel at 1024 -> 512;
  5  ADF completion + largest-entry search against the CPU device;
  6  TT evaluation at 2^20 points, the double-word refined solve and the
     certified GEMM-only truncation step, at real widths.

Every phase prints one JSON line with its first-call time (compile
included), the median of 3 warm runs timed to completion, its correctness
numbers beside their bounds, and the card.  The last line is
``{"ok": true, "device": {...}}``; any failure exits non-zero without it.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0xBAADF00D

# instance sizes: the largest the repository runs (a rehearsal on the CPU
# may shrink them before calling the phase functions directly)
POISSON_D, POISSON_RANK = 32, 30
DMRG_D, DMRG_RANK = 32, 16
ROUND_D, ROUND_RANK, ROUND_BIG = 32, 256, 1024
EVAL_M, DF_N = 1 << 20, 1800


class PhaseError(RuntimeError):
    pass


def _nvidia_smi() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise PhaseError(f"nvidia-smi unavailable: {e}") from e
    if r.returncode != 0 or not r.stdout.strip():
        raise PhaseError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


def phase0_gpu_tests() -> dict:
    """The ``gpu``-marked tests, in a child that exits before this process
    reserves the card.  tests/conftest.py keeps the CPU unless
    XERUS_TEST_ON_GPU=1."""
    env = dict(os.environ, XERUS_TEST_ON_GPU="1")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "pytest", "-m", "gpu", "tests/",
                        "-q", "-p", "no:cacheprovider", "-p", "no:randomly"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    tail = r.stdout.strip().splitlines()[-1:] or [r.stderr.strip()[-300:]]
    if r.returncode != 0:
        sys.stdout.write(r.stdout[-6000:])
        sys.stderr.write(r.stderr[-3000:])
        raise PhaseError(f"gpu tests failed (rc={r.returncode}): {tail[0]}")
    return {"phase": 0, "name": "gpu_tests", "seconds": time.perf_counter() - t0,
            "summary": tail[0]}


# ---------------------------------------------------------------- helpers

class Card:
    """The device every phase reports beside its numbers."""

    def __init__(self, smi: str):
        import jax
        self.dev = jax.devices()[0]
        self.tag = {"platform": self.dev.platform, "kind": self.dev.device_kind,
                    "count": len(jax.devices()),
                    "nvidia_smi": smi.splitlines()[0]}

    def stats(self) -> dict:
        return self.dev.memory_stats() or {}

    def holds(self, arr) -> bool:
        return arr.devices() == {self.dev}


def _sync(out):
    import jax
    return jax.block_until_ready(out)


def timed(fn, reps: int = 3):
    """(result of the last call, first-call seconds, median warm seconds).
    The first call includes compilation; every call ends in a
    block_until_ready (or returns host values)."""
    t0 = time.perf_counter()
    out = _sync(fn())
    first = time.perf_counter() - t0
    warm = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = _sync(fn())
        warm.append(time.perf_counter() - t0)
    return out, first, statistics.median(warm)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def run_phase(card: Card, number: int, name: str, body) -> dict:
    """Run one phase; record the card's allocation counters around it so a
    phase whose hot kernels silently ran on the CPU cannot pass."""
    before = card.stats().get("num_allocs", 0)
    t0 = time.perf_counter()
    rec = body()
    seconds = time.perf_counter() - t0
    after = card.stats()
    rec = {"phase": number, "name": name, "phase_seconds": seconds, **rec,
           "gpu_allocs": after.get("num_allocs", 0) - before,
           "gpu_peak_bytes": after.get("peak_bytes_in_use"),
           "device": card.tag}
    check(rec["gpu_allocs"] > 0, f"phase {number}: no allocation on the GPU")
    print(json.dumps(rec, default=float), flush=True)
    return rec


def _np_cores(tt):
    import numpy as np
    return [np.asarray(c.to_ndarray(), np.float64) for c in tt.components]


def _tt_rel_diff(a, b) -> float:
    """||a - b|| / ||b|| for two TTs (lists of (rl, n, rr) cores), host f64."""
    import numpy as np
    from bench import host_log_norm
    d = len(a)
    z = []
    for k in range(d):
        x = np.asarray(a[k], np.float64)
        y = np.asarray(b[k], np.float64) * (-1.0 if k == 0 else 1.0)
        if k == 0:
            z.append(np.concatenate([x, y], axis=2))
        elif k == d - 1:
            z.append(np.concatenate([x, y], axis=0))
        else:
            top = np.concatenate([x, np.zeros(x.shape[:2] + y.shape[2:])], 2)
            bot = np.concatenate([np.zeros(y.shape[:2] + x.shape[2:]), y], 2)
            z.append(np.concatenate([top, bot], axis=0))
    return float(np.exp(host_log_norm(z) - host_log_norm(b)))


# ----------------------------------------------------------------- phases

def phase2_poisson(card: Card) -> dict:
    import numpy as np
    import xerus_tpu as xe
    from xerus_tpu.examples import laplace_operator
    from bench import _host_poisson_residual
    dims = [2] * POISSON_D
    xe.set_seed(SEED)
    with xe.host():
        A = laplace_operator(dims)
        b = xe.TTTensor.ones(dims)
        x0 = xe.TTTensor.random(dims, POISSON_RANK)
    A64, b64 = [np.asarray(c.to_ndarray()) for c in A.components], _np_cores(b)

    def native():
        x = x0.copy()
        xe.ALS_SPD(A, x, b, 1e-12)
        return x

    x, first, warm = timed(native)
    res = _host_poisson_residual(_np_cores(x), A64, b64)
    check(res <= 1e-10, f"ALS_SPD host-f64 residual {res:.3e} > 1e-10")
    (xf, _hist), f_first, f_warm = timed(lambda: xe.als_spd_fused(A, x0, b))
    f_res = _host_poisson_residual(_np_cores(xf), A64, b64)
    check(np.isfinite(f_res), "als_spd_fused residual not finite")
    return {"instance": "laplace_operator([2]*32), ones rhs, rank-30 start",
            "als_spd_f64": {"first_call_s": first, "warm_median_s": warm,
                            "residual_f64": res, "bound": 1e-10,
                            "ranks_max": max(x.ranks())},
            "als_spd_fused_df32": {"first_call_s": f_first,
                                   "warm_median_s": f_warm,
                                   "residual_f64": f_res}}


def phase3_heisenberg(card: Card) -> dict:
    import jax
    import numpy as np
    import xerus_tpu as xe
    from xerus_tpu.examples import heisenberg_mpo
    from xerus_tpu.config import on_accelerator
    from xerus_tpu.ops import dmrg_kernels
    d, rank = DMRG_D, DMRG_RANK
    with xe.host():
        H = heisenberg_mpo(d)
        xe.set_seed(SEED + 1)
        g0 = xe.TTTensor.random([2] * d, rank)

    def solve():
        g = g0.copy()
        return g, xe.smallest_eigenvalue(H, g, max_rank=rank)

    check(on_accelerator(), "solver=None would not pick lanczos")
    runs_before = dmrg_kernels.make_dmrg_run.cache_info().currsize
    (g, lam), first, warm = timed(solve)
    check(dmrg_kernels.make_dmrg_run.cache_info().currsize > runs_before,
          "smallest_eigenvalue(solver=None) did not take the lanczos kernel")
    with xe.host():
        eig_res = (xe.apply_operator(H, g) - lam * g).frob_norm()
    t0 = time.perf_counter()
    with jax.default_device(jax.devices("cpu")[0]):
        _g_cpu, lam_cpu = solve()
    cpu_s = time.perf_counter() - t0
    rel = abs(lam - lam_cpu) / abs(lam_cpu)
    check(rel <= 1e-8, f"|dE|/|E| = {rel:.3e} > 1e-8 vs the CPU run")
    return {"instance": "heisenberg_mpo(32), rank-16 start, max_rank=16",
            "solver": "lanczos", "first_call_s": first, "warm_median_s": warm,
            "energy": lam, "energy_cpu": lam_cpu, "rel_energy_diff": rel,
            "bound": 1e-8, "eig_residual_f64": eig_res,
            "cpu_reference_s": cpu_s, "ranks_max": max(g.ranks())}


def phase4_rounding(card: Card) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import xerus_tpu as xe
    from xerus_tpu.core.tensor import Tensor
    from functools import partial
    from xerus_tpu.ops.tt_kernels import (
        _round_randomized_scan, make_randomized_round_scan, pad_cores,
        res_rank, tt_round_sweep_segmented)
    from bench import _make_cores, cpu_round_sweep, host_log_norm
    rng = np.random.Generator(np.random.PCG64(SEED))
    host = _make_cores(rng, ROUND_D, 2, ROUND_RANK, np.float64)
    target, big_target = ROUND_RANK // 2, ROUND_BIG // 2
    ref = cpu_round_sweep(host, target)
    e_ref = _tt_rel_diff(ref, host)

    def round_f64():
        t = xe.TTTensor._make([Tensor.from_ndarray(c) for c in host])
        t.round_fast(target, method="svd")
        return t

    t, first, warm = timed(round_f64)
    e64 = _tt_rel_diff(_np_cores(t), host)
    gap64 = abs(e64 - e_ref) / e_ref
    check(gap64 <= 1e-8, f"f64 truncation error {e64} vs LAPACK {e_ref}")

    # f32 deterministic kernel, matmul precision 'highest' (jit_f32); the
    # log-norm relative error |log||x|| - log||ref||| / |log||ref||| is
    # bench.py's f32_vs_f64_log_norm_rel_err
    dev32 = [jnp.asarray(c, jnp.float32) for c in host]
    out32 = tt_round_sweep_segmented(dev32, target)
    check(card.holds(out32[0]), "f32 rounding output is not on the card")
    lognorm_ref = host_log_norm(ref)
    dln32 = abs(host_log_norm([np.asarray(c, np.float64) for c in out32])
                - lognorm_ref)
    ln32 = dln32 / abs(lognorm_ref)
    check(ln32 <= 1e-4, f"f32 segmented log-norm rel error {ln32:.3e} > 1e-4")

    # randomized kernel of round_fast(method="randomized") at rank
    # 1024 -> 512, f32 against f64.  The randomized truncation is only
    # quasi-optimal, so its reference is the same kernel in f64: both draw
    # the same f32 sketch and differ by their arithmetic alone.
    big = _make_cores(rng, ROUND_D, 2, ROUND_BIG, np.float64)
    stacked64, _ = pad_cores(big)
    stacked32 = stacked64.astype(jnp.float32)
    shape = tuple(stacked64.shape)
    k64 = make_randomized_round_scan(shape, big_target, 8, "float64")
    k32 = make_randomized_round_scan(shape, big_target, 8, "float32")

    def unpad(out):
        """The scan's padded (Qs, final) cut to the logical TT shapes."""
        qs, final = out
        d = ROUND_D
        cores = []
        for i in range(d):
            rl = 1 if i == 0 else res_rank(i, d, 2, big_target)
            rr = 1 if i == d - 1 else res_rank(i + 1, d, 2, big_target)
            c = qs[i] if i < d - 1 else final
            cores.append(np.asarray(c[:rl, :, :rr], np.float64))
        return cores

    ln_r64 = host_log_norm(unpad(_sync(k64(stacked64))))
    r32, r_first, r_warm = timed(lambda: k32(stacked32))
    check(card.holds(r32[1]), "randomized output is not on the card")
    d_hi = abs(host_log_norm(unpad(r32)) - ln_r64)
    err_hi = d_hi / abs(ln_r64)
    check(err_hi <= 1e-4,
          f"rank-1024 f32 log-norm rel error {err_hi:.3e} > 1e-4")
    # the same f32 kernel traced at the default matmul precision (TF32 on
    # the card's tensor cores) instead of jit_f32's 'highest'
    with jax.enable_x64(False), jax.default_matmul_precision("default"):
        r_tf32 = _sync(jax.jit(partial(
            _round_randomized_scan, target_rank=big_target, oversample=8,
            qr_method="householder"))(stacked32))
    d_tf32 = abs(host_log_norm(unpad(r_tf32)) - ln_r64)
    return {"instance": "d=32 n=2 random TT (bench._make_cores)",
            "round_fast_svd_f64_256to128": {
                "first_call_s": first, "warm_median_s": warm,
                "trunc_err": e64, "trunc_err_lapack": e_ref,
                "rel_gap": gap64, "bound": 1e-8},
            "segmented_f32_highest_256to128": {
                "log_norm_rel_err": ln32, "log_norm_abs_diff": dln32,
                "bound": 1e-4, "reference": "numpy/LAPACK f64 chain"},
            "randomized_f32_1024to512": {
                "first_call_s": r_first, "warm_median_s": r_warm,
                "log_norm_rel_err_highest": err_hi,
                "log_norm_abs_diff_highest": d_hi, "bound": 1e-4,
                "log_norm_rel_err_default_precision": d_tf32 / abs(ln_r64),
                "log_norm_abs_diff_default_precision": d_tf32,
                "reference": "same kernel in f64 on the card"}}


def phase5_completion(card: Card) -> dict:
    import jax
    import numpy as np
    import xerus_tpu as xe
    dims = [4] * 5
    with xe.host():
        xe.set_seed(SEED + 5)
        truth = xe.TTTensor.random(dims, 3)
        truth /= truth.frob_norm()
        ms = xe.SinglePointMeasurementSet.random(400, dims)
        ms.measure(truth)
        x0 = xe.TTTensor.random(dims, 1)
        dense_truth = truth.to_tensor().to_ndarray()

    def solve():
        xe.set_seed(SEED + 6)          # the rank bumps draw from it
        x = x0.copy()
        resid = xe.ADF(x, ms, max_ranks=[3] * 4)
        pos = xe.find_largest_entry(x, accuracy=0.05)
        return x, resid, pos

    (x, resid, pos), first, warm = timed(solve)
    with jax.default_device(jax.devices("cpu")[0]):
        x_cpu, resid_cpu, pos_cpu = solve()

    def recovery(t):
        return float(np.linalg.norm(t.to_tensor().to_ndarray() - dense_truth)
                     / np.linalg.norm(dense_truth))

    rec, rec_cpu = recovery(x), recovery(x_cpu)
    flat = np.abs(dense_truth).reshape(-1)
    check(rec <= 1e-6, f"recovery error {rec:.3e} > 1e-6")
    check(pos == pos_cpu, f"largest entry {pos} != CPU's {pos_cpu}")
    return {"instance": "dims [4]*5, truth rank 3, 400 samples, max rank 3",
            "first_call_s": first, "warm_median_s": warm,
            "sample_residual": resid, "recovery_err": rec,
            "recovery_err_cpu": rec_cpu, "bound": 1e-6,
            "largest_entry": int(pos), "largest_entry_cpu": int(pos_cpu),
            "entry_frac_of_max": float(flat[pos] / flat.max())}


def phase6_replacements(card: Card) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import xerus_tpu as xe
    from xerus_tpu.algorithms.measurements import _evaluate_tt_at_points
    from xerus_tpu.ops import df32
    from xerus_tpu.ops import tt_kernels as tk
    out = {}

    # TT evaluation at 2^20 points: batched gather + contraction
    dims, rank, M = [4] * 10, 16, EVAL_M
    with xe.host():
        xe.set_seed(SEED + 7)
        tt = xe.TTTensor.random(dims, rank)
    rng = np.random.default_rng(SEED)
    P = rng.integers(0, 4, size=(M, len(dims)))
    vals, first, warm = timed(lambda: _evaluate_tt_at_points(tt, P))
    cores = _np_cores(tt)
    sub = rng.choice(M, 4096, replace=False)
    F = np.ones((sub.size, 1))
    for k, c in enumerate(cores):
        F = np.einsum("ma,amb->mb", F, c[:, P[sub, k], :])
    err = float(np.max(np.abs(vals[sub] - F[:, 0])) / np.max(np.abs(F)))
    check(err <= 1e-12, f"TT evaluation error {err:.3e}")
    out["evaluate_tt_at_points_M2^20"] = {
        "first_call_s": first, "warm_median_s": warm, "max_rel_err": err,
        "bound": 1e-12, "note": "object call incl. host transfer of values"}

    # df refined SPD solve at the ALS local-system size, 1800^2
    n = DF_N
    g = rng.standard_normal((n, n)) / np.sqrt(n)
    A = g @ g.T + np.eye(n)
    bvec = rng.standard_normal(n)
    Ah, Al = df32.df_from_f64(A)
    bh, bl = df32.df_from_f64(bvec)
    solve = jax.jit(df32.df_solve_spd_refined)
    (xh, xl), first, warm = timed(lambda: solve(Ah, Al, bh, bl))
    check(card.holds(xh), "df solve output is not on the card")
    x = df32.df_to_f64(xh, xl)
    res = float(np.linalg.norm(A @ x - bvec) / np.linalg.norm(bvec))
    check(res <= 1e-10, f"df refined solve residual {res:.3e}")
    out["df_solve_spd_refined_1800"] = {"first_call_s": first,
                                        "warm_median_s": warm,
                                        "residual_f64": res, "bound": 1e-10}

    # certified GEMM-only truncation step at the bench's bond shape
    B, Mc, cap, keep = 256, 512, 128, 96
    U, _ = np.linalg.qr(rng.standard_normal((B, B)))
    V, _ = np.linalg.qr(rng.standard_normal((Mc, B)))
    s = np.concatenate([np.linspace(10.0, 1.0, keep), np.full(B - keep, 1e-6)])
    cur = jnp.asarray((U * s) @ V.T, jnp.float32)
    step = tk.jit_f32(lambda c: tk._trunc_step_gemm_exact(
        c, keep, cap, jnp.float32, 1e-30))
    (us, vt), first, warm = timed(lambda: step(cur))
    check(card.holds(us), "gemm_exact output is not on the card")
    A64 = np.asarray(cur, np.float64)
    sv = np.linalg.svd(A64, compute_uv=False)
    e = np.linalg.norm(A64 - np.asarray(us, np.float64)
                       @ np.asarray(vt, np.float64)) ** 2 / np.sum(sv ** 2)
    e_opt = float(np.sum(sv[keep:] ** 2) / np.sum(sv ** 2))
    check(abs(e - e_opt) <= 5e-6, f"gemm_exact error {e} vs optimal {e_opt}")
    out["gemm_exact_xla_256x512"] = {"first_call_s": first,
                                     "warm_median_s": warm,
                                     "trunc_err": float(e),
                                     "trunc_err_svd": e_opt, "bound": 5e-6}
    return out


def phase_multi(card: Card) -> dict:
    """tp-sharded ALS solve, rank-sharded TSQR rounding and dp-sharded ADF
    on default_mesh(4), each against its one-card result."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import xerus_tpu as xe
    from xerus_tpu.examples import laplace_operator
    from xerus_tpu.parallel.mesh import default_mesh
    from xerus_tpu.parallel.tp_als import tp_als_solve, _reverse_chain
    from xerus_tpu.parallel.tsqr_round import tt_round_tsqr
    from xerus_tpu.ops.tt_kernels import (_als_half_sweep, jit_f32,
                                          tt_round_sweep_uniform)
    from bench import _host_poisson_residual, _make_cores
    check(len(jax.devices()) >= 4, "--multi needs four devices")
    mesh = default_mesh(4)
    devices = list(mesh.devices.flat)
    check(len(set(devices)) == 4, f"mesh holds {len(set(devices))} devices")
    allocs_before = _allocs(devices)
    one = jax.devices()[0]
    out = {"mesh": dict(mesh.shape)}

    # tp_als_solve on the phase-2 Poisson instance (f32 kernels)
    dims = [2] * POISSON_D
    xe.set_seed(SEED)
    with xe.host():
        A = laplace_operator(dims)
        b = xe.TTTensor.ones(dims)
        x0 = xe.TTTensor.random(dims, POISSON_RANK)
        x0.canonicalize_left()
    f32 = lambda t: [np.asarray(c.to_ndarray(), np.float32)
                     for c in t.components]
    xc, Ac, bc = f32(x0), f32(A), f32(b)
    A64, b64 = [np.asarray(c.to_ndarray()) for c in A.components], _np_cores(b)
    sweeps = 4
    tp_out, first, warm = timed(lambda: tp_als_solve(
        xc, Ac, bc, mesh, num_half_sweeps=sweeps, cg_iters=128))
    with jax.default_device(one):
        serial = tuple(jnp.asarray(c) for c in xc)
        As, bs = tuple(jnp.asarray(c) for c in Ac), \
            tuple(jnp.asarray(c) for c in bc)
        rev = False
        sweep = jit_f32(_als_half_sweep)
        for _ in range(sweeps):
            serial = tuple(_reverse_chain(sweep(serial, As, bs)))
            As = tuple(_reverse_chain(As, operator=True))
            bs = tuple(_reverse_chain(bs))
            rev = not rev
        if rev:
            serial = _reverse_chain(serial)
    r_tp = _host_poisson_residual([np.asarray(c, np.float64) for c in tp_out],
                                  A64, b64)
    r_one = _host_poisson_residual([np.asarray(c, np.float64) for c in serial],
                                   A64, b64)
    check(r_tp <= 1.25 * r_one + 1e-5 and r_one <= 1.25 * r_tp + 1e-5,
          f"tp_als residual {r_tp:.3e} vs one card {r_one:.3e}")
    out["tp_als_solve"] = {"first_call_s": first, "warm_median_s": warm,
                           "residual_f64": r_tp, "residual_one_card": r_one}

    # rank-sharded TSQR rounding 256 -> 128 (f64)
    rng = np.random.Generator(np.random.PCG64(SEED))
    host = _make_cores(rng, ROUND_D, 2, ROUND_RANK, np.float64)
    ts, first, warm = timed(lambda: [jnp.asarray(c) for c in tt_round_tsqr(
        [jnp.asarray(c) for c in host], ROUND_RANK // 2, mesh)])
    with jax.default_device(one):
        ref1 = tt_round_sweep_uniform([jnp.asarray(c) for c in host],
                                      ROUND_RANK // 2, method="gram")
    e_ts = _tt_rel_diff([np.asarray(c) for c in ts], host)
    e_one = _tt_rel_diff([np.asarray(c) for c in ref1], host)
    check(abs(e_ts - e_one) <= 1e-8 * e_one,
          f"tsqr truncation error {e_ts} vs one card {e_one}")
    out["tt_round_tsqr_256to128"] = {"first_call_s": first,
                                     "warm_median_s": warm,
                                     "trunc_err": e_ts,
                                     "trunc_err_one_card": e_one}

    # dp-sharded ADF (xe.ADF, an ADFVariant) on the phase-5 instance
    dims = [4] * 5
    with xe.host():
        xe.set_seed(SEED + 5)
        truth = xe.TTTensor.random(dims, 3)
        truth /= truth.frob_norm()
        ms = xe.SinglePointMeasurementSet.random(400, dims)
        ms.measure(truth)
        x0 = xe.TTTensor.random(dims, 1)
        dense_truth = truth.to_tensor().to_ndarray()

    def adf(**kw):
        xe.set_seed(SEED + 6)          # the rank bumps draw from it
        x = x0.copy()
        xe.ADF(x, ms, max_ranks=[3] * 4, **kw)
        return x

    x_dp, first, warm = timed(lambda: adf(mesh=mesh))
    with jax.default_device(one):
        x_one = adf()
    a1, a2 = x_one.to_tensor().to_ndarray(), x_dp.to_tensor().to_ndarray()
    diff = float(np.linalg.norm(a1 - a2) / np.linalg.norm(a1))
    rec = float(np.linalg.norm(a2 - dense_truth) / np.linalg.norm(dense_truth))
    # both runs stop at a 1e-8 sample residual; their iterates may differ
    # by the summation order of the sharded gradient, at that scale
    check(rec <= 1e-6, f"dp ADF recovery error {rec:.3e} > 1e-6")
    check(diff <= 1e-6, f"dp ADF differs from one card by {diff:.3e}")
    out["adf_dp"] = {"first_call_s": first, "warm_median_s": warm,
                     "recovery_err": rec, "rel_diff_one_card": diff,
                     "bound": 1e-6}
    new_allocs = [a - b for a, b in zip(_allocs(devices), allocs_before)]
    out["allocs_per_device"] = new_allocs
    check(all(n > 0 for n in new_allocs),
          f"not every mesh device allocated: {new_allocs}")
    return out


def _allocs(devices) -> list:
    """Allocation counters of each device (every device of the mesh must
    have held sharded data for the multi-device phase to pass)."""
    return [(d.memory_stats() or {}).get("num_allocs", 0) for d in devices]


def _keep_cpu_backend() -> None:
    """The CPU references (phases 3 and 5, the gpu tests) need the CPU
    backend beside the GPU one when JAX_PLATFORMS names platforms."""
    plat = os.environ.get("JAX_PLATFORMS", "")
    if plat and "cpu" not in plat.split(","):
        os.environ["JAX_PLATFORMS"] = plat + ",cpu"


def main(argv) -> int:
    multi = "--multi" in argv
    try:
        smi = _nvidia_smi()
        _keep_cpu_backend()
        if not multi:
            print(json.dumps(phase0_gpu_tests()), flush=True)
        import jax
        if jax.default_backend() != "gpu":
            raise PhaseError(f"JAX backend is {jax.default_backend()!r}, "
                             "not a GPU")
        try:
            from xerus_tpu.config import enable_compile_cache
        except ImportError as e:
            raise PhaseError(f"xerus_tpu is not importable: {e}") from e
        cache = enable_compile_cache()
        card = Card(smi)
        print(smi, flush=True)
        print(json.dumps({"phase": 1, "name": "device", **card.tag,
                          "jax": jax.__version__, "compile_cache": cache,
                          "jax_platforms": os.environ.get("JAX_PLATFORMS")}),
              flush=True)
        if multi:
            run_phase(card, 7, "multi_device", lambda: phase_multi(card))
        else:
            for number, name, body in (
                    (2, "poisson_als", phase2_poisson),
                    (3, "heisenberg_dmrg", phase3_heisenberg),
                    (4, "tt_rounding", phase4_rounding),
                    (5, "completion", phase5_completion),
                    (6, "kernel_replacements", phase6_replacements)):
                run_phase(card, number, name, lambda b=body: b(card))
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    dev = card.dev
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
