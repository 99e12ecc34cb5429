"""All five BASELINE.json workloads, end to end, one JSON line each.

Unlike bench.py (the kernel benchmark), this exercises the full
object-level API the way a user would; it runs on the CPU or a GPU.

  1. TT-SVD + rank-truncated rounding of a dense random order-6 tensor
  2. Indexed einsum chain suite with contraction-order optimization
  3. ALS solve of the d=10 Poisson TTOperator system
  4. Two-site DMRG ground state of the d=32 Heisenberg chain (adaptive rank)
  5. ADF completion + largest-entry search

Usage: python benchmarks/all_workloads.py [--cpu|--gpu] [--only N[,M...]]

Each workload re-seeds (0xBAADF00D + workload index) so the instances are
IDENTICAL across modes (BASELINE.md measurement rules).

--gpu runs the SAME instances with the solver fast paths dispatched to the
card (round_fast / the fused ALS program / lanczos-DMRG / the ADF device
solve) and object-level prep pinned to the host.  Each device kernel is
warmed once before timing; the warm (compile) time is reported separately
as "warm_s".
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    import jax
    jax.config.update("jax_platforms", "cpu")

GPU_MODE = "--gpu" in sys.argv
if GPU_MODE:
    import jax
    from xerus_tpu.config import enable_compile_cache
    enable_compile_cache()
    if jax.default_backend() != "gpu":
        sys.exit("--gpu: JAX found no GPU")

import numpy as np

# --only 3 / --only 1,5 / --only=1,5: run a subset of the five workloads
# (each block re-seeds independently, so subsets measure the identical
# instances).
_ONLY = None
for _k, _a in enumerate(sys.argv):
    if _a == "--only" or _a.startswith("--only="):
        if "=" in _a:
            _v = _a.split("=", 1)[1]
        elif _k + 1 < len(sys.argv):
            _v = sys.argv[_k + 1]
        else:
            sys.exit("usage: --only N[,M...] with N in 1..5")
        _ONLY = {int(x) for x in _v.split(",") if x.strip()}
        if not _ONLY or not _ONLY <= {1, 2, 3, 4, 5}:
            sys.exit(f"usage: --only N[,M...] with N in 1..5 (got {_v!r})")


def _want(n: int) -> bool:
    return _ONLY is None or n in _ONLY


def main() -> None:
    import xerus_tpu as xe
    from xerus_tpu import Tensor, TTTensor, TTOperator
    from xerus_tpu.examples import laplace_operator, heisenberg_mpo
    from xerus_tpu.config import host

    results = []

    # -- workload 1: TT-SVD + rounding of dense order-6 tensor ----------
    if _want(1):
        xe.set_seed(0xBAADF00D + 1)
        with host():
            dense = Tensor.random([8] * 6)
        if GPU_MODE:
            # FULL task on device: the exact unfolding TT costs no FLOPs
            # (identity reshapes + one data reshape), so round_fast performs
            # the entire TT-SVD truncation inside the device kernels — the
            # timed section covers the complete decomposition, matching the
            # CPU side's TTSVD+round scope (it previously timed only the
            # rounding of a host-computed TT-SVD)
            tt_w = TTTensor.from_dense_unfolding(dense)
            t0 = time.perf_counter()
            tt_w.round_fast(16, method="svd")      # warm (compile) run
            warm = time.perf_counter() - t0
            t0 = time.perf_counter()
            tt = TTTensor.from_dense_unfolding(dense)
            tt.round_fast(16, method="svd")
            secs = time.perf_counter() - t0
            with host():
                err = (tt.to_tensor() - dense).frob_norm() / dense.frob_norm()
            results.append({"workload": "ttsvd_round_order6_n8",
                            "seconds": round(secs, 3), "warm_s": round(warm, 1),
                            "rel_err_at_rank16": f"{err:.3e}",
                            "ranks": tt.ranks(),
                            "mode": "gpu unfolding + round_fast(svd), full task"})
        else:
            t0 = time.perf_counter()
            tt = TTTensor(dense, eps=0.0)
            tt.round(16)
            err = (tt.to_tensor() - dense).frob_norm() / dense.frob_norm()
            results.append({"workload": "ttsvd_round_order6_n8",
                            "seconds": round(time.perf_counter() - t0, 3),
                            "rel_err_at_rank16": f"{err:.3e}",
                            "ranks": tt.ranks()})

    # -- workload 2: indexed einsum chain suite -------------------------
    if _want(2):
        xe.set_seed(0xBAADF00D + 2)

        def dsl_suite():
            """The full indexed-expression suite through the object DSL —
            the SAME code path both backends (VERDICT r2 item #4: same
            granularity both sides; reference path
            indexedTensorReadOnly.cpp:290-324).  Returns (wall_s, out, ref):
            wall includes operand construction, DSL dispatch and evaluation,
            exactly like the CPU branch always did."""
            t0 = time.perf_counter()
            i, j, k, l, m = xe.indices(5)
            B = Tensor.random([40, 30, 20])
            C = Tensor.random([30, 40, 20])
            A = Tensor()
            A(i, j) << B(i, k, l) * C(k, j, l)
            chain = [Tensor.random([30, 30]) for _ in range(8)]
            out = Tensor()
            idxs = xe.indices(9)
            expr = chain[0](idxs[0], idxs[1])
            for p in range(1, 8):
                expr = expr * chain[p](idxs[p], idxs[p + 1])
            out(idxs[0], idxs[8]) << expr
            wall = time.perf_counter() - t0
            ref = np.asarray(chain[0].to_ndarray(), np.float64)
            for p in range(1, 8):
                ref = ref @ np.asarray(chain[p].to_ndarray(), np.float64)
            return wall, out.to_ndarray(), ref

        if GPU_MODE:
            # the object DSL's evaluation is a cached jitted einsum; the GPU
            # number times the SAME contraction suite as one chained-loop
            # device program in f32 (bench.py methodology)
            import jax.numpy as jnp
            from bench import _time_looped
            rng = np.random.Generator(np.random.PCG64(0xBAADF00D + 2))
            B = rng.normal(size=(40, 30, 20)).astype(np.float32)
            C = rng.normal(size=(30, 40, 20)).astype(np.float32)
            chain = [rng.normal(size=(30, 30)).astype(np.float32)
                     for _ in range(8)]

            def suite(inputs):
                Bv, Cv, *ch = inputs
                A = jnp.einsum("ikl,kjl->ij", Bv, Cv)
                out = ch[0]
                for c in ch[1:]:
                    out = out @ c
                return (A, out)

            t0 = time.perf_counter()
            # the whole suite is microseconds of device work: 16384 chained
            # iterations put the loop wall well above the dispatch cost
            per = _time_looped(suite, (jnp.asarray(B), jnp.asarray(C),
                                       *map(jnp.asarray, chain)), 16384)
            warm = time.perf_counter() - t0
            ref1 = np.einsum("ikl,kjl->ij", B.astype(np.float64),
                             C.astype(np.float64))
            # correctness at the same kernel discipline the loop timed
            # (matmul precision 'highest': true f32 products)
            import jax as _jax
            with _jax.enable_x64(False), _jax.default_matmul_precision("highest"):
                got = np.asarray(suite((jnp.asarray(B), jnp.asarray(C),
                                        *map(jnp.asarray, chain)))[0])
            ok = bool(np.allclose(got, ref1, rtol=1e-4, atol=1e-2))
            # the honest same-granularity number (VERDICT r2 item #4): the
            # identical object-DSL suite, dispatch included.  Warm once (the
            # two einsum programs compile), then time.
            dsl_warm, _, _ = dsl_suite()
            xe.set_seed(0xBAADF00D + 2)     # identical instance to the CPU run
            dsl_wall, out_arr, dsl_ref = dsl_suite()
            dsl_ok = bool(np.allclose(np.asarray(out_arr, np.float64), dsl_ref,
                                      rtol=1e-4, atol=1e-2))
            results.append({"workload": "einsum_chain_suite",
                            "seconds": round(dsl_wall, 3),
                            "warm_s": round(dsl_warm, 1),
                            "correct": dsl_ok,
                            "kernel_per_suite_s": round(per, 9),
                            "kernel_warm_s": round(warm, 1),
                            "kernel_correct": ok,
                            "mode": "gpu object DSL wall (dispatch included); "
                                    "chained-loop kernel as sub-metric"})
        else:
            wall, out_arr, ref = dsl_suite()
            ok = bool(np.allclose(out_arr, ref, atol=1e-10))
            results.append({"workload": "einsum_chain_suite",
                            "seconds": round(wall, 3),
                            "correct": ok})

    # -- workload 3: d=10 Poisson ALS solve ------------------------------
    if _want(3):
        xe.set_seed(0xBAADF00D + 3)
        dims = [2] * 10
        with host():
            Aop = laplace_operator(dims)
            b = TTTensor.ones(dims)
            x0 = TTTensor.random(dims, 6)
        if GPU_MODE:
            xw = x0.copy()
            t0 = time.perf_counter()
            xe.als_spd_fused(Aop, xw, b)           # warm (compile) run
            warm = time.perf_counter() - t0
            x = x0.copy()
            t0 = time.perf_counter()
            # the whole mixed-precision solve (f32 while_loop to the plateau
            # + df finish, f64-quality residual) as ONE device program —
            # same recipe as the d=32 north star (BASELINE.md quality rule)
            x, _hist = xe.als_spd_fused(Aop, x, b)
            secs = time.perf_counter() - t0
            with host():
                from xerus_tpu.tt.ttnetwork import apply_operator
                res64 = float((apply_operator(Aop, x) - b).frob_norm()
                              / b.frob_norm())
            results.append({"workload": "als_poisson_d10",
                            "seconds": round(secs, 3), "warm_s": round(warm, 1),
                            "relative_residual": f"{res64:.3e}",
                            "ranks": x.ranks(),
                            "mode": "gpu fused f32-while_loop + df32 program"})
        else:
            x = x0.copy()
            t0 = time.perf_counter()
            resid = xe.ALS_SPD(Aop, x, b, 1e-12)
            results.append({"workload": "als_poisson_d10",
                            "seconds": round(time.perf_counter() - t0, 3),
                            "relative_residual": f"{resid:.3e}",
                            "ranks": x.ranks()})

    # -- workload 4: two-site DMRG Heisenberg ground state (d=32) -------
    if _want(4):
        xe.set_seed(0xBAADF00D + 4)
        d = 32
        with host():
            H = heisenberg_mpo(d)
            g0 = TTTensor.random([2] * d, 4)
        if GPU_MODE:
            # shift=0.0: the Heisenberg ground energy is known negative, so
            # skip the auto lambda_max estimation phase (2 extra half-sweep
            # dispatches + the projector-carrying kernel variant)
            gw = g0.copy()
            t0 = time.perf_counter()
            xe.smallest_eigenvalue(H, gw, sites=2, max_rank=16, num_sweeps=6,
                                   shift=0.0)
            warm = time.perf_counter() - t0
            g = g0.copy()
            t0 = time.perf_counter()
            lam = xe.smallest_eigenvalue(H, g, sites=2, max_rank=16,
                                         num_sweeps=6, shift=0.0)
            secs = time.perf_counter() - t0
            with host():
                Hg = xe.apply_operator(H, g)
                var = (Hg - lam * g).frob_norm()
            results.append({"workload": "dmrg_heisenberg_d32",
                            "seconds": round(secs, 3), "warm_s": round(warm, 1),
                            "ground_energy": round(lam, 8),
                            "eig_residual": f"{var:.3e}",
                            "max_rank": max(g.ranks()),
                            "mode": "gpu lanczos scan kernel"})
        else:
            g = g0.copy()
            t0 = time.perf_counter()
            lam = xe.smallest_eigenvalue(H, g, sites=2, max_rank=16,
                                         num_sweeps=6, solver="exact")
            Hg = xe.apply_operator(H, g)
            var = (Hg - lam * g).frob_norm()
            results.append({"workload": "dmrg_heisenberg_d32",
                            "seconds": round(time.perf_counter() - t0, 3),
                            "ground_energy": round(lam, 8),
                            "eig_residual": f"{var:.3e}",
                            "max_rank": max(g.ranks())})

    # -- workload 5: ADF completion + largest entry ----------------------
    if _want(5):
        xe.set_seed(0xBAADF00D + 5)
        dims = [4] * 5
        with host():
            truth = TTTensor.random(dims, 3)
            truth /= truth.frob_norm()
            ms = xe.SinglePointMeasurementSet.random(400, dims)
            ms.measure(truth)
            xc0 = TTTensor.random(dims, 1)  # rank-adaptive start (adf.cpp:589)
        variant = xe.ADFVariant(400, 1e-8, 0.9999)
        if GPU_MODE:
            xw = xc0.copy()
            t0 = time.perf_counter()
            # check_every="device": the whole fixed-rank solve is ONE
            # lax.while_loop program per rank level (stopping logic
            # in-program, adf_kernels.make_adf_device_run) — one dispatch
            # per rank level instead of one per 8 iterations
            variant(xw, ms, max_ranks=[3] * 4, check_every="device")  # warm
            warm = time.perf_counter() - t0
            xc = xc0.copy()
            t0 = time.perf_counter()
            resid = variant(xc, ms, max_ranks=[3] * 4, check_every="device")
            pos = xe.find_largest_entry(xc, accuracy=0.05)
            secs = time.perf_counter() - t0
            arr = np.abs(xc.to_tensor().to_ndarray()).reshape(-1)
            results.append({"workload": "adf_completion_largest_entry",
                            "seconds": round(secs, 3), "warm_s": round(warm, 1),
                            "sample_residual": f"{resid:.3e}",
                            "recovery_err_vs_truth": f"{ms.test(xc):.3e}",
                            "found_entry_frac_of_max": round(
                                float(arr[pos] / arr.max()), 4),
                            "mode": "gpu ADF while_loop device solve"})
        else:
            xc = xc0.copy()
            t0 = time.perf_counter()
            resid = variant(xc, ms, max_ranks=[3] * 4)
            pos = xe.find_largest_entry(xc, accuracy=0.05)
            arr = np.abs(xc.to_tensor().to_ndarray()).reshape(-1)
            results.append({"workload": "adf_completion_largest_entry",
                            "seconds": round(time.perf_counter() - t0, 3),
                            "sample_residual": f"{resid:.3e}",
                            "recovery_err_vs_truth": f"{ms.test(xc):.3e}",
                            "found_entry_frac_of_max": round(
                                float(arr[pos] / arr.max()), 4)})

    for r in results:
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
