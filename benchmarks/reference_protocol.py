"""The reference's benchmark harness protocol (benchmark.cxx:39-267).

Three least-squares problem families x the solver portfolio, 10 solves
per run, per-solver convergence-rate and end-residual log-histograms
(bases 1.2 / 1.7) merged with any data already on disk under
benchmark/<profile>/<problem>/<solver>_{speed,residual}.tsv — the exact
file layout of the reference, so downstream tooling reads either.

Differences from benchmark.cxx: runs a finite number of rounds
(--rounds, default 1; the reference loops forever), and the profile name
encodes the backend + dtype instead of compile flags (the config here is
runtime, not compile-time — SURVEY.md section 5.6).

Usage: python benchmarks/reference_protocol.py [--rounds N] [--out DIR]
           [--max-steps N] [--gpu] [--problems a,b] [--solvers x,y]

--gpu runs the protocol with the session's GPU as the default device
(profile xerus_tpu_gpu_f64): problem construction under host(), solves
dispatched to the card in the float64 object dtype.  Without it the
protocol runs on the CPU.  The object-level solvers dispatch one
expression at a time, so --max-steps and the --problems/--solvers
filters bound a validation run.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

GPU_MODE = "--gpu" in sys.argv

import jax

if GPU_MODE:
    from xerus_tpu.config import enable_compile_cache
    enable_compile_cache()
    if jax.default_backend() != "gpu":
        sys.exit("--gpu: JAX found no GPU")
else:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import xerus_tpu as xe  # noqa: E402
from xerus_tpu.misc import LogHistogram  # noqa: E402

HISTOGRAM_BASE_CONVERGENCE_RATES = 1.2
HISTOGRAM_BASE_END_RESIDUAL = 1.7
NUM_SOLVES_PER_RUN = 10


class Problem:
    """benchmark.cxx:48-71 LeastSquaresProblem."""

    def __init__(self, name, dims, x_ranks, b_ranks, solvers):
        self.name = name
        self.dims = list(dims)
        self.x_ranks = x_ranks
        self.b_ranks = b_ranks
        self.solvers = solvers

    def get_a(self):
        return xe.TTOperator.identity(self.dims + self.dims)

    def get_x(self):
        x = xe.TTTensor.random(self.dims, self.x_ranks)
        x /= x.frob_norm()
        return x

    def get_b(self):
        b = xe.TTTensor.random(self.dims, self.b_ranks)
        b /= b.frob_norm()
        return b


class RandomProblem(Problem):
    """benchmark.cxx:84-104 ls::random."""

    def __init__(self, name, dims, a_ranks, x_ranks, b_ranks, solvers):
        super().__init__(name, dims, x_ranks, b_ranks, solvers)
        self.a_ranks = a_ranks

    def get_a(self):
        A = xe.TTOperator.random(self.dims + self.dims, self.a_ranks)
        A /= A.frob_norm()
        return A


class SPDRandomProblem(RandomProblem):
    """benchmark.cxx:107-127: A <- A A^T / ||.|| (via indexed expression)."""

    def get_a(self):
        A = xe.TTOperator.random(self.dims + self.dims, self.a_ranks)
        i, j, k = xe.indices(3)
        S = xe.TTOperator()
        S(i / 2, j / 2) << A(i / 2, k / 2) * A(j / 2, k / 2)
        S /= S.frob_norm()
        return S


def _call(variant, A, x, b, perf):
    if A is None:        # approximation family: no operator
        return variant(x, b, perf_data=perf)
    return variant(A, x, b, perf_data=perf)


def als_solver(spd):
    def run(A, x, b, perf):
        variant = xe.ALSVariant(1, 0, xe.ALSVariant.lapack_solver, spd)
        variant.convergenceEpsilon = 1e-8
        return _call(variant, A, x, b, perf)
    return run


MAX_STEPS = 0   # 0 = run to convergence (reference behavior)


def cg_solver(spd):
    def run(A, x, b, perf):
        variant = xe.GeometricCGVariant(MAX_STEPS, 1e-8, spd,
                                        xe.SubmanifoldRetractionI,
                                        xe.ProjectiveVectorTransport)
        return _call(variant, A, x, b, perf)
    return run


def sd_solver(spd, retraction):
    def run(A, x, b, perf):
        variant = xe.SteepestDescentVariant(MAX_STEPS, 1e-8, spd, retraction)
        return _call(variant, A, x, b, perf)
    return run


def approx_wrap(solver):
    """benchmark.cxx:151-159 Approximation_Variant: ignore A."""
    def run(A, x, b, perf):
        return solver(None, x, b, perf)
    return run


def solver_portfolio(spd):
    """benchmark.cxx:130-146 (HOSVD SD is marked //TODO in the reference
    but functional here)."""
    return [
        ("ALS", als_solver(spd)),
        ("CG", cg_solver(spd)),
        ("SteepestDescent_submanifold",
         sd_solver(spd, xe.SubmanifoldRetractionII)),
        ("SteepestDescent_als", sd_solver(spd, xe.ALSRetractionII)),
        ("SteepestDescent_hosvd", sd_solver(spd, xe.HOSVDRetractionII)),
    ]


def problems():
    return [
        Problem("approximation", [2] * 10, 2, 4,
                [(n, approx_wrap(s)) for n, s in solver_portfolio(True)]),
        RandomProblem("random", [2] * 10, 3, 3, 3, solver_portfolio(False)),
        SPDRandomProblem("symmetric_posdef_random", [2] * 10, 2, 3, 3,
                         solver_portfolio(True)),
    ]


def profile_name():
    from xerus_tpu.config import config
    dev = jax.devices()[0].platform
    dtype = "f64" if config.value_dtype == np.float64 else "f32"
    return f"xerus_tpu_{dev}_{dtype}"


def run_solver(solver, A, X, B, speed_hist, residual_hist):
    for i in range(NUM_SOLVES_PER_RUN):
        perf = xe.PerformanceData()
        perf.reset()
        x = X[i].copy()
        try:
            solver(A[i], x, B[i], perf)
        except Exception as e:  # a diverged solve records as residual 1
            print(f"    solve {i} failed: {e}")
            residual_hist.add(1.0)
            continue
        speed_hist += perf.get_histogram(HISTOGRAM_BASE_CONVERGENCE_RATES,
                                         True)
        if perf.data:
            residual_hist.add(max(perf.data[-1].residual, 1e-300))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", default="benchmark")
    ap.add_argument("--max-steps", type=int, default=0,
                    help="cap CG/SD iterations (0 = to convergence, the "
                         "reference's endless-loop behavior; use e.g. 40 "
                         "for a bounded validation run)")
    ap.add_argument("--gpu", action="store_true",
                    help="solve on the GPU (see module docstring)")
    ap.add_argument("--problems", default="",
                    help="comma-separated problem-family filter")
    ap.add_argument("--solvers", default="",
                    help="comma-separated solver-name filter")
    args = ap.parse_args()
    global MAX_STEPS
    MAX_STEPS = args.max_steps
    want_p = {p for p in args.problems.split(",") if p}
    want_s = {s for s in args.solvers.split(",") if s}
    from xerus_tpu.config import host
    profile = profile_name()
    print(f"running profile {profile}")
    for _ in range(args.rounds):
        for prob in problems():
            if want_p and prob.name not in want_p:
                continue
            with host():   # object-level construction off the device
                A = [prob.get_a() for _ in range(NUM_SOLVES_PER_RUN)]
                X = [prob.get_x() for _ in range(NUM_SOLVES_PER_RUN)]
                B = [prob.get_b() for _ in range(NUM_SOLVES_PER_RUN)]
            for sname, solver in prob.solvers:
                if want_s and sname not in want_s:
                    continue
                print(f"  solving {prob.name} with {sname}")
                t0 = time.perf_counter()
                speed = LogHistogram(HISTOGRAM_BASE_CONVERGENCE_RATES)
                residual = LogHistogram(HISTOGRAM_BASE_END_RESIDUAL)
                run_solver(solver, A, X, B, speed, residual)
                d = os.path.join(args.out, profile, prob.name)
                os.makedirs(d, exist_ok=True)
                for hist, kind in ((speed, "speed"), (residual, "residual")):
                    path = os.path.join(d, f"{sname}_{kind}.tsv")
                    if os.path.exists(path):
                        hist += LogHistogram.read_from_file(path)
                    hist.dump_to_file(path)
                print(f"    {time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    main()
