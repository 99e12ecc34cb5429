#!/usr/bin/env python
"""Structural breakdown of the randomized rounding sweep at rank 1024.

The bf16 study (benchmarks/bf16_round_study.py) measures what the
matmul-precision knobs buy; this driver separates the structural
suspects for the rest of the sweep's wall:

  cholqr1       the shipping panel orthonormalization (Gram + chol +
                trsm with rl*n RHS) — the bf16-study baseline
  cholqr1_invl  trsm against the (l, l) identity once, then the panel
                apply as a GEMM — tests whether the wide-RHS trsm
                is the bottleneck
  none          no orthonormalization at all (INVALID result, timing
                floor): what the sweep costs when it is pure GEMM

All variants run precision='default' on the bulk GEMMs and
gram_precision='high' (the speed preset 'bf16_frontier').  Timing:
chained-loop, median of repeats to completion (bench._time_looped).  Quality (skipped for 'none'): same on-device difference-TT
readout as the bf16 study, on the decaying-spectrum instance where
mantissa effects are visible.

Usage: python benchmarks/round_structure_study.py [--rank N] [--target N]
Writes benchmarks/round_structure_r{rank}.json.
"""

from __future__ import annotations

import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
os.environ.setdefault("XERUS_TPU_NO_X64", "1")

import numpy as np

import bench as _bench
from bench import _make_cores
from bf16_round_study import make_rel_err_fn, _parse_int

D = 32
N = 2


def main() -> None:
    rank = _parse_int("--rank", 1024)
    target = _parse_int("--target", rank // 2)
    oversample = 8
    iters = _parse_int("--iters", 96 if rank >= 1024 else 192)

    from xerus_tpu.config import enable_compile_cache
    enable_compile_cache()

    import jax
    import jax.numpy as jnp
    from xerus_tpu.ops.tt_kernels import (_round_randomized,
                                          randomized_round_flops)

    rng = np.random.Generator(np.random.PCG64(0xBAADF00D))
    cores = _make_cores(rng, D, N, rank, np.float32)
    shapes = [c.shape for c in cores]
    flops = randomized_round_flops(shapes, target, oversample)
    dev = tuple(jnp.asarray(c) for c in cores)

    # decaying-spectrum instance (same construction as the bf16 study)
    dec = []
    for c in cores:
        rl, _, rr = c.shape
        dl = 0.99 ** np.arange(rl, dtype=np.float32)
        dr = 0.99 ** np.arange(rr, dtype=np.float32)
        dec.append(jnp.asarray(c * dl[:, None, None] * dr[None, None, :]))
    dec = tuple(dec)

    rel_fn = None
    base_err = {}
    results = []
    for method in ("cholqr1", "cholqr1_invl", "none"):
        def kernel(cs, method=method):
            return _round_randomized(cs, None, target, oversample,
                                     qr_method=method,
                                     precision="default",
                                     gram_precision="high")

        once = jax.jit(kernel)
        def timed(inst, kernel=kernel):
            return _bench._time_looped(kernel, inst, iters)

        for inst_name, inst in (("random_flat", dev), ("decaying", dec)):
            t = timed(inst)
            row = {"method": method, "instance": inst_name, "rank": rank,
                   "target": target, "time_s": round(t, 6),
                   "tflops": round(flops / t / 1e12, 3)}
            if method != "none":
                with jax.enable_x64(False), \
                        jax.default_matmul_precision("highest"):
                    out = once(inst)
                    if rel_fn is None:
                        rel_fn = make_rel_err_fn(shapes,
                                                 [o.shape for o in out])
                    err = float(rel_fn(inst, out))
                base_err.setdefault(inst_name, err)
                row["rel_trunc_err"] = f"{err:.6e}"
                row["err_vs_cholqr1"] = round(
                    err / (base_err[inst_name] + 1e-300), 4)
            results.append(row)
            print(json.dumps(row), flush=True)

    with open(os.path.join(_REPO, "benchmarks",
                           f"round_structure_r{rank}.json"), "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
