#!/usr/bin/env python
"""Matmul-precision study on the randomized rounding sweep.

The rank-1024 randomized sweep runs every GEMM at f32-'highest' by
default.  This driver measures what dropping the bulk GEMMs to 'high' or
'default' (reduced-precision matrix-unit modes; TF32 on NVIDIA tensor
cores) buys — and what it costs in truncation quality — using the
precision/gram_precision knobs of ops/tt_kernels._round_randomized.

Methodology
- Timing: chained-loop, median of repeats to completion
  (bench._time_looped).
- Quality: relative truncation error ||X - Xr||_F / ||X||_F measured
  ON DEVICE in f32 via an overflow-safe env sweep over the difference
  TT (block-concatenated cores, per-step normalization).  All variants
  are read out by the SAME jitted program, so any f32 readout bias is
  common mode; the discriminating resolution is ~1e-6 relative, far
  below the ~1e-3 effects under study.
- Instances: bench.py's rank-1024 TT (same seed), target 512,
  oversample 8, cholqr1 panels — the BENCH rank-scaling row — plus a
  decaying-spectrum variant (per-bond geometric damping, the
  cliff-instance construction of bench.py) where truncation error is
  small and mantissa noise cannot hide.

Usage: python benchmarks/bf16_round_study.py [--rank N] [--target N]
Writes one JSON line per (instance, variant) to stdout.

Reference semantics anchor: round(), ttNetwork.cpp:644 (the reference
rounds in f64 always; this study is about how far below f32-'highest'
a device can go while matching the f32 path's task quality).
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

D = 32
N = 2


def _parse_int(flag: str, default: int) -> int:
    for k, a in enumerate(sys.argv):
        if a == flag and k + 1 < len(sys.argv):
            return int(sys.argv[k + 1])
        if a.startswith(flag + "="):
            return int(a.split("=", 1)[1])
    return default


def make_rel_err_fn(shapes, out_shapes):
    """Jitted f32 device program: rel ||X - Y||_F / ||X||_F for TTs of
    fixed shapes, via the scaled env sweep of the difference TT."""
    import jax
    import jax.numpy as jnp

    def rel_err(xs, ys):
        # env sweep over the block TT Z_i = [X_i, -Y_i] (block diag in
        # the middle), normalized per step; and over X alone.
        def log_env(pairs):
            env = None
            log_acc = jnp.zeros((), jnp.float32)
            for c in pairs:
                if env is None:
                    env = jnp.einsum("unU,vnV->uvUV", c, c)[0, 0]
                else:
                    env = jnp.einsum("uv,unU,vnV->UV", env, c, c,
                                     precision="highest")
                nrm = jnp.linalg.norm(env) + 1e-30
                env = env / nrm
                log_acc = log_acc + jnp.log(nrm)
            return 0.5 * (log_acc + jnp.log(jnp.abs(env[0, 0]) + 1e-38))

        zs = []
        d = len(xs)
        for i, (x, y) in enumerate(zip(xs, ys)):
            xl, n, xr = x.shape
            yl, _, yr = y.shape
            sgn = -1.0 if i == 0 else 1.0
            if i == 0:
                z = jnp.concatenate([x, sgn * y], axis=2)
            elif i == d - 1:
                z = jnp.concatenate([x, y], axis=0)
            else:
                top = jnp.concatenate(
                    [x, jnp.zeros((xl, n, yr), x.dtype)], axis=2)
                bot = jnp.concatenate(
                    [jnp.zeros((yl, n, xr), x.dtype), y], axis=2)
                z = jnp.concatenate([top, bot], axis=0)
            zs.append(z)
        return jnp.exp(log_env(zs) - log_env(xs))

    return jax.jit(rel_err)


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

    # decaying-spectrum variant: geometric per-bond damping (the bench
    # cliff construction) so the optimal truncation error is small and
    # precision loss in the projection GEMMs is visible, not masked.
    dec = []
    for i, c in enumerate(cores):
        rl, _, rr = c.shape
        # 0.99: optimal per-bond rel err ~0.99^512 ~ 5.8e-3 at target
        # 512 — above the f32 readout floor, same order as one-bf16-pass
        # noise, so precision loss is DISCRIMINABLE (0.97 would decay to
        # 3e-14 and floor every variant at readout resolution)
        dl = 0.99 ** np.arange(rl, dtype=np.float32)
        dr = 0.99 ** np.arange(rr, dtype=np.float32)
        dec.append(jnp.asarray(c * dl[:, None, None] * dr[None, None, :]))
    dec = tuple(dec)

    rel_fn = None
    variants = [
        ("highest", "highest"),
        ("high", "highest"),
        ("high", "high"),
        ("default", "highest"),
        ("default", "high"),
        ("default", "default"),
    ]

    # variants OUTER, instances INNER: both instances share shapes, so
    # one single-run program per variant serves both.
    results = []
    base_err = {}
    instances = (("random_flat", dev), ("decaying", dec))
    for pP, pG in variants:
        def kernel(cs, pP=pP, pG=pG):
            return _round_randomized(cs, None, target, oversample,
                                     qr_method="cholqr1",
                                     precision=pP, gram_precision=pG)

        once = jax.jit(kernel)
        def timed(inst, kernel=kernel):
            return _bench._time_looped(kernel, inst, iters)

        for inst_name, inst in instances:
            t = timed(inst)
            tfl = flops / t / 1e12
            with jax.enable_x64(False), \
                    jax.default_matmul_precision("highest"):
                out = once(inst)
                if rel_fn is None:
                    rel_fn = make_rel_err_fn(shapes,
                                             [o.shape for o in out])
                err = float(rel_fn(inst, out))
            base_err.setdefault(inst_name, err)
            row = {
                "instance": inst_name, "rank": rank, "target": target,
                "precision": pP, "gram_precision": pG,
                "time_s": round(t, 6), "tflops": round(tfl, 3),
                "rel_trunc_err": f"{err:.6e}",
                "err_vs_highest": round(
                    err / (base_err[inst_name] + 1e-300), 4),
            }
            results.append(row)
            print(json.dumps(row), flush=True)

    with open(os.path.join(_REPO, "benchmarks",
                           f"bf16_round_study_r{rank}.json"), "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
