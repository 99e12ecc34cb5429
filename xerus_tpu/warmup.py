"""Kernel pre-compilation for a problem family.

First compiles of the whole-sweep kernels take seconds to minutes; this
helper compiles the hot whole-sweep kernels
for given dimensions/ranks up front — e.g. at job start, before timing-
critical work — by executing each kernel once on small random data of the
right shape.  Compilations also land in the persistent compilation cache
when the persistent cache is on (config.enable_compile_cache), so later processes
skip the XLA work entirely.

The reference needs no analogue (C++ is ahead-of-time compiled); this is
the JAX answer to its "no warm-up needed" property.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def _tt_shapes(dims: Sequence[int], rank: int):
    d = len(dims)
    shapes = []
    for i in range(d):
        rl = 1 if i == 0 else min(rank, int(np.prod(dims[:i])),
                                  int(np.prod(dims[i:])))
        rr = 1 if i == d - 1 else min(rank, int(np.prod(dims[:i + 1])),
                                      int(np.prod(dims[i + 1:])))
        shapes.append((rl, dims[i], rr))
    return shapes


def warmup(dims: Sequence[int], rank: int,
           target_rank: Optional[int] = None,
           dtype: str = "float32",
           op_rank: int = 0,
           rhs_rank: int = 1,
           spd: bool = True,
           num_measurements: int = 0,
           kinds: Sequence[str] = ("round", "randomized", "als"),
           oversample: int = 8) -> Dict[str, float]:
    """Pre-compile the whole-sweep kernels for a TT problem family.

    dims/rank describe the iterate; `target_rank` the rounding target
    (default rank//2); `op_rank` enables the ALS kernels for a TT operator
    of that rank (0 skips them unless "als" in kinds, then defaults to 3,
    the QTT Laplace rank); `num_measurements` > 0 enables the ADF
    iteration kernel.  Extra kinds: "df_round" (f64-quality rounding,
    ops/df_rounding.py — its per-site jits are the most expensive compiles
    in the library) and "dmrg" (matrix-free Lanczos half-sweep).
    Returns {kernel name: compile seconds}.
    """
    import jax
    import jax.numpy as jnp
    from .ops.tt_kernels import (tt_round_sweep_uniform,
                                 tt_round_randomized_uniform, make_als_sweep)

    dims = [int(n) for n in dims]
    d = len(dims)
    target = int(target_rank) if target_rank else max(1, rank // 2)
    rng = np.random.Generator(np.random.PCG64(0))
    times: Dict[str, float] = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.tree_util.tree_map(
            lambda x: x.block_until_ready() if hasattr(x, "block_until_ready")
            else x, out)
        times[name] = time.perf_counter() - t0

    x_shapes = _tt_shapes(dims, rank)
    cores = [rng.normal(size=s).astype(dtype) * 0.1 for s in x_shapes]
    dev_cores = [jnp.asarray(c) for c in cores]

    # warm through the PUBLIC wrappers: this also compiles the small
    # pad/unpad slice programs around the scan kernel, not just the sweep
    if "round" in kinds:
        for method in ("gram", "svd"):
            run(f"round_{method}", tt_round_sweep_uniform, dev_cores,
                target, method)
    if "randomized" in kinds:
        run("round_randomized", tt_round_randomized_uniform, dev_cores,
            target, int(oversample))
    if "streaming" in kinds:
        from .ops.tt_kernels import tt_round_streaming_uniform
        run("round_streaming", tt_round_streaming_uniform, dev_cores, target)
    if "apply_round" in kinds:
        from .ops.apply_kernels import apply_operator_rounded_cores
        a = int(op_rank) or 3
        A_shapes = [(1 if i == 0 else a, dims[i], dims[i],
                     1 if i == d - 1 else a) for i in range(d)]
        A_list = [rng.normal(size=s).astype(dtype) * 0.1 for s in A_shapes]
        run("apply_round", apply_operator_rounded_cores, A_list, cores,
            target)
    if "als" in kinds:
        a = int(op_rank) or 3
        A_shapes = []
        for i in range(d):
            al = 1 if i == 0 else a
            ar = 1 if i == d - 1 else a
            A_shapes.append((al, dims[i], dims[i], ar))
        b_shapes = _tt_shapes(dims, int(rhs_rank))
        x_t = tuple(jnp.asarray(c) for c in cores)
        A_t = tuple(jnp.asarray(rng.normal(size=s).astype(dtype) * 0.1)
                    for s in A_shapes)
        b_t = tuple(jnp.asarray(rng.normal(size=s).astype(dtype) * 0.1)
                    for s in b_shapes)
        shapes_key = tuple(tuple(c.shape) for c in x_t)
        for direction in ("lr", "rl"):
            fn = make_als_sweep(shapes_key, dtype, direction, spd)
            run(f"als_{direction}", fn, x_t, A_t, b_t)
    if "df_round" in kinds:
        from .ops.df_rounding import tt_round_df_from_f64
        run("df_round", tt_round_df_from_f64,
            [np.asarray(c, np.float64) for c in cores], target)
    if "dmrg" in kinds:
        if len(set(dims)) != 1:
            raise ValueError("'dmrg' warmup needs uniform mode dimensions")
        from .ops.dmrg_kernels import make_dmrg_sweep_lobpcg
        from .ops.tt_kernels import pad_cores
        a = int(op_rank) or 5
        stack, r = pad_cores(cores)
        n0 = dims[0]
        H = rng.normal(size=(d, a, n0, n0, a)).astype(dtype) * 0.1
        fn = make_dmrg_sweep_lobpcg(tuple(stack.shape), int(r), dtype, 32,
                                    "lanczos")
        run("dmrg_lanczos", fn, jnp.asarray(stack), jnp.asarray(H))
    if num_measurements > 0:
        from .ops.adf_kernels import make_adf_iteration, build_onehots
        M = int(num_measurements)
        P = rng.integers(0, np.array(dims), size=(M, d))
        onehots = build_onehots(P, dims, np.dtype(dtype))
        vals = jnp.asarray(rng.normal(size=(M,)).astype(dtype))
        x_t = tuple(jnp.asarray(c) for c in cores)
        shapes_key = tuple(tuple(c.shape) for c in x_t)
        fn = make_adf_iteration(shapes_key, dtype)
        run("adf_iteration", fn, x_t, onehots, vals)
    return times
