"""Global configuration for xerus_tpu.

The reference library (xerus) fixes ``value_t = double`` and derives its
comparison tolerance ``EPSILON = 8 * machine-eps`` from it
(/root/reference/include/xerus/basic.h:37-43).  We keep float64 as the
default *semantic* dtype (enabled through jax x64) so that decomposition /
solver residuals match the reference to ~1e-10, while allowing the compute
dtype to be lowered (float32 / bfloat16) for throughput benchmarks.
"""

from __future__ import annotations

import os

import jax
import numpy as np

# ---------------------------------------------------------------------------
# x64: xerus is a double-precision library.  Enable unless explicitly disabled.
# ---------------------------------------------------------------------------
if os.environ.get("XERUS_TPU_NO_X64", "0") != "1":
    jax.config.update("jax_enable_x64", True)

_DEFAULT_DTYPE = np.float64 if jax.config.jax_enable_x64 else np.float32


class _Config:
    """Mutable runtime configuration (xerus' compile-time config.mk becomes this)."""

    def __init__(self) -> None:
        self.value_dtype = np.dtype(_DEFAULT_DTYPE)
        # Runtime checks (dimension/format validation).  The reference controls
        # this via XERUS_DISABLE_RUNTIME_CHECKS (config.mk.default:16).
        self.runtime_checks = os.environ.get("XERUS_TPU_DISABLE_CHECKS", "0") != "1"
        # Dense<->sparse auto-switch heuristic factor (tensor.h:72 sparsityFactor).
        self.sparsity_factor = 4
        # NaN/Inf guards in solver loops (the reference's closest analogue is
        # all_entries_valid + the FAILTEST machinery, SURVEY.md §5.3; this is
        # the checkify-style new design).
        self.nan_checks = os.environ.get("XERUS_TPU_NAN_CHECKS", "0") == "1"

    @property
    def epsilon(self) -> float:
        """Default comparison tolerance: 8 * machine eps (basic.h:43)."""
        return 8.0 * float(np.finfo(self.value_dtype).eps)


config = _Config()


def value_dtype():
    return config.value_dtype


def set_value_dtype(dtype) -> None:
    config.value_dtype = np.dtype(dtype)


def EPSILON() -> float:
    return config.epsilon


def checks_enabled() -> bool:
    return config.runtime_checks


_COVERAGE = bool(os.environ.get("XERUS_TEST_COVERAGE"))


def require(cond: bool, msg: str = "") -> None:
    """REQUIRE analogue (misc/check.h:40): raises when runtime checks are on.

    With XERUS_TEST_COVERAGE=1 every executed call records its call site
    as a coverage landmark (reference test.h:40-51; misc/coverage.py)."""
    if _COVERAGE:
        from .misc import coverage
        coverage.record_caller()
    if config.runtime_checks and not cond:
        raise ValueError(msg or "xerus_tpu runtime check failed")


def on_accelerator() -> bool:
    """True when the session's default backend is an accelerator (GPU).

    Solver defaults that only pay off with device-resident kernels (the
    matrix-free Lanczos DMRG, algorithms/eigensolver.py) decide by this,
    not by a platform name."""
    return jax.default_backend() != "cpu"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins; otherwise the cache
    lives at the fixed path ``<repo>/.jax_cache``, so every script of this
    repository shares one cache whose key does not move with the working
    directory."""
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir


def host():
    """Context manager pinning jax computations to the CPU backend.

    The object layer (Tensor math, move_core, frob_norm, the small
    factorizations) carries the reference's host-LAPACK f64 semantics;
    drivers wrap their object-level preambles in this scope so that many
    tiny dispatches stay on the host while the whole-sweep kernels run on
    the session's default device.  Interactive users may build objects
    under it too:

        with xe.host():
            A = laplace_operator([2] * 32)
            x = xe.TTTensor.random([2] * 32, 30)
    """
    import jax
    from contextlib import nullcontext
    try:
        return jax.default_device(jax.devices("cpu")[0])
    except Exception:
        return nullcontext()
