"""On-device kernel profiling hook.

The reference's XERUS_PERFORMANCE_ANALYSIS macros time host kernel calls
(misc/performanceAnalysis.h:31-38); on a device the equivalent is a
jax.profiler trace viewable in Perfetto/TensorBoard."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Context manager: profiles all device work in the block to log_dir."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def guard_finite(array_like, context: str = "") -> None:
    """Raise if the array contains NaN/Inf (failure-detection guard,
    enabled via config.nan_checks)."""
    from ..config import config
    if not config.nan_checks:
        return
    import jax.numpy as jnp
    import numpy as np
    arr = array_like.to_jax() if hasattr(array_like, "to_jax") else array_like
    if not bool(jnp.all(jnp.isfinite(arr))):
        raise FloatingPointError(
            f"non-finite values detected{': ' + context if context else ''}")
