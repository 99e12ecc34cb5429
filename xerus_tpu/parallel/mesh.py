"""Device-mesh plumbing.

The reference has no distributed layer (SURVEY.md §2.6): its parallelism is
OpenMP pragmas over measurement/sample loops plus threaded BLAS.  Here the
communication backend is jax.sharding over a Mesh: collectives
(psum/all-gather/reduce-scatter) arise from sharded einsums via GSPMD and
run over the device interconnect (NCCL over NVLink on a GPU host, which
joins every card to every other, so the mesh shape follows the algorithm
alone).  Axis roles:

* ``dp`` — the measurement/sample batch axis (ADF, UQ-ADF, measurement
  evaluation: the loops the reference marks embarrassingly parallel with
  OpenMP, adf.cpp:570, uqAdf.cpp:117, measurments.cpp:477).
* ``tp`` — the rank axis of large matricizations (ALS local systems,
  rounding GEMMs): tensor-parallel GEMM with all-reduce of partial sums.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def default_mesh(n_devices: Optional[int] = None,
                 axis_names: Tuple[str, str] = ("dp", "tp")) -> Mesh:
    """2D mesh over the available devices: dp gets the larger factor."""
    devices = jax.devices()
    n = len(devices) if n_devices is None else n_devices
    if n > len(devices):
        raise ValueError(
            f"default_mesh: requested {n} devices but the {devices[0].platform} "
            f"backend has only {len(devices)}. For a virtual multi-device CPU "
            f"backend set JAX_PLATFORMS=cpu and XLA_FLAGS="
            f"--xla_force_host_platform_device_count={n} before jax "
            f"initialises (tests/conftest.py recipe)."
        )
    devices = devices[:n]
    tp = 1
    for cand in (2, 4, 8):
        if n % cand == 0 and n // cand >= cand:
            tp = cand
    dp = n // tp
    dev_array = np.array(devices).reshape(dp, tp)
    return Mesh(dev_array, axis_names)


def measurement_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (measurement) axis over dp."""
    return NamedSharding(mesh, P("dp"))


def rank_sharding(mesh: Mesh, axis_index: int, ndim: int) -> NamedSharding:
    spec = [None] * ndim
    spec[axis_index] = "tp"
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
