"""Device-side sparse x dense contraction kernels.

Device equivalent of the reference's hand-written mixed sparse/dense
GEMMs (src/xerus/sparseTimesFullContraction.cpp:66-224) and the CHOLMOD
sparse kernels (src/xerus/cholmod_wrapper.cpp): a matricized sparse operand
becomes COO index/value arrays, the product is a gather of dense rows scaled
by the values and a segment-sum over output rows (XLA scatter-add).  The
host scipy path (core/contract.py) stays the default for small operands,
where a dispatch costs more than the work; this kernel takes over at
``DEVICE_SPARSE_THRESHOLD`` dense-FLOP-equivalents.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

# switch to the device path when dense rows * cols exceeds this
DEVICE_SPARSE_THRESHOLD = 1 << 22


@partial(jax.jit, static_argnums=(4,))
def _coo_times_dense(rows, cols, vals, dense, out_rows: int):
    """(sparse [out_rows x k]) @ (dense [k x n]) -> dense [out_rows x n]."""
    gathered = dense[cols] * vals[:, None]          # (nnz, n)
    return jnp.zeros((out_rows, dense.shape[1]), dtype=dense.dtype
                     ).at[rows].add(gathered)


@partial(jax.jit, static_argnums=(4,))
def _dense_times_coo(dense, rows, cols, vals, out_cols: int):
    """(dense [m x k]) @ (sparse [k x out_cols]) -> dense [m x out_cols]."""
    gathered = dense[:, rows] * vals[None, :]       # (m, nnz)
    return jnp.zeros((dense.shape[0], out_cols), dtype=dense.dtype
                     ).at[:, cols].add(gathered)


def sparse_times_dense(positions: np.ndarray, values: np.ndarray,
                       sparse_shape: Tuple[int, int], dense) -> jnp.ndarray:
    """positions: linear row-major indices into sparse_shape."""
    m, k = sparse_shape
    rows = jnp.asarray(positions // k, dtype=jnp.int32)
    cols = jnp.asarray(positions % k, dtype=jnp.int32)
    vals = jnp.asarray(values, dtype=dense.dtype)
    return _coo_times_dense(rows, cols, vals, dense, m)


def dense_times_sparse(dense, positions: np.ndarray, values: np.ndarray,
                       sparse_shape: Tuple[int, int]) -> jnp.ndarray:
    k, n = sparse_shape
    rows = jnp.asarray(positions // n, dtype=jnp.int32)
    cols = jnp.asarray(positions % n, dtype=jnp.int32)
    vals = jnp.asarray(values, dtype=dense.dtype)
    return _dense_times_coo(dense, rows, cols, vals, n)
