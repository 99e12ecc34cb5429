"""Pairwise tensor contraction.

Re-design of ``xerus::contract`` (src/xerus/tensor.cpp:1252-1352): matricize
both operands and run one GEMM.  Dense x dense goes through
``lax.dot_general`` on device; contractions involving sparse operands
use scipy.sparse on host (the CHOLMOD/sparseTimesFullContraction analogue,
src/xerus/cholmod_wrapper.cpp, src/xerus/sparseTimesFullContraction.cpp) with
a device COO segment-sum path for large dense results (ops/sparse_dense.py).

The result representation follows the reference's sparsity expectation rule
(tensor.cpp:1275-1279): sparse result iff both operands sparse and the
expected density is low.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax

from ..config import require
from ..misc.performance import pa_section
from .tensor import Tensor, Representation, _prod


@jax.jit
def _matmul(a, b):
    return jax.lax.dot_general(a, b, dimension_numbers=(((1,), (0,)), ((), ())),
                               preferred_element_type=a.dtype)


def contract(lhs: Tensor, rhs: Tensor, num_modes: int,
             lhs_trans: bool = False, rhs_trans: bool = False) -> Tensor:
    """Contract the last ``num_modes`` modes of lhs (first if ``lhs_trans``)
    with the first ``num_modes`` of rhs (last if ``rhs_trans``)."""
    num_modes = int(num_modes)
    lhs_open = lhs.degree() - num_modes
    rhs_open = rhs.degree() - num_modes
    require(lhs_open >= 0 and rhs_open >= 0, "contract: too many modes")

    if lhs_trans:
        lhs_open_dims = lhs.dimensions[num_modes:]
        lhs_con_dims = lhs.dimensions[:num_modes]
    else:
        lhs_open_dims = lhs.dimensions[:lhs_open]
        lhs_con_dims = lhs.dimensions[lhs_open:]
    if rhs_trans:
        rhs_open_dims = rhs.dimensions[:rhs_open]
        rhs_con_dims = rhs.dimensions[rhs_open:]
    else:
        rhs_open_dims = rhs.dimensions[num_modes:]
        rhs_con_dims = rhs.dimensions[:num_modes]
    require(list(lhs_con_dims) == list(rhs_con_dims),
            f"contract: contracted dims mismatch {lhs_con_dims} vs {rhs_con_dims}")

    out_dims = list(lhs_open_dims) + list(rhs_open_dims)
    m = _prod(lhs_open_dims)
    k = _prod(lhs_con_dims)
    n = _prod(rhs_open_dims)

    if lhs.is_sparse() or rhs.is_sparse():
        return _contract_sparse(lhs, rhs, lhs_trans, rhs_trans, m, k, n, out_dims)

    a = lhs.to_jax(apply_factor=False)
    b = rhs.to_jax(apply_factor=False)
    a2 = a.reshape(k, m).T if lhs_trans else a.reshape(m, k)
    b2 = b.reshape(n, k).T if rhs_trans else b.reshape(k, n)
    # host-side dispatch accounting (XERUS_PA_START/END around the GEMM,
    # blasLapackWrapper.cpp:177-193)
    with pa_section("Dense BLAS", "Matrix-Matrix-Multiplication",
                    f"{m}x{k} * {k}x{n}"):
        out = _matmul(a2, b2)
    result = Tensor.from_jax(out.reshape(out_dims) if out_dims else out.reshape(()))
    result.factor = lhs.factor * rhs.factor
    return result


def _to_csr(t: Tensor, rows: int, cols: int, trans: bool):
    """Matricize a sparse tensor to (rows, cols) CSR; linear positions are
    row-major over the tensor's own dims, so a transposed view swaps strides."""
    import scipy.sparse as sp
    pos, val = t.sparse_coo()
    if not trans:
        mat = sp.csr_matrix((val, (pos // cols, pos % cols)), shape=(rows, cols))
    else:
        # stored as (cols, rows) row-major; transpose to (rows, cols)
        mat = sp.csr_matrix((val, (pos % rows, pos // rows)), shape=(rows, cols))
    return mat


def _contract_sparse(lhs: Tensor, rhs: Tensor, lhs_trans: bool, rhs_trans: bool,
                     m: int, k: int, n: int, out_dims) -> Tensor:
    import scipy.sparse as sp
    factor = lhs.factor * rhs.factor

    both_sparse = lhs.is_sparse() and rhs.is_sparse()

    # Large mixed sparse x dense products run on device (gather + segment-sum,
    # ops/sparse_kernels.py) — the sparseTimesFullContraction equivalent.
    from ..ops.sparse_kernels import (DEVICE_SPARSE_THRESHOLD,
                                      sparse_times_dense, dense_times_sparse)
    if not both_sparse and m * n >= DEVICE_SPARSE_THRESHOLD:
        if lhs.is_sparse() and not lhs_trans:
            pos, val = lhs.sparse_coo()
            dense = rhs.to_jax(apply_factor=False).reshape(
                (n, k) if rhs_trans else (k, n))
            dense = dense.T if rhs_trans else dense
            out = sparse_times_dense(pos, val, (m, k), dense)
            res = Tensor.from_jax(out.reshape(out_dims) if out_dims else out.reshape(()))
            res.factor = factor
            return res
        if rhs.is_sparse() and not rhs_trans:
            pos, val = rhs.sparse_coo()
            dense = lhs.to_jax(apply_factor=False).reshape(
                (k, m) if lhs_trans else (m, k))
            dense = dense.T if lhs_trans else dense
            out = dense_times_sparse(dense, pos, val, (k, n))
            res = Tensor.from_jax(out.reshape(out_dims) if out_dims else out.reshape(()))
            res.factor = factor
            return res
    if lhs.is_sparse():
        a = _to_csr(lhs, m, k, lhs_trans)
    else:
        arr = np.asarray(lhs.to_jax(apply_factor=False)).reshape(
            (k, m) if lhs_trans else (m, k))
        a = arr.T if lhs_trans else arr
    if rhs.is_sparse():
        b = _to_csr(rhs, k, n, rhs_trans)
    else:
        arr = np.asarray(rhs.to_jax(apply_factor=False)).reshape(
            (n, k) if rhs_trans else (k, n))
        b = arr.T if rhs_trans else arr

    with pa_section("Mixed BLAS", "Matrix-Matrix-Multiplication",
                    f"{m}x{k} * {k}x{n}"):
        prod = a @ b  # scipy: sparse*dense, dense*sparse, sparse*sparse

    if both_sparse and sp.issparse(prod):
        # Result sparse iff expected density low (tensor.cpp:1275-1279):
        # keep sparse if nnz * sparsityFactor < size.
        coo = prod.tocoo()
        if coo.nnz * Tensor.sparsityFactor < m * n:
            out = Tensor(out_dims, Representation.Sparse)
            lin = coo.row.astype(np.int64) * n + coo.col.astype(np.int64)
            for p, v in zip(lin, coo.data):
                out._sparse[int(p)] = out._sparse.get(int(p), 0.0) + float(v)
            out.factor = factor
            return out
        prod = coo.toarray()
    elif sp.issparse(prod):
        prod = prod.toarray()
    out = Tensor(out_dims, Representation.Dense, data=np.asarray(prod).reshape(out_dims) if out_dims else np.asarray(prod).reshape(()))
    out.factor = factor
    return out
