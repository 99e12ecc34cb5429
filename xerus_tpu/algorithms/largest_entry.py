"""Largest-entry search in a TT.

Re-design of include/xerus/algorithms/largestEntry.h:34-37,
src/xerus/algorithms/largestEntry.cpp:30-54: iterate entrywise squaring +
soft thresholding until the rank collapses, then take the per-core argmax of
the resulting (near) rank-one TT.
"""

from __future__ import annotations

import numpy as np

from ..tt.ttnetwork import TTNetwork, entrywise_product


def find_largest_entry(T: TTNetwork, accuracy: float = 0.0,
                       lower_bound: float = 0.0) -> int:
    """Linear position of the entry with largest absolute value.

    Object-level f64 math (round / entrywise squares / soft thresholds)
    is pinned to the host: it is a long chain of tiny ops, each of which
    would otherwise pay a device dispatch."""
    from ..config import host
    with host():
        # small tensors: materialize and take the exact argmax.  The
        # squaring/soft-threshold iteration exists for tensors too large
        # to materialize (largestEntry.cpp:30-54); below ~64k entries
        # contraction is instant while each squaring round pays dozens of
        # object-level ops (measured 11 s for a 4^5 search that the
        # contraction answers in milliseconds).  `accuracy` permits an
        # approximate answer; the exact argmax always satisfies it.
        total = 1
        for d in T.dimensions:
            total *= d
        if total <= 65536 and not T.is_operator:
            arr = np.abs(T.to_tensor().to_ndarray()).reshape(-1)
            return int(np.argmax(arr))
        return _find_largest_entry(T, accuracy, lower_bound)


def _find_largest_entry(T: TTNetwork, accuracy: float = 0.0,
                        lower_bound: float = 0.0) -> int:
    if sum(T.ranks()) >= T.degree() and T.degree() > 0:
        alpha = accuracy
        X = T.copy()
        X.round(1)
        Xn = max(T[_find_largest_entry(X, 0.0, 0.0)], lower_bound)
        tau = (1 - alpha) * alpha * Xn * Xn / (2.0 * max(T.degree() - 1, 1))

        X = T.copy()
        while sum(X.ranks()) >= T.degree():
            X = entrywise_product(X, X)
            X.soft_threshold(tau, True)

            Y = X.copy()
            Y.round(1)
            y_max_pos = _find_largest_entry(Y, 0.0, 0.0)
            Xn = max(X[_pos_to_multi(X, y_max_pos)],
                     (1 - (1 - alpha) * alpha / 2.0) * Xn * Xn)
            f_norm = X.frob_norm()
            Xn /= f_norm
            X /= f_norm
            tau = (1 - alpha) * alpha * Xn * Xn / (2.0 * max(T.degree() - 1, 1))
        return _find_largest_entry(X, 0.0, 0.0)

    # already (near) rank one: per-core argmax (largestEntry.cpp:37-52)
    num = T.num_components()
    position = 0
    factor = 1
    for d in T.dimensions:
        factor *= d
    for c in range(num):
        local_size = T.dimensions[c]
        if T.is_operator:
            local_size *= T.dimensions[num + c]
        factor //= local_size
        comp = np.abs(T.components[c].to_ndarray()).reshape(-1)
        max_pos = int(np.argmax(comp))
        position += max_pos * factor
    return position


def _pos_to_multi(X, pos: int):
    from ..core.tensor import Tensor
    return list(Tensor.position_to_multiIndex(pos, X.dimensions))
