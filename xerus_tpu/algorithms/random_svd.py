"""Randomized TT-SVD of a dense tensor.

Re-design of include/xerus/algorithms/randomSVD.h (the reference ships the
whole algorithm COMMENTED OUT — randomTTSVD never compiled in v3.0.1; this
makes the surface real).  Rather than the reference's sketch-then-RQ chain
on the host, we build the exact unfolding TT (factorization-free,
TTTensor.from_dense_unfolding) and run the device-resident randomized
rounding sweep (ops/tt_kernels._round_randomized*), which is the same
randomize-then-orthogonalize mathematics with all FLOPs in fused XLA
GEMM/QR kernels.
"""

from __future__ import annotations

from typing import Sequence, Union

from ..config import require
from ..tt.ttnetwork import TTTensor


def randomTTSVD(tensor, ranks: Union[int, Sequence[int]],
                oversampling: Union[int, Sequence[int], None] = None
                ) -> TTTensor:
    """Quasi-optimal TT approximation of a dense tensor at the given
    per-bond ``ranks`` via randomized sketching (randomSVD.h:30-124).

    ``oversampling`` is accepted for reference-signature parity; the
    device kernels manage their own sketch oversampling internally, so a
    scalar/vector here only validates shape.  Sparse tensors densify
    (the reference's sparse sketch path serves CPUs; on a device the dense
    unfolding + fused rounding sweep is the fast route).
    """
    tt = TTTensor.from_dense_unfolding(tensor)
    n_bonds = tt.num_ranks()
    if not isinstance(ranks, int):
        ranks = [int(r) for r in ranks]
        require(len(ranks) == n_bonds,
                f"need {n_bonds} ranks, got {len(ranks)}")
    if oversampling is not None and not isinstance(oversampling, int):
        require(len(list(oversampling)) == n_bonds,
                f"need {n_bonds} oversampling entries")
    tt.round_fast(ranks, method="randomized")
    return tt
