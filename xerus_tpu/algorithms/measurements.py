"""Measurement sets for tensor completion / recovery.

Re-design of include/xerus/measurments.h:43-146, src/xerus/measurments.cpp.
Positions live in device-friendly batched arrays: evaluation against a TT is
one vectorized gather-matmul sweep over the measurement axis instead of the
reference's per-measurement tensor contractions with stack-prefix recycling
(measurments.cpp:470-500) — on an accelerator the batched form is the fast
path, and it shards trivially over the measurement axis (SURVEY.md §2.6a).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import jax.numpy as jnp

from ..config import config, require
from ..core.tensor import Tensor
from .. import misc as _misc


def _evaluate_tt_at_points(tt, positions: np.ndarray) -> np.ndarray:
    """values[m] = tt[positions[m]] via one batched gather + contraction
    per site; the (M, r) frontier is the only intermediate."""
    M = positions.shape[0]
    P = jnp.asarray(positions)
    F = jnp.ones((M, 1), dtype=config.value_dtype)
    for k, comp in enumerate(tt.components):
        C = comp.to_jax()                       # (rl, n, rr)
        taken = jnp.take(C, P[:, k], axis=1)    # (rl, M, rr)
        F = jnp.einsum("ma,amb->mb", F, taken)
    return np.asarray(F[:, 0])


def _evaluate_dense_at_points(t: Tensor, positions: np.ndarray) -> np.ndarray:
    arr = t.to_ndarray()
    return arr[tuple(positions[:, k] for k in range(positions.shape[1]))]


class SinglePointMeasurementSet:
    """Point measurements: positions (M, d) + values (M,)
    (measurments.h:43-91)."""

    def __init__(self):
        self.positions = np.zeros((0, 0), dtype=np.int64)
        self.measuredValues = np.zeros((0,), dtype=config.value_dtype)

    # -- construction ---------------------------------------------------
    @classmethod
    def random(cls, num: int, dimensions_or_solution,
               callback: Optional[Callable] = None) -> "SinglePointMeasurementSet":
        out = cls()
        if isinstance(dimensions_or_solution, (list, tuple)):
            dims = [int(d) for d in dimensions_or_solution]
            out.create_random_positions(num, dims)
            if callback is not None:
                out.measure(callback)
        else:
            solution = dimensions_or_solution
            out.create_random_positions(num, list(solution.dimensions))
            out.measure(solution)
        return out

    def create_random_positions(self, num: int, dimensions: Sequence[int]) -> None:
        dims = np.array(dimensions, dtype=np.int64)
        require(num <= int(np.prod(dims)), "more measurements than entries")
        rng = _misc.randomEngine
        seen = set()
        rows = []
        while len(rows) < num:
            cand = tuple(int(rng.integers(0, d)) for d in dims)
            if cand not in seen:
                seen.add(cand)
                rows.append(cand)
        self.positions = np.array(rows, dtype=np.int64)
        self.measuredValues = np.zeros(num, dtype=config.value_dtype)
        self.sort(positions_only=True)

    # -- information ----------------------------------------------------
    def size(self) -> int:
        return self.positions.shape[0]

    def degree(self) -> int:
        return self.positions.shape[1]

    def frob_norm(self) -> float:
        return float(np.linalg.norm(self.measuredValues))

    def add(self, position: Sequence[int], value: float) -> None:
        pos = np.asarray(position, dtype=np.int64)[None, :]
        if self.positions.size == 0:
            self.positions = pos
            self.measuredValues = np.array([value], dtype=config.value_dtype)
        else:
            self.positions = np.vstack([self.positions, pos])
            self.measuredValues = np.append(self.measuredValues, value)

    def sort(self, positions_only: bool = False) -> None:
        if self.size() == 0:
            return
        order = np.lexsort(self.positions.T[::-1])
        self.positions = self.positions[order]
        if not positions_only:
            self.measuredValues = self.measuredValues[order]

    # -- per-measurement accessors (python/recovery.cpp:33-45) ----------
    def get_position(self, i: int) -> List[int]:
        return [int(p) for p in self.positions[i]]

    def set_position(self, i: int, position: Sequence[int]) -> None:
        self.positions[i] = np.asarray(position, dtype=np.int64)

    def get_measuredValue(self, i: int) -> float:
        return float(self.measuredValues[i])

    def set_measuredValue(self, i: int, value: float) -> None:
        self.measuredValues[i] = value

    # -- measuring ------------------------------------------------------
    def measure(self, solution) -> None:
        self.measuredValues = np.asarray(self._eval(solution),
                                         dtype=config.value_dtype)

    def _eval(self, solution) -> np.ndarray:
        from ..tt.ttnetwork import TTNetwork
        if isinstance(solution, TTNetwork):
            return _evaluate_tt_at_points(solution, self.positions)
        if isinstance(solution, Tensor):
            return _evaluate_dense_at_points(solution, self.positions)
        if callable(solution):
            return np.array([solution(list(p)) for p in self.positions],
                            dtype=config.value_dtype)
        # TensorNetwork
        return np.array([solution[list(p)] for p in self.positions],
                        dtype=config.value_dtype)

    def test(self, solution) -> float:
        """Relative l2 error of solution vs the stored values
        (measurments.h:79-88)."""
        vals = np.asarray(self._eval(solution), dtype=config.value_dtype)
        return float(np.linalg.norm(vals - self.measuredValues)
                     / (np.linalg.norm(self.measuredValues) or 1.0))


class RankOneMeasurementSet:
    """Rank-one measurements <w_1 x .. x w_d, X>: per-mode weight matrices
    (measurments.h:94-146).  positions[k] is an (M, n_k) array."""

    def __init__(self):
        self.positions: List[np.ndarray] = []
        self.measuredValues = np.zeros((0,), dtype=config.value_dtype)

    @classmethod
    def random(cls, num: int, dimensions_or_solution,
               callback: Optional[Callable] = None) -> "RankOneMeasurementSet":
        out = cls()
        if isinstance(dimensions_or_solution, (list, tuple)):
            dims = [int(d) for d in dimensions_or_solution]
            out.create_random_positions(num, dims)
            if callback is not None:
                out.measure(callback)
        else:
            solution = dimensions_or_solution
            out.create_random_positions(num, list(solution.dimensions))
            out.measure(solution)
        return out

    @classmethod
    def from_single_point(cls, sp: SinglePointMeasurementSet,
                          dimensions: Sequence[int]) -> "RankOneMeasurementSet":
        out = cls()
        M = sp.size()
        out.positions = []
        for k, d in enumerate(dimensions):
            W = np.zeros((M, int(d)), dtype=config.value_dtype)
            W[np.arange(M), sp.positions[:, k]] = 1.0
            out.positions.append(W)
        out.measuredValues = sp.measuredValues.copy()
        return out

    def create_random_positions(self, num: int, dimensions: Sequence[int]) -> None:
        rng = _misc.randomEngine
        self.positions = [
            np.asarray(rng.normal(size=(num, int(d))), dtype=config.value_dtype)
            for d in dimensions]
        self.measuredValues = np.zeros(num, dtype=config.value_dtype)
        self.normalize()

    def size(self) -> int:
        return self.measuredValues.shape[0]

    def degree(self) -> int:
        return len(self.positions)

    def frob_norm(self) -> float:
        return float(np.linalg.norm(self.measuredValues))

    def add(self, position: Sequence, value: float) -> None:
        vecs = [np.asarray(p.to_ndarray() if isinstance(p, Tensor) else p,
                           dtype=config.value_dtype) for p in position]
        if not self.positions:
            self.positions = [v[None, :] for v in vecs]
            self.measuredValues = np.array([value], dtype=config.value_dtype)
        else:
            self.positions = [np.vstack([P, v[None, :]])
                              for P, v in zip(self.positions, vecs)]
            self.measuredValues = np.append(self.measuredValues, value)

    def normalize(self) -> None:
        """Unit-normalize every per-mode weight vector, rescaling the
        measured values by the same factors so the measurement equations
        stay consistent (measurments.cpp:349-358)."""
        for k in range(len(self.positions)):
            norms = np.linalg.norm(self.positions[k], axis=1, keepdims=True)
            norms[norms == 0] = 1.0
            self.positions[k] = self.positions[k] / norms
            if self.measuredValues.size:
                self.measuredValues = self.measuredValues / norms[:, 0]

    def sort(self, positions_only: bool = False) -> None:
        """Lexicographic over each measurement's concatenated per-mode
        weight vectors (measurments.cpp:330-347)."""
        if self.size() == 0 or not self.positions:
            return
        key = np.hstack(self.positions)          # (M, sum n_k)
        order = np.lexsort(key.T[::-1])
        self.positions = [W[order] for W in self.positions]
        if not positions_only:
            self.measuredValues = self.measuredValues[order]

    # -- per-measurement accessors (python/recovery.cpp:86-98) ----------
    def get_position(self, i: int) -> List[Tensor]:
        return [Tensor.from_ndarray(W[i].copy()) for W in self.positions]

    def set_position(self, i: int, position: Sequence) -> None:
        require(len(position) == self.degree(),
                "need one weight vector per mode")
        for k, p in enumerate(position):
            vec = np.asarray(p.to_ndarray() if isinstance(p, Tensor) else p,
                             dtype=config.value_dtype)
            self.positions[k][i] = vec

    def get_measuredValue(self, i: int) -> float:
        return float(self.measuredValues[i])

    def set_measuredValue(self, i: int, value: float) -> None:
        self.measuredValues[i] = value

    def measure(self, solution) -> None:
        self.measuredValues = np.asarray(self._eval(solution),
                                         dtype=config.value_dtype)

    def _eval(self, solution) -> np.ndarray:
        from ..tt.ttnetwork import TTNetwork
        if isinstance(solution, TTNetwork):
            M = self.size()
            F = jnp.ones((M, 1), dtype=config.value_dtype)
            for k, comp in enumerate(solution.components):
                C = comp.to_jax()
                W = jnp.asarray(self.positions[k])
                F = jnp.einsum("ma,anb,mn->mb", F, C, W)
            return np.asarray(F[:, 0])
        if isinstance(solution, Tensor):
            arr = jnp.asarray(solution.to_ndarray())
            M = self.size()
            out = jnp.broadcast_to(arr, (M,) + arr.shape)
            for k in range(self.degree()):
                W = jnp.asarray(self.positions[k])
                out = jnp.einsum("mn...,mn->m...", out, W)
            return np.asarray(out)
        if callable(solution):
            return np.array(
                [solution([self.positions[k][i] for k in range(self.degree())])
                 for i in range(self.size())], dtype=config.value_dtype)
        raise TypeError(f"cannot measure {type(solution)!r}")

    def test(self, solution) -> float:
        vals = np.asarray(self._eval(solution), dtype=config.value_dtype)
        return float(np.linalg.norm(vals - self.measuredValues)
                     / (np.linalg.norm(self.measuredValues) or 1.0))
