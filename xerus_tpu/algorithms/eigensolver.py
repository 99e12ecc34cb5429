"""ALS/DMRG ground-state eigensolver on the TT manifold.

min <x, A x> / <x, x> for a symmetric TTOperator A — the DMRG workload of
BASELINE.json config 4 (two-site Heisenberg ground state).  The reference
library has no eigensolver (SURVEY.md §2.4 lists only Ax=b solvers); this is
a driver-defined capability built on the same environment-cache machinery as
the ALS engine: with x canonicalized around the optimized sites the local
metric is the identity, so each micro-step is a dense symmetric eigenproblem
solved with jnp.linalg.eigh.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import jax.numpy as jnp

from ..config import config, require
from ..core.tensor import Tensor
from ..core import factorizations as fact
from ..core.contract import contract as core_contract
from ..tt.ttnetwork import TTTensor, TTOperator
from .performance_data import PerformanceData, NoPerfData


class EigenALSVariant:
    """sites=1: site-wise eigen-ALS; sites=2: two-site DMRG with adaptive
    rank (eps-truncated SVD splits capped by max_rank)."""

    def __init__(self, sites: int = 2, num_sweeps: int = 0,
                 convergence_epsilon: float = 1e-10, max_rank: int = 64,
                 eps: float = 1e-10):
        self.sites = sites
        self.numSweeps = num_sweeps
        self.convergenceEpsilon = convergence_epsilon
        self.maxRank = max_rank
        self.eps = eps

    def __call__(self, A: TTOperator, x: TTTensor,
                 perf_data: PerformanceData = NoPerfData) -> float:
        return self.solve(A, x, self.numSweeps, self.convergenceEpsilon,
                          perf_data)

    def solve(self, A: TTOperator, x: TTTensor, num_sweeps: int,
              conv_eps: float, perf: PerformanceData = NoPerfData) -> float:
        num = x.num_components()
        require(self.sites in (1, 2), "sites must be 1 or 2")
        require(num >= self.sites, "TT too short")
        x.move_core(0)
        x /= x.frob_norm() or 1.0
        A_cores = [c.to_jax() for c in A.components]

        # right environments (xl, al, xr)
        dtype = config.value_dtype
        one3 = jnp.ones((1, 1, 1), dtype=dtype)
        right: List = [one3]
        for k in range(num - 1, self.sites - 1, -1):
            xc = x.components[k].to_jax()
            right.append(jnp.einsum("umU,amnb,vnV,UbV->uav", xc, A_cores[k],
                                    xc, right[-1]))
        left: List = [one3]

        perf.start()
        energy = math.inf
        sweeps = 0
        curr = 0
        direction = +1
        while True:
            # local operator over the current site block
            L, R = left[-1], right[-1]
            if self.sites == 1:
                Aloc = jnp.einsum("uav,amnb,UbV->umUvnV", L, A_cores[curr], R)
                shape = (L.shape[0], A_cores[curr].shape[1], R.shape[0])
            else:
                Aloc = jnp.einsum("uav,amnb,bMNc,UcV->umMUvnNV", L,
                                  A_cores[curr], A_cores[curr + 1], R)
                shape = (L.shape[0], A_cores[curr].shape[1],
                         A_cores[curr + 1].shape[1], R.shape[0])
            nn = int(np.prod(shape))
            w, v = jnp.linalg.eigh(Aloc.reshape(nn, nn))
            lam = float(w[0])
            ground = v[:, 0].reshape(shape)

            if self.sites == 1:
                x.components[curr] = Tensor.from_jax(ground)
                x.assume_core_position(curr)
            else:
                t = Tensor.from_jax(ground)
                U, S, Vt = fact.calculate_svd(t, 2, self.maxRank, self.eps)
                if direction > 0:
                    x.components[curr] = U
                    x.components[curr + 1] = core_contract(S, Vt, 1)
                    x.assume_core_position(curr + 1)
                else:
                    x.components[curr] = core_contract(U, S, 1)
                    x.components[curr + 1] = Vt
                    x.assume_core_position(curr)

            at_right = direction > 0 and curr == num - self.sites
            at_left = direction < 0 and curr == 0
            if at_right or at_left:
                sweeps += 1
                last = energy
                energy = lam
                if perf:
                    perf.add(energy, x, 1)
                if ((num_sweeps and sweeps >= num_sweeps)
                        or abs(last - energy) < conv_eps
                        or num <= self.sites):
                    break
                direction = -direction
            elif direction > 0:
                # orthogonalize current site, extend left env
                x._transfer_core(curr, curr + 1, False)
                xc = x.components[curr].to_jax()
                left.append(jnp.einsum("uav,umU,amnb,vnV->UbV", left[-1], xc,
                                       A_cores[curr], xc))
                right.pop()
                curr += 1
            else:
                last_site = curr + self.sites - 1
                x._transfer_core(last_site, last_site - 1, False)
                xc = x.components[last_site].to_jax()
                right.append(jnp.einsum("umU,amnb,vnV,UbV->uav", xc,
                                        A_cores[last_site], xc, right[-1]))
                left.pop()
                curr -= 1
        nrm = x.frob_norm()
        if nrm > 0:
            x /= nrm
        return energy


DMRG_groundstate = EigenALSVariant(sites=2, num_sweeps=0,
                                   convergence_epsilon=1e-10)
ALS_groundstate = EigenALSVariant(sites=1, num_sweeps=0,
                                  convergence_epsilon=1e-10)


def smallest_eigenvalue(A: TTOperator, x: TTTensor, sites: int = 2,
                        num_sweeps: int = 0, eps: float = 1e-10,
                        max_rank: int = 64,
                        perf_data: PerformanceData = NoPerfData,
                        solver: Optional[str] = None,
                        num_starts: int = 1,
                        shift: Optional[float] = None) -> float:
    """solver="exact": adaptive-rank object-level sweeps with dense local
    eigh (the reference's approach).  solver="lanczos": the whole-sweep
    scan kernel with matrix-free Lanczos local solves
    (ops/dmrg_kernels.py; one device program per solve instead of dense
    local eigh) — requires sites=2 and uniform mode dimensions; ranks are
    fixed at max_rank (x is rank-bumped if needed).  Arbitrary spectra
    are handled via an auto-estimated spectral shift (shift=None); pass
    shift=0.0 if the ground energy is known negative (skips the
    lambda_max estimation phase and the projector carry) or a known
    upper bound s > lambda_min.

    solver=None picks automatically: "lanczos" when the default backend
    is an accelerator (config.on_accelerator) and its structural
    requirements hold, "exact" otherwise."""
    if solver is None:
        from ..config import on_accelerator
        solver = ("lanczos" if on_accelerator() and sites == 2
                  and len(set(x.dimensions)) == 1 else "exact")
    require(solver in ("exact", "lanczos"),
            f"unknown solver {solver!r}; expected 'exact' or 'lanczos'")
    if solver == "lanczos":
        require(sites == 2, "solver='lanczos' is two-site only")
        require(len(set(x.dimensions)) == 1,
                "solver='lanczos' needs uniform mode dimensions")
        from ..ops.dmrg_kernels import dmrg_groundstate_scan
        from ..config import host
        cap = TTTensor.reduce_to_maximal_ranks(
            [max_rank] * (x.degree() - 1), x.dimensions)
        if list(x.ranks()) != cap:
            with host():
                rnd = TTTensor.random(x.dimensions, max_rank)
                scale = 1e-3 * (x.frob_norm() or 1.0) / (rnd.frob_norm()
                                                         or 1.0)
                bumped = x + scale * rnd
                bumped.round(max_rank)
                x.components = bumped.components
                x.canonicalized = bumped.canonicalized
                x.corePosition = bumped.corePosition
        if num_starts > 1:
            # race independent random initializations in ONE batched
            # program per half-sweep; lowest energy wins
            from ..ops.dmrg_kernels import dmrg_groundstate_multistart
            energy = dmrg_groundstate_multistart(
                A, x, num_starts=int(num_starts),
                num_half_sweeps=2 * (num_sweeps or 8), conv_eps=eps,
                solver="lanczos", shift=shift)
        else:
            energy = dmrg_groundstate_scan(
                A, x, num_half_sweeps=2 * (num_sweeps or 8),
                conv_eps=eps, solver="lanczos", shift=shift)
        if perf_data:
            perf_data.start()
            perf_data.add(energy, x, 1)
        return energy
    variant = EigenALSVariant(sites, num_sweeps, eps, max_rank)
    return variant(A, x, perf_data)
