"""UQ-ADF: reconstruct a solution TT over stochastic (Hermite) modes from
samples.

Re-design of src/xerus/algorithms/uqAdf.cpp:30-477.  Mode 0 is the physical
mode; modes 1..d-1 carry Hermite-polynomial embeddings of the random
variables (randVar_to_position, uqAdf.cpp:39-50).  The reference's
OpenMP-parallel per-sample loops become batched (N, ...) jnp einsums that
shard over the sample axis (SURVEY.md §2.6a).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import jax.numpy as jnp

from ..config import config, require
from ..core.tensor import Tensor
from ..tt.ttnetwork import TTTensor
from .. import misc as _misc


def randvar_to_position(v: float, poly_degree: int) -> np.ndarray:
    """Probabilists' Hermite embedding He_i(v) = H_i(v/sqrt2)/2^(i/2)
    (uqAdf.cpp:39-50)."""
    p = np.zeros(poly_degree, dtype=config.value_dtype)
    # probabilists' Hermite via recurrence He_0=1, He_1=v, He_{n+1}=v He_n - n He_{n-1}
    for i in range(poly_degree):
        if i == 0:
            p[i] = 1.0
        elif i == 1:
            p[i] = v
        else:
            p[i] = v * p[i - 1] - (i - 1) * p[i - 2]
    return p


class UQMeasurementSet:
    """(uqAdf.h:35-50)"""

    def __init__(self):
        self.randomVectors: List[List[float]] = []
        self.solutions: List[Tensor] = []
        self.initialRandomVectors: List[List[float]] = []
        self.initialSolutions: List[Tensor] = []

    def add(self, rndvec: Sequence[float], solution: Tensor) -> None:
        self.randomVectors.append(list(rndvec))
        self.solutions.append(solution.copy() if isinstance(solution, Tensor)
                              else Tensor.from_ndarray(solution))

    def add_initial(self, rndvec: Sequence[float], solution: Tensor) -> None:
        self.initialRandomVectors.append(list(rndvec))
        self.initialSolutions.append(solution.copy())


class _UQInternalSolver:
    def __init__(self, x: TTTensor, random_variables, solutions):
        require(len(random_variables) == len(solutions),
                "need one solution per random vector")
        self.x = x
        self.N = len(solutions)
        self.d = x.degree()
        self.sols = jnp.asarray(np.stack(
            [np.asarray(s.to_ndarray() if isinstance(s, Tensor) else s)
             for s in solutions]))                       # (N, n0)
        self.sol_norm = float(jnp.linalg.norm(self.sols)) or 1.0
        # positions[k]: (N, n_k) Hermite embeddings, k = 1..d-1
        self.pos: List = [None]
        for k in range(1, self.d):
            self.pos.append(jnp.asarray(np.stack(
                [randvar_to_position(rv[k - 1], x.dimensions[k])
                 for rv in random_variables])))
        self.right: List = [None] * self.d       # right[k]: (N, r_{k-1})
        self.left_is: List = [None] * self.d     # (N, r_k, r_k)
        self.left_ought: List = [None] * self.d  # (N, r_k)

    def solve(self, max_iterations: int = 1000, mesh=None) -> None:
        """Outer loop on host; each full iteration (stacks + sweep) is ONE
        jitted program (mirrors ops/adf_kernels.py's design).

        With `mesh`, the sample axis (N) of the solutions and Hermite
        embeddings is sharded over the mesh's "dp" axis; every einsum here
        is sample-batched, so GSPMD turns the gradient/step reductions into
        psums over the interconnect and the cores stay replicated (SURVEY.md §2.6a)."""
        import jax
        from functools import partial

        pos = tuple(self.pos[1:])  # (N, n_k) embeddings for modes 1..d-1
        sols = self.sols
        d = self.d
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            ms = NamedSharding(mesh, P("dp"))
            # pad the sample axis to a dp multiple with all-zero samples:
            # zero embeddings give zero stacks, predictions and gradient
            # contributions, so padding is exactly neutral
            p_dp = mesh.shape["dp"]
            N = sols.shape[0]
            padn = (-N) % p_dp
            if padn:
                sols = jnp.pad(sols, ((0, padn), (0, 0)))
                pos = tuple(jnp.pad(p, ((0, padn), (0, 0))) for p in pos)
            pos = tuple(jax.device_put(p, ms) for p in pos)
            sols = jax.device_put(sols, ms)

        @jax.jit
        def iteration(cores):
            cores = list(cores)
            # canonicalize to 0 (RQ sweep)
            for k in range(d - 1, 0, -1):
                rl, n, rr = cores[k].shape
                q, r = jnp.linalg.qr(cores[k].reshape(rl, n * rr).T)
                cores[k] = q.T.reshape(q.shape[1], n, rr)
                cores[k - 1] = jnp.einsum("anb,bk->ank", cores[k - 1], r.T)
            # right stacks
            right = [None] * d
            right[d - 1] = jnp.einsum("mn,anb->ma", pos[d - 2], cores[d - 1])
            for k in range(d - 2, 0, -1):
                right[k] = jnp.einsum("mn,anb,mb->ma", pos[k - 1], cores[k],
                                      right[k + 1])
            X0 = cores[0].reshape(cores[0].shape[1], cores[0].shape[2])
            pred = jnp.einsum("nb,mb->mn", X0, right[1])
            resid = jnp.linalg.norm(pred - sols)

            left_is = [None] * d
            left_ought = [None] * d
            for k in range(d):
                C = cores[k]
                if k == 0:
                    diff = pred - sols
                    delta = jnp.einsum("mn,mb->nb", diff, right[1]
                                       ).reshape(C.shape)
                    tmp = jnp.einsum("anb,mb->mn", delta, right[1])
                    norm2 = jnp.sum(tmp * tmp)
                else:
                    w = pos[k - 1]
                    if k < d - 1:
                        is_part = jnp.einsum("mn,anb,mb->ma", w, C, right[k + 1])
                    else:
                        is_part = jnp.einsum("mn,anb->ma", w, C)
                    if k > 1:
                        is_part = jnp.einsum("mab,mb->ma", left_is[k - 1], is_part)
                    diff = is_part - left_ought[k - 1]
                    if k < d - 1:
                        delta = jnp.einsum("ma,mn,mb->anb", diff, w, right[k + 1])
                        rp = jnp.einsum("mn,anb,mb->ma", w, delta, right[k + 1])
                    else:
                        delta = jnp.einsum("ma,mn->an", diff, w)[:, :, None]
                        rp = jnp.einsum("mn,anb->ma", w, delta)
                    if k > 1:
                        val = jnp.einsum("ma,mab,mb->m", rp, left_is[k - 1], rp)
                    else:
                        val = jnp.einsum("ma,ma->m", rp, rp)
                    norm2 = jnp.maximum(jnp.sum(val), 0.0)
                pyr = jnp.sum(delta * delta)
                step = jnp.where(norm2 > 0, pyr / jnp.maximum(norm2, 1e-300), 0.0)
                new_core = cores[k] - step * delta
                if k + 1 < d:
                    rl, n, rr = new_core.shape
                    q, r = jnp.linalg.qr(new_core.reshape(rl * n, rr))
                    cores[k] = q.reshape(rl, n, q.shape[1])
                    cores[k + 1] = jnp.einsum("ab,bnc->anc", r, cores[k + 1])
                    # left stacks with the updated (orthogonal) core
                    C2 = cores[k]
                    if k == 0:
                        X0n = C2.reshape(C2.shape[1], C2.shape[2])
                        left_ought[0] = jnp.einsum("mn,nb->mb", sols, X0n)
                        left_is[0] = None
                    else:
                        meas = jnp.einsum("mn,anb->mab", pos[k - 1], C2)
                        if k > 1:
                            left_is[k] = jnp.einsum("mab,mac,mcd->mbd", meas,
                                                    left_is[k - 1], meas)
                        else:
                            left_is[k] = jnp.einsum("mab,mac->mbc", meas, meas)
                        left_ought[k] = jnp.einsum("ma,mab->mb",
                                                   left_ought[k - 1], meas)
                else:
                    cores[k] = new_core
            return tuple(cores), resid

        cores = tuple(c.to_jax() for c in self.x.components)
        residuals = [1000.0] * 10
        for _ in range(max_iterations):
            cores, resid = iteration(cores)
            residuals.append(float(resid) / self.sol_norm)
            if residuals[-1] / residuals[-10] > 0.99:
                break
        self.x.components = [Tensor.from_jax(c) for c in cores]
        self.x.canonicalized = False
        self.x.move_core(0, keep_rank=True)


def uq_adf(arg1, arg2, solutions=None, max_iterations: int = 1000,
           mesh=None):
    """uq_adf(x, random_variables, solutions) or
    uq_adf(measurement_set, guess) (uqAdf.h:54-56).  `mesh` shards the
    sample axis over the mesh's "dp" axis (multi-chip)."""
    if isinstance(arg1, UQMeasurementSet):
        ms, guess = arg1, arg2
        if ms.initialRandomVectors:
            x = _initial_guess_from_special_samples(ms, guess)
            rvs = list(ms.randomVectors) + list(ms.initialRandomVectors)
            sols = list(ms.solutions) + list(ms.initialSolutions)
        else:
            x = guess.copy()
            rvs, sols = list(ms.randomVectors), list(ms.solutions)
        _UQInternalSolver(x, rvs, sols).solve(max_iterations, mesh)
        return x
    x, random_variables = arg1, arg2
    _UQInternalSolver(x, random_variables, solutions).solve(max_iterations, mesh)
    return None


def _initial_guess_from_special_samples(ms: UQMeasurementSet,
                                        guess: TTTensor) -> TTTensor:
    """Mean + per-direction linear terms from axis-aligned initial samples
    (uqAdf.cpp:334-407)."""
    dims = list(guess.dimensions)
    sols = [s.to_ndarray() if isinstance(s, Tensor) else np.asarray(s)
            for s in ms.solutions]
    mean = np.mean(np.stack(sols), axis=0)

    def term(first_vec, active: int = -1) -> TTTensor:
        comps = [Tensor.from_ndarray(first_vec.reshape(1, dims[0], 1))]
        for k in range(1, len(dims)):
            pos = 0 if (active < 0 or k - 1 == active) else 1
            comps.append(Tensor.dirac([1, dims[k], 1], [0, pos, 0]))
        out = TTTensor._make(comps)
        out.assume_core_position(0)
        return out

    new_x = term(mean)
    for m, rv in enumerate(ms.initialRandomVectors):
        init_sol = (ms.initialSolutions[m].to_ndarray()
                    if isinstance(ms.initialSolutions[m], Tensor)
                    else np.asarray(ms.initialSolutions[m]))
        new_x += term(init_sol - mean, active=m)
    new_x.round(0.00025)
    return new_x


def uq_mc(x: TTTensor, N: int, num_special: int = 0
          ) -> Tuple[List[List[float]], List[Tensor]]:
    """Monte-Carlo sample (random vectors, solutions) from a UQ TT
    (uqAdf.cpp:425-448)."""
    rng = _misc.randomEngine
    random_variables = []
    solutions = []
    for _ in range(N):
        rv = []
        p = jnp.ones((1,), dtype=config.value_dtype)
        for k in range(x.degree() - 1, 0, -1):
            v = (0.3 if k <= num_special else 1.0) * float(rng.normal())
            rv.insert(0, v)
            C = x.components[k].to_jax()
            w = jnp.asarray(randvar_to_position(v, x.dimensions[k]))
            p = jnp.einsum("anb,b,n->a", C, p, w)
        C0 = x.components[0].to_jax()
        sol = jnp.einsum("anb,b->n", C0, p)
        solutions.append(Tensor.from_jax(sol))
        random_variables.append(rv)
    return random_variables, solutions


def uq_avg(x: TTTensor, N: int, num_special: int = 0) -> Tensor:
    """Monte-Carlo average of the physical mode (uqAdf.cpp:451-477)."""
    _, sols = uq_mc(x, N, num_special)
    acc = sols[0].to_jax()
    for s in sols[1:]:
        acc = acc + s.to_jax()
    return Tensor.from_jax(acc / N)
