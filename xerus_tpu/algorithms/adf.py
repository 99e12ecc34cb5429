"""ADF — alternating directional fitting for tensor completion.

Re-design of include/xerus/algorithms/adf.h:39-270,
src/xerus/algorithms/adf.cpp.  The reference builds per-measurement
forward/backward contraction stacks with sort+dedup prefix sharing
(adf.cpp:103-193) and OpenMP loops; the device formulation keeps the
stacks as (M, rank) batched arrays updated by gather-matmuls, the projected
gradient as a segment-sum over measurements, and the slice-wise optimal step
as a second segment-sum — all XLA ops that shard over the measurement axis.

Algorithm semantics match adf.cpp exactly: per sweep left->right, per core
compute the projected gradient E(A^T(b-Ax)), take the slice-wise optimal step
(PyR/|A P_j y|^2, update_x adf.cpp:468-487), move the core; terminate on
target residual or stagnating residual decrease (solve_with_current_ranks
adf.cpp:541-566); then bump ranks by a small random rank-1 perturbation and
re-solve until maxRanks (adf.cpp:589-601).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import jax.numpy as jnp

from ..config import config, require
from ..core.tensor import Tensor
from ..tt.ttnetwork import TTTensor
from .measurements import RankOneMeasurementSet
from .performance_data import PerformanceData, NoPerfData


class ADFVariant:
    def __init__(self, max_iterations: int, target_residual: float,
                 minimal_residual_decrease: float):
        self.maxIterations = max_iterations
        self.targetResidualNorm = target_residual
        self.minimalResidualNormDecrease = minimal_residual_decrease

    def __call__(self, x: TTTensor, measurements,
                 max_ranks: Optional[Sequence[int]] = None,
                 perf_data: PerformanceData = NoPerfData,
                 mesh=None, check_every: int = 1) -> float:
        """``mesh`` dp-shards the measurement axis of every iteration over
        the device mesh (SURVEY.md section 2.6a; same contract as
        uq_adf(mesh=...)); point measurements only.

        ``check_every=K`` chains K iterations per device dispatch
        (ops/adf_kernels.make_adf_multi_iteration): the stopping logic
        still sees every iteration's residual, but the iterate may
        overshoot the stopping point by up to K-1 (cheap) iterations.
        Use where per-dispatch latency dominates the iteration; K=1 is
        exact reference termination semantics (adf.cpp:541-566).

        ``check_every="device"`` runs the whole fixed-rank solve as ONE
        lax.while_loop program per rank level
        (ops/adf_kernels.make_adf_device_run): the stopping logic runs
        in-program with the same per-iteration semantics as K=1 (the
        cores end exactly one update past the stopping measurement), at
        one dispatch per rank level instead of one per K iterations."""
        solver = _InternalSolver(self, x,
                                 list(max_ranks) if max_ranks is not None
                                 else list(x.ranks()),
                                 measurements, perf_data)
        solver.mesh = mesh
        solver.check_every = ("device" if check_every == "device"
                              else max(1, int(check_every)))
        return solver.solve()


class _InternalSolver:
    def __init__(self, variant: ADFVariant, x: TTTensor, max_ranks: List[int],
                 measurements, perf: PerformanceData):
        self.v = variant
        self.x = x
        self.max_ranks = TTTensor.reduce_to_maximal_ranks(max_ranks, x.dimensions)
        self.meas = measurements
        self.rank_one = isinstance(measurements, RankOneMeasurementSet)
        self.perf = perf
        self.M = measurements.size()
        self.d = x.degree()
        require(self.d == measurements.degree(),
                "measurement degree does not match x")
        require(self.M > 0, "no measurements given")
        self.values = jnp.asarray(measurements.measuredValues)
        self.norm_values = float(np.linalg.norm(measurements.measuredValues)) or 1.0
        if self.rank_one:
            self.W = [jnp.asarray(w) for w in measurements.positions]
        else:
            self.P = jnp.asarray(measurements.positions)
        self.iteration = 0
        self.residual_norm = 1.0
        self.last_residual = 1.0
        # stacks: forward[k] covers components < k; backward[k] covers > k-2
        self.forward: List = [None] * (self.d + 1)
        self.backward: List = [None] * (self.d + 1)
        self.forward[0] = jnp.ones((self.M, 1), dtype=config.value_dtype)
        self.backward[self.d] = jnp.ones((self.M, 1), dtype=config.value_dtype)

    # -- stack updates (adf.cpp:255-290) --------------------------------
    def _site_matrix(self, k: int, comp) -> jnp.ndarray:
        """(M, rl, rr) view of component k selected per measurement."""
        C = comp.to_jax() if isinstance(comp, Tensor) else comp
        if self.rank_one:
            return jnp.einsum("anb,mn->mab", C, self.W[k])
        return jnp.transpose(jnp.take(C, self.P[:, k], axis=1), (1, 0, 2))

    def update_forward(self, k: int, comp) -> None:
        site = self._site_matrix(k, comp)
        self.forward[k + 1] = jnp.einsum("ma,mab->mb", self.forward[k], site)

    def update_backward(self, k: int, comp) -> None:
        site = self._site_matrix(k, comp)
        self.backward[k] = jnp.einsum("mab,mb->ma", site, self.backward[k + 1])

    # -- residual (adf.cpp:290-313) -------------------------------------
    def calc_residual(self, cp: int) -> jnp.ndarray:
        self.update_forward(cp, self.x.components[cp])
        pred = jnp.einsum("ma,ma->m", self.forward[cp + 1], self.backward[cp + 1])
        return self.values - pred

    # -- one sweep core step --------------------------------------------
    def _core_step(self, cp: int, residual: jnp.ndarray) -> None:
        comp = self.x.components[cp]
        rl, n, rr = comp.dimensions[0], comp.dimensions[1], comp.dimensions[2]
        F = self.forward[cp]          # (M, rl)
        B = self.backward[cp + 1]     # (M, rr)
        outer = jnp.einsum("m,ma,mb->mab", residual, F, B)
        if self.rank_one:
            # gradient (rl, n, rr) = sum_m outer x w
            grad = jnp.einsum("mab,mn->anb", outer, self.W[cp])
            # norm of A applied to grad (slot 0 only, adf.cpp:404-408)
            site = self._site_matrix(cp, Tensor.from_jax(grad))
            val = jnp.einsum("ma,mab,mb->m", F, site, B)
            denom = float(jnp.sum(val * val))
            PyR = float(jnp.sum(grad * grad))
            alpha = PyR / denom if denom > 0 else 0.0
            new = comp.to_jax() + alpha * grad
        else:
            idx = self.P[:, cp]
            grad_by_slice = jnp.zeros((n, rl, rr), dtype=config.value_dtype
                                      ).at[idx].add(outer)      # (n, rl, rr)
            grad = jnp.transpose(grad_by_slice, (1, 0, 2))       # (rl, n, rr)
            # slicewise |A P_j y|^2 (adf.cpp:415-466)
            Ggath = grad_by_slice[idx]                           # (M, rl, rr)
            val = jnp.einsum("ma,mab,mb->m", F, Ggath, B)
            norms = jnp.zeros((n,), dtype=config.value_dtype).at[idx].add(val * val)
            PyR = jnp.sum(grad_by_slice * grad_by_slice, axis=(1, 2))  # (n,)
            alpha = jnp.where(norms > 0, PyR / norms, 0.0)
            new = comp.to_jax() + alpha[None, :, None] * grad
        self.x.components[cp] = Tensor.from_jax(new)
        self.x.assume_core_position(cp)

    # -- main loop (adf.cpp:541-566) ------------------------------------
    def solve_with_current_ranks(self) -> None:
        return self._solve_current_ranks_jitted()

    def _solve_current_ranks_jitted(self) -> None:
        """Fast path: each iteration is ONE XLA program
        (ops/adf_kernels.py); host keeps only the stagnation logic."""
        from ..ops.adf_kernels import make_adf_iteration, build_onehots
        import jax

        if self.rank_one:
            onehots = tuple(jnp.asarray(w) for w in self.meas.positions)
        else:
            dims = [c.dimensions[1] for c in self.x.components]
            onehots = build_onehots(np.asarray(self.meas.positions), dims,
                                    np.dtype(config.value_dtype))
        from ..config import host
        with host():   # object-level canonicalization uses host LAPACK
            self.x.move_core(0, keep_rank=True)
        cores = tuple(c.to_jax() for c in self.x.components)

        from ..ops.adf_kernels import canonicalize_left_cores
        canonicalize_left = jax.jit(canonicalize_left_cores)

        res_dec = [0.0, 0.0, 0.0, 0.0]
        K = getattr(self, "check_every", 1)
        if K != "device":
            K = max(1, int(K))
        mesh = getattr(self, "mesh", None)
        while self.v.maxIterations == 0 or self.iteration < self.v.maxIterations:
            shapes_key = tuple(tuple(c.shape) for c in cores)
            if K == "device":
                # whole fixed-rank solve in ONE while_loop program; the
                # in-program stopping logic matches the K=1 host path and
                # carries (res_dec, last) across dispatches for exact
                # stagnation continuity.  Residuals enter/leave UNSCALED
                # (target and last are pre-multiplied by norm_values).
                from ..ops.adf_kernels import make_adf_device_run
                CAP = 512  # static compile bucket; `remaining` trims it
                # with a mesh, the one-hots/values dp-shard over the
                # measurement axis (point measurements; rank-one sets run
                # replicated, mirroring the chained factories)
                fn = make_adf_device_run(
                    shapes_key, str(cores[0].dtype), CAP, self.rank_one,
                    mesh if not self.rank_one else None)
                remaining = (self.v.maxIterations - self.iteration
                             if self.v.maxIterations else CAP)
                nv = self.norm_values
                dt = cores[0].dtype
                new_cores, hist, cnt = fn(
                    cores, onehots, jnp.asarray(self.values, dt),
                    jnp.asarray(self.v.targetResidualNorm * nv, dt),
                    jnp.asarray(self.v.minimalResidualNormDecrease, dt),
                    jnp.asarray(np.asarray(res_dec), dt),
                    jnp.asarray(self.residual_norm * nv, dt),
                    jnp.asarray(remaining, jnp.int32))
                cores = new_cores
                cnt = int(cnt)
                hist_host = np.asarray(hist)[:cnt]
                for rv in hist_host:
                    self.iteration += 1
                    self.last_residual = self.residual_norm
                    self.residual_norm = float(rv) / nv
                    self.perf.add(self.residual_norm, self.x, 0,
                                  iteration=self.iteration)
                    ratio = min(self.residual_norm
                                / (self.last_residual or 1.0), 1.0)
                    res_dec = [ratio] + res_dec[:3]
                if cnt < remaining and cnt < CAP:
                    break  # the in-program stop condition fired
                continue   # hit the cap bucket: dispatch again
            if K > 1:
                # K chained iterations per dispatch; the stopping logic
                # below still sees every iteration's residual (docstring
                # of ADFVariant.__call__).  With a mesh, the chained
                # program also dp-shards the measurement axis (point
                # measurements; rank-one sets fall back to the
                # replicated chain, mirroring the K=1 path below).
                if mesh is not None and not self.rank_one:
                    from ..ops.adf_kernels import (
                        make_adf_multi_iteration_sharded)
                    fn = make_adf_multi_iteration_sharded(
                        mesh, shapes_key, str(cores[0].dtype), K)
                else:
                    from ..ops.adf_kernels import make_adf_multi_iteration
                    fn = make_adf_multi_iteration(shapes_key,
                                                  str(cores[0].dtype), K,
                                                  self.rank_one)
                new_cores, hist = fn(cores, onehots,
                                     jnp.asarray(self.values))
                cores = new_cores          # canonicalized in-program
                stop = False
                for rv in np.asarray(hist):
                    self.iteration += 1
                    self.last_residual = self.residual_norm
                    self.residual_norm = float(rv) / self.norm_values
                    self.perf.add(self.residual_norm, self.x, 0,
                                  iteration=self.iteration)
                    ratio = min(self.residual_norm
                                / (self.last_residual or 1.0), 1.0)
                    res_dec = [ratio] + res_dec[:3]
                    if (self.residual_norm < self.v.targetResidualNorm
                            or np.prod(res_dec)
                            > self.v.minimalResidualNormDecrease ** 4
                            or (self.v.maxIterations
                                and self.iteration >= self.v.maxIterations)):
                        stop = True
                        break
                if stop:
                    break
                continue
            self.iteration += 1
            if mesh is not None and not self.rank_one:
                from ..ops.adf_kernels import make_adf_iteration_sharded
                fn = make_adf_iteration_sharded(mesh, shapes_key,
                                                str(cores[0].dtype))
            else:
                fn = make_adf_iteration(shapes_key, str(cores[0].dtype),
                                        self.rank_one)
            new_cores, resid0 = fn(cores, onehots, jnp.asarray(self.values))
            self.last_residual = self.residual_norm
            self.residual_norm = float(resid0) / self.norm_values
            self.perf.add(self.residual_norm, self.x, 0,
                          iteration=self.iteration)
            ratio = min(self.residual_norm / (self.last_residual or 1.0), 1.0)
            res_dec = [ratio] + res_dec[:3]
            cores = canonicalize_left(new_cores)
            if (self.residual_norm < self.v.targetResidualNorm
                    or np.prod(res_dec) > self.v.minimalResidualNormDecrease ** 4):
                break
        self.x.components = [Tensor.from_jax(c) for c in cores]
        self.x.assume_core_position(0)

    def _solve_current_ranks_host(self) -> None:
        res_dec = [0.0, 0.0, 0.0, 0.0]
        while self.v.maxIterations == 0 or self.iteration < self.v.maxIterations:
            self.iteration += 1
            self.x.move_core(0, keep_rank=True)
            for cp in range(self.d - 1, 0, -1):
                self.update_backward(cp, self.x.components[cp])
            residual = self.calc_residual(0)
            from ..misc.profiling import guard_finite
            guard_finite(residual, f"ADF iteration {self.iteration}")
            self.last_residual = self.residual_norm
            self.residual_norm = float(jnp.linalg.norm(residual)) / self.norm_values
            self.perf.add(self.residual_norm, self.x, 0, iteration=self.iteration)
            # ratios > 1 clamp to 1: an early residual jump must not inflate
            # the stagnation product into a spurious stop (the reference has
            # this failure mode for badly-scaled initial guesses)
            ratio = min(self.residual_norm / (self.last_residual or 1.0), 1.0)
            res_dec = [ratio] + res_dec[:3]
            if (self.residual_norm < self.v.targetResidualNorm
                    or np.prod(res_dec) > self.v.minimalResidualNormDecrease ** 4):
                return
            for cp in range(self.d):
                if cp > 0:
                    residual = self.calc_residual(cp)
                self._core_step(cp, residual)
                if cp + 1 < self.d:
                    self.x.move_core(cp + 1, keep_rank=True)
                    self.update_forward(cp, self.x.components[cp])

    def _solve_adaptive_device(self) -> float:
        """The whole rank-adaptive solve as ONE device program
        (ops/adf_kernels.make_adf_adaptive_run): cores padded to
        max_ranks, live ranks as data, rank bumps in-program (VERDICT r2
        item #5 — the per-rank-level path paid a host bump + a fresh
        while_loop program per level; this pays one dispatch total).

        Semantics vs the host loop: the bump is the same
        scale-eps*||x|| random rank-1 kick, drawn from an in-program
        deterministic key instead of the library RNG, and capped bonds
        ride slot 0 instead of being re-rounded (see _bump_cores).  The
        stagnation window restarts (not resumes) if the solve overflows
        the 512-iteration dispatch bucket."""
        from ..ops.adf_kernels import make_adf_adaptive_run, build_onehots
        from ..config import host

        with host():
            self.x.move_core(0, keep_rank=True)
        d = self.d
        caps = tuple(self.max_ranks)
        dims = [c.dimensions[1] for c in self.x.components]
        if self.rank_one:
            onehots = tuple(jnp.asarray(w) for w in self.meas.positions)
        else:
            onehots = build_onehots(np.asarray(self.meas.positions), dims,
                                    np.dtype(config.value_dtype))
        dt = np.dtype(config.value_dtype)
        padded = []
        for k, c in enumerate(self.x.components):
            arr = np.asarray(c.to_ndarray(), dt)
            capL = 1 if k == 0 else caps[k - 1]
            capR = 1 if k == d - 1 else caps[k]
            buf = np.zeros((capL, dims[k], capR), dt)
            buf[:arr.shape[0], :, :arr.shape[2]] = arr
            padded.append(jnp.asarray(buf))
        ranks = np.asarray(self.x.ranks(), np.int32)
        bump = max(1e-6, 16.0 * config.epsilon)
        CAP = 512
        shapes_key = tuple(tuple(c.shape) for c in padded)
        fn = make_adf_adaptive_run(shapes_key, str(padded[0].dtype), CAP,
                                   caps, float(bump),
                                   rank_one=self.rank_one)
        nv = self.norm_values
        cores = tuple(padded)
        while self.v.maxIterations == 0 or self.iteration < self.v.maxIterations:
            remaining = (self.v.maxIterations - self.iteration
                         if self.v.maxIterations else CAP)
            cores, ranks_dev, hist, cnt = fn(
                cores, onehots, jnp.asarray(self.values, dt),
                jnp.asarray(self.v.targetResidualNorm * nv, dt),
                jnp.asarray(self.v.minimalResidualNormDecrease, dt),
                jnp.asarray(ranks), jnp.asarray(self.residual_norm * nv, dt),
                jnp.asarray(remaining, jnp.int32))
            cnt = int(cnt)
            ranks = np.asarray(ranks_dev)
            for rv in np.asarray(hist)[:cnt]:
                self.iteration += 1
                self.last_residual = self.residual_norm
                self.residual_norm = float(rv) / nv
                self.perf.add(self.residual_norm, self.x, 0,
                              iteration=self.iteration)
            if cnt < remaining and cnt < CAP:
                break  # the in-program done condition fired
        out = []
        for k, c in enumerate(cores):
            rl = 1 if k == 0 else int(ranks[k - 1])
            rr = 1 if k == d - 1 else int(ranks[k])
            out.append(Tensor.from_ndarray(np.asarray(c)[:rl, :, :rr]))
        self.x.components = out
        self.x.assume_core_position(0)
        return self.residual_norm

    def solve(self) -> float:
        self.perf.start()
        if (getattr(self, "check_every", 1) == "device"
                and getattr(self, "mesh", None) is None
                and list(self.x.ranks()) != list(self.max_ranks)):
            return self._solve_adaptive_device()
        self.x.canonicalize_left()
        self.solve_with_current_ranks()
        while (self.residual_norm > self.v.targetResidualNorm
               and self.x.ranks() != self.max_ranks
               and (self.v.maxIterations == 0
                    or self.iteration < self.v.maxIterations)):
            # rank bump: add a tiny random rank-1 term, re-round, re-solve.
            # The bump scale is dtype-aware: the reference's 1e-6 (adf.cpp
            # :594) sits 9 orders above its f64 round threshold
            # (EPSILON=8*ulp~1.8e-15, ttNetwork.h) — but under the f32
            # value dtype config.epsilon is ~9.5e-7, exactly at 1e-6, and the
            # round nondeterministically truncated the bump away, freezing
            # bonds at their deficient ranks (observed: bond 0 stuck at
            # rank 1, solve stagnating at the rank-1 floor).  16x above
            # the threshold keeps the +1-per-bump growth semantics in
            # every dtype; in f64 the scale is the reference's 1e-6.
            from ..config import host
            with host():  # object-level f64 math off the accelerator
                self.x.move_core(0, keep_rank=True)
                rnd = TTTensor.random(self.x.dimensions, [1] * (self.d - 1))
                bump = max(1e-6, 16.0 * config.epsilon)
                scale = bump * self.x.frob_norm() / (rnd.frob_norm() or 1.0)
                bumped = self.x + scale * rnd
                bumped.round(self.max_ranks)
            self.x.components = bumped.components
            self.x.canonicalized = bumped.canonicalized
            self.x.corePosition = bumped.corePosition
            self.x.dimensions = bumped.dimensions
            self.solve_with_current_ranks()
        return self.residual_norm


ADF = ADFVariant(0, 1e-8, 0.999)
