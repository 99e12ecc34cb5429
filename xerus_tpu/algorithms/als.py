"""ALS / DMRG / ASD sweep engine for min ||Ax-b|| (or ||x-b||) on the TT
manifold.

Re-design of the reference's single configurable engine
(include/xerus/algorithms/als.h:37-223, src/xerus/algorithms/als.cpp):

* ``sites=1`` -> ALS, ``sites=2`` -> DMRG; ``local_solver='asd'`` replaces
  the local solve by one exact-step gradient step (als.cpp:73-92).
* ``assume_spd`` selects the <x,Ax> energy path; otherwise the engine works
  on the normal equations A^T A x = A^T b (choose_energy_functional,
  als.cpp:255-300).
* Left/right environment caches (localOperatorCache / rhsCache,
  als.cpp:217-253, 340-380) are jnp arrays updated per step; every einsum
  dispatches to XLA.  The device-resident full-sweep kernel lives in
  ops/tt_kernels.py.

Not ported: prepare_x_for_als' full-rank node elision (als.cpp:105-182) — a
work-skipping gauge choice (full-rank boundary nodes set to reshape-identity
and excluded from the sweep).  Formalized divergence: see PARITY.md §2.4 and
tests/test_als.py::test_full_rank_boundary_node_elision_is_gauge_neutral,
which pins that both gauges converge to the same solution.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import numpy as np
import jax.numpy as jnp

from ..config import config, require
from ..core.tensor import Tensor
from ..core import factorizations as fact
from ..tt.ttnetwork import TTTensor, TTOperator, apply_operator
from .performance_data import PerformanceData, NoPerfData

FLAG_FINISHED_HALFSWEEP = 1
FLAG_FINISHED_FULLSWEEP = 3


class ALSVariant:
    """Configurable sweep solver (als.h:37-208)."""

    def __init__(self, sites: int, num_half_sweeps: int, local_solver: str,
                 assume_spd: bool, use_residual: bool = False):
        require(sites > 0, "sites must be positive")
        self.sites = sites
        self.numHalfSweeps = num_half_sweeps
        self.convergenceEpsilon = 1e-6
        self.useResidualForEndCriterion = use_residual
        self.preserveCorePosition = True
        self.assumeSPD = assume_spd
        self.local_solver = local_solver  # 'lapack' | 'asd'

    # the reference's LocalSolver binding surface (leastSquares.cpp:133-135;
    # als.h:43-48): class attrs naming the solvers + a localSolver member
    lapack_solver = "lapack"
    ASD_solver = "asd"
    LocalSolver = str

    @property
    def localSolver(self) -> str:
        return self.local_solver

    @localSolver.setter
    def localSolver(self, value: str) -> None:
        self.local_solver = value

    # -- call styles (als.h:152-208) -----------------------------------
    def __call__(self, *args, **kwargs) -> float:
        """(A, x, b, [eps|num_half_sweeps], [perf_data]) or (x, b, ...)."""
        args = list(args)
        A = None
        if isinstance(args[0], TTOperator):
            A = args.pop(0)
        x = args.pop(0)
        b = args.pop(0)
        eps = self.convergenceEpsilon
        num_half_sweeps = self.numHalfSweeps
        perf = kwargs.get("perf_data", NoPerfData)
        for a in args:
            if isinstance(a, PerformanceData):
                perf = a
            elif isinstance(a, float):
                eps = a
            elif isinstance(a, int):
                num_half_sweeps = a
        return self.solve(A, x, b, num_half_sweeps, eps, perf)

    # ------------------------------------------------------------------
    def solve(self, A: Optional[TTOperator], x: TTTensor, b: TTTensor,
              num_half_sweeps: int, conv_eps: float,
              perf: PerformanceData = NoPerfData) -> float:
        if (self.sites == 1 and A is not None
                and (self.local_solver == "lapack"
                     or (self.local_solver in ("asd", "cg")
                         and self.assumeSPD))):
            return self._solve_fast(A, x, b, num_half_sweeps, conv_eps, perf)
        data = _ALSData(self, A, x, b)
        perf.start()
        while True:
            # local solve at data.curr
            if self.local_solver == "asd":
                _asd_step(data)
            else:
                _local_solve(data)
            done = _check_end_of_sweep(data, num_half_sweeps, conv_eps, perf)
            if done:
                break
            data.move_to_next_index()
        if data.canonicalize_at_end and self.preserveCorePosition:
            x.move_core(data.core_pos_at_end, keep_rank=True)
        return data.residual()

    def _solve_fast(self, A: TTOperator, x: TTTensor, b: TTTensor,
                    num_half_sweeps: int, conv_eps: float,
                    perf: PerformanceData) -> float:
        """Whole-halfsweep jitted path for single-site SPD ALS: each
        half-sweep is ONE XLA program computing the sweep AND the relative
        residual (ops/tt_kernels.py make_als_sweep_res); the convergence
        loop stays on host (SURVEY.md §7 design stance) but fetches only
        ONE scalar per half-sweep — the cores never leave the device until
        the loop ends."""
        from ..ops.tt_kernels import make_als_sweep_res
        from ..config import host
        initial_canon = x.canonicalized
        initial_core = x.corePosition if x.canonicalized else 0
        with host():   # object-level prep uses host LAPACK
            x.move_core(0)
            norm_b = b.frob_norm() or 1.0
            # The reference's local solver runtime-detects symmetry and
            # falls back to PLU (blasLapackWrapper.cpp:542-585); decide
            # once per operator here so the compiled sweeps stay
            # branch-free.  "assumeSPD" selects the energy functional,
            # NOT the local factorization (als.cpp:43-48 calls the
            # auto-dispatching xerus::solve).
            local_assume = "pos" if (self.assumeSPD
                                     and A.is_symmetric()) else "gen"
        obj_dtype = np.asarray(x.components[0].to_ndarray()).dtype

        def dev(c):
            return jnp.asarray(np.asarray(c.to_ndarray()))

        A_cores = tuple(dev(c) for c in A.components)
        b_cores = tuple(dev(c) for c in b.components)
        cores = tuple(dev(c) for c in x.components)

        def to_host_tensors(cores_now):
            return [Tensor.from_ndarray(
                np.asarray(c).astype(obj_dtype)) for c in cores_now]

        def reverse_tt(cs):
            return tuple(jnp.transpose(c, (2, 1, 0)) for c in reversed(cs))

        def reverse_op(cs):
            return tuple(jnp.transpose(c, (3, 1, 2, 0)) for c in reversed(cs))

        perf.start()
        energy = last = last2 = math.inf
        half_sweeps = 0
        direction = "lr"
        spd = self.assumeSPD
        reversed_state = False
        asd = self.local_solver in ("asd", "cg")
        instrumented = bool(perf) and (perf.error_function
                                       or perf.checkpoint_path)
        if not instrumented:
            # device-resident loop: ALL half-sweeps + residuals + the
            # two-back stagnation test as ONE while_loop program
            # (ops/tt_kernels.make_als_run / make_als_run_rev) — the
            # per-sweep host loop paid one dispatch + one scalar fetch
            # (+ reversal dispatches for the lr-only kernels) per
            # half-sweep
            from ..ops.tt_kernels import make_als_run, make_als_run_rev
            CAP = 32  # static compile bucket; `remaining` trims it
            shapes_key = tuple(tuple(c.shape) for c in cores)
            dt = cores[0].dtype
            cores0 = cores
            while True:  # one-shot Cholesky-failure retry (see below)
                if spd and not asd:
                    run = make_als_run(shapes_key, str(cores0[0].dtype), CAP,
                                       local_assume=local_assume)
                else:
                    run = make_als_run_rev(
                        shapes_key, str(cores0[0].dtype), CAP,
                        solver=self.local_solver if asd else "nonspd")
                cores = cores0
                total = 0
                parity = 0
                energy = last = last2 = math.inf
                half_sweeps = 0
                chol_nan = False
                # num_half_sweeps == 0 means run until stagnation (host
                # loop semantics: `half_sweeps == num_half_sweeps` never
                # fires)
                while num_half_sweeps == 0 or total < num_half_sweeps:
                    remaining_before = (num_half_sweeps - total
                                        if num_half_sweeps else CAP)
                    cores, hist, cnt = run(
                        cores, A_cores, b_cores, jnp.asarray(conv_eps, dt),
                        jnp.asarray(parity, jnp.int32),
                        jnp.asarray(remaining_before, jnp.int32),
                        jnp.asarray(energy if math.isfinite(energy)
                                    else np.inf, dt),
                        jnp.asarray(last if math.isfinite(last)
                                    else np.inf, dt))
                    cnt = int(cnt)
                    hist_host = np.asarray(hist)[:cnt]
                    for j, rv in enumerate(hist_host):
                        half_sweeps += 1
                        last2, last = last, energy
                        energy = float(rv)
                        if not math.isfinite(energy):
                            if local_assume == "pos" and spd and not asd:
                                chol_nan = True
                                break
                            from ..misc.profiling import guard_finite
                            guard_finite(cores[0],
                                         f"ALS half-sweep {half_sweeps}")
                        if perf:
                            sweep_lr = (parity + j) % 2 == 0
                            perf.add(energy, x,
                                     FLAG_FINISHED_HALFSWEEP if sweep_lr
                                     else FLAG_FINISHED_FULLSWEEP)
                    if chol_nan:
                        break
                    total += max(cnt, 1)
                    parity = total % 2
                    if cnt < min(remaining_before, CAP):
                        break  # in-program stagnation/limit fired
                if chol_nan:
                    # The reference's solve retries a failed Cholesky via
                    # LDL^T (blasLapackWrapper.cpp:586-651): a symmetric
                    # but INDEFINITE operator (e.g. a Hamiltonian MPO)
                    # passes is_symmetric yet NaNs under assume_a='pos'.
                    # Detect the non-finite fetched residual and re-run
                    # the solve from the initial cores with the general
                    # local solver.
                    local_assume = "gen"
                    continue
                break
            direction = "lr" if (total - 1) % 2 == 0 else "rl"
            with host():
                x.components = to_host_tensors(cores)
                x.assume_core_position(
                    x.num_components() - 1 if direction == "lr" else 0)
                if initial_canon and self.preserveCorePosition:
                    x.move_core(initial_core, keep_rank=True)
            return energy
        cores0 = cores
        while True:
            shapes_key = tuple(tuple(c.shape) for c in cores)
            if asd:
                # ASD / matrix-free CG (SPD): lr kernel only; odd
                # half-sweeps run on the site-reversed system
                # (ops/tt_kernels.py _asd_half_sweep / _als_half_sweep_cg)
                if (direction == "rl") != reversed_state:
                    cores = reverse_tt(cores)
                    A_cores = reverse_op(A_cores)
                    b_cores = reverse_tt(b_cores)
                    reversed_state = not reversed_state
                shapes_key = tuple(tuple(c.shape) for c in cores)
                fn = make_als_sweep_res(shapes_key, str(cores[0].dtype), "lr",
                                        spd=True, solver=self.local_solver)
                cores, res = fn(cores, A_cores, b_cores)
            elif spd:
                fn = make_als_sweep_res(shapes_key, str(cores[0].dtype),
                                        direction,
                                        local_assume=local_assume)
                cores, res = fn(cores, A_cores, b_cores)
            else:
                # non-SPD: lr kernel only; odd half-sweeps run on the
                # site-reversed system (equivalent to an rl sweep)
                if (direction == "rl") != reversed_state:
                    cores = reverse_tt(cores)
                    A_cores = reverse_op(A_cores)
                    b_cores = reverse_tt(b_cores)
                    reversed_state = not reversed_state
                shapes_key = tuple(tuple(c.shape) for c in cores)
                fn = make_als_sweep_res(shapes_key, str(cores[0].dtype), "lr",
                                        spd=False)
                cores, res = fn(cores, A_cores, b_cores)
            half_sweeps += 1
            last2, last = last, energy
            # the ONLY device fetch of the loop: one scalar (fused
            # residual); it also serves as the finiteness guard
            energy = float(res)
            if not math.isfinite(energy):
                if local_assume == "pos" and spd and not asd:
                    # Cholesky NaN on a symmetric-indefinite operator:
                    # restart with the general local solver (reference
                    # LDL^T fallback, blasLapackWrapper.cpp:586-651)
                    local_assume = "gen"
                    cores = cores0
                    energy = last = last2 = math.inf
                    half_sweeps = 0
                    direction = "lr"
                    continue
                from ..misc.profiling import guard_finite
                guard_finite(cores[0], f"ALS half-sweep {half_sweeps}")
            if perf:
                flags = FLAG_FINISHED_HALFSWEEP if direction == "lr" \
                    else FLAG_FINISHED_FULLSWEEP
                if perf.error_function or perf.checkpoint_path:
                    # instrumented run: materialize x for the callback
                    with host():
                        x.components = to_host_tensors(
                            reverse_tt(cores) if reversed_state else cores)
                perf.add(energy, x, flags)
            if (half_sweeps == num_half_sweeps
                    or abs(last - energy) < conv_eps
                    or abs(last2 - energy) < conv_eps):
                break
            direction = "rl" if direction == "lr" else "lr"
        if reversed_state:
            cores = reverse_tt(cores)
        with host():
            x.components = to_host_tensors(cores)
            if spd and not asd:
                x.assume_core_position(
                    x.num_components() - 1 if direction == "lr" else 0)
            else:
                # reversal-style sweeps (non-SPD, ASD) end at site d-1 of
                # the possibly-reversed system
                x.assume_core_position(0 if reversed_state else
                                       x.num_components() - 1)
            if initial_canon and self.preserveCorePosition:
                x.move_core(initial_core, keep_rank=True)
        return energy


class _ALSData:
    """Environment caches + sweep state (ALSAlgorithmicData, als.h:44-107)."""

    def __init__(self, variant: ALSVariant, A: Optional[TTOperator],
                 x: TTTensor, b: TTTensor):
        require(x.dimensions == b.dimensions, "x and b dimensions must match")
        if A is not None:
            num = A.num_components()
            require(A.dimensions[:num] == x.dimensions
                    and A.dimensions[num:] == x.dimensions,
                    "operator dimensions must match x")
        self.v = variant
        self.A = A
        self.x = x
        self.b = b
        self.num = x.num_components()
        self.sites = variant.sites
        require(self.num >= self.sites, "TT too short for chosen number of sites")
        self.target_rank = list(x.ranks())
        self.norm_b = b.frob_norm()
        self.canonicalize_at_end = x.canonicalized
        self.core_pos_at_end = x.corePosition if x.canonicalized else 0

        x.move_core(0)
        self.curr = 0
        self.direction = +1
        self.half_sweeps = 0
        self.energy = math.inf
        self.last_energy = math.inf
        self.last_energy2 = math.inf

        spd_like = (A is None) or variant.assumeSPD
        self.spd = spd_like

        # Environment stacks.  SPD: op env (xl, al, xl'); else (xl, a1, a2, xl')
        # rhs env SPD/none: (xl, bl); else (bl, al, xl).
        one = jnp.ones((1,) * (3 if self.spd else 4), dtype=config.value_dtype) \
            if A is not None else None
        self.op_left: List = [one] if A is not None else [None]
        self.op_right: List = [one] if A is not None else [None]
        rb1 = jnp.ones((1, 1), dtype=config.value_dtype) if self.spd \
            else jnp.ones((1, 1, 1), dtype=config.value_dtype)
        self.rhs_left: List = [rb1]
        self.rhs_right: List = [rb1]
        for pos in range(self.num - 1, self.sites - 1, -1):
            self._push_right(pos)

    # -- core array accessors ------------------------------------------
    def _xc(self, i):
        return self.x.components[i].to_jax()

    def _bc(self, i):
        return self.b.components[i].to_jax()

    def _Ac(self, i):
        return self.A.components[i].to_jax()

    # -- environment pushes (als.cpp:184-253, 340-380) ------------------
    def _push_right(self, pos: int) -> None:
        xc = self._xc(pos)
        if self.A is not None:
            Ac = self._Ac(pos)
            if self.spd:
                env = jnp.einsum("umU,amnb,vnV,UbV->uav", xc, Ac, xc,
                                 self.op_right[-1])
            else:
                env = jnp.einsum("umU,pzmq,rznt,vnV,UqtV->uprv", xc, Ac, Ac,
                                 xc, self.op_right[-1])
            self.op_right.append(env)
        if self.spd:
            bc = self._bc(pos)
            renv = jnp.einsum("umU,bmB,UB->ub", xc, bc, self.rhs_right[-1])
        else:
            bc = self._bc(pos)
            Ac = self._Ac(pos)
            renv = jnp.einsum("bzB,azmq,umU,BqU->bau", bc, Ac, xc,
                              self.rhs_right[-1])
        self.rhs_right.append(renv)

    def _push_left(self, pos: int) -> None:
        xc = self._xc(pos)
        if self.A is not None:
            Ac = self._Ac(pos)
            if self.spd:
                env = jnp.einsum("uav,umU,amnb,vnV->UbV", self.op_left[-1],
                                 xc, Ac, xc)
            else:
                env = jnp.einsum("uprv,umU,pzmq,rznt,vnV->UqtV",
                                 self.op_left[-1], xc, Ac, Ac, xc)
            self.op_left.append(env)
        if self.spd:
            bc = self._bc(pos)
            renv = jnp.einsum("ub,umU,bmB->UB", self.rhs_left[-1], xc, bc)
        else:
            bc = self._bc(pos)
            Ac = self._Ac(pos)
            renv = jnp.einsum("bau,bzB,azmq,umU->BqU", self.rhs_left[-1],
                              bc, Ac, xc)
        self.rhs_left.append(renv)

    def move_to_next_index(self) -> None:
        if self.direction > 0:
            # left-orthogonalize current site, push env left
            self.x._transfer_core(self.curr, self.curr + 1, False)
            self._push_left(self.curr)
            if self.A is not None:
                self.op_right.pop()
            self.rhs_right.pop()
            self.curr += 1
        else:
            last = self.curr + self.sites - 1
            self.x._transfer_core(last, last - 1, False)
            self._push_right(last)
            if self.A is not None:
                self.op_left.pop()
            self.rhs_left.pop()
            self.curr -= 1
        self.x.assume_core_position(self.curr)

    # -- local system assembly (als.cpp:383-423) ------------------------
    def local_operator(self):
        """Matrix over (row = u m.. U) x (col = v n.. V)."""
        L = self.op_left[-1]
        R = self.op_right[-1]
        if self.spd:
            if self.sites == 1:
                Ac = self._Ac(self.curr)
                return jnp.einsum("uav,amnb,UbV->umUvnV", L, Ac, R)
            A1 = self._Ac(self.curr)
            A2 = self._Ac(self.curr + 1)
            return jnp.einsum("uav,amnb,bMNc,UcV->umMUvnNV", L, A1, A2, R)
        if self.sites == 1:
            Ac = self._Ac(self.curr)
            return jnp.einsum("uprv,pzmq,rznt,UqtV->umUvnV", L, Ac, Ac, R)
        A1, A2 = self._Ac(self.curr), self._Ac(self.curr + 1)
        return jnp.einsum("uprv,pzmq,rznt,qZMs,tZNw,UswV->umMUvnNV",
                          L, A1, A1, A2, A2, R)

    def local_rhs(self):
        Lb = self.rhs_left[-1]
        Rb = self.rhs_right[-1]
        if self.spd:
            if self.sites == 1:
                bc = self._bc(self.curr)
                return jnp.einsum("ub,bmB,UB->umU", Lb, bc, Rb)
            b1, b2 = self._bc(self.curr), self._bc(self.curr + 1)
            return jnp.einsum("ub,bmB,BMC,UC->umMU", Lb, b1, b2, Rb)
        if self.sites == 1:
            bc = self._bc(self.curr)
            Ac = self._Ac(self.curr)
            return jnp.einsum("bau,bzB,azmq,BqU->umU", Lb, bc, Ac, Rb)
        b1, b2 = self._bc(self.curr), self._bc(self.curr + 1)
        A1, A2 = self._Ac(self.curr), self._Ac(self.curr + 1)
        return jnp.einsum("bau,bzB,azmq,BZC,qZMs,CsU->umMU",
                          Lb, b1, A1, b2, A2, Rb)

    def local_identity_rhs(self):
        """A is None: projection of b onto the fixed-environment basis."""
        return self.local_rhs()

    # -- energy / residual (als.cpp:255-300) ----------------------------
    def residual(self) -> float:
        if self.A is not None:
            Ax = apply_operator(self.A, self.x)
            diff = Ax - self.b
            return diff.frob_norm() / (self.norm_b if self.norm_b > 0 else 1.0)
        diff = self.x - self.b
        return diff.frob_norm() / (self.norm_b if self.norm_b > 0 else 1.0)

    def energy_value(self) -> float:
        if self.A is None or not self.spd or self.v.useResidualForEndCriterion:
            return self.residual()
        # 0.5 <x,Ax> - <x,b> using the local system (x core = current sites)
        Aloc = self.local_operator()
        bloc = self.local_rhs()
        xl = self._local_x()
        row = xl.reshape(-1)
        n = row.shape[0]
        Amat = Aloc.reshape(n, n)
        return float(0.5 * row @ (Amat @ row) - row @ bloc.reshape(-1))

    def _local_x(self):
        xl = self._xc(self.curr)
        for p in range(1, self.sites):
            nxt = self._xc(self.curr + p)
            xl = jnp.tensordot(xl, nxt, axes=[[xl.ndim - 1], [0]])
        return xl


def _local_solve(data: _ALSData) -> None:
    """LAPACK-equivalent local solve + SVD split for sites>1 (als.cpp:43-71)."""
    bloc = data.local_rhs()
    shape = bloc.shape
    n = int(np.prod(shape))
    if data.A is not None:
        Aloc = data.local_operator().reshape(n, n)
        sol = fact._solve_matrix(Aloc, bloc.reshape(n, 1)).reshape(shape)
    else:
        sol = bloc
    _write_back(data, sol)


def _asd_step(data: _ALSData) -> None:
    """One exact-stepsize gradient step (als.cpp:73-92)."""
    require(data.sites == 1, "ASD only defined for single-site")
    bloc = data.local_rhs()
    xl = data._local_x()
    if data.A is not None:
        Aloc = data.local_operator()
        n = int(np.prod(xl.shape))
        Amat = Aloc.reshape(n, n)
        grad = bloc.reshape(-1) - Amat @ xl.reshape(-1)
        gg = float(grad @ grad)
        gAg = float(grad @ (Amat @ grad))
        alpha = gg / gAg if gAg > 0 else 0.0
        sol = (xl.reshape(-1) + alpha * grad).reshape(xl.shape)
    else:
        sol = bloc
    _write_back(data, sol)


def _write_back(data: _ALSData, sol) -> None:
    """Store the local solution into x's components; SVD-split for sites>1."""
    if data.sites == 1:
        data.x.components[data.curr] = Tensor.from_jax(sol)
        data.x.assume_core_position(data.curr)
        return
    t = Tensor.from_jax(sol)  # (u, m.., M.., U) for sites=2: (u,m,M,U)
    if data.direction > 0:
        U, S, Vt = fact.calculate_svd(t, 2, data.target_rank[data.curr],
                                      config.epsilon)
        from ..core.contract import contract as core_contract
        data.x.components[data.curr] = U
        data.x.components[data.curr + 1] = core_contract(S, Vt, 1)
        data.x.assume_core_position(data.curr + 1)
        # env bookkeeping: caches currently hold envs for [0,curr) and
        # (curr+sites-1, num); both still valid.
        data.x.corePosition = data.curr + 1
    else:
        U, S, Vt = fact.calculate_svd(t, 2, data.target_rank[data.curr],
                                      config.epsilon)
        from ..core.contract import contract as core_contract
        data.x.components[data.curr] = core_contract(U, S, 1)
        data.x.components[data.curr + 1] = Vt
        data.x.assume_core_position(data.curr)


def _check_end_of_sweep(data: _ALSData, num_half_sweeps: int, conv_eps: float,
                        perf: PerformanceData) -> bool:
    """(als.cpp:426-475)"""
    at_right_end = data.direction > 0 and data.curr == data.num - data.sites
    at_left_end = data.direction < 0 and data.curr == 0
    if at_right_end or at_left_end:
        data.half_sweeps += 1
        data.last_energy2 = data.last_energy
        data.last_energy = data.energy
        data.energy = data.energy_value()
        if perf:
            flags = FLAG_FINISHED_HALFSWEEP if data.direction > 0 \
                else FLAG_FINISHED_FULLSWEEP
            perf.stop_timer()
            residual = data.residual()
            perf.continue_timer()
            perf.add(residual, data.x, flags)
        if (data.half_sweeps == num_half_sweeps
                or abs(data.last_energy - data.energy) < conv_eps
                or abs(data.last_energy2 - data.energy) < conv_eps
                or data.num <= data.sites):
            return True
        data.direction = -data.direction
    elif perf:
        perf.stop_timer()
        residual = data.residual()
        perf.continue_timer()
        perf.add(residual, data.x, 0)
    return False


# preset variants (als.cpp:556-563)
ALS = ALSVariant(1, 0, "lapack", assume_spd=False)
ALS_SPD = ALSVariant(1, 0, "lapack", assume_spd=True)
# Extension: matrix-free CG local solves — never materializes
# the (r*n*r)^2 local operator; the large-rank single-site path
ALS_SPD_CG = ALSVariant(1, 0, "cg", assume_spd=True)
DMRG = ALSVariant(2, 0, "lapack", assume_spd=False)
DMRG_SPD = ALSVariant(2, 0, "lapack", assume_spd=True)
ASD = ALSVariant(1, 0, "asd", assume_spd=False)
ASD_SPD = ALSVariant(1, 0, "asd", assume_spd=True)
