"""Expression evaluation: trace -> einsum -> assignment.

This is the JAX replacement for the reference's evaluation stack
(src/xerus/indexedTensorWritable.cpp:60-80,
src/xerus/indexedTensor_tensor_evaluate.cpp:248,
src/xerus/tensorNetwork.cpp:1253): at assignment time the expression tree is
resolved to labelled operands and compiled to ONE cached, jitted einsum whose
contraction path is chosen once per (structure, shapes) signature — the
reference re-runs its heuristic search at every evaluation
(tensorNetwork.cpp:1321); we must not.

Sparse-representation-preserving fast paths (permutations, pairwise
contractions) route through core.contract / core.reshuffle instead.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..config import require
from ..core.tensor import Tensor, reshuffle as core_reshuffle
from ..core.contract import contract as core_contract
from ..core import factorizations as fact
from .expressions import (Expression, IndexedTensor, Product, Sum, SolveExpr,
                          Factorisation)

Label = Tuple[int, int]


# ---------------------------------------------------------------------------
# Cached jitted einsum
# ---------------------------------------------------------------------------

@lru_cache(maxsize=8192)
def _einsum_callable(op_labels: Tuple[Tuple[int, ...], ...],
                     out_labels: Tuple[int, ...],
                     shapes: Tuple[Tuple[int, ...], ...]):
    def f(*arrays):
        args: list = []
        for arr, labs in zip(arrays, op_labels):
            args.append(arr)
            args.append(list(labs))
        args.append(list(out_labels))
        return jnp.einsum(*args, optimize="auto",
                          preferred_element_type=arrays[0].dtype)
    return jax.jit(f)


def _run_einsum(operands: List[Tuple[object, Tuple[Label, ...]]],
                out_labels: Sequence[Label]):
    """Canonicalize labels to dense ints and run the cached jitted einsum."""
    mapping: Dict[Label, int] = {}

    def canon(labs):
        out = []
        for l in labs:
            if l not in mapping:
                mapping[l] = len(mapping)
            out.append(mapping[l])
        return tuple(out)

    op_labs = tuple(canon(labs) for _, labs in operands)
    out_labs = canon(tuple(out_labels))
    arrays = [a for a, _ in operands]
    shapes = tuple(tuple(a.shape) for a in arrays)
    return _einsum_callable(op_labs, out_labs, shapes)(*arrays)


# ---------------------------------------------------------------------------
# Operand gathering
# ---------------------------------------------------------------------------

class _Term:
    """A single indexed object resolved into (Tensor operand, labels)."""

    __slots__ = ("tensor", "labels")

    def __init__(self, tensor: Tensor, labels: List[Label]):
        self.tensor = tensor
        self.labels = labels


def _resolve_term(it: IndexedTensor) -> List[_Term]:
    """Resolve one IndexedTensor into concrete (Tensor, labels) operands,
    applying fixed indices and expanding networks into their nodes."""
    labels, fixed = it.resolved()
    obj = it.obj

    if isinstance(obj, Tensor):
        t = obj
        if any(f is not None for f in fixed):
            t = t.copy()
            # fix from the last mode so positions stay valid
            for m in reversed(range(len(fixed))):
                if fixed[m] is not None:
                    t.fix_mode(m, fixed[m])
            labels = [l for l, f in zip(labels, fixed) if f is None]
        return [_Term(t, list(labels))]

    # TensorNetwork-like objects expand into their nodes; external link k of
    # the network carries the resolved outer label labels[k], internal links
    # get fresh labels shared by their two endpoints.
    if hasattr(obj, "einsum_operands"):
        require(all(f is None for f in fixed),
                "fixed indices on networks: fix the network first")
        return [_Term(t, list(ls)) for t, ls in obj.einsum_operands(labels)]

    raise TypeError(f"cannot evaluate object of type {type(obj)!r}")


def _open_labels(terms: List[_Term]) -> List[Label]:
    """Labels appearing exactly once across all operands, in appearance order."""
    counts: Dict[Label, int] = {}
    order: List[Label] = []
    for term in terms:
        for l in term.labels:
            if l not in counts:
                order.append(l)
            counts[l] = counts.get(l, 0) + 1
    return [l for l in order if counts[l] == 1]


def _label_dims(terms: List[_Term]) -> Dict[Label, int]:
    dims: Dict[Label, int] = {}
    for term in terms:
        for l, d in zip(term.labels, term.tensor.dimensions):
            if l in dims:
                require(dims[l] == d,
                        f"dimension mismatch for shared index: {dims[l]} vs {d}")
            else:
                dims[l] = d
    return dims


# ---------------------------------------------------------------------------
# Product evaluation
# ---------------------------------------------------------------------------

def _eval_product(p: Product, out_labels: Optional[List[Label]]) -> Tuple[Tensor, List[Label]]:
    terms: List[_Term] = []
    for f in p.factors:
        terms.extend(_resolve_term(f))
    opens = _open_labels(terms)
    if out_labels is None:
        out_labels = opens
    else:
        require(sorted(map(repr, opens)) == sorted(map(repr, out_labels)),
                f"LHS indices {out_labels} do not match open RHS indices {opens}")

    # validity: every non-open label must appear exactly twice (a trace or a
    # contraction); matches the reference's index rules.
    counts: Dict[Label, int] = {}
    for t in terms:
        for l in t.labels:
            counts[l] = counts.get(l, 0) + 1
    for l, c in counts.items():
        require(c <= 2, f"index used {c} > 2 times")

    dims = _label_dims(terms)
    scalar = p.scalar
    for t in terms:
        scalar *= t.tensor.factor

    result = _sparse_fast_path(terms, out_labels)
    if result is None:
        operands = [(t.tensor.to_jax(apply_factor=False), tuple(t.labels))
                    for t in terms]
        arr = _run_einsum(operands, out_labels)
        result = Tensor.from_jax(arr)
    result.factor *= scalar
    return result, list(out_labels)


def _sparse_fast_path(terms: List[_Term], out_labels: List[Label]) -> Optional[Tensor]:
    """Representation-preserving evaluation for permutations and pairwise
    contractions involving sparse operands (the reference's dense/sparse
    kernel dispatch, tensor.cpp:1275-1352)."""
    if not any(t.tensor.is_sparse() for t in terms):
        return None

    if len(terms) == 1:
        t = terms[0]
        if len(set(t.labels)) == len(t.labels) and sorted(map(repr, t.labels)) == sorted(map(repr, out_labels)):
            # pure permutation: shuffle[old] = new position
            shuffle = [out_labels.index(l) for l in t.labels]
            res = core_reshuffle(t.tensor, shuffle)
            res.factor = 1.0  # factor folded by caller via term scan? no —
            # caller multiplies scalar which already includes tensor.factor
            return res
        return None

    if len(terms) == 2:
        a, b = terms
        if len(set(a.labels)) != len(a.labels) or len(set(b.labels)) != len(b.labels):
            return None
        shared = [l for l in a.labels if l in b.labels]
        if not shared:
            return None
        a_open = [l for l in a.labels if l not in shared]
        b_open = [l for l in b.labels if l not in shared]
        if sorted(map(repr, out_labels)) != sorted(map(repr, a_open + b_open)):
            return None
        # reorder a: open..., shared...; b: shared..., open...
        ta, tb = a.tensor, b.tensor
        fa, fb = ta.factor, tb.factor
        a_perm_target = a_open + shared
        b_perm_target = shared + b_open
        if a.labels != a_perm_target:
            ta = core_reshuffle(ta, [a_perm_target.index(l) for l in a.labels])
        if b.labels != b_perm_target:
            tb = core_reshuffle(tb, [b_perm_target.index(l) for l in b.labels])
        ta = ta.copy(); ta.factor = 1.0
        tb = tb.copy(); tb.factor = 1.0
        res = core_contract(ta, tb, len(shared))
        res_labels = a_open + b_open
        if res_labels != out_labels:
            res = core_reshuffle(res, [out_labels.index(l) for l in res_labels])
        # caller multiplies in scalar (which contains fa*fb)
        return res
    return None


# ---------------------------------------------------------------------------
# Generic expression evaluation
# ---------------------------------------------------------------------------

def _eval_expr(expr: Expression, out_labels: Optional[List[Label]]) -> Tuple[Tensor, List[Label]]:
    if isinstance(expr, IndexedTensor):
        return _eval_product(Product([expr]), out_labels)
    if isinstance(expr, Product):
        return _eval_product(expr, out_labels)
    if isinstance(expr, Sum):
        first_coeff, first_term = expr.terms[0]
        acc, labels = _eval_expr(first_term, out_labels)
        acc = acc.copy()
        acc.factor *= first_coeff
        for coeff, term in expr.terms[1:]:
            t, _ = _eval_expr(term, labels)
            t = t.copy()
            t.factor *= coeff
            acc += t
        return acc, labels
    if isinstance(expr, SolveExpr):
        return _eval_solve(expr, out_labels)
    raise TypeError(f"cannot evaluate {type(expr)!r}")


def _eval_solve(expr: SolveExpr, x_labels: Optional[List[Label]]) -> Tuple[Tensor, List[Label]]:
    """x = b / A: solve A x = b (indexedTensor_tensor_solve.cpp)."""
    b, b_labels = _eval_expr(expr.b, None)
    # A's open labels = b's labels + x's labels
    A_t, A_labels = _eval_expr(expr.A, None)
    x_open = [l for l in A_labels if l not in b_labels]
    require(len(x_open) + len(b_labels) == len(A_labels),
            "solve: A must carry all of b's open indices")
    if x_labels is None:
        x_labels = x_open
    require(sorted(map(repr, x_labels)) == sorted(map(repr, x_open)),
            "solve: LHS indices do not match A's free indices")
    want = list(b_labels) + list(x_labels)
    if A_labels != want:
        A_t = core_reshuffle(A_t, [want.index(l) for l in A_labels])
    x = fact.solve(A_t, b)
    return x, list(x_labels)


# ---------------------------------------------------------------------------
# Assignment entry points
# ---------------------------------------------------------------------------

def assign(lhs: IndexedTensor, rhs: Expression) -> None:
    target = lhs.obj
    # Specialized targets (TTNetwork, TensorNetwork) intercept here.
    hook = getattr(target, "assign_indexed", None)
    if hook is not None:
        hook(lhs, rhs)
        return
    require(isinstance(target, Tensor), f"cannot assign to {type(target)!r}")
    # Resolve LHS labels against the RHS-implied degree: spans like i&0 need
    # the result's degree, which equals the RHS open-label count.
    lhs_labels = _resolve_lhs_labels(lhs, rhs)
    result, _ = _eval_expr(rhs, lhs_labels)
    _write_into(target, result)


def _resolve_lhs_labels(lhs: IndexedTensor, rhs: Expression) -> Optional[List[Label]]:
    """LHS labels; target dims may not yet match the result, so spans are
    resolved against the RHS open-label count when needed."""
    degree = _rhs_open_count(rhs)
    labels: List[Label] = []
    for idx in lhs.indices:
        require(not idx.fixed(), "fixed indices not supported on assignment target")
        span = idx.actual_span(degree)
        for k in range(span):
            labels.append((idx.value_id, k))
    require(len(labels) == degree,
            f"LHS spans {len(labels)} modes but RHS result has {degree}")
    return labels


def _rhs_open_count(expr: Expression) -> int:
    if isinstance(expr, (IndexedTensor, Product)):
        p = expr if isinstance(expr, Product) else Product([expr])
        terms: List[_Term] = []
        for f in p.factors:
            terms.extend(_resolve_term(f))
        return len(_open_labels(terms))
    if isinstance(expr, Sum):
        return _rhs_open_count(expr.terms[0][1])
    if isinstance(expr, SolveExpr):
        return _rhs_open_count(expr.A) - _rhs_open_count(expr.b)
    raise TypeError(str(type(expr)))


def _write_into(target: Tensor, result: Tensor) -> None:
    target.dimensions = list(result.dimensions)
    target.factor = result.factor
    target.representation = result.representation
    target._dense = result._dense
    target._sparse = dict(result._sparse) if result._sparse is not None else None


def evaluate_to_tensor(expr: Expression, out_labels) -> Tensor:
    t, _ = _eval_expr(expr, out_labels)
    return t


# ---------------------------------------------------------------------------
# Factorisation assignment: (Q(i,r), R(r,j)) << QR(A(i,j))
# ---------------------------------------------------------------------------

def assign_factorisation(f: Factorisation, targets: List[IndexedTensor]) -> None:
    src, src_labels = _eval_expr(f.source, None)

    if f.kind == "svd":
        require(len(targets) == 3, "SVD needs (U, S, Vt) targets")
    else:
        require(len(targets) == 2, f"{f.kind} needs two targets")

    # The shared "rank" index appears in consecutive targets; the split
    # position is where the first target's non-rank labels end.
    first_ids = [i.value_id for i in targets[0].indices if not i.fixed()]
    last_ids = [i.value_id for i in targets[-1].indices if not i.fixed()]
    rank_ids = set(first_ids) & set(last_ids)
    if f.kind == "svd":
        rank_ids = (set(first_ids) & {i.value_id for i in targets[1].indices}) | \
                   (set(last_ids) & {i.value_id for i in targets[1].indices})
    # labels of source covered by the first target (all but the rank index)
    first_open = [vid for vid in first_ids if vid not in rank_ids]
    # reorder src so that first_open labels come first, in target order
    src_order: List[Label] = []
    for vid in first_open:
        src_order.extend([l for l in src_labels if l[0] == vid])
    split_pos = len(src_order)
    for l in src_labels:
        if l not in src_order:
            src_order.append(l)
    if src_order != src_labels:
        src = core_reshuffle(src, [src_order.index(l) for l in src_labels])

    if f.kind == "svd":
        U, S, Vt = fact.calculate_svd(src, split_pos, f.max_rank, f.eps)
        if f.soft_threshold > 0.0:
            # shrink singular values by tau and drop the zeros
            # (reference SVD(..., softThreshold) argument,
            # indexedTensor_tensor_factorisations.h:40-100)
            import numpy as _np
            s = _np.diag(_np.asarray(S.to_ndarray()))
            s = _np.maximum(s - f.soft_threshold, 0.0)
            keep = max(int(_np.sum(s > 0)), 1)
            if f.max_rank:
                keep = min(keep, f.max_rank)
            U.resize_mode(U.degree() - 1, keep)
            Vt.resize_mode(0, keep)
            from ..core.tensor import Tensor as _T, Representation as _R
            S = _T([keep, keep], _R.Sparse)
            for i2 in range(keep):
                S._sparse[i2 * keep + i2] = float(s[i2])
        results = (U, S, Vt)
    elif f.kind == "qr":
        results = fact.calculate_qr(src, split_pos)
    elif f.kind == "rq":
        results = fact.calculate_rq(src, split_pos)
    elif f.kind == "qc":
        results = fact.calculate_qc(src, split_pos)
    elif f.kind == "cq":
        results = fact.calculate_cq(src, split_pos)
    else:
        raise ValueError(f"unknown factorisation {f.kind!r}")

    # Produced mode labels: lhs factor carries src_order[:split]+[rank],
    # rhs factor [rank]+src_order[split:]; middle (SVD S) is rank x rank.
    RANK = (-2, 0)
    RANK2 = (-3, 0)
    if f.kind == "svd":
        produced = [list(src_order[:split_pos]) + [RANK],
                    [RANK, RANK2],
                    [RANK2] + list(src_order[split_pos:])]
    elif f.kind in ("qr", "qc"):
        produced = [list(src_order[:split_pos]) + [RANK],
                    [RANK] + list(src_order[split_pos:])]
    else:  # rq, cq: first output keeps the lhs modes, rank is its last mode
        produced = [list(src_order[:split_pos]) + [RANK],
                    [RANK] + list(src_order[split_pos:])]

    rank_vids = list(rank_ids)
    for tgt, res, prod_labels in zip(targets, results, produced):
        _write_reordered(tgt, res, prod_labels, rank_vids)


def _write_reordered(target: IndexedTensor, result: Tensor,
                     produced_labels: List[Label], rank_vids: List[int]) -> None:
    """Reshuffle a factorisation output into the target's index order."""
    degree = result.degree()
    want: List[Label] = []
    for idx in target.indices:
        require(not idx.fixed(), "fixed indices not supported on factorisation target")
        span = idx.actual_span(degree)
        if idx.value_id in rank_vids:
            # rank indices: match any produced rank label, in order of use
            rank_labels = [l for l in produced_labels if l[0] < 0 and l not in want]
            require(span == 1, "rank index must have span one")
            want.append(rank_labels[0])
        else:
            mine = [l for l in produced_labels if l[0] == idx.value_id]
            require(len(mine) == span,
                    f"factorisation target index spans {span} but source has {len(mine)}")
            want.extend(mine)
    require(len(want) == degree, "factorisation target index spans mismatch")
    if want != produced_labels:
        result = core_reshuffle(result, [want.index(l) for l in produced_labels])
    _write_into(target.obj, result)
