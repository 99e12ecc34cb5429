"""Site-sharded TT arithmetic: blocks of sites per device, zero collectives.

The reference parallelizes exactly these ops with OpenMP threads — TT
entrywise product's per-component Kronecker loop (ttNetwork.cpp:1288-1300
`#pragma omp for`) and componentwise arithmetic — because every site's work
is independent.  On a device mesh the same independence maps to sharding the
SITE axis of the padded core stacks over a mesh axis with `shard_map`:
each device transforms its block of sites locally and no collective is
needed at all (SURVEY.md §2.6(c): "per-edge independence inside
entrywise_product, dyadic_product, TT addition ... mapped across devices
with a final canonicalization sweep").

Both ops return NON-canonicalized cores (same contract as the reference,
whose += and entrywise_product also leave the result un-canonicalized —
ttNetwork.cpp:797, 1275); run `round()`/`move_core` afterwards if needed.

For very long chains these scale linearly in d/p while the rank-sharded
paths (tsqr_round.py) keep per-site collectives; the two compose (site
blocks x rank shards) when both axes are large.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import List, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map


_MESHES = {}


def _pad_stack(cores: Sequence[np.ndarray], d_pad: int
               ) -> Tuple[np.ndarray, int]:
    """Pad a core list to a uniform (d_pad, r, n, r) stack (rank pad-to-max,
    trailing dummy zero sites up to d_pad)."""
    r = max(max(c.shape[0], c.shape[2]) for c in cores)
    n = cores[0].shape[1]
    out = np.zeros((d_pad, r, n, r), dtype=np.asarray(cores[0]).dtype)
    for k, c in enumerate(cores):
        out[k, :c.shape[0], :, :c.shape[2]] = c
    return out, r


def _entrywise_local(a_blk, b_blk):
    """Per-site Kronecker of the rank axes (ttNetwork.cpp:1288-1300)."""
    prod = jnp.einsum("kanb,kcnd->kacnbd", a_blk, b_blk)
    k, ra, rb, n, _, _ = prod.shape
    return prod.reshape(k, ra * rb, n, ra * rb)


def _add_local(a_blk, b_blk, *, m: int, d: int, ra: int, rb: int, axis: str):
    """Per-site block embedding of TT addition (ttNetwork.cpp:797-840):
    first site row-concat, last site column-concat, interior block-diag."""
    start = jax.lax.axis_index(axis) * m
    R = ra + rb
    k, _, n, _ = a_blk.shape

    def place(site_off, a_core, b_core):
        g = start + site_off                      # global site index
        out = jnp.zeros((R, n, R), dtype=a_core.dtype)
        out = jax.lax.dynamic_update_slice(out, a_core, (0, 0, 0))
        off_l = jnp.where(g == 0, 0, ra)
        off_r = jnp.where(g == d - 1, 0, ra)
        return jax.lax.dynamic_update_slice(out, b_core, (off_l, 0, off_r))

    return jax.vmap(place)(jnp.arange(k), a_blk, b_blk)


@lru_cache(maxsize=16)
def _make_sharded(mesh_key, kind: str, shapes, dtype_str: str, axis: str,
                  meta):
    mesh = _MESHES[mesh_key]
    if kind == "entrywise":
        body = _entrywise_local
    else:
        m, d, ra, rb = meta
        body = partial(_add_local, m=m, d=d, ra=ra, rb=rb, axis=axis)
    fn = shard_map(body, mesh=mesh,
                   in_specs=(P(axis), P(axis)),
                   out_specs=P(axis), check_vma=False)
    return jax.jit(fn)


def _prepare(a_cores, b_cores, mesh: Mesh, axis: str):
    p = mesh.shape[axis]
    d = len(a_cores)
    d_pad = ((d + p - 1) // p) * p
    a_stack, ra = _pad_stack([np.asarray(c) for c in a_cores], d_pad)
    b_stack, rb = _pad_stack([np.asarray(c) for c in b_cores], d_pad)
    mesh_key = (id(mesh), p)
    _MESHES[mesh_key] = mesh
    return a_stack, b_stack, ra, rb, d, d_pad, p, mesh_key


def tt_entrywise_product_sharded(a_cores: Sequence, b_cores: Sequence,
                                 mesh: Mesh, axis: str = "dp") -> List:
    """Hadamard product of two TTs with the site axis sharded over
    ``mesh.shape[axis]`` devices; ranks multiply per bond."""
    a_stack, b_stack, ra, rb, d, d_pad, p, mk = _prepare(
        a_cores, b_cores, mesh, axis)
    fn = _make_sharded(mk, "entrywise", (a_stack.shape, b_stack.shape),
                       str(a_stack.dtype), axis, None)
    out = np.asarray(fn(jnp.asarray(a_stack), jnp.asarray(b_stack)))
    res = []
    for k in range(d):
        la_l, la_r = a_cores[k].shape[0], a_cores[k].shape[2]
        lb_l, lb_r = b_cores[k].shape[0], b_cores[k].shape[2]
        # logical (a, b) rank pairs sit at a*rb + b in the padded kron axis
        rows = (np.arange(la_l)[:, None] * rb + np.arange(lb_l)).reshape(-1)
        cols = (np.arange(la_r)[:, None] * rb + np.arange(lb_r)).reshape(-1)
        res.append(jnp.asarray(out[k][np.ix_(rows, range(out.shape[2]),
                                             cols)]))
    return res


def tt_add_sharded(a_cores: Sequence, b_cores: Sequence, mesh: Mesh,
                   axis: str = "dp") -> List:
    """TT addition (block-diagonal rank-sum embedding) with the site axis
    sharded; bond ranks add."""
    if len(a_cores) == 1:
        # single site: first==last, and the block embedding degenerates to
        # a plain core sum (the sharded body would overwrite a with b)
        return [jnp.asarray(np.asarray(a_cores[0])
                            + np.asarray(b_cores[0]))]
    a_stack, b_stack, ra, rb, d, d_pad, p, mk = _prepare(
        a_cores, b_cores, mesh, axis)
    m = d_pad // p
    fn = _make_sharded(mk, "add", (a_stack.shape, b_stack.shape),
                       str(a_stack.dtype), axis, (m, d, ra, rb))
    out = np.asarray(fn(jnp.asarray(a_stack), jnp.asarray(b_stack)))
    res = []
    for k in range(d):
        la_l, la_r = a_cores[k].shape[0], a_cores[k].shape[2]
        lb_l, lb_r = b_cores[k].shape[0], b_cores[k].shape[2]
        if k == 0:
            rows = np.arange(1)
        else:
            rows = np.concatenate([np.arange(la_l), ra + np.arange(lb_l)])
        if k == d - 1:
            cols = np.arange(1)
        else:
            cols = np.concatenate([np.arange(la_r), ra + np.arange(lb_r)])
        res.append(jnp.asarray(out[k][np.ix_(rows, range(out.shape[2]),
                                             cols)]))
    return res
