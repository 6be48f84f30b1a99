"""PLOC builder — higher-quality BVH2 via parallel locally-ordered clustering.

The reference builds Morton-split LBVH trees ("BVH-only, no SAH",
reference README.md:79); their traversal quality is 1.5–3× worse than
surface-area-aware trees. This builder implements PLOC (Meister & Bittner
2018 style): clusters sorted by Morton code repeatedly find their
nearest neighbor (by surface area of the union) within a ±R window of the
sorted order, and mutual pairs merge. Every step is a fixed-shape vector
op — windowed shifts, cumsum ranks, masked scatters — so the whole build is
one jitted device program, like ops/lbvh.py.

Output is format-compatible with the LBVH2 ABI (internal nodes 0..N-2 with
the final merge at the root id 0, leaves N-1..2N-2 in Morton order, packed
conservative fp16 bounds via the same fixed-point sweep), so the collapse,
the wide/packed layouts, artifacts, and the native tools all work
unchanged — it's a drop-in quality option (PERF.md roadmap item 1).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import fp16_jax as f16
from .lbvh import LBVH2, _bounds_fixed_point, _static_height_bound, _tri_bounds
from .morton import build_morton_and_sort

__all__ = ["build_ploc2"]

LEAF_FLAG = 0x80000000
INVALID = 0xFFFFFFFF
_BIG = jnp.float32(3.0e38)


def _union_area(mn_a, mx_a, mn_b, mx_b):
    """Surface area of the union AABB (the PLOC merge cost)."""
    mn = jnp.minimum(mn_a, mn_b)
    mx = jnp.maximum(mx_a, mx_b)
    d = jnp.maximum(mx - mn, 0.0)
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]


@partial(jax.jit, static_argnames=("num_triangles", "radius"))
def _build_ploc_impl(triangles: jax.Array, num_triangles: int, radius: int) -> LBVH2:
    n = num_triangles
    num_internal = n - 1
    num_nodes = 2 * n - 1

    codes, tri_order = build_morton_and_sort(triangles)
    tri_sorted = triangles[tri_order.astype(jnp.int32)]
    leaf_mn, leaf_mx = _tri_bounds(tri_sorted)

    # leaf records (ABI: leaves at N-1..2N-2 in Morton order)
    leaf_bounds = f16.pack_bounds_conservative(leaf_mn, leaf_mx)
    leaf_meta = jnp.uint32(LEAF_FLAG) | (tri_order & jnp.uint32(0x7FFFFFFF))
    bounds_u32 = jnp.zeros((num_nodes, 3), jnp.uint32).at[num_internal:].set(leaf_bounds)
    meta = jnp.zeros((num_nodes,), jnp.uint32).at[num_internal:].set(leaf_meta)

    if n == 1:
        zeros = jnp.zeros((1,), jnp.uint32)
        return LBVH2(bounds_u32, zeros, zeros, meta, jnp.full((1,), jnp.uint32(INVALID)))

    idx = jnp.arange(n, dtype=jnp.int32)

    def cond(st):
        return st[0] > 1

    def body(st):
        c, cmn, cmx, node_ids, next_internal, left, right = st
        active = idx < c

        # --- windowed nearest-neighbor search (union surface area) ---
        best_sa = jnp.full((n,), _BIG)
        best_j = idx
        for d in range(1, radius + 1):
            mn_s = jnp.roll(cmn, -d, axis=0)
            mx_s = jnp.roll(cmx, -d, axis=0)
            sa = _union_area(cmn, cmx, mn_s, mx_s)
            pair_ok = active & (idx + d < c)
            sa = jnp.where(pair_ok, sa, _BIG)
            # i's right-neighbor candidate i+d
            upd_i = sa < best_sa
            best_j = jnp.where(upd_i, idx + d, best_j)
            best_sa = jnp.where(upd_i, sa, best_sa)
            # (i+d)'s left-neighbor candidate i
            sa_back = jnp.roll(sa, d, axis=0)
            back_ok = active & (idx - d >= 0) & (sa_back < best_sa)
            best_j = jnp.where(back_ok, idx - d, best_j)
            best_sa = jnp.where(back_ok, sa_back, best_sa)

        nn = best_j
        nn_of_nn = nn[jnp.clip(nn, 0, n - 1)]
        mutual = active & (nn_of_nn == idx) & (idx < nn) & (nn < c)

        # liveness guard (ADVICE r1 #2): exact surface-area ties can leave a
        # round with zero mutual nearest-neighbor pairs — force-merge the
        # first two clusters so the loop always makes progress
        stuck = ~jnp.any(mutual) & (c > 1)
        mutual = mutual | (stuck & (idx == 0))
        nn = jnp.where(stuck & (idx == 0), 1, nn)

        # --- assign internal ids downward so the final merge lands at 0 ---
        k = jnp.sum(mutual)
        rank = jnp.cumsum(mutual.astype(jnp.int32)) - mutual.astype(jnp.int32)
        new_id = next_internal - rank                      # per-merge id

        nn_c = jnp.clip(nn, 0, n - 1)
        li = node_ids
        ri = node_ids[nn_c]
        tgt = jnp.where(mutual, new_id, num_nodes)          # OOB → dropped
        left = left.at[tgt].set(li.astype(jnp.uint32), mode="drop")
        right = right.at[tgt].set(ri.astype(jnp.uint32), mode="drop")

        # --- merge in place at i; absorb j = nn[i] ---
        u_mn = jnp.minimum(cmn, cmn[nn_c])
        u_mx = jnp.maximum(cmx, cmx[nn_c])
        cmn = jnp.where(mutual[:, None], u_mn, cmn)
        cmx = jnp.where(mutual[:, None], u_mx, cmx)
        node_ids = jnp.where(mutual, new_id, node_ids)

        absorbed = jnp.zeros((n,), bool).at[
            jnp.where(mutual, nn_c, n)
        ].set(True, mode="drop")
        keep = active & ~absorbed

        # --- compact the surviving clusters to the prefix ---
        pos = jnp.cumsum(keep.astype(jnp.int32)) - 1
        tgt = jnp.where(keep, pos, n)
        cmn = jnp.full_like(cmn, _BIG).at[tgt].set(cmn, mode="drop")
        cmx = jnp.full_like(cmx, -_BIG).at[tgt].set(cmx, mode="drop")
        node_ids = jnp.zeros_like(node_ids).at[tgt].set(node_ids, mode="drop")

        return (
            jnp.sum(keep).astype(jnp.int32),
            cmn,
            cmx,
            node_ids,
            next_internal - k,
            left,
            right,
        )

    init = (
        jnp.int32(n),
        leaf_mn,
        leaf_mx,
        (num_internal + idx).astype(jnp.int32),   # leaf node ids
        jnp.int32(num_internal - 1),
        jnp.zeros((num_nodes,), jnp.uint32),
        jnp.zeros((num_nodes,), jnp.uint32),
    )
    _, _, _, _, _, left, right = jax.lax.while_loop(cond, body, init)

    # parents (refit support), then the shared fp16 bound sweeps
    parent = jnp.full((num_nodes,), jnp.uint32(INVALID))
    li = left[:num_internal].astype(jnp.int32)
    ri = right[:num_internal].astype(jnp.int32)
    parent = parent.at[li].set(jnp.arange(num_internal, dtype=jnp.uint32))
    parent = parent.at[ri].set(jnp.arange(num_internal, dtype=jnp.uint32))
    parent = parent.at[0].set(jnp.uint32(INVALID))

    bounds_u32 = _bounds_fixed_point(
        bounds_u32, left, right, num_internal, _static_height_bound(n)
    )
    return LBVH2(bounds_u32=bounds_u32, left=left, right=right, meta=meta, parent=parent)


def build_ploc2(triangles: jax.Array, radius: int = 8) -> LBVH2:
    """Quality BVH2 build (PLOC). Same output type/ABI as build_lbvh2."""
    n = int(triangles.shape[0])
    if n < 1:
        raise ValueError("build_ploc2 requires at least one triangle")
    return _build_ploc_impl(triangles, n, radius)
