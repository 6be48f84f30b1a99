"""Packed-leaf (multi-triangle) BVH pipeline.

The reference's BVH4 holds exactly one triangle per leaf
(PathTracer.js:578-588), which the parity pipeline reproduces. This module
builds the same tree shape over *clusters* of K consecutive sorted
triangles instead: the leaf level shrinks K×, the total node count ~K×, and
each leaf visit intersects its K triangles from consecutive records —
trading node visits (pop, slab test, sort, push) for triangle tests. The
best K is a property of the traversal kernel and is measured, not assumed
(``fast_build_options``).

Pipeline (fully on device, one jitted program):
  morton sort (exact reference bit semantics, ops/morton.py)
  → group K consecutive sorted triangles per cluster
  → cluster AABBs (union of member boxes, conservative fp16 packing)
  → Karras connectivity over the clusters' leading Morton codes
  → fixed-point bound sweeps (same machinery as ops/lbvh.py)
  → LBVH2 whose leaves reference CLUSTER indices
  → the standard BVH4 collapse / make_wide_bvh consume it unchanged.

The triangle array is returned in sorted order (cluster members contiguous)
together with the original-index permutation; ops.trace.pack_bvh turns both
into the triangle records, so traversal still reports reference triangle
indices.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import fp16_jax as f16
from .lbvh import (
    INVALID,
    LEAF_FLAG,
    LBVH2,
    _bounds_fixed_point,
    _karras_connectivity,
    _static_height_bound,
    _tri_bounds,
)
from .morton import build_morton_and_sort

__all__ = ["ClusteredScene", "build_lbvh2_clustered", "build_sah2_clustered",
           "refit_lbvh2_clustered", "records_pipeline"]


class ClusteredScene(NamedTuple):
    """A packed-leaf LBVH2 plus the cluster-ordered geometry it indexes."""

    bvh2: LBVH2            # leaves carry LEAF_FLAG|cluster_index
    tris_sorted: jax.Array  # (N,3,3) f32 — Morton order, cluster members contiguous
    tri_order: jax.Array    # (N,) uint32 — original index per sorted position
    leaf_size: int          # K — max triangles per cluster (static)


@partial(jax.jit, static_argnames=("num_triangles", "leaf_size"))
def _build_clustered_impl(
    triangles: jax.Array, num_triangles: int, leaf_size: int
) -> ClusteredScene:
    n = num_triangles
    k = leaf_size
    c = -(-n // k)                     # number of clusters
    num_internal = c - 1
    num_nodes = 2 * c - 1

    codes, tri_order = build_morton_and_sort(triangles)
    tris_sorted = triangles[tri_order.astype(jnp.int32)]

    # cluster bounds: union over the ≤K member triangle boxes
    tmn, tmx = _tri_bounds(tris_sorted)
    pad = c * k - n
    pmn = jnp.pad(tmn, ((0, pad), (0, 0)), constant_values=jnp.inf)
    pmx = jnp.pad(tmx, ((0, pad), (0, 0)), constant_values=-jnp.inf)
    cl_mn = jnp.min(pmn.reshape(c, k, 3), axis=1)
    cl_mx = jnp.max(pmx.reshape(c, k, 3), axis=1)
    leaf_bounds = f16.pack_bounds_conservative(cl_mn, cl_mx)

    # Karras over the clusters' leading codes (sorted, ties index-broken)
    cl_codes = codes[:: k]             # code of each cluster's first member
    leaf_meta = jnp.uint32(LEAF_FLAG) | jnp.arange(c, dtype=jnp.uint32)

    bounds_u32 = jnp.zeros((num_nodes, 3), dtype=jnp.uint32)
    bounds_u32 = bounds_u32.at[num_internal:].set(leaf_bounds)
    meta = jnp.zeros((num_nodes,), dtype=jnp.uint32)
    meta = meta.at[num_internal:].set(leaf_meta)

    if c == 1:
        zeros = jnp.zeros((1,), dtype=jnp.uint32)
        bvh2 = LBVH2(
            bounds_u32=bounds_u32, left=zeros, right=zeros, meta=meta,
            parent=jnp.full((1,), jnp.uint32(INVALID)),
        )
        return ClusteredScene(bvh2, tris_sorted, tri_order, k)

    ileft, iright, parent = _karras_connectivity(cl_codes, c)
    left = jnp.zeros((num_nodes,), dtype=jnp.uint32).at[:num_internal].set(ileft)
    right = jnp.zeros((num_nodes,), dtype=jnp.uint32).at[:num_internal].set(iright)
    bounds_u32 = _bounds_fixed_point(
        bounds_u32, left, right, num_internal, _static_height_bound(c)
    )
    bvh2 = LBVH2(bounds_u32=bounds_u32, left=left, right=right, meta=meta,
                 parent=parent)
    return ClusteredScene(bvh2, tris_sorted, tri_order, k)


def build_lbvh2_clustered(triangles: jax.Array, leaf_size: int = 4) -> ClusteredScene:
    """Packed-leaf LBVH2 over (N,3,3) triangles, K = ``leaf_size`` tris/leaf.

    The returned BVH2's leaf metas hold CLUSTER indices; cluster ``c`` owns
    sorted triangles [cK, min(N, (c+1)K)). Feed the result to
    :func:`records_pipeline` for the traversal layout.
    """
    n = int(triangles.shape[0])
    if n < 1:
        raise ValueError("build_lbvh2_clustered requires at least one triangle")
    if leaf_size < 1:
        raise ValueError("leaf_size must be >= 1")
    return _build_clustered_impl(triangles, n, leaf_size)


@partial(jax.jit, static_argnames=("leaf_size", "num_sweeps"))
def _refit_clustered_impl(bvh: LBVH2, tri_order: jax.Array,
                          triangles: jax.Array, leaf_size: int,
                          num_sweeps: int):
    k = leaf_size
    num_nodes = bvh.num_nodes
    num_internal = bvh.num_internal
    c = num_internal + 1
    n = triangles.shape[0]

    tris_sorted = triangles[tri_order.astype(jnp.int32)]
    tmn, tmx = _tri_bounds(tris_sorted)
    pad = c * k - n
    pmn = jnp.pad(tmn, ((0, pad), (0, 0)), constant_values=jnp.inf)
    pmx = jnp.pad(tmx, ((0, pad), (0, 0)), constant_values=-jnp.inf)
    cl_mn = jnp.min(pmn.reshape(c, k, 3), axis=1)
    cl_mx = jnp.max(pmx.reshape(c, k, 3), axis=1)

    # Layout-agnostic: Morton trees put leaves in rows [num_internal, 2c-1)
    # but the native SAH builder emits PRE-ORDER rows (leaves interleaved
    # with internals), so leaf rows must be identified by LEAF_FLAG in meta
    # and internal rows by its absence — never by row position.
    leaf_mask = (bvh.meta & jnp.uint32(LEAF_FLAG)) != 0
    cidx = jnp.where(
        leaf_mask, (bvh.meta & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32), 0
    )
    leaf_bounds = f16.pack_bounds_conservative(cl_mn[cidx], cl_mx[cidx])
    bounds = jnp.where(leaf_mask[:, None], leaf_bounds,
                       jnp.zeros((num_nodes, 3), jnp.uint32))

    if num_internal > 0:
        left = bvh.left.astype(jnp.int32)
        right = bvh.right.astype(jnp.int32)

        def sweep(b):
            lmn, lmx = f16.unpack_bounds(b[left])
            rmn, rmx = f16.unpack_bounds(b[right])
            # plain pack, NOT conservative: unions of unpacked fp16 values
            # are exactly fp16-representable, so packing is the identity and
            # the 1-ULP-per-level expansion the builder needs for raw f32
            # geometry (BVHBuilder.wgsl:83-102) would only inflate internal
            # boxes here — and would break the bit-parity contract of
            # collapse_apply_refit (ops/collapse.py), whose gathered bounds
            # must equal the full collapse's leaf-up f32 re-merge.
            packed = f16.pack_bounds(
                jnp.minimum(lmn, rmn), jnp.maximum(lmx, rmx)
            )
            return jnp.where(leaf_mask[:, None], b, packed)

        def cond(carry):
            _, changed, it = carry
            return changed & (it < num_sweeps)

        def body(carry):
            b, _, it = carry
            b2 = sweep(b)
            return b2, jnp.any(b2 != b), it + 1

        bounds, _, _ = jax.lax.while_loop(
            cond, body, (bounds, jnp.bool_(True), jnp.int32(0))
        )
    return bvh._replace(bounds_u32=bounds), tris_sorted


def refit_lbvh2_clustered(
    cs: ClusteredScene, triangles: jax.Array, num_sweeps: int | None = None
) -> ClusteredScene:
    """Refit a packed-cluster tree to deformed geometry, keeping topology
    AND the cluster assignment (the [cK,(c+1)K) indexing contract survives —
    only bounds move). The dynamic-scene path for clustered trees (verdict
    r2 #3): cluster unions from the moved triangles, then the same
    deterministic union sweeps as ops/lbvh.py::refit_lbvh2.

    ``triangles`` is the deformed geometry in ORIGINAL order (the permutation
    is re-applied here). ``num_sweeps`` (pass ``height+2`` from an SAH
    build) only CAPS the convergence loop — the default cap is the node
    count, a true bound for ANY tree shape (an SAH tree can be deeper than
    the Morton static height bound, and an under-cap would silently leave
    stale internal bounds → hole pixels). The loop exits on convergence, so
    a generous cap costs nothing on real trees.
    """
    c = cs.bvh2.num_internal + 1
    sweeps = num_sweeps if num_sweeps is not None else max(
        _static_height_bound(c), cs.bvh2.num_internal + 1)
    k = int(cs.leaf_size)  # may arrive as a device scalar via a jit boundary
    bvh2, tris_sorted = _refit_clustered_impl(
        cs.bvh2, cs.tri_order, triangles, k, sweeps
    )
    return ClusteredScene(bvh2, tris_sorted, cs.tri_order, k)


@partial(jax.jit, static_argnames=("leaf_size", "sweeps", "width"))
def _records_impl(bvh2, tris_sorted, tri_order, leaf_size, sweeps, width):
    from .collapse import collapse_lbvh2_to_bvh4, collapse_lbvh2_to_bvh8
    from .trace import make_wide_bvh, pack_bvh

    collapse = {4: collapse_lbvh2_to_bvh4, 8: collapse_lbvh2_to_bvh8}[width]
    wide = make_wide_bvh(collapse(bvh2, sweeps=sweeps))
    return pack_bvh(wide, tris_sorted, tri_ids=tri_order, leaf_size=leaf_size)


def records_pipeline(cs: ClusteredScene, *, height: int | None = None,
                     width: int = 4):
    """collapse → widen → pack as one jitted program → (nodes, TriRecords)
    (ops/trace.py layout). ``height`` (from :func:`build_sah2_clustered`)
    pins the collapse sweep count; without it the static shape-derived
    bound is used."""
    return _records_impl(cs.bvh2, cs.tris_sorted, cs.tri_order,
                         leaf_size=int(cs.leaf_size),
                         sweeps=None if height is None else int(height) + 2,
                         width=width)


def build_sah2_clustered(
    triangles: jax.Array, leaf_size: int = 8
) -> tuple[ClusteredScene, int]:
    """SAH-quality packed-leaf BVH2 (native binned-SAH, host) + tree height.

    Same ClusteredScene contract as :func:`build_lbvh2_clustered` — cluster
    ``c`` owns sorted triangles [cK, min(N, (c+1)K)) — but clusters come
    from SAH splits snapped to multiples of K (native/sah_build.cpp), so
    they are spatially compact with tighter boxes than Morton runs. Pass
    ``height`` to :func:`records_pipeline`.
    """
    import numpy as np

    from ..native.bvhtool import build_sah_clustered_native

    n = int(triangles.shape[0])
    if n < 1:
        raise ValueError("build_sah2_clustered requires at least one triangle")
    tris_np = np.asarray(triangles, dtype=np.float32)
    arrays, order, height = build_sah_clustered_native(tris_np, leaf_size)
    if leaf_size == 1:
        # single-triangle leaves name original triangle indices in their
        # meta (native/sah_build.cpp), so the cluster order is the identity
        order = np.arange(n, dtype=np.uint32)
    bvh2 = LBVH2(
        bounds_u32=jnp.asarray(arrays["bounds"]),
        left=jnp.asarray(arrays["left"]),
        right=jnp.asarray(arrays["right"]),
        meta=jnp.asarray(arrays["meta"]),
        parent=jnp.asarray(arrays["parent"]),
    )
    order_j = jnp.asarray(order)
    tris_sorted = jnp.asarray(triangles)[order_j.astype(jnp.int32)]
    return ClusteredScene(bvh2, tris_sorted, order_j, int(leaf_size)), int(height)
