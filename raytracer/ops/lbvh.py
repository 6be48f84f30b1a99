"""LBVH2 builder — fully on-device, vectorized Karras 2012, no atomics.

Data-parallel redesign of the reference's GPU builder
(``src/shaders/BVHBuilder.wgsl``) + host orchestration
(``src/libs/PathTracer.js:671-749``):

* The reference round-trips host↔device four times (upload tris, CPU Morton
  sort upload, GPU build, readback for CPU collapse). Here the *entire*
  build — Morton, sort, connectivity, bounds — is one jitted program; the
  collapse consumes device arrays directly (SURVEY.md §3.2).
* Karras ``buildInternal`` (BVHBuilder.wgsl:152-240) is one-thread-per-node
  parallel; we express it as pure vector math over all internal nodes with
  the doubling/binary searches emulated exactly via masked fixed-trip loops.
* The atomic bottom-up AABB climb (``propagateUp``, BVHBuilder.wgsl:242-275)
  is nondeterministic and has no vectorized form; it is replaced by
  deterministic fixed-point union sweeps: every internal node recomputes its
  box from its children's *packed fp16* boxes each sweep. After ``height(T)``
  sweeps every node holds exactly the value the sequential bottom-up pass
  would produce — including the compounding ±1-ULP conservative expansion at
  every level, because each sweep re-reads child bounds through the fp16
  decode exactly like ``readBounds2``.

Node layout (the ABI of data/BVH2.bin, PathTracer.js:8-10):
  node i = [b0, b1, b2, left, right, meta], meta = LEAF_FLAG|triIndex for
  leaves, 0 for internal. Internal nodes 0..N-2, leaves N-1..2N-2.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import fp16_jax as f16
from .morton import build_morton_and_sort

__all__ = ["LBVH2", "build_lbvh2", "refit_lbvh2"]

LEAF_FLAG = 0x80000000
INVALID = 0xFFFFFFFF


class LBVH2(NamedTuple):
    """Device-side LBVH2 in struct-of-arrays form (numNodes2 = 2N-1 rows)."""

    bounds_u32: jax.Array  # (M, 3) uint32 — packed fp16 AABBs
    left: jax.Array        # (M,) uint32 — child index (garbage for leaves: 0)
    right: jax.Array       # (M,) uint32
    meta: jax.Array        # (M,) uint32 — LEAF_FLAG|tri for leaves, 0 internal
    parent: jax.Array      # (M,) uint32 — INVALID at root (extra vs artifact;
    #                        used for refit, not serialized)

    @property
    def num_nodes(self) -> int:
        return self.bounds_u32.shape[0]

    @property
    def num_internal(self) -> int:
        return (self.num_nodes - 1) // 2


def _delta(m: jax.Array, i: jax.Array, j: jax.Array, n: int) -> jax.Array:
    """Karras δ(i,j): common-prefix length of codes, index tie-break; −1 out
    of range (BVHBuilder.wgsl:134-149)."""
    valid = (j >= 0) & (j < n)
    mj = m[jnp.clip(j, 0, n - 1)]
    mi = m[i]
    x = mi ^ mj
    y = i.astype(jnp.uint32) ^ j.astype(jnp.uint32)
    d = jnp.where(
        x == 0,
        32 + jax.lax.clz(y).astype(jnp.int32),
        jax.lax.clz(x).astype(jnp.int32),
    )
    return jnp.where(valid, d, jnp.int32(-1))


def _tri_bounds(triangles: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(N,3,3) → per-triangle AABB min/max (BVHBuilder.wgsl:36-58)."""
    return jnp.min(triangles, axis=1), jnp.max(triangles, axis=1)


def _karras_connectivity(codes: jax.Array, n: int):
    """All internal nodes' (left, right) child indices + parents, vectorized.

    Exact emulation of buildInternal (BVHBuilder.wgsl:152-240): per node,
    direction pick, doubling search for the range end, binary search refine,
    then split search; leaves are offset by leafBase = n-1.
    """
    num_internal = n - 1
    i = jnp.arange(num_internal, dtype=jnp.int32)
    delta = partial(_delta, codes)

    d_right = delta(i, i + 1, n)
    d_left = delta(i, i - 1, n)
    d = jnp.where((d_right - d_left) > 0, jnp.int32(1), jnp.int32(-1))
    delta_min = delta(i, i - d, n)

    # doubling search: smallest lmax=2^k with delta(i, i+lmax*d) <= delta_min
    def dbl_body(_, carry):
        lmax, done = carry
        cond = delta(i, i + lmax * d, n) > delta_min
        done2 = done | ~cond
        lmax2 = jnp.where(done2, lmax, lmax << 1)
        return lmax2, done2

    lmax = jnp.full_like(i, 2)
    done = jnp.zeros_like(i, dtype=bool)
    lmax, _ = jax.lax.fori_loop(0, 32, dbl_body, (lmax, done))

    # binary search for exact range length l
    def bin_body(_, carry):
        l, t = carry
        active = t > 0
        pred = active & (delta(i, i + (l + t) * d, n) > delta_min)
        return jnp.where(pred, l + t, l), jnp.where(active, t >> 1, t)

    l0 = jnp.zeros_like(i)
    t0 = lmax >> 1
    l, _ = jax.lax.fori_loop(0, 32, bin_body, (l0, t0))

    j = i + l * d
    first = jnp.minimum(i, j)
    last = jnp.maximum(i, j)
    delta_node = delta(first, last, n)

    # split search (BVHBuilder.wgsl:202-215)
    def split_body(_, carry):
        split, step = carry
        active = step > 1
        step2 = jnp.where(active, (step + 1) >> 1, step)
        new_split = split + step2
        pred = active & (new_split < last) & (delta(first, new_split, n) > delta_node)
        return jnp.where(pred, new_split, split), step2

    split0 = first
    step0 = last - first
    split, _ = jax.lax.fori_loop(0, 33, split_body, (split0, step0))

    leaf_base = jnp.uint32(num_internal)
    left = jnp.where(
        split == first, leaf_base + split.astype(jnp.uint32), split.astype(jnp.uint32)
    )
    right_idx = split + 1
    right = jnp.where(
        right_idx == last,
        leaf_base + right_idx.astype(jnp.uint32),
        right_idx.astype(jnp.uint32),
    )

    num_nodes = 2 * n - 1
    parent = jnp.full((num_nodes,), jnp.uint32(INVALID))
    parent = parent.at[left.astype(jnp.int32)].set(i.astype(jnp.uint32))
    parent = parent.at[right.astype(jnp.int32)].set(i.astype(jnp.uint32))
    parent = parent.at[0].set(jnp.uint32(INVALID))
    return left, right, parent


def _static_height_bound(n: int) -> int:
    """Upper bound on Karras-tree height: ≤30 morton levels + balanced
    tie-break subtrees of depth ≤ ceil(log2 n), +2 slack."""
    return 32 + int(math.ceil(math.log2(max(n, 2)))) + 2


def _bounds_fixed_point(
    bounds_u32: jax.Array,
    left: jax.Array,
    right: jax.Array,
    num_internal: int,
    max_sweeps: int,
) -> jax.Array:
    """Deterministic bottom-up AABB propagation via fixed-point union sweeps.

    Replaces the atomic climb (BVHBuilder.wgsl:242-275). Each sweep: every
    internal node = conservative-pack(union(decode(children))). Converges in
    height(T) sweeps; we run a while_loop with a convergence test and the
    static bound as a safety cap.
    """

    def sweep(b):
        lmn, lmx = f16.unpack_bounds(b[left.astype(jnp.int32)])
        rmn, rmx = f16.unpack_bounds(b[right.astype(jnp.int32)])
        mn = jnp.minimum(lmn, rmn)
        mx = jnp.maximum(lmx, rmx)
        packed = f16.pack_bounds_conservative(mn, mx)
        return b.at[:num_internal].set(packed[:num_internal])

    def cond(carry):
        _, changed, it = carry
        return changed & (it < max_sweeps)

    def body(carry):
        b, _, it = carry
        b2 = sweep(b)
        return b2, jnp.any(b2 != b), it + 1

    out, _, _ = jax.lax.while_loop(
        cond, body, (bounds_u32, jnp.bool_(True), jnp.int32(0))
    )
    return out


@partial(jax.jit, static_argnames=("num_triangles",))
def _build_lbvh2_impl(triangles: jax.Array, num_triangles: int) -> LBVH2:
    n = num_triangles
    num_internal = n - 1
    num_nodes = 2 * n - 1

    codes, tri_order = build_morton_and_sort(triangles)

    # leaves: nodes [n-1, 2n-2) in sorted-leaf order (BVHBuilder.wgsl:279-299)
    tri_sorted = triangles[tri_order.astype(jnp.int32)]
    leaf_mn, leaf_mx = _tri_bounds(tri_sorted)
    leaf_bounds = f16.pack_bounds_conservative(leaf_mn, leaf_mx)
    leaf_meta = jnp.uint32(LEAF_FLAG) | (tri_order & jnp.uint32(0x7FFFFFFF))

    bounds_u32 = jnp.zeros((num_nodes, 3), dtype=jnp.uint32)
    bounds_u32 = bounds_u32.at[num_internal:].set(leaf_bounds)

    meta = jnp.zeros((num_nodes,), dtype=jnp.uint32)
    meta = meta.at[num_internal:].set(leaf_meta)

    if n == 1:
        zeros = jnp.zeros((1,), dtype=jnp.uint32)
        return LBVH2(
            bounds_u32=bounds_u32,
            left=zeros,
            right=zeros,
            meta=meta,
            parent=jnp.full((1,), jnp.uint32(INVALID)),
        )

    ileft, iright, parent = _karras_connectivity(codes, n)
    left = jnp.zeros((num_nodes,), dtype=jnp.uint32).at[:num_internal].set(ileft)
    right = jnp.zeros((num_nodes,), dtype=jnp.uint32).at[:num_internal].set(iright)

    bounds_u32 = _bounds_fixed_point(
        bounds_u32, left, right, num_internal, _static_height_bound(n)
    )
    return LBVH2(bounds_u32=bounds_u32, left=left, right=right, meta=meta, parent=parent)


def build_sah2(triangles) -> tuple[LBVH2, int]:
    """Host-native binned-SAH BVH2 (quality builder) → device LBVH2 + height.

    Same output contract as :func:`build_lbvh2` (2N−1 rows, root 0,
    conservative fp16 bounds) but with surface-area-heuristic topology —
    30%+ fewer traversal visits than the Morton LBVH on the benchmark
    scenes. Requires lib/libbvhtool.so (raytracer/native/build.sh).
    """
    import numpy as np

    from ..native import bvhtool

    tris_np = np.asarray(triangles, dtype=np.float32)
    arrays, height = bvhtool.build_sah_native(tris_np)
    bvh = LBVH2(
        bounds_u32=jnp.asarray(arrays["bounds"]),
        left=jnp.asarray(arrays["left"]),
        right=jnp.asarray(arrays["right"]),
        meta=jnp.asarray(arrays["meta"]),
        parent=jnp.asarray(arrays["parent"]),
    )
    return bvh, height


def build_lbvh2(triangles: jax.Array) -> LBVH2:
    """Build the LBVH2 for a (N,3,3) float32 triangle array, fully on device.

    N must be ≥ 1 (the empty-scene path is handled by the orchestrator,
    matching PathTracer.js:701-707).
    """
    n = int(triangles.shape[0])
    if n < 1:
        raise ValueError("build_lbvh2 requires at least one triangle")
    return _build_lbvh2_impl(triangles, n)


@partial(jax.jit, static_argnames=("num_sweeps",))
def refit_lbvh2(bvh: LBVH2, triangles: jax.Array, num_sweeps: int | None = None) -> LBVH2:
    """Recompute all bounds for deformed geometry, keeping the topology.

    The dynamic-scene path (BASELINE config 5): leaf boxes from the moved
    triangles, then the same deterministic union sweeps. Topology (left/right/
    meta/parent) is untouched, so this is much cheaper than a full rebuild.
    """
    num_nodes = bvh.num_nodes
    num_internal = bvh.num_internal
    n = num_internal + 1

    tri_idx = (bvh.meta[num_internal:] & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)
    tri_sorted = triangles[tri_idx]
    leaf_mn, leaf_mx = _tri_bounds(tri_sorted)
    leaf_bounds = f16.pack_bounds_conservative(leaf_mn, leaf_mx)

    bounds = jnp.zeros((num_nodes, 3), dtype=jnp.uint32).at[num_internal:].set(leaf_bounds)
    if num_internal > 0:
        sweeps = num_sweeps if num_sweeps is not None else _static_height_bound(n)
        bounds = _bounds_fixed_point(bounds, bvh.left, bvh.right, num_internal, sweeps)
    return bvh._replace(bounds_u32=bounds)
