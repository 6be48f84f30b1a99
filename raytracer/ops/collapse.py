"""BVH2 → BVH4 wideners — device-side, vectorized, deterministic.

The reference has two distinct wideners (SURVEY.md §2):

1. **Greedy re-emission collapse** (PathTracer.js:506-667) — the quality path
   used by the live renderer: pre-order re-emitted node array, each internal
   node greedily absorbs ≤4 grandchildren (always expanding the *first*
   internal kid), parent bounds re-merged in f32 from the children's decoded
   fp16 boxes and re-packed with the truncating codec. The reference runs it
   recursively on the CPU after a GPU readback; here it is a *single jitted
   device program*:

   * the ≤4-kid gathering is a closed-form function of ≤3 levels of child
     pointers (the greedy loop has at most 2 expansion steps) → one vector
     expression over all nodes;
   * which BVH2 nodes survive as BVH4 nodes is top-down reachability;
   * the pre-order output index of every surviving node is
     ``idx(parent) + 1 + Σ sizes of elder siblings`` — subtree sizes bottom-up,
     then offsets top-down, both as fixed-point sweeps (same trick as the
     LBVH bounds pass, ops/lbvh.py);
   * merged bounds bottom-up in f32. A union of fp16-representable values is
     fp16-representable, so packing once at the end with the truncating codec
     is bit-identical to the reference's pack-at-every-level.

   Output arrays are padded to numNodes2 rows (static shape); the logical
   node count is returned as a device scalar and the valid rows are exactly
   the prefix [0, numNodes4) because pre-order ranks are dense.

2. **O(N) index-preserving promotion** (tests/test.cpp:104-196) — the native
   tool's algorithm: same index space, bounds copied verbatim, (left,right)
   replaced by up to 4 grandchildren. Embarrassingly parallel → direct
   vectorization. (Also reimplemented as an actual C++ CLI in
   ``raytracer/native/bvh_convert.cpp``.)
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .lbvh import LBVH2, _static_height_bound

__all__ = [
    "BVH4",
    "CollapsePlan",
    "collapse_lbvh2_to_bvh4",
    "collapse_lbvh2_to_bvh8",
    "collapse_plan",
    "collapse_apply_refit",
    "promote_lbvh2_to_bvh4_wide",
]

LEAF_FLAG = 0x80000000
INVALID = 0xFFFFFFFF


class BVH4(NamedTuple):
    """Device-side BVH4, struct-of-arrays. Row layout mirrors the stride-8
    artifact (PathTracer.js:13): packed fp16 bounds, 4 children (INVALID for
    empty), meta = LEAF_FLAG|tri for leaves / 0 for internal."""

    bounds_u32: jax.Array   # (M, 3) uint32
    children: jax.Array     # (M, 4) uint32
    meta: jax.Array         # (M,) uint32
    num_nodes: jax.Array    # () uint32 — logical length (rows beyond are padding)


def _f32_to_f16_bits_trunc(x: jax.Array) -> jax.Array:
    """Truncating f32→fp16 (PathTracer.js:42-51): drop mantissa bits, flush
    exp<=0 to signed zero, saturate exp>=31 to ±inf."""
    u = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)
    s = (u >> jnp.uint32(16)) & jnp.uint32(0x8000)
    e = ((u >> jnp.uint32(23)) & jnp.uint32(0xFF)).astype(jnp.int32) - 112
    m = (u >> jnp.uint32(13)) & jnp.uint32(0x03FF)
    val = s | (e.astype(jnp.uint32) << jnp.uint32(10)) | m
    return jnp.where(e <= 0, s, jnp.where(e >= 31, s | jnp.uint32(0x7C00), val))


def _pack_bounds_trunc(mn: jax.Array, mx: jax.Array) -> jax.Array:
    def pack2(a, b):
        return _f32_to_f16_bits_trunc(a) | (_f32_to_f16_bits_trunc(b) << jnp.uint32(16))

    return jnp.stack(
        [
            pack2(mn[..., 0], mn[..., 1]),
            pack2(mn[..., 2], mx[..., 0]),
            pack2(mx[..., 1], mx[..., 2]),
        ],
        axis=-1,
    )


def _decode_bounds(b: jax.Array) -> tuple[jax.Array, jax.Array]:
    from . import fp16_jax as f16

    return f16.unpack_bounds(b)


def _gather_kids(left: jax.Array, right: jax.Array, leaf: jax.Array) -> jax.Array:
    """(M,4) uint32 kid ids per node (INVALID pad) — closed form of the greedy
    treelet gathering (PathTracer.js:608-621). Valid for internal rows only;
    leaf rows are overwritten with INVALID."""
    m = left.shape[0]
    inv = jnp.uint32(INVALID)

    def g(arr, idx):
        return arr[jnp.clip(idx.astype(jnp.int32), 0, m - 1)]

    def lf(idx):
        return g(leaf, idx)

    L, R = left, right
    LL, LR = g(left, L), g(right, L)
    RL, RR = g(left, R), g(right, R)
    leafL, leafR = lf(L), lf(R)
    leafLL, leafLR = lf(LL), lf(LR)
    leafRL, leafRR = lf(RL), lf(RR)

    def sel(c, a, b):
        return jnp.where(c, a, b)

    # --- ~leafL branch: after step 1 kids = [LL, LR, R] ---
    LLL, LLR = g(left, LL), g(right, LL)
    LRL, LRR = g(left, LR), g(right, LR)
    # expand first internal of [LL, LR, R]
    nl_k0 = sel(~leafLL, LLL, LL)
    nl_k1 = sel(~leafLL, LLR, sel(~leafLR, LRL, LR))
    nl_k2 = sel(~leafLL, LR, sel(~leafLR, LRR, sel(~leafR, RL, R)))
    nl_k3 = sel(
        ~leafLL, R, sel(~leafLR, R, sel(~leafR, RR, inv))
    )

    # --- leafL & ~leafR branch: after step 1 kids = [L, RL, RR] ---
    RLL, RLR = g(left, RL), g(right, RL)
    RRL, RRR = g(left, RR), g(right, RR)
    lr_k0 = L
    lr_k1 = sel(~leafRL, RLL, RL)
    lr_k2 = sel(~leafRL, RLR, sel(~leafRR, RRL, RR))
    lr_k3 = sel(~leafRL, RR, sel(~leafRR, RRR, inv))

    # --- leafL & leafR: [L, R, INV, INV] ---
    k0 = sel(~leafL, nl_k0, sel(~leafR, lr_k0, L))
    k1 = sel(~leafL, nl_k1, sel(~leafR, lr_k1, R))
    k2 = sel(~leafL, nl_k2, sel(~leafR, lr_k2, inv))
    k3 = sel(~leafL, nl_k3, sel(~leafR, lr_k3, inv))

    kids = jnp.stack([k0, k1, k2, k3], axis=-1)
    return jnp.where(leaf[:, None], inv, kids)


def _fixed_point(body, init, max_iters: int):
    """Iterate body until no array changes or the static cap is hit."""

    def cond(carry):
        _, changed, it = carry
        return changed & (it < max_iters)

    def step(carry):
        state, _, it = carry
        new = body(state)
        changed = jnp.any(
            jnp.stack([jnp.any(a != b) for a, b in zip(jax.tree.leaves(new), jax.tree.leaves(state))])
        )
        return new, changed, it + 1

    out, _, _ = jax.lax.while_loop(cond, step, (init, jnp.bool_(True), jnp.int32(0)))
    return out


@partial(jax.jit, static_argnames=("num_nodes2", "sweeps"))
def _collapse_impl(
    bounds2: jax.Array,
    left2: jax.Array,
    right2: jax.Array,
    meta2: jax.Array,
    num_nodes2: int,
    sweeps: int | None = None,
) -> BVH4:
    m = num_nodes2
    n_tris = (m + 1) // 2
    if sweeps is None:
        sweeps = _static_height_bound(n_tris)
    leaf = (meta2 & jnp.uint32(LEAF_FLAG)) != 0
    inv = jnp.uint32(INVALID)

    if m == 1:
        return BVH4(
            bounds_u32=bounds2,
            children=jnp.full((1, 4), inv),
            meta=meta2,
            num_nodes=jnp.uint32(1),
        )

    kids = _gather_kids(left2, right2, leaf)  # (M, 4)
    kid_valid = kids != inv
    kids_i = jnp.clip(kids.astype(jnp.int32), 0, m - 1)

    # 1. reachability: which BVH2 nodes become BVH4 nodes
    def reach_body(is4):
        src = (is4 > 0) & ~leaf
        upd = is4
        for k in range(4):
            tgt = jnp.where(src & kid_valid[:, k], kids_i[:, k], m)  # m → dropped
            upd = upd.at[tgt].max(jnp.where(src, 1, 0), mode="drop")
        return upd

    is4 = jnp.zeros((m,), jnp.int32).at[0].set(1)
    is4 = _fixed_point(reach_body, is4, sweeps)
    is4b = is4 > 0

    # 2. BVH4 subtree sizes, bottom-up
    def size_body(size):
        s = 1 + jnp.sum(jnp.where(kid_valid, size[kids_i], 0), axis=-1)
        return jnp.where(leaf, 1, s)

    size = _fixed_point(size_body, jnp.ones((m,), jnp.int32), sweeps)

    # 3. pre-order output index, top-down: idx(kid_k) = idx(n) + 1 + Σ_{j<k} size(kid_j)
    kid_sizes = jnp.where(kid_valid, size[kids_i], 0)
    elder = jnp.cumsum(kid_sizes, axis=-1) - kid_sizes  # exclusive prefix sum

    def idx_body(idx):
        upd = idx
        src = is4b & ~leaf
        for k in range(4):
            tgt = jnp.where(src & kid_valid[:, k], kids_i[:, k], m)
            upd = upd.at[tgt].set(idx + 1 + elder[:, k], mode="drop")
        return upd

    idx = _fixed_point(idx_body, jnp.zeros((m,), jnp.int32), sweeps)

    # 4. merged bounds over the BVH4 tree, bottom-up in f32
    mn0, mx0 = _decode_bounds(bounds2)

    def bounds_body(state):
        bmn, bmx = state
        inf = jnp.float32(jnp.inf)
        kmn = jnp.where(kid_valid[..., None], bmn[kids_i], inf)
        kmx = jnp.where(kid_valid[..., None], bmx[kids_i], -inf)
        umn = jnp.min(kmn, axis=1)
        umx = jnp.max(kmx, axis=1)
        return (
            jnp.where(leaf[:, None], mn0, umn),
            jnp.where(leaf[:, None], mx0, umx),
        )

    fmn, fmx = _fixed_point(bounds_body, (mn0, mx0), sweeps)

    # 5. emit into pre-order rows (dense prefix [0, numNodes4))
    node_bounds = jnp.where(leaf[:, None], bounds2, _pack_bounds_trunc(fmn, fmx))
    node_children = jnp.where(
        leaf[:, None] | ~kid_valid, inv, idx[kids_i].astype(jnp.uint32)
    )
    node_meta = jnp.where(leaf, meta2, jnp.uint32(0))

    rows = jnp.where(is4b, idx, m)  # non-surviving nodes → dropped
    out_bounds = jnp.zeros((m, 3), jnp.uint32).at[rows].set(node_bounds, mode="drop")
    out_children = jnp.full((m, 4), inv).at[rows].set(node_children, mode="drop")
    out_meta = jnp.zeros((m,), jnp.uint32).at[rows].set(node_meta, mode="drop")
    num_nodes4 = jnp.sum(is4b).astype(jnp.uint32)

    return BVH4(
        bounds_u32=out_bounds, children=out_children, meta=out_meta, num_nodes=num_nodes4
    )


def collapse_lbvh2_to_bvh4(bvh2: LBVH2, sweeps: int | None = None) -> BVH4:
    """Device-side greedy re-emission collapse (PathTracer.js:506-667
    semantics, bit-exact vs. the host oracle).

    ``sweeps`` bounds the fixed-point iteration count (≥ tree height); the
    default covers LBVH trees — pass the measured height (+ slack) for
    arbitrarily-shaped trees like the native SAH builder's."""
    return _collapse_impl(
        bvh2.bounds_u32, bvh2.left, bvh2.right, bvh2.meta, bvh2.num_nodes,
        sweeps=sweeps,
    )


def _subtree_tri_counts(left: jax.Array, right: jax.Array, leaf: jax.Array,
                        sweeps: int) -> jax.Array:
    """Per-node triangle count of the BVH2 subtree (leaves = 1), bottom-up."""
    m = left.shape[0]

    def g(arr, idx):
        return arr[jnp.clip(idx.astype(jnp.int32), 0, m - 1)]

    def body(cnt):
        return jnp.where(leaf, 1, g(cnt, left) + g(cnt, right))

    return _fixed_point(body, jnp.ones((m,), jnp.int32), sweeps)


def _gather_kids_wide(left: jax.Array, right: jax.Array, leaf: jax.Array,
                      width: int, weight: jax.Array) -> jax.Array:
    """(M, width) greedy treelet gather: starting from [L, R], repeatedly
    split the valid INTERNAL kid with the LARGEST subtree (by ``weight``,
    e.g. triangle count) until ``width`` slots are filled or every kid is a
    leaf. The largest-subtree heuristic keeps the emitted tree balanced —
    unlike the reference's first-internal expansion (PathTracer.js:608-621),
    which this package only mirrors for the parity-pinned 4-wide collapse
    (``_gather_kids``). Valid for internal rows only; leaf rows → INVALID."""
    m = left.shape[0]
    inv = jnp.uint32(INVALID)
    cols = jnp.arange(width, dtype=jnp.int32)[None, :]

    kids = jnp.full((m, width), inv)
    kids = kids.at[:, 0].set(left).at[:, 1].set(right)
    nvalid = jnp.full((m,), 2, jnp.int32)

    for _ in range(width - 2):
        ki = jnp.clip(kids.astype(jnp.int32), 0, m - 1)
        valid = kids != inv
        internal_k = valid & ~leaf[ki]
        w = jnp.where(internal_k, weight[ki], -1)      # (M, width)
        j = jnp.argmax(w, axis=-1).astype(jnp.int32)   # widest internal kid
        can = (jnp.max(w, axis=-1) > 0) & (nvalid < width)
        node = jnp.take_along_axis(ki, j[:, None], axis=1)[:, 0]
        lkid, rkid = left[node], right[node]
        # split slot j in place; append the sibling at the first free slot
        kids = jnp.where((cols == j[:, None]) & can[:, None],
                         lkid[:, None], kids)
        kids = jnp.where((cols == nvalid[:, None]) & can[:, None],
                         rkid[:, None], kids)
        nvalid = nvalid + can.astype(jnp.int32)

    return jnp.where(leaf[:, None], inv, kids)


@partial(jax.jit, static_argnames=("num_nodes2", "width", "sweeps"))
def _collapse_wide_impl(
    bounds2: jax.Array,
    left2: jax.Array,
    right2: jax.Array,
    meta2: jax.Array,
    num_nodes2: int,
    width: int,
    sweeps: int | None = None,
) -> BVH4:
    """Width-generalized greedy re-emission collapse (steps 1-5 of
    ``_collapse_impl`` with ``width`` child slots per node). Used for the
    8-wide traversal trees (PERF.md roadmap: BVH8 upper levels halve record
    visits on the scalar-issue-bound consume loop); the 4-wide path keeps
    the separate reference-parity implementation above."""
    m = num_nodes2
    n_tris = (m + 1) // 2
    if sweeps is None:
        sweeps = _static_height_bound(n_tris)
    leaf = (meta2 & jnp.uint32(LEAF_FLAG)) != 0
    inv = jnp.uint32(INVALID)

    if m == 1:
        return BVH4(
            bounds_u32=bounds2,
            children=jnp.full((1, width), inv),
            meta=meta2,
            num_nodes=jnp.uint32(1),
        )

    counts = _subtree_tri_counts(left2, right2, leaf, sweeps)
    kids = _gather_kids_wide(left2, right2, leaf, width, counts)
    kid_valid = kids != inv
    kids_i = jnp.clip(kids.astype(jnp.int32), 0, m - 1)

    # 1. reachability
    def reach_body(isw):
        src = (isw > 0) & ~leaf
        upd = isw
        for k in range(width):
            tgt = jnp.where(src & kid_valid[:, k], kids_i[:, k], m)
            upd = upd.at[tgt].max(jnp.where(src, 1, 0), mode="drop")
        return upd

    isw = jnp.zeros((m,), jnp.int32).at[0].set(1)
    isw = _fixed_point(reach_body, isw, sweeps)
    iswb = isw > 0

    # 2. wide-subtree sizes, bottom-up
    def size_body(size):
        s = 1 + jnp.sum(jnp.where(kid_valid, size[kids_i], 0), axis=-1)
        return jnp.where(leaf, 1, s)

    size = _fixed_point(size_body, jnp.ones((m,), jnp.int32), sweeps)

    # 3. pre-order output index, top-down
    kid_sizes = jnp.where(kid_valid, size[kids_i], 0)
    elder = jnp.cumsum(kid_sizes, axis=-1) - kid_sizes

    def idx_body(idx):
        upd = idx
        src = iswb & ~leaf
        for k in range(width):
            tgt = jnp.where(src & kid_valid[:, k], kids_i[:, k], m)
            upd = upd.at[tgt].set(idx + 1 + elder[:, k], mode="drop")
        return upd

    idx = _fixed_point(idx_body, jnp.zeros((m,), jnp.int32), sweeps)

    # 4. merged bounds, bottom-up in f32
    mn0, mx0 = _decode_bounds(bounds2)

    def bounds_body(state):
        bmn, bmx = state
        inf = jnp.float32(jnp.inf)
        kmn = jnp.where(kid_valid[..., None], bmn[kids_i], inf)
        kmx = jnp.where(kid_valid[..., None], bmx[kids_i], -inf)
        return (
            jnp.where(leaf[:, None], mn0, jnp.min(kmn, axis=1)),
            jnp.where(leaf[:, None], mx0, jnp.max(kmx, axis=1)),
        )

    fmn, fmx = _fixed_point(bounds_body, (mn0, mx0), sweeps)

    # 5. emit into pre-order rows
    node_bounds = jnp.where(leaf[:, None], bounds2, _pack_bounds_trunc(fmn, fmx))
    node_children = jnp.where(
        leaf[:, None] | ~kid_valid, inv, idx[kids_i].astype(jnp.uint32)
    )
    node_meta = jnp.where(leaf, meta2, jnp.uint32(0))

    rows = jnp.where(iswb, idx, m)
    out_bounds = jnp.zeros((m, 3), jnp.uint32).at[rows].set(node_bounds, mode="drop")
    out_children = jnp.full((m, width), inv).at[rows].set(node_children, mode="drop")
    out_meta = jnp.zeros((m,), jnp.uint32).at[rows].set(node_meta, mode="drop")
    num_nodes_w = jnp.sum(iswb).astype(jnp.uint32)

    return BVH4(
        bounds_u32=out_bounds, children=out_children, meta=out_meta,
        num_nodes=num_nodes_w,
    )


def collapse_lbvh2_to_bvh8(bvh2: LBVH2, sweeps: int | None = None) -> BVH4:
    """8-wide greedy collapse → BVH8 in the BVH4 container (children (M,8)).

    An extension beyond the reference's 4-wide collapse
    (PathTracer.js:506-667): half the node visits per traversal at ~2× the
    slab tests per visit. Treelets are gathered largest-subtree-first for
    balance; downstream (make_wide_bvh, pack_bvh, the traversal) is
    width-agnostic."""
    return _collapse_wide_impl(
        bvh2.bounds_u32, bvh2.left, bvh2.right, bvh2.meta, bvh2.num_nodes,
        width=8, sweeps=sweeps,
    )


class CollapsePlan(NamedTuple):
    """The topology half of the greedy collapse, computed ONCE per tree.

    Collapse's treelet gathering, reachability, subtree sizes, and pre-order
    output indices (steps 1-3 of ``_collapse_impl``) are pure functions of
    (left, right, meta) — refitting moves bounds but never topology — so for
    dynamic scenes the four per-frame fixed-point sweeps can be replaced by a
    single static gather of the refitted BVH2 bounds (``collapse_apply_refit``).
    The reference rebuilds its BVH4 from scratch per deformation instead
    (PathTracer.js:671-749, seconds per frame)."""

    children: jax.Array   # (M, 4) uint32 — BVH4 children per pre-order row
    meta: jax.Array       # (M,) uint32 — LEAF_FLAG|tri or 0
    src: jax.Array        # (M,) int32 — source BVH2 node of each BVH4 row
    emitted: jax.Array    # (M,) bool — row < numNodes4 (pre-order is dense)
    num_nodes: jax.Array  # () uint32


@partial(jax.jit, static_argnames=("num_nodes2", "sweeps"))
def _collapse_plan_impl(
    left2: jax.Array,
    right2: jax.Array,
    meta2: jax.Array,
    num_nodes2: int,
    sweeps: int | None = None,
) -> CollapsePlan:
    m = num_nodes2
    n_tris = (m + 1) // 2
    if sweeps is None:
        sweeps = _static_height_bound(n_tris)
    leaf = (meta2 & jnp.uint32(LEAF_FLAG)) != 0
    inv = jnp.uint32(INVALID)

    if m == 1:
        return CollapsePlan(
            children=jnp.full((1, 4), inv),
            meta=meta2,
            src=jnp.zeros((1,), jnp.int32),
            emitted=jnp.ones((1,), bool),
            num_nodes=jnp.uint32(1),
        )

    kids = _gather_kids(left2, right2, leaf)
    kid_valid = kids != inv
    kids_i = jnp.clip(kids.astype(jnp.int32), 0, m - 1)

    def reach_body(is4):
        src_ = (is4 > 0) & ~leaf
        upd = is4
        for k in range(4):
            tgt = jnp.where(src_ & kid_valid[:, k], kids_i[:, k], m)
            upd = upd.at[tgt].max(jnp.where(src_, 1, 0), mode="drop")
        return upd

    is4 = jnp.zeros((m,), jnp.int32).at[0].set(1)
    is4 = _fixed_point(reach_body, is4, sweeps)
    is4b = is4 > 0

    def size_body(size):
        s = 1 + jnp.sum(jnp.where(kid_valid, size[kids_i], 0), axis=-1)
        return jnp.where(leaf, 1, s)

    size = _fixed_point(size_body, jnp.ones((m,), jnp.int32), sweeps)

    kid_sizes = jnp.where(kid_valid, size[kids_i], 0)
    elder = jnp.cumsum(kid_sizes, axis=-1) - kid_sizes

    def idx_body(idx):
        upd = idx
        src_ = is4b & ~leaf
        for k in range(4):
            tgt = jnp.where(src_ & kid_valid[:, k], kids_i[:, k], m)
            upd = upd.at[tgt].set(idx + 1 + elder[:, k], mode="drop")
        return upd

    idx = _fixed_point(idx_body, jnp.zeros((m,), jnp.int32), sweeps)

    node_children = jnp.where(
        leaf[:, None] | ~kid_valid, inv, idx[kids_i].astype(jnp.uint32)
    )
    node_meta = jnp.where(leaf, meta2, jnp.uint32(0))
    rows = jnp.where(is4b, idx, m)
    out_children = jnp.full((m, 4), inv).at[rows].set(node_children, mode="drop")
    out_meta = jnp.zeros((m,), jnp.uint32).at[rows].set(node_meta, mode="drop")
    out_src = jnp.zeros((m,), jnp.int32).at[rows].set(
        jnp.arange(m, dtype=jnp.int32), mode="drop"
    )
    num_nodes4 = jnp.sum(is4b).astype(jnp.uint32)
    emitted = jnp.zeros((m,), bool).at[rows].set(True, mode="drop")
    return CollapsePlan(
        children=out_children, meta=out_meta, src=out_src, emitted=emitted,
        num_nodes=num_nodes4,
    )


def collapse_plan(bvh2: LBVH2, sweeps: int | None = None) -> CollapsePlan:
    """Compute the static (topology) half of the collapse once."""
    return _collapse_plan_impl(
        bvh2.left, bvh2.right, bvh2.meta, bvh2.num_nodes, sweeps=sweeps
    )


def _flush_f16_subnormals(b: jax.Array) -> jax.Array:
    """Flush fp16 subnormal halfwords of packed u32 bound words to signed
    zero — exactly what ``_f32_to_f16_bits_trunc`` does to a decoded
    subnormal (e <= 0 → sign only), so a verbatim gather matches the full
    collapse's re-pack even for |component| < 2^-14 (ADVICE r4)."""

    def fl(h):
        return jnp.where((h & jnp.uint32(0x7C00)) == 0,
                         h & jnp.uint32(0x8000), h)

    lo = b & jnp.uint32(0xFFFF)
    hi = b >> jnp.uint32(16)
    return fl(lo) | (fl(hi) << jnp.uint32(16))


def collapse_apply_refit(plan: CollapsePlan, bounds2_u32: jax.Array) -> BVH4:
    """BVH4 from a precomputed plan + REFITTED BVH2 bounds: one gather.

    Bit-identical to ``collapse_lbvh2_to_bvh4`` whenever ``bounds2_u32``
    satisfies parent == union(children) exactly in fp16 — which every refit
    in this package guarantees: leaf boxes are conservatively packed once and
    unions of fp16-representable values are fp16-representable, so the
    truncating re-pack the full collapse performs (step 4) is the identity
    and each surviving node's merged bound equals its own BVH2 bound. The one
    non-identity case of that re-pack — fp16 subnormal components, common in
    axis-at-zero scenes (|x| < 2^-14 after the conservative 1-ULP leaf
    expansion) — is reproduced here by flushing internal rows' subnormal
    halfwords to signed zero, as the full collapse's truncation does (leaf
    rows pass verbatim there too). For raw BUILD bounds (which keep the
    builder's per-sweep conservative internal expansion) the gathered boxes
    may be a few fp16 ULPs larger than the full collapse's re-merged ones —
    conservative containment, never a miss. Parity-tested in
    tests/test_collapse.py including a ground-plane-at-zero scene."""
    m = plan.src.shape[0]
    b4 = bounds2_u32[jnp.clip(plan.src, 0, m - 1)]
    internal = plan.meta == 0
    b4 = jnp.where(internal[:, None], _flush_f16_subnormals(b4), b4)
    b4 = jnp.where(plan.emitted[:, None], b4, jnp.uint32(0))
    return BVH4(
        bounds_u32=b4, children=plan.children, meta=plan.meta,
        num_nodes=plan.num_nodes,
    )


@partial(jax.jit, static_argnames=("num_nodes2",))
def _promote_impl(bounds2, left2, right2, meta2, num_nodes2: int) -> BVH4:
    m = num_nodes2
    inv = jnp.uint32(INVALID)
    leaf = (meta2 & jnp.uint32(LEAF_FLAG)) != 0

    def leafish(c):
        oob = c >= jnp.uint32(m)
        return oob | leaf[jnp.clip(c.astype(jnp.int32), 0, m - 1)]

    def g(arr, c):
        return arr[jnp.clip(c.astype(jnp.int32), 0, m - 1)]

    L, R = left2, right2
    lleaf, rleaf = leafish(L), leafish(R)
    # promote(left) contributes 1 (itself) or 2 (its kids); then promote(right)
    a0 = jnp.where(lleaf, L, g(left2, L))
    a1 = jnp.where(lleaf, inv, g(right2, L))
    b0 = jnp.where(rleaf, R, g(left2, R))
    b1 = jnp.where(rleaf, inv, g(right2, R))
    # compact [a0, a1?, b0, b1?] — a0/b0 always present (INVALID children of
    # internal LBVH2 nodes never occur; left/right are always valid)
    k0 = a0
    k1 = jnp.where(lleaf, b0, a1)
    k2 = jnp.where(lleaf, b1, b0)
    k3 = jnp.where(lleaf, inv, b1)

    children = jnp.stack([k0, k1, k2, k3], axis=-1)
    children = jnp.where(leaf[:, None], inv, children)
    meta4 = jnp.where(leaf, meta2, jnp.uint32(0))
    return BVH4(
        bounds_u32=bounds2,
        children=children,
        meta=meta4,
        num_nodes=jnp.uint32(m),
    )


def promote_lbvh2_to_bvh4_wide(bvh2: LBVH2) -> BVH4:
    """Device-side O(N) index-preserving wide promotion (test.cpp semantics)."""
    return _promote_impl(bvh2.bounds_u32, bvh2.left, bvh2.right, bvh2.meta, bvh2.num_nodes)


@jax.jit
def bvh2_as_bvh4(bvh2: LBVH2) -> BVH4:
    """Zero-cost view of the binary LBVH in the 4-wide node struct
    (children = [left, right, INVALID, INVALID]) so the same traversal
    kernels run pure BVH2 traversal (BASELINE config 1)."""
    m = bvh2.bounds_u32.shape[0]
    inv = jnp.uint32(INVALID)
    leaf = (bvh2.meta & jnp.uint32(LEAF_FLAG)) != 0
    children = jnp.stack(
        [bvh2.left, bvh2.right, jnp.full((m,), inv), jnp.full((m,), inv)],
        axis=-1,
    )
    children = jnp.where(leaf[:, None], inv, children)
    return BVH4(
        bounds_u32=bvh2.bounds_u32,
        children=children,
        meta=bvh2.meta,
        num_nodes=jnp.uint32(m),
    )
