"""BVH traversal: the packed tree layout, its plain XLA reference, and the
one trace entry every renderer calls.

Layout (built once per scene by :func:`pack_bvh`; the CUDA kernel in
``native/trace_kernel.cu`` and :func:`trace_reference` read exactly these
arrays):

* ``nodes`` (M, 8·w) f32 — one row per wide node of width w ∈ {4, 8}, as
  eight groups of w words: the children's box mnx, mny, mnz, mxx, mxy, mxz,
  then ``ref`` and ``cnt`` stored as int32 bit patterns. ``cnt`` = −1 marks
  an empty slot, 0 an internal child (``ref`` = its node row), k > 0 a leaf
  of k triangles starting at triangle row ``ref``. For w = 4 a row is 128
  bytes, one cache line.
* ``tris`` (:class:`TriRecords`) — ``rec`` (T, 12) f32 ``[v0, e1, e2, g]``
  in leaf order (e1 = v1−v0, e2 = v2−v0, g = e1×e2 the unnormalized
  geometric normal) and ``ids`` (T,) int32, the original triangle index a
  hit reports.

Traversal (the same visiting order in both implementations, after the
reference's per-ray stack, renderer.wgsl:210-346): each ray owns a 64-deep
stack seeded with the root row. A popped entry whose entry distance is not
below the current best t is dropped. A node entry slab-tests its w children
against the best t (renderer.wgsl:141-168), sorts the hits by entry
distance (stable, ties by slot) and pushes them far→near, so the nearest
pops first. A leaf entry runs Möller–Trumbore (eps 1e-7, strict
eps < t < best; renderer.wgsl:171-208) over its triangles in row order.
Leaf stack entries are encoded ``~(first·64 + cnt − 1)`` (negative).

``t_max`` is a per-ray initial best t: only hits with t < t_max count, and a
ray with t_max ≤ 0 is inactive. ``any_hit`` stops a ray at its first
accepted hit (shadow rays); ``t`` is then that hit's distance, not the
nearest. Outputs are ``(t, nx, ny, nz, tri)``: t = INF, n = 0, tri = −1 on a
miss; n is the unit geometric normal g/|g| (not flipped toward the ray).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import fp16_jax as f16
from .camera import INF, safe_inv_dir
from .collapse import BVH4

__all__ = ["WideBVH", "TriRecords", "make_wide_bvh", "pack_bvh",
           "unpack_nodes", "trace", "trace_reference", "trace_rays_brute",
           "STACK_MAX"]

LEAF_FLAG = 0x80000000
INVALID = 0xFFFFFFFF
STACK_MAX = 64          # renderer.wgsl:8
MT_EPS = 1e-7           # renderer.wgsl:178
MAX_LEAF = 64           # leaf stack entries keep cnt − 1 in 6 bits
_LEAF_CHUNK = 4         # triangles the reference intersects per iteration

# cref encoding of WideBVH (int32): -1 = empty slot; bit 30 set = leaf →
# low bits are the leaf index; otherwise an internal node index.
_CREF_LEAF_BIT = jnp.int32(1 << 30)


class WideBVH(NamedTuple):
    """A wide BVH with each node's children's boxes and refs inline."""

    cmn: jax.Array   # (M, w, 3) f32 — child box minima (+inf for empty)
    cmx: jax.Array   # (M, w, 3) f32 — child box maxima (−inf for empty)
    cref: jax.Array  # (M, w) int32 — encoded child refs


class TriRecords(NamedTuple):
    """Triangle records in leaf order, as the traversal reads them."""

    rec: jax.Array   # (T, 12) f32 — [v0, e1, e2, g]
    ids: jax.Array   # (T,) int32 — original triangle index


def make_wide_bvh(bvh: BVH4) -> WideBVH:
    """Fold each node's children's bounds/kind into the parent record.

    Validity rules mirror the WGSL reader (renderer.wgsl:286-291): child slots
    that are INVALID, out of range, or carry a degenerate (min>max) box are
    disabled. Works for any width (BVH2 fed as (left, right, INV, INV),
    BVH4, BVH8). A tree whose root is itself a leaf (a scene of one leaf)
    gets that leaf as slot 0 of row 0, so traversal needs no special case.
    """
    m, w = bvh.children.shape
    num_nodes = bvh.num_nodes.astype(jnp.uint32)
    mn, mx = f16.unpack_bounds(bvh.bounds_u32)

    ch = bvh.children
    valid = (ch != jnp.uint32(INVALID)) & (ch < num_nodes)
    ci = jnp.clip(ch.astype(jnp.int32), 0, m - 1)

    cmn = mn[ci]                     # (M, w, 3)
    cmx = mx[ci]
    cmeta = bvh.meta[ci]
    root_leaf = (bvh.meta[0] & jnp.uint32(LEAF_FLAG)) != 0
    first_slot = (jnp.arange(m)[:, None] == 0) & (jnp.arange(w)[None, :] == 0)
    as_root = root_leaf & first_slot
    valid = jnp.where(as_root, True, valid)
    cmn = jnp.where(as_root[..., None], mn[0], cmn)
    cmx = jnp.where(as_root[..., None], mx[0], cmx)
    cmeta = jnp.where(as_root, bvh.meta[0], cmeta)
    ci = jnp.where(as_root, 0, ci)
    degenerate = jnp.any(cmn > cmx, axis=-1)
    valid = valid & ~degenerate

    child_leaf = (cmeta & jnp.uint32(LEAF_FLAG)) != 0
    leaf_idx = (cmeta & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)
    cref = jnp.where(child_leaf, leaf_idx | _CREF_LEAF_BIT, ci)
    cref = jnp.where(valid, cref, jnp.int32(-1))

    inf = jnp.float32(jnp.inf)
    cmn = jnp.where(valid[..., None], cmn, inf)
    cmx = jnp.where(valid[..., None], cmx, -inf)
    return WideBVH(cmn=cmn, cmx=cmx, cref=cref)


def _i2f(x):
    return jax.lax.bitcast_convert_type(x.astype(jnp.int32), jnp.float32)


def _f2i(x):
    return jax.lax.bitcast_convert_type(x, jnp.int32)


@partial(jax.jit, static_argnames=("leaf_size",))
def pack_bvh(wide: WideBVH, tris: jax.Array, tri_ids: jax.Array | None = None,
             leaf_size: int = 1) -> tuple[jax.Array, TriRecords]:
    """WideBVH + (T,3,3) triangles → (nodes, TriRecords) (module docstring).

    ``leaf_size=1``: leaf refs in ``wide.cref`` are triangle indices into
    ``tris``. ``leaf_size=K>1``: leaf refs are cluster indices
    (ops/cluster.py) — cluster c owns rows [cK, min(T, (c+1)K)) of the
    cluster-ordered ``tris``; pass the original-id permutation as
    ``tri_ids`` so hits still report reference indices.
    """
    m, w = wide.cref.shape
    n_tris = tris.shape[0]
    if leaf_size > MAX_LEAF or n_tris * MAX_LEAF >= 1 << 31:
        raise ValueError(
            f"leaf_size {leaf_size} / {n_tris} triangles exceed the stack "
            f"entry encoding (leaf_size <= {MAX_LEAF}, triangles < 2^25)")
    cref = wide.cref
    is_leaf = (cref >= 0) & ((cref & _CREF_LEAF_BIT) != 0)
    first = (cref & (_CREF_LEAF_BIT - 1)) * leaf_size
    count = jnp.clip(n_tris - first, 0, leaf_size)
    cnt = jnp.where(cref < 0, -1,
                    jnp.where(is_leaf, jnp.where(count > 0, count, -1), 0))
    ref = jnp.where(cnt > 0, first, jnp.where(cnt == 0, cref, 0))

    groups = [wide.cmn[..., 0], wide.cmn[..., 1], wide.cmn[..., 2],
              wide.cmx[..., 0], wide.cmx[..., 1], wide.cmx[..., 2],
              _i2f(ref), _i2f(cnt)]
    nodes = jnp.concatenate(groups, axis=1)           # (M, 8w)

    flat = tris.reshape(n_tris, 9)
    v0, v1, v2 = flat[:, 0:3], flat[:, 3:6], flat[:, 6:9]
    e1 = v1 - v0
    e2 = v2 - v0
    rec = jnp.concatenate([v0, e1, e2, jnp.cross(e1, e2)], axis=-1)
    ids = (jnp.arange(n_tris, dtype=jnp.int32) if tri_ids is None
           else tri_ids.astype(jnp.int32))
    return nodes, TriRecords(rec=rec, ids=ids)


def unpack_nodes(nodes: jax.Array):
    """nodes → (cmn (M,w,3), cmx (M,w,3), ref (M,w) int32, cnt (M,w) int32)."""
    m = nodes.shape[0]
    w = nodes.shape[-1] // 8
    g = nodes.reshape(m, 8, w)
    cmn = jnp.stack([g[:, 0], g[:, 1], g[:, 2]], axis=-1)
    cmx = jnp.stack([g[:, 3], g[:, 4], g[:, 5]], axis=-1)
    return cmn, cmx, _f2i(g[:, 6]), _f2i(g[:, 7])


def _mt(o, d, v0, e1, e2):
    """Möller–Trumbore from a precomputed record, reference semantics
    (renderer.wgsl:171-208). Shapes broadcast; returns (t, valid)."""
    p = jnp.cross(d, e2)
    det = jnp.sum(e1 * p, axis=-1)
    inv_det = jnp.float32(1.0) / jnp.where(det == 0, jnp.float32(1.0), det)
    s = o - v0
    u = inv_det * jnp.sum(s * p, axis=-1)
    q = jnp.cross(s, e1)
    v = inv_det * jnp.sum(d * q, axis=-1)
    t = inv_det * jnp.sum(e2 * q, axis=-1)
    ok = (
        (jnp.abs(det) >= jnp.float32(MT_EPS))
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > jnp.float32(MT_EPS))
    )
    return t, ok


class _State(NamedTuple):
    sp: jax.Array        # (C,) int32 — top of stack, -1 empty
    stack_e: jax.Array   # (C, S) int32 — node row, or ~(first·64 + cnt−1)
    stack_d: jax.Array   # (C, S) f32 — entry distance
    best_t: jax.Array    # (C,) f32
    best_row: jax.Array  # (C,) int32, -1 = miss


def _push(st_e, st_d, sp, rows, ok, e, dist):
    ok = ok & (sp < STACK_MAX - 1)
    sp = jnp.where(ok, sp + 1, sp)
    pos = jnp.where(ok, sp, STACK_MAX)           # out of range → dropped
    st_e = st_e.at[rows, pos].set(e, mode="drop")
    st_d = st_d.at[rows, pos].set(dist, mode="drop")
    return st_e, st_d, sp


def _trace_chunk(nodes, rec, o, d, t_max, any_hit: bool):
    """Traverse one chunk of C rays to completion (vectorized over rays)."""
    c = o.shape[0]
    m, w = nodes.shape[0], nodes.shape[1] // 8
    n_tris = rec.shape[0]
    inv = safe_inv_dir(d)
    rows = jnp.arange(c, dtype=jnp.int32)
    lanes = jnp.arange(_LEAF_CHUNK, dtype=jnp.int32)

    state = _State(
        sp=jnp.where(t_max > 0, 0, -1).astype(jnp.int32),
        stack_e=jnp.zeros((c, STACK_MAX), jnp.int32),
        stack_d=jnp.full((c, STACK_MAX), -INF),
        best_t=t_max,
        best_row=jnp.full((c,), -1, jnp.int32),
    )

    def body(st: _State) -> _State:
        active = st.sp >= 0
        spc = jnp.maximum(st.sp, 0)
        e = st.stack_e[rows, spc]
        dist = st.stack_d[rows, spc]
        sp = jnp.where(active, st.sp - 1, st.sp)
        go = active & (dist < st.best_t)
        is_leaf = e < 0

        # --- node entry: slab-test the children, push the hits far→near
        g = nodes[jnp.clip(e, 0, m - 1)].reshape(c, 8, w)
        t1 = (g[:, 0:3] - o[:, :, None]) * inv[:, :, None]      # (C,3,w)
        t2 = (g[:, 3:6] - o[:, :, None]) * inv[:, :, None]
        tmin = jnp.max(jnp.minimum(t1, t2), axis=1)
        tmax = jnp.min(jnp.maximum(t1, t2), axis=1)
        ref, cnt = _f2i(g[:, 6]), _f2i(g[:, 7])
        hit = ((tmax >= jnp.maximum(tmin, 0.0)) & (tmin < st.best_t[:, None])
               & (cnt >= 0) & (go & ~is_leaf)[:, None])
        ent = jnp.where(cnt > 0, ~((ref << 6) | (cnt - 1)), ref)
        order = jnp.argsort(jnp.where(hit, tmin, INF), axis=-1, stable=True)
        s_e = jnp.take_along_axis(ent, order, axis=-1)
        s_d = jnp.take_along_axis(tmin, order, axis=-1)
        s_hit = jnp.take_along_axis(hit, order, axis=-1)
        st_e, st_d = st.stack_e, st.stack_d
        for k in reversed(range(w)):
            st_e, st_d, sp = _push(st_e, st_d, sp, rows, s_hit[:, k],
                                   s_e[:, k], s_d[:, k])

        # --- leaf entry: the next _LEAF_CHUNK triangles, in row order; the
        # rest of the leaf goes back on top of the stack
        leaf_go = go & is_leaf
        code = ~e
        first = code >> 6
        n_left = (code & (MAX_LEAF - 1)) + 1
        tri_row = first[:, None] + lanes
        r = rec[jnp.clip(tri_row, 0, n_tris - 1)]                # (C,L,12)
        t_hit, ok = _mt(o[:, None, :], d[:, None, :],
                        r[..., 0:3], r[..., 3:6], r[..., 6:9])
        ok = ok & leaf_go[:, None] & (lanes < n_left[:, None])
        cand = jnp.where(ok & (t_hit < st.best_t[:, None]), t_hit, INF)
        slot = jnp.argmin(cand, axis=-1)         # first of equal t wins
        new_t = cand[rows, slot]
        upd = new_t < st.best_t
        best_t = jnp.where(upd, new_t, st.best_t)
        best_row = jnp.where(upd, tri_row[rows, slot], st.best_row)
        rest = leaf_go & (n_left > _LEAF_CHUNK)
        rest_e = ~(((first + _LEAF_CHUNK) << 6) | (n_left - _LEAF_CHUNK - 1))
        st_e, st_d, sp = _push(st_e, st_d, sp, rows, rest, rest_e,
                               jnp.full((c,), -INF))
        if any_hit:
            sp = jnp.where(best_row >= 0, -1, sp)
        return _State(sp, st_e, st_d, best_t, best_row)

    final = jax.lax.while_loop(lambda st: jnp.any(st.sp >= 0), body, state)
    return final.best_t, final.best_row


def _finish(tris: TriRecords, best_t, best_row):
    """(best t, best row) → the (t, nx, ny, nz, tri) outputs."""
    hit = best_row >= 0
    row = jnp.maximum(best_row, 0)
    g = tris.rec[row, 9:12]
    n = g * jax.lax.rsqrt(jnp.sum(g * g, axis=-1, keepdims=True))
    n = jnp.where(hit[:, None], n, 0.0)
    return (jnp.where(hit, best_t, INF), n[:, 0], n[:, 1], n[:, 2],
            jnp.where(hit, tris.ids[row], -1))


@partial(jax.jit, static_argnames=("any_hit", "chunk"))
def trace_reference(nodes: jax.Array, tris: TriRecords, o: jax.Array,
                    d: jax.Array, t_max: jax.Array, any_hit: bool = False,
                    chunk: int = 8192):
    """Plain XLA traversal of (R,3) rays — the CPU path and the kernel's
    reference. Rays run in ``chunk``-sized groups, each until its stacks
    drain (keep chunks spatially coherent)."""
    r = o.shape[0]
    chunk = max(1, min(chunk, r))
    pad = (-r) % chunk
    op = jnp.pad(o, ((0, pad), (0, 0))).reshape(-1, chunk, 3)
    dp = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0).reshape(-1, chunk, 3)
    tp = jnp.pad(t_max, (0, pad)).reshape(-1, chunk)     # pad rays inactive
    best_t, best_row = jax.lax.map(
        lambda a: _trace_chunk(nodes, tris.rec, a[0], a[1], a[2], any_hit),
        (op, dp, tp))
    return _finish(tris, best_t.reshape(-1)[:r], best_row.reshape(-1)[:r])


@partial(jax.jit, static_argnames=("any_hit", "reference"))
def trace(nodes: jax.Array, tris: TriRecords, o: jax.Array, d: jax.Array, *,
          any_hit: bool = False, t_max: jax.Array | None = None,
          reference: bool = False):
    """Trace rays ``o``/``d`` of shape (..., 3) → (t, nx, ny, nz, tri), each
    of shape (...). The one traversal entry: the CUDA kernel on ``gpu``, the
    XLA reference on ``cpu``; any other platform is an error.
    ``reference=True`` runs the XLA reference on the current device — the
    kernel's oracle, for comparisons on the card."""
    shape = o.shape[:-1]
    o = jnp.asarray(o, jnp.float32).reshape(-1, 3)
    d = jnp.asarray(d, jnp.float32).reshape(-1, 3)
    t_max = jnp.broadcast_to(
        INF if t_max is None else jnp.asarray(t_max, jnp.float32), shape
    ).reshape(-1)
    backend = jax.default_backend()
    if reference:
        out = trace_reference(nodes, tris, o, d, t_max, any_hit=any_hit)
    elif backend == "gpu":
        from . import cuda_trace

        cuda_trace.ensure_registered()
        out = cuda_trace.trace_cuda(nodes, tris, o, d, t_max, any_hit=any_hit)
    elif backend == "cpu":
        out = trace_reference(nodes, tris, o, d, t_max, any_hit=any_hit)
    else:
        raise RuntimeError(
            f"no BVH traversal for platform {backend!r} (supported: gpu, cpu)")
    return tuple(a.reshape(shape) for a in out)


@jax.jit
def trace_rays_brute(tris: jax.Array, origins: jax.Array, dirs: jax.Array):
    """Ground-truth closest hit: test every ray against every triangle.

    O(R·T) — the correctness oracle for the BVH path and the natural fast
    path for tiny scenes. Tie-break: lowest triangle index (argmin)."""
    v0 = tris[None, :, 0, :]
    t, ok = _mt(origins[:, None, :], dirs[:, None, :], v0,
                tris[None, :, 1, :] - v0, tris[None, :, 2, :] - v0)
    t = jnp.where(ok, t, INF)
    idx = jnp.argmin(t, axis=-1)
    best = jnp.take_along_axis(t, idx[:, None], axis=-1)[:, 0]
    return best, jnp.where(best < INF, idx.astype(jnp.int32), -1)
