"""BVH8 path: 8-wide greedy collapse + width-generalized traversal.

An extension beyond the reference's fixed 4-wide collapse
(PathTracer.js:506-667): half the node visits per ray for twice the slab
tests per visit. Correctness is pinned the same way as the 4-wide path —
structural invariants vs the BVH2, then exact tri-id parity vs the
brute-force oracle through the trace entry.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from raytracer.models.scene import Scene
from raytracer.ops.camera import generate_rays
from raytracer.ops.collapse import (
    INVALID,
    LEAF_FLAG,
    _decode_bounds,
    collapse_lbvh2_to_bvh8,
)
from raytracer.ops.lbvh import build_lbvh2
from raytracer.ops.trace import (
    make_wide_bvh,
    pack_bvh,
    trace,
    trace_rays_brute,
    unpack_nodes,
)
from raytracer.render import trace_frame
from raytracer.utils import procgen

CAM_POS = jnp.array([0.15, -0.1, 2.5], jnp.float32)
CAM_QUAT = jnp.array([0.0, 0.1, 0.0, 0.9949874], jnp.float32)


def _scene_tris(n_sub=2, trim=0):
    tris_np = procgen.make_icosphere(n_sub)
    if trim:
        tris_np = tris_np[:-trim]
    scene = Scene().set_triangles(tris_np)
    scene._normalize_enabled, scene._normalize_mode = True, "cube"
    scene.normalize_mesh()
    return jnp.asarray(scene.triangles)


def test_rec_layout_width8_roundtrip():
    """Node rows are 8·w words for either width and any leaf size, and
    unpack back to the packed boxes and per-slot counts."""
    from raytracer.ops.cluster import build_lbvh2_clustered, records_pipeline

    tris = _scene_tris(1)
    for k in (1, 2, 8, 32):
        cs = build_lbvh2_clustered(tris, leaf_size=k)
        for width in (4, 8):
            nodes, trec = records_pipeline(cs, width=width)
            assert nodes.shape[1] == 8 * width
            cmn, cmx, ref, cnt = (np.asarray(a) for a in unpack_nodes(nodes))
            assert cmn.shape == cmx.shape == (nodes.shape[0], width, 3)
            assert cnt.max() <= k and cnt.min() >= -1
            # every triangle row is covered by exactly one leaf slot
            rows = np.concatenate([np.arange(r, r + c) for r, c in
                                   zip(ref[cnt > 0], cnt[cnt > 0])])
            assert sorted(rows.tolist()) == list(range(tris.shape[0]))
            assert trec.rec.shape == (tris.shape[0], 12)
    with pytest.raises(ValueError):
        pack_bvh(make_wide_bvh(collapse_lbvh2_to_bvh8(build_lbvh2(tris))),
                 tris, leaf_size=65)


def test_collapse8_structure():
    """Every BVH2 leaf appears exactly once under the BVH8 root; every
    node's decoded box contains its children's boxes."""
    tris = _scene_tris(2)
    bvh2 = build_lbvh2(tris)
    b8 = collapse_lbvh2_to_bvh8(bvh2)
    n = int(b8.num_nodes)
    kids = np.asarray(b8.children)[:n]
    meta = np.asarray(b8.meta)[:n]
    leaf = (meta & LEAF_FLAG) != 0

    # walk from the root, count leaf occurrences
    seen = np.zeros(n, np.int32)
    stack = [0]
    while stack:
        i = stack.pop()
        seen[i] += 1
        if not leaf[i]:
            ks = kids[i]
            ks = ks[ks != INVALID]
            assert len(ks) >= 2          # internal nodes keep ≥2 children
            stack.extend(int(x) for x in ks)
    assert (seen <= 1).all()             # pre-order emission: no sharing
    assert seen.sum() == n               # every emitted row is reachable
    n_leaves = int(leaf.sum())
    assert n_leaves == tris.shape[0]

    # containment in decoded f32 space
    mn, mx = (np.asarray(a) for a in _decode_bounds(b8.bounds_u32[:n]))
    for i in range(n):
        if leaf[i]:
            continue
        for k in kids[i]:
            if k == INVALID:
                continue
            assert (mn[i] <= mn[k] + 1e-6).all() and (mx[i] >= mx[k] - 1e-6).all()

    # 8-wide trees are strictly shallower record-wise: fewer internal nodes
    # than the 4-wide greedy collapse would emit is not guaranteed, but the
    # internal count must be < the BVH2's internal count / 2 + slack
    assert n - n_leaves <= (tris.shape[0] - 1 + 2) // 2


@pytest.mark.parametrize("k", [1, pytest.param(8, marks=pytest.mark.full)])
def test_bvh8_kernel_parity_vs_brute(k):
    """Exact tri-id parity of the 8-wide record path — primary frames and
    arbitrary ray buffers, closest-hit and any-hit — K=1 and packed K=8
    leaves."""
    if k == 1:
        tris = _scene_tris(1)
        nodes, trec = pack_bvh(
            make_wide_bvh(collapse_lbvh2_to_bvh8(build_lbvh2(tris))), tris)
    else:
        from raytracer.ops.cluster import build_lbvh2_clustered, records_pipeline

        tris = _scene_tris(2, trim=3)    # short tail cluster
        nodes, trec = records_pipeline(
            build_lbvh2_clustered(tris, leaf_size=k), width=8)
    assert nodes.shape[1] == 64

    w, h = (64, 32) if k == 1 else (96, 64)
    t, nx, ny, nz, tri = trace_frame(nodes, trec, CAM_POS, CAM_QUAT, w, h)
    o, d = generate_rays(w, h, CAM_POS, CAM_QUAT)
    bt, btri = trace_rays_brute(tris, o.reshape(-1, 3), d.reshape(-1, 3))
    bt = np.asarray(bt).reshape(h, w)
    btri = np.asarray(btri).reshape(h, w)
    assert (np.asarray(tri) == btri).all()
    hit = btri >= 0
    assert np.allclose(np.asarray(t)[hit], bt[hit], rtol=1e-5)

    # arbitrary ray buffers (bounce waves / shadow rays), incl. any-hit
    ob, db = o.reshape(-1, 3)[:512], d.reshape(-1, 3)[:512]
    rt, _, _, _, rtri = trace(nodes, trec, ob, db)
    rbt, rbtri = trace_rays_brute(tris, ob, db)
    assert (np.asarray(rtri) == np.asarray(rbtri)).all()
    _, _, _, _, otri = trace(nodes, trec, ob, db, any_hit=True)
    assert ((np.asarray(otri) >= 0) == (np.asarray(rbtri) >= 0)).all()
