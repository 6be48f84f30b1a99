"""Renderer tests: BVH trace == brute force, XLA == numpy oracle, image
semantics, traversal statistics."""

import numpy as np
import pytest

from raytracer.ops.collapse import collapse_lbvh2_to_bvh4, promote_lbvh2_to_bvh4_wide
from raytracer.ops.lbvh import build_lbvh2
from raytracer.ops.shade import present_frame, quantize_rgba8
from raytracer.ops.trace import make_wide_bvh, pack_bvh, trace, trace_rays_brute
from raytracer.reference import cpu_tracer
from raytracer.render import (render_frame_u8, render_ldr, render_ldr_brute,
                              trace_frame, trace_frames)
from raytracer.utils import procgen

CAM_POS = np.array([0.0, 0.0, 3.5], np.float32)   # PathTracer.js:67 default
CAM_QUAT = np.array([0.0, 0.0, 0.0, 1.0], np.float32)


def _records(tris, widener=collapse_lbvh2_to_bvh4):
    """(nodes, TriRecords) of the single-triangle-leaf tree."""
    return pack_bvh(make_wide_bvh(widener(build_lbvh2(tris))), tris)


@pytest.mark.parametrize("mesh", ["icosphere", "cornell", "cube"])
def test_bvh_equals_brute_force(mesh):
    tris = {
        "icosphere": procgen.make_icosphere(2),
        "cornell": procgen.make_cornell_box(),
        "cube": procgen.make_cube(),
    }[mesh]
    w, h = 96, 64
    rgb_bvh, t_bvh, tri_bvh = render_ldr(*_records(tris), CAM_POS, CAM_QUAT, w, h)
    rgb_bf, t_bf, tri_bf = render_ldr_brute(tris, CAM_POS, CAM_QUAT, w, h)
    t_bvh, t_bf = np.asarray(t_bvh), np.asarray(t_bf)
    tri_bvh, tri_bf = np.asarray(tri_bvh), np.asarray(tri_bf)
    # hit distances must agree exactly; triangle ids may differ only where two
    # triangles are hit at the *identical* t (rays on shared quad diagonals)
    np.testing.assert_array_equal(t_bvh, t_bf)
    mismatch = tri_bvh != tri_bf
    assert np.all(t_bvh[mismatch] < 1e30)
    assert mismatch.mean() < 0.005


def test_bvh_equals_brute_force_promoted_tree():
    tris = procgen.make_icosphere(2)
    w, h = 64, 48
    _, _, tri_a = render_ldr(*_records(tris, promote_lbvh2_to_bvh4_wide), CAM_POS, CAM_QUAT, w, h)
    _, _, tri_b = render_ldr_brute(tris, CAM_POS, CAM_QUAT, w, h)
    np.testing.assert_array_equal(np.asarray(tri_a), np.asarray(tri_b))


def test_trace_frames_equals_per_frame_trace():
    """F cameras in one trace call give each camera's own frame, bit for
    bit — including the pad rays of a size that is no multiple of the tile."""
    nodes, trec = _records(procgen.make_icosphere(2))
    w, h = 72, 40
    poss = np.stack([CAM_POS + np.array([0.2 * i - 0.2, 0.1 * i, 0.0],
                                        np.float32) for i in range(3)])
    quats = np.tile(CAM_QUAT, (3, 1))
    batch = [np.asarray(a) for a in trace_frames(nodes, trec, poss, quats, w, h)]
    assert all(a.shape == (3, h, w) for a in batch)
    for i in range(3):
        one = trace_frame(nodes, trec, poss[i], quats[i], w, h)
        for a, b in zip(batch, one):
            np.testing.assert_array_equal(a[i], np.asarray(b))
    assert len({int((b >= 0).sum()) for b in batch[4]}) > 1   # distinct views


def test_xla_matches_numpy_oracle():
    tris = procgen.make_icosphere(2)
    w, h = 64, 48
    img, t, tri = render_frame_u8(*_records(tris), CAM_POS, CAM_QUAT, w, h), None, None
    want, t_np, tri_np = cpu_tracer.render_oracle(tris, CAM_POS, CAM_QUAT, w, h)
    img = np.asarray(img)
    # float math may differ by 1 ulp at silhouette pixels → allow tiny u8 diff
    diff = np.abs(img.astype(int) - want.astype(int))
    assert (diff <= 1).mean() > 0.999
    assert np.median(diff) == 0


def test_hit_rate_and_depth_sane():
    tris = procgen.make_icosphere(2)
    w, h = 64, 64
    _, t, tri = render_ldr(*_records(tris), CAM_POS, CAM_QUAT, w, h)
    tri = np.asarray(tri)
    t = np.asarray(t)
    hit = tri >= 0
    assert 0.1 < hit.mean() < 0.9  # unit sphere at distance 3.5, fov 70
    assert np.all(t[hit] > 2.0) and np.all(t[hit] < 5.0)


def test_rotated_camera():
    tris = procgen.make_cornell_box()
    # 180° yaw: camera at -z looking +z
    quat = np.array([0.0, 1.0, 0.0, 0.0], np.float32)
    pos = np.array([0.0, 0.0, -3.0], np.float32)
    w, h = 48, 48
    _, _, tri_bvh = render_ldr(*_records(tris), pos, quat, w, h)
    _, _, tri_bf = render_ldr_brute(tris, pos, quat, w, h)
    np.testing.assert_array_equal(np.asarray(tri_bvh), np.asarray(tri_bf))
    assert (np.asarray(tri_bvh) >= 0).any()


def test_scalar_traversal_and_stats():
    tris = procgen.make_icosphere(1)
    bvh4 = collapse_lbvh2_to_bvh4(build_lbvh2(tris))
    n4 = int(bvh4.num_nodes)
    b4 = np.asarray(bvh4.bounds_u32)[:n4]
    c4 = np.asarray(bvh4.children)[:n4]
    m4 = np.asarray(bvh4.meta)[:n4]

    # slightly off-axis ray to avoid the shared-vertex 4-way tie at the pole
    o = np.array([0.013, 0.027, 3.5], np.float32)
    d = np.array([0.004, -0.009, -1.0], np.float32)
    d /= np.linalg.norm(d)
    t, tri, stats = cpu_tracer.traverse_bvh4_scalar(b4, c4, m4, tris, o, d)
    t_bf, tri_bf = cpu_tracer.brute_force_trace(tris, o[None], d[None])
    assert tri == tri_bf[0]
    np.testing.assert_allclose(t, t_bf[0], rtol=1e-6)
    assert 0 < stats["visits"] < n4  # near-first ordering prunes
    assert stats["tri_tests"] < len(tris)


def test_miss_background_and_present():
    tris = procgen.make_cube(0.5)
    w, h = 32, 32
    img = np.asarray(render_frame_u8(*_records(tris), CAM_POS, CAM_QUAT, w, h))
    # corners miss → miss color 0.01 → round(0.01*255)=3
    assert tuple(img[0, 0]) == (3, 3, 3, 255)
    shown = np.asarray(present_frame(img))
    # present of miss: 3/255≈0.011765 → reinhard → gamma → ~0.133 → 34
    assert tuple(shown[0, 0][:3]) == (34, 34, 34)
    assert shown[0, 0, 3] == 255


def test_quantize_matches_wgsl_rounding():
    vals = np.array([[0.0, 0.001, 0.0019], [0.002, 0.5, 1.0]], np.float32)
    q = np.asarray(quantize_rgba8(vals.reshape(2, 1, 3)))
    # round(0.001*255)=0 (0.255→0)? np.round(0.255)=0.0 — banker's? 0.255 rounds to 0
    assert q[0, 0, 0] == 0
    assert q[1, 0, 1] == 128  # 0.5*255=127.5 → round-half-even → 128? np.round→128
    assert q[1, 0, 2] == 255


def test_raybuf_kernel_matches_brute_on_scattered_rays(rng):
    """The trace entry on arbitrary per-ray origins and directions (bounce /
    shadow waves) vs brute force."""
    import jax

    tris = procgen.make_icosphere(2)
    nodes, trec = _records(tris)
    o = rng.uniform(-2, 2, (2048, 3)).astype(np.float32)
    d = rng.normal(size=(2048, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t, nx, ny, nz, tri = trace(nodes, trec, o, d)
    t_bf, tri_bf = trace_rays_brute(jax.numpy.asarray(tris), o, d)
    t, tri, t_bf, tri_bf = map(np.asarray, (t, tri, t_bf, tri_bf))
    np.testing.assert_array_equal(tri >= 0, tri_bf >= 0)
    hit = tri >= 0
    np.testing.assert_allclose(t[hit], t_bf[hit], rtol=1e-5)
