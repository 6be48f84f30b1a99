"""Robustness + determinism: degenerate inputs, bit-reproducible builds,
checkpoint resume (SURVEY.md §5.2-5.4 equivalents)."""

import numpy as np

from raytracer import PathTracer, Scene
from raytracer.ops.collapse import collapse_lbvh2_to_bvh4
from raytracer.ops.lbvh import build_lbvh2
from raytracer.ops.trace import make_wide_bvh, pack_bvh
from raytracer.render import render_ldr
from raytracer.utils import procgen

CAM_POS = np.array([0.0, 0.0, 3.5], np.float32)
CAM_QUAT = np.array([0.0, 0.0, 0.0, 1.0], np.float32)


def test_build_is_deterministic():
    """Replaces the reference's atomic build nondeterminism with bit
    reproducibility: two builds of the same input are byte-identical."""
    tris = procgen.make_icosphere(3)
    a = build_lbvh2(tris)
    b = build_lbvh2(tris)
    np.testing.assert_array_equal(np.asarray(a.bounds_u32), np.asarray(b.bounds_u32))
    np.testing.assert_array_equal(np.asarray(a.left), np.asarray(b.left))
    ca = collapse_lbvh2_to_bvh4(a)
    cb = collapse_lbvh2_to_bvh4(b)
    np.testing.assert_array_equal(np.asarray(ca.bounds_u32), np.asarray(cb.bounds_u32))


def test_degenerate_triangles_dont_crash_or_hit():
    """Zero-area triangles (|det| < eps) are rejected by the MT guard
    (renderer.wgsl:188 semantics) and never produce hits."""
    good = procgen.make_quad(2.0, y=-0.5)
    degen = np.zeros((3, 3, 3), np.float32)  # three point-triangles at origin
    degen[1] = [[1, 1, 1]] * 3
    degen[2, :, 0] = [0.0, 1.0, 2.0]  # collinear
    tris = np.concatenate([good, degen]).astype(np.float32)

    rec = pack_bvh(make_wide_bvh(collapse_lbvh2_to_bvh4(build_lbvh2(tris))), tris)
    rgb, t, tri = render_ldr(*rec, CAM_POS, CAM_QUAT, 32, 32)
    tri = np.asarray(tri)
    assert set(np.unique(tri)).issubset({-1, 0, 1})  # only the quad's 2 tris
    assert np.isfinite(np.asarray(rgb)).all()


def test_duplicate_triangles_all_indexed():
    tri = procgen.make_quad(1.0)[0:1]
    tris = np.repeat(tri, 9, axis=0)
    bvh = build_lbvh2(tris)
    meta = np.asarray(bvh.meta)
    leaf_tris = np.sort(meta[bvh.num_internal:] & 0x7FFFFFFF)
    np.testing.assert_array_equal(leaf_tris, np.arange(9))


def test_checkpoint_roundtrip(tmp_path):
    pt = PathTracer(width=32, height=32)
    pt.set_scene(Scene().set_triangles(procgen.make_icosphere(2)))
    img_before = np.asarray(pt.render())
    buf_before = pt.bvh2_artifact()

    ckpt = tmp_path / "scene.npz"
    pt.save_checkpoint(ckpt)

    pt2 = PathTracer(width=32, height=32)
    pt2.load_checkpoint(ckpt)
    np.testing.assert_array_equal(pt2.bvh2_artifact(), buf_before)
    np.testing.assert_array_equal(np.asarray(pt2.render()), img_before)


def test_refit_after_checkpoint_load_rebuilds_plan(tmp_path):
    """A CollapsePlan belongs to one topology. Loading a checkpoint of a
    DIFFERENT scene with the same triangle count must not reuse the previous
    scene's plan in refit_bvh (it would pass the same-count fallback guard
    and silently corrupt the BVH4 — ADVICE r4)."""
    from raytracer.ops.collapse import collapse_lbvh2_to_bvh4

    tris_a = procgen.make_icosphere(2)
    rng = np.random.default_rng(7)
    tris_b = (tris_a[rng.permutation(len(tris_a))]
              + rng.normal(0, 0.3, tris_a.shape)).astype(np.float32)

    pt = PathTracer(width=32, height=32)
    pt.set_scene(Scene().set_triangles(tris_a))
    pt.refit_bvh(tris_a * np.float32(1.05))   # materializes plan for scene A

    ckpt = tmp_path / "b.npz"
    pt_b = PathTracer(width=32, height=32)
    pt_b.set_scene(Scene().set_triangles(tris_b))
    pt_b.save_checkpoint(ckpt)

    pt.load_checkpoint(ckpt)                  # same tri count, new topology
    assert pt._collapse_plan is None and pt._bvh2_height is None
    pt.refit_bvh(pt.triangles_data)           # must derive scene B's plan
    full = collapse_lbvh2_to_bvh4(pt._bvh2)
    np.testing.assert_array_equal(np.asarray(pt._bvh4.children),
                                  np.asarray(full.children))
    np.testing.assert_array_equal(np.asarray(pt._bvh4.bounds_u32),
                                  np.asarray(full.bounds_u32))


def test_huge_coordinates_survive_fp16_packing():
    """Coordinates beyond fp16 range saturate to ±inf bounds but traversal
    still terminates and in-range geometry renders."""
    tris = np.concatenate(
        [procgen.make_quad(2.0, y=-0.5), procgen.make_quad(2.0, y=-1e8)]
    ).astype(np.float32)
    rec = pack_bvh(make_wide_bvh(collapse_lbvh2_to_bvh4(build_lbvh2(tris))), tris)
    rgb, t, tri = render_ldr(*rec, CAM_POS, CAM_QUAT, 16, 16)
    assert np.isfinite(np.asarray(rgb)).all()
