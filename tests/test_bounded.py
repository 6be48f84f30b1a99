"""Depth-bounded traversal (render.py::trace_tiles_bounded) — exactness.

The bounded pipeline (coarse depth probe → bounded main pass → repair of
no-hit-under-finite-bound lanes) must produce the SAME image as the
unbounded trace, by construction: a hit found under bound B is the true
nearest, and every possibly-wrong ray is re-traced unbounded. These tests
check that claim end-to-end through ops.trace.trace, including a run where
the bounds are deliberately sabotaged so the repair pass has to do the
work — the analog of the reference's oracle-vs-kernel discipline
(/root/reference/tests/test.py:149-230).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from raytracer.models.scene import Scene
from raytracer.ops.cluster import (build_lbvh2_clustered, build_sah2_clustered,
                                   records_pipeline)
from raytracer.ops.collapse import collapse_lbvh2_to_bvh4
from raytracer.ops.lbvh import build_lbvh2
from raytracer.ops.trace import make_wide_bvh, pack_bvh
from raytracer.render import trace_frame, trace_tiles_bounded
from raytracer.utils import procgen

CAM_POS = np.array([0.0, 0.0, 2.5], np.float32)
CAM_QUAT = np.array([0.0, 0.0, 0.0, 1.0], np.float32)


def _scene_records(leaf_k=1, sah=False):
    tris_np = procgen.make_icosphere(2)
    sc = Scene().set_triangles(tris_np)
    sc._normalize_enabled, sc._normalize_mode = True, "cube"
    sc.normalize_mesh()
    tris = jnp.asarray(sc.triangles)
    if leaf_k > 1:
        if sah:
            cs, h = build_sah2_clustered(tris, leaf_size=leaf_k)
            return tris, records_pipeline(cs, height=h)
        return tris, records_pipeline(
            build_lbvh2_clustered(tris, leaf_size=leaf_k))
    wide = make_wide_bvh(collapse_lbvh2_to_bvh4(build_lbvh2(tris)))
    return tris, pack_bvh(wide, tris)


def _assert_same_image(ref, got):
    rt, rtri = np.asarray(ref[0]), np.asarray(ref[4])
    bt, btri = np.asarray(got[0]), np.asarray(got[1])
    assert (rtri == btri).all(), f"{(rtri != btri).sum()} tri mismatches"
    hit = rtri >= 0
    assert np.allclose(rt[hit], bt[hit], rtol=1e-6, atol=1e-6)
    assert np.all(bt[~hit] >= 1e29), "miss lanes must report t=INF"


@pytest.mark.full
def test_bounded_equals_unbounded():
    tris, qn = _scene_records()
    w, h = 96, 64
    ref = trace_frame(*qn, CAM_POS, CAM_QUAT, w, h)
    t, nx, ny, nz, tri, nrep = trace_tiles_bounded(
        *qn, CAM_POS, CAM_QUAT, w, h, repair_cap=1024
    )
    _assert_same_image(ref, (t, tri))


@pytest.mark.full
def test_bounded_repair_fixes_sabotaged_bounds():
    """Half-scale bounds guarantee underestimates on every interior tile;
    the repair pass must restore the exact image and must actually fire.

    Finite bounds only exist on tiles whose full 3x3 tile neighborhood hit
    at coarse resolution, so the frame must be big enough to have interior
    tiles (5x5 grid) and the camera close enough that every ray hits."""
    tris, qn = _scene_records()
    w, h = 160, 160
    pos = np.array([0.0, 0.0, 1.2], np.float32)  # sphere fills the frame
    ref = trace_frame(*qn, pos, CAM_QUAT, w, h)
    assert (np.asarray(ref[4]) >= 0).all(), "setup: every ray must hit"
    t, nx, ny, nz, tri, nrep = trace_tiles_bounded(
        *qn, pos, CAM_QUAT, w, h, repair_cap=w * h,
        _bound_scale=0.5, _bound_pad=0.0,
    )
    assert int(nrep) > 0, "sabotaged bounds should force repairs"
    assert int(nrep) <= w * h
    _assert_same_image(ref, (t, tri))


@pytest.mark.full
def test_bounded_repair_loops_past_cap():
    """More repairs needed than repair_cap: the batched repair loop must
    still restore the exact image (ADVICE r2: a single truncated batch
    left silent hole pixels)."""
    tris, qn = _scene_records()
    w, h = 160, 160
    pos = np.array([0.0, 0.0, 1.2], np.float32)
    ref = trace_frame(*qn, pos, CAM_QUAT, w, h)
    t, nx, ny, nz, tri, nrep = trace_tiles_bounded(
        *qn, pos, CAM_QUAT, w, h, repair_cap=64,
        _bound_scale=0.5, _bound_pad=0.0,
    )
    assert int(nrep) > 64, "setup: must exceed one repair batch"
    _assert_same_image(ref, (t, tri))


@pytest.mark.parametrize("k", [8])
@pytest.mark.full
def test_bounded_packed_leaves(k):
    tris, qn = _scene_records(leaf_k=k)
    w, h = 96, 64
    ref = trace_frame(*qn, CAM_POS, CAM_QUAT, w, h)
    t, nx, ny, nz, tri, nrep = trace_tiles_bounded(
        *qn, CAM_POS, CAM_QUAT, w, h, repair_cap=1024,
    )
    _assert_same_image(ref, (t, tri))


_has_sah_clustered = False
try:
    from raytracer.native import bvhtool as _bvhtool

    _has_sah_clustered = _bvhtool.available() and getattr(
        _bvhtool._lib, "bvh_build_sah_clustered", None
    ) is not None
except Exception:
    pass


@pytest.mark.skipif(not _has_sah_clustered,
                    reason="libbvhtool.so with bvh_build_sah_clustered not built")
@pytest.mark.full
def test_sah_clustered_pipeline_parity():
    """SAH-snapped clusters (native builder) through the trace entry match
    the brute-force oracle exactly — same contract as the Morton clusters."""
    from raytracer.render import render_ldr_brute

    tris_np = procgen.make_icosphere(2)[:315]  # force a partial tail cluster
    sc = Scene().set_triangles(tris_np)
    sc._normalize_enabled, sc._normalize_mode = True, "cube"
    sc.normalize_mesh()
    tris = jnp.asarray(sc.triangles)
    k = 8
    cs, height = build_sah2_clustered(tris, leaf_size=k)
    # contract: cluster c owns sorted tris [cK, min((c+1)K, N)); permutation
    n = int(tris.shape[0])
    assert sorted(np.asarray(cs.tri_order).tolist()) == list(range(n))
    meta = np.asarray(cs.bvh2.meta)
    leaf = (meta >> 31) != 0
    assert sorted((meta[leaf] & 0x7FFFFFFF).tolist()) == list(range(-(-n // k)))

    qn = records_pipeline(cs, height=height)
    w, h = 96, 64
    t, nx, ny, nz, tri = trace_frame(*qn, CAM_POS, CAM_QUAT, w, h)
    _, rt, rtri = render_ldr_brute(tris, CAM_POS, CAM_QUAT, w, h)
    t, tri, rt, rtri = map(np.asarray, (t, tri, rt, rtri))
    assert (tri == rtri).all()
    hit = rtri >= 0
    assert np.allclose(t[hit], rt[hit], rtol=1e-5, atol=1e-6)


@pytest.mark.skipif(not _has_sah_clustered,
                    reason="libbvhtool.so with bvh_build_sah_clustered not built")
@pytest.mark.full
def test_sah_clustered_k32_parity():
    """The SHIPPED production configuration — SAH clusters at K=32
    of earlier builds — pinned on the CPU through the reference."""
    from raytracer.render import render_ldr_brute

    tris_np = procgen.make_icosphere(2)[:500]  # partial tail cluster at K=32
    sc = Scene().set_triangles(tris_np)
    sc._normalize_enabled, sc._normalize_mode = True, "cube"
    sc.normalize_mesh()
    tris = jnp.asarray(sc.triangles)
    k = 32
    cs, height = build_sah2_clustered(tris, leaf_size=k)
    qn = records_pipeline(cs, height=height)
    w, h = 64, 64
    t, nx, ny, nz, tri = trace_frame(*qn, CAM_POS, CAM_QUAT, w, h)
    _, rt, rtri = render_ldr_brute(tris, CAM_POS, CAM_QUAT, w, h)
    t, tri, rt, rtri = map(np.asarray, (t, tri, rt, rtri))
    assert (tri == rtri).all()
    hit = rtri >= 0
    assert np.allclose(t[hit], rt[hit], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sah", [False, True])
def test_clustered_refit_deform_parity(sah):
    """Deform the geometry, refit the packed-cluster tree (topology + cluster
    assignment kept, bounds recomputed), and re-trace: the image must match
    the brute-force oracle on the deformed triangles exactly (verdict r2 #3
    — the dynamic-scene path for clustered trees)."""
    from raytracer.ops.cluster import refit_lbvh2_clustered
    from raytracer.render import render_ldr_brute

    if sah and not _has_sah_clustered:
        pytest.skip("libbvhtool.so with bvh_build_sah_clustered not built")

    tris_np = procgen.make_icosphere(2)
    sc = Scene().set_triangles(tris_np)
    sc._normalize_enabled, sc._normalize_mode = True, "cube"
    sc.normalize_mesh()
    tris = jnp.asarray(sc.triangles)
    k = 8
    if sah:
        cs, height = build_sah2_clustered(tris, leaf_size=k)
        sweeps = height + 2
    else:
        cs = build_lbvh2_clustered(tris, leaf_size=k)
        sweeps = None

    # smooth displacement along the normal direction — a real deformation,
    # not a rigid move, so stale bounds would definitely miss
    t = np.asarray(tris)
    deformed = t + 0.15 * np.sin(3.0 * t[..., :1]) * np.cos(2.0 * t[..., 1:2])
    deformed = jnp.asarray(deformed.astype(np.float32))

    cs2 = refit_lbvh2_clustered(cs, deformed, num_sweeps=sweeps)
    # cluster contract intact: same order, same topology
    np.testing.assert_array_equal(np.asarray(cs2.tri_order),
                                  np.asarray(cs.tri_order))
    np.testing.assert_array_equal(np.asarray(cs2.bvh2.meta),
                                  np.asarray(cs.bvh2.meta))

    bvh4 = (collapse_lbvh2_to_bvh4(cs2.bvh2, sweeps=sweeps) if sah
            else collapse_lbvh2_to_bvh4(cs2.bvh2))
    qn = pack_bvh(make_wide_bvh(bvh4), cs2.tris_sorted,
                  tri_ids=cs2.tri_order, leaf_size=k)
    w, h = 96, 64
    t_, nx, ny, nz, tri = trace_frame(*qn, CAM_POS, CAM_QUAT, w, h)
    _, rt, rtri = render_ldr_brute(deformed, CAM_POS, CAM_QUAT, w, h)
    t_, tri, rt, rtri = map(np.asarray, (t_, tri, rt, rtri))
    assert (tri == rtri).all(), f"{(tri != rtri).sum()} mismatches after refit"
    hit = rtri >= 0
    assert np.allclose(t_[hit], rt[hit], rtol=1e-5, atol=1e-6)


@pytest.mark.full
def test_temporal_bounds_exact_across_samples():
    """trace_tiles_temporal (previous-frame depth bounds + repair) must give
    exactly the plain jittered trace for every successive seed — the
    progressive accumulation is then identical with and without the
    accelerator."""
    from raytracer.render import trace_tiles_temporal

    tris, qn = _scene_records()
    w, h = 96, 64
    prev = trace_frame(*qn, CAM_POS, CAM_QUAT, w, h,
                       jitter=True, jitter_seed=1)
    pt, ptri = prev[0], prev[4]
    for seed in (2, 3):
        ref = trace_frame(*qn, CAM_POS, CAM_QUAT, w, h,
                          jitter=True, jitter_seed=seed)
        t, nx, ny, nz, tri, nrep = trace_tiles_temporal(
            *qn, CAM_POS, CAM_QUAT, w, h, pt, ptri, seed,
            repair_cap=1024,
        )
        rtri = np.asarray(ref[4])
        assert (np.asarray(tri) == rtri).all(), \
            f"seed {seed}: {(np.asarray(tri) != rtri).sum()} mismatches"
        hit = rtri >= 0
        assert np.allclose(np.asarray(t)[hit], np.asarray(ref[0])[hit],
                           rtol=1e-6, atol=1e-6)
        pt, ptri = t, tri
