"""Progressive path tracing tests: light-model consistency, accumulation,
camera-move reset."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer import PathTracer, Scene
from raytracer.ops.collapse import collapse_lbvh2_to_bvh4
from raytracer.ops.lbvh import build_lbvh2
from raytracer.ops.trace import make_wide_bvh, pack_bvh
from raytracer.render_pt import accumulate, pt_sample_frame
from raytracer.utils import procgen

CAM_POS = np.array([0.0, 1.0, 3.0], np.float32)
CAM_QUAT = np.array([0.0, 0.0, 0.0, 1.0], np.float32)


def _records(tris):
    tris = jnp.asarray(tris)
    return pack_bvh(make_wide_bvh(collapse_lbvh2_to_bvh4(build_lbvh2(tris))),
                    tris)


def test_direct_matches_primary_shade_on_open_plane():
    """On an unoccluded plane, the path-traced mean must converge to the
    shipped Lambert shade ρ·(0.15 + n·l) plus bounded GI (here: none —
    nothing else to bounce off, sky accounts for the 0.15)."""
    tris = procgen.make_quad(50.0, y=0.0)
    rec = _records(tris)
    w = h = 24

    acc = jnp.zeros((h, w, 3), jnp.float32)
    n_samples = 48
    for i in range(n_samples):
        s = pt_sample_frame(
            *rec, CAM_POS, CAM_QUAT, jax.random.key(i), w, h, bounces=2,
        )
        acc = accumulate(acc, s, jnp.int32(i))
    acc = np.asarray(acc)

    # pick pixels that hit the plane — with the reference's un-flipped
    # texture-y convention, "down" rays land in the TOP image rows
    hit_px = acc[4, w // 2]
    sun = np.array([1.0, 1.5, 1.0]) / np.linalg.norm([1.0, 1.5, 1.0])
    ndotl = sun[1]  # plane normal (0,1,0)
    want = np.array([0.9, 0.7, 0.3]) * (0.15 + ndotl)
    np.testing.assert_allclose(hit_px, want, rtol=0.08)


@pytest.mark.full
def test_radiance_finite_and_nonnegative():
    tris = procgen.make_cornell_box()
    s = pt_sample_frame(
        *_records(tris), CAM_POS, CAM_QUAT, jax.random.key(0), 16, 16,
        bounces=3,
    )
    s = np.asarray(s)
    assert np.isfinite(s).all() and (s >= 0).all()


@pytest.mark.full
def test_background_pixels_show_miss_color():
    tris = procgen.make_cube(0.3)
    s = pt_sample_frame(
        *_records(tris), np.array([0, 0, 5], np.float32), CAM_QUAT,
        jax.random.key(0), 16, 16, bounces=2,
    )
    s = np.asarray(s)
    np.testing.assert_allclose(s[0, 0], [0.01, 0.01, 0.01], atol=1e-6)


def test_accumulate_running_mean():
    a = jnp.zeros((2, 2, 3))
    s1 = jnp.full((2, 2, 3), 1.0)
    s2 = jnp.full((2, 2, 3), 3.0)
    a = accumulate(a, s1, jnp.int32(0))
    a = accumulate(a, s2, jnp.int32(1))
    np.testing.assert_allclose(np.asarray(a), 2.0)


def test_pathtracer_progressive_reset_on_camera_move():
    pt = PathTracer(width=16, height=16)
    pt.set_scene(Scene().set_triangles(procgen.make_cornell_box()))
    pt.render_progressive(bounces=2)
    pt.render_progressive(bounces=2)
    assert pt.frame_count == 2
    pt.set_camera_position(0.1, 0.0, 3.5)
    pt.render_progressive(bounces=2)
    assert pt.frame_count == 1  # reset happened
    img = np.asarray(pt.present_progressive())
    assert img.shape == (16, 16, 4) and img.dtype == np.uint8


@pytest.mark.full
def test_gi_adds_energy_in_concave_scene():
    """Inside the Cornell box, bounces>1 must add (bounded) energy vs
    direct-only."""
    tris = procgen.make_cornell_box()
    rec = _records(tris)
    pos = np.array([0.0, 0.0, 2.2], np.float32)

    def mean_radiance(bounces, n=8):
        acc = jnp.zeros((12, 12, 3), jnp.float32)
        for i in range(n):
            s = pt_sample_frame(
                *rec, pos, CAM_QUAT, jax.random.key(100 + i), 12, 12,
                bounces=bounces,
            )
            acc = accumulate(acc, s, jnp.int32(i))
        return float(np.asarray(acc).mean())

    direct = mean_radiance(1)
    gi = mean_radiance(3)
    assert gi > direct * 1.01
    assert gi < direct * 3.0  # bounded (albedo < 1)


def test_progressive_aa_mode_bounces0():
    """bounces=0 → jittered-primary AA accumulation."""
    pt = PathTracer(width=16, height=16)
    pt.set_scene(Scene().set_triangles(procgen.make_cornell_box()))
    a1 = np.asarray(pt.render_progressive(bounces=0))
    a2 = np.asarray(pt.render_progressive(bounces=0))
    assert pt.frame_count == 2
    assert a1.shape == (16, 16, 3)
    assert np.isfinite(a2).all() and (a2 >= 0).all()
