"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""

import jax
import numpy as np
import pytest

from raytracer.ops.collapse import collapse_lbvh2_to_bvh4
from raytracer.ops.lbvh import build_lbvh2
from raytracer.ops.trace import make_wide_bvh, pack_bvh
from raytracer.parallel.mesh import (
    make_mesh,
    render_cameras_sharded,
    render_spp_sharded,
    render_tiles_sharded,
)
from raytracer.render import render_ldr, trace_frame
from raytracer.utils import procgen

CAM_POS = np.array([0.0, 0.0, 3.5], np.float32)
CAM_QUAT = np.array([0.0, 0.0, 0.0, 1.0], np.float32)


@pytest.fixture(scope="module")
def scene():
    tris = jax.numpy.asarray(procgen.make_icosphere(2))
    return pack_bvh(make_wide_bvh(collapse_lbvh2_to_bvh4(build_lbvh2(tris))),
                    tris)


def test_eight_devices_available():
    assert jax.device_count() >= 8


def test_tiles_sharded_equals_single(scene):
    nodes, tris = scene
    mesh = make_mesh(8)
    w, h = 64, 64
    rgb_s, t_s, tri_s = render_tiles_sharded(nodes, tris, CAM_POS, CAM_QUAT, w, h, mesh)
    rgb_1, t_1, tri_1 = render_ldr(nodes, tris, CAM_POS, CAM_QUAT, w, h)
    np.testing.assert_array_equal(np.asarray(tri_s), np.asarray(tri_1))
    np.testing.assert_allclose(np.asarray(rgb_s), np.asarray(rgb_1), rtol=1e-6)


def test_tiles_sharded_output_is_sharded(scene):
    nodes, tris = scene
    mesh = make_mesh(8)
    rgb, _, _ = render_tiles_sharded(nodes, tris, CAM_POS, CAM_QUAT, 64, 64, mesh)
    shard_rows = {s.index[0].start or 0 for s in rgb.addressable_shards}
    assert len(shard_rows) == 8  # each device holds a distinct row band


def test_spp_sharded_accumulates(scene):
    nodes, tris = scene
    mesh = make_mesh(8)
    seeds = np.arange(8, dtype=np.uint32)
    rgb = render_spp_sharded(nodes, tris, CAM_POS, CAM_QUAT, seeds, 64, 64, mesh)
    rgb = np.asarray(rgb)
    assert rgb.shape == (64, 64, 3)
    assert np.isfinite(rgb).all()
    # jittered multi-sample mean should soften but roughly match single frame
    rgb_1, _, _ = render_ldr(nodes, tris, CAM_POS, CAM_QUAT, 64, 64)
    assert abs(rgb.mean() - np.asarray(rgb_1).mean()) < 0.05


def test_cameras_sharded(scene):
    nodes, tris = scene
    mesh = make_mesh(8)
    c = 8
    pos = np.tile(CAM_POS, (c, 1)).astype(np.float32)
    pos[:, 0] = np.linspace(-0.5, 0.5, c)
    quat = np.tile(CAM_QUAT, (c, 1)).astype(np.float32)
    out = render_cameras_sharded(nodes, tris, pos, quat, 32, 32, mesh)
    out = np.asarray(out)
    assert out.shape == (8, 32, 32, 3)
    # different cameras → different images
    assert not np.array_equal(out[0], out[-1])


@pytest.mark.full
def test_tiles_sharded_pallas_equals_single(scene):
    """Sharded row bands assemble into exactly the single-device frame
    traced through the same entry (t and ids bit-identical)."""
    nodes, tris = scene
    mesh = make_mesh(8)
    w, h = 128, 128
    rgb_s, t_s, tri_s = render_tiles_sharded(nodes, tris, CAM_POS, CAM_QUAT,
                                             w, h, mesh)
    t1, nx, ny, nz, tri1 = trace_frame(nodes, tris, CAM_POS, CAM_QUAT, w, h)
    np.testing.assert_array_equal(np.asarray(tri_s), np.asarray(tri1))
    np.testing.assert_array_equal(np.asarray(t_s), np.asarray(t1))


@pytest.mark.full
def test_spp_sharded_equals_progressive_mean(scene):
    """n devices accumulate exactly n frames of the single-device
    progressive stream — the estimators are unified."""
    import jax.numpy as jnp

    from raytracer.ops.shade import shade_lambert

    nodes, tris = scene
    mesh = make_mesh(8)
    seeds = jnp.arange(8, dtype=jnp.int32)
    rgb_spp = render_spp_sharded(nodes, tris, CAM_POS, CAM_QUAT, seeds, 64, 64,
                                 mesh)
    acc = 0
    for s in range(8):
        _, nx, ny, nz, tri = trace_frame(nodes, tris, CAM_POS, CAM_QUAT, 64, 64,
                                         jitter=True, jitter_seed=s)
        acc = acc + shade_lambert(jnp.stack([nx, ny, nz], -1), tri >= 0)
    assert np.allclose(np.asarray(rgb_spp), np.asarray(acc / 8), atol=1e-5)


def test_pt_spp_sharded(scene):
    """Path-traced (NEE + bounce) samples sharded across devices."""
    import jax.numpy as jnp

    from raytracer.parallel.mesh import render_pt_spp_sharded

    nodes, tris = scene
    mesh = make_mesh(8)
    seeds = jnp.arange(8, dtype=jnp.int32)
    out = render_pt_spp_sharded(nodes, tris, CAM_POS, CAM_QUAT, seeds, 32, 32,
                                mesh, bounces=1)
    out = np.asarray(out)
    assert out.shape == (32, 32, 3)
    assert np.isfinite(out).all() and out.max() > 0


def test_sharded_outputs_span_every_device(scene):
    """No sharded path leaves its work on one device: the camera batch and
    the row bands come back with one distinct shard per mesh device."""
    nodes, tris = scene
    mesh = make_mesh(4)
    pos = np.tile(CAM_POS, (8, 1)).astype(np.float32)
    quat = np.tile(CAM_QUAT, (8, 1)).astype(np.float32)
    cams = render_cameras_sharded(nodes, tris, pos, quat, 16, 16, mesh)
    rgb, _, _ = render_tiles_sharded(nodes, tris, CAM_POS, CAM_QUAT, 16, 16,
                                     mesh)
    for out in (cams, rgb):
        devs = {s.device for s in out.addressable_shards}
        assert devs == set(mesh.devices.flat)


@pytest.mark.full
def test_cameras_sharded_pallas_equals_xla(scene):
    """Config-5 layout: each device's camera batch traced in one call equals
    a per-camera single-device render."""
    nodes, tris = scene
    mesh = make_mesh(4)
    c = 4
    pos = np.tile(CAM_POS, (c, 1)).astype(np.float32)
    pos[:, 0] = np.linspace(-0.5, 0.5, c)
    quat = np.tile(CAM_QUAT, (c, 1)).astype(np.float32)
    out = render_cameras_sharded(nodes, tris, pos, quat, 64, 64, mesh)
    single = [np.asarray(render_ldr(nodes, tris, pos[i], quat[i], 64, 64)[0])
              for i in range(c)]
    np.testing.assert_allclose(np.asarray(out), np.stack(single), atol=1e-6)


@pytest.mark.full
def test_pt_spp_sharded_pallas_equals_mean(scene):
    """Multi-device PT == the mean of the single-device PT samples traced
    through the same entry."""
    import jax.numpy as jnp

    from raytracer.parallel.mesh import render_pt_spp_sharded
    from raytracer.render_pt import pt_sample_frame

    nodes, tris = scene
    mesh = make_mesh(4)
    seeds = jnp.arange(4, dtype=jnp.int32)
    out = render_pt_spp_sharded(nodes, tris, CAM_POS, CAM_QUAT, seeds, 32, 32,
                                mesh, bounces=1)
    ref = np.mean(
        [
            np.asarray(
                pt_sample_frame(
                    nodes, tris, CAM_POS, CAM_QUAT, jax.random.key(s), 32, 32,
                    bounces=1,
                )
            )
            for s in range(4)
        ],
        axis=0,
    )
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-6)


def test_make_mesh_rejects_overprovision():
    with pytest.raises(ValueError):
        make_mesh(jax.device_count() + 1)
