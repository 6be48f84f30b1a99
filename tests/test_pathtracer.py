"""PathTracer orchestrator + FPSCamera tests (the XLA reference on CPU)."""

import math

import numpy as np

from raytracer import FPSCamera, PathTracer, Scene
from raytracer.io import artifacts
from raytracer.reference import cpu_tracer
from raytracer.utils import procgen


def test_default_mesh_render():
    pt = PathTracer(width=64, height=48)
    pt.initialize()
    img = np.asarray(pt.render())
    assert img.shape == (48, 64, 4) and img.dtype == np.uint8
    # default tetrahedron at default camera: something visible
    assert (img[..., :3] > 3).any()
    # matches the oracle exactly (brute-force path, 4 tris)
    want, _, _ = cpu_tracer.render_oracle(
        pt.triangles_data, pt.camera_position, pt.camera_quaternion, 64, 48
    )
    diff = np.abs(img.astype(int) - want.astype(int))
    assert (diff <= 1).mean() > 0.999


def test_set_scene_and_artifacts(tmp_path):
    tris = procgen.make_icosphere(2)
    p = tmp_path / "s.glb"
    procgen.write_glb(p, tris)
    scene = Scene().load_glb(p, normalize=True, mode="cube")

    pt = PathTracer(width=64, height=64)
    pt.set_scene(scene)
    assert pt.build_stats["num_triangles"] == len(tris)
    assert pt.build_stats["num_nodes2"] == 2 * len(tris) - 1

    buf2 = pt.bvh2_artifact()
    assert buf2[0] == 2 * len(tris) - 1
    buf4 = pt.bvh4_artifact()
    b4, c4, m4 = artifacts.bvh4_from_u32(buf4)
    assert len(m4) == int(buf4[0]) > 0

    img = np.asarray(pt.render())
    assert (np.asarray(img[..., :3]) > 3).any()

    pt.dump_bvh_json(tmp_path / "bvh.json")
    import json

    d = json.loads((tmp_path / "bvh.json").read_text())
    assert d["numNodes"] == int(buf2[0])
    assert d["nodes"][0]["children"][0] > 0


def test_render_presented_differs():
    pt = PathTracer(width=32, height=32)
    pt.initialize()
    ldr = np.asarray(pt.render())
    shown = np.asarray(pt.render_presented())
    assert shown.shape == ldr.shape
    assert not np.array_equal(shown, ldr)  # tonemap changes values


def test_empty_scene():
    pt = PathTracer(width=16, height=16)
    pt.build_bvh(np.zeros((0, 3, 3), np.float32))
    assert pt.bvh2_artifact().tolist() == [0]


# -- FPSCamera semantics -------------------------------------------------------


def test_camera_defaults_and_quat():
    cam = FPSCamera()
    np.testing.assert_allclose(cam.position, [0, 1.6, 5])
    cam.update(0.016)
    np.testing.assert_allclose(cam.rotation, [0, 0, 0, 1], atol=1e-12)


def test_camera_mouse_yaw():
    cam = FPSCamera()
    # mouse right by 100px: yaw -= 100*0.002 = -0.2 rad around Y
    cam.move_mouse(100.0, 0.0)
    cam.update(0.016)
    q = cam.rotation
    assert abs(q[1] - math.sin(-0.1)) < 1e-9 and abs(q[3] - math.cos(0.1)) < 1e-9


def test_camera_pitch_clamp():
    cam = FPSCamera()
    cam.move_mouse(0.0, -1e9)
    cam.update(0.016)
    # pitch clamped to pi/2 - 1e-4
    q = cam.rotation
    assert abs(q[0] - math.sin((math.pi / 2 - 1e-4) / 2)) < 1e-9


def test_camera_walk_forward_and_sprint():
    cam = FPSCamera(position=(0, 0, 0))
    cam.press("KeyW")
    cam.update(1.0)
    np.testing.assert_allclose(cam.position, [0, 0, -4.0], atol=1e-12)
    cam.press("ShiftLeft")
    cam.update(1.0)
    np.testing.assert_allclose(cam.position, [0, 0, -14.0], atol=1e-9)


def test_camera_ground_mode_projects_xz():
    cam = FPSCamera(position=(0, 0, 0), fly=False)
    cam.move_mouse(0.0, 1e9)  # pitch up to clamp
    cam.press("KeyW")
    cam.update(1.0)
    # ground mode: W moves along XZ only
    assert abs(cam.position[1]) < 1e-9
    assert abs(np.linalg.norm(cam.position) - 4.0) < 1e-6


def test_camera_fly_mode_moves_vertically():
    cam = FPSCamera(position=(0, 0, 0), fly=True)
    cam.move_mouse(0.0, -1e9)  # mouse up → pitch up to clamp
    cam.press("KeyW")
    cam.update(1.0)
    assert cam.position[1] > 3.9  # moved nearly straight up


def test_camera_diagonal_normalized():
    cam = FPSCamera(position=(0, 0, 0))
    cam.press("KeyW")
    cam.press("KeyD")
    cam.update(1.0)
    assert abs(np.linalg.norm(cam.position) - 4.0) < 1e-6


def test_widener_variants_render_identically():
    import numpy as np
    from raytracer.utils import procgen

    tris = procgen.make_icosphere(2)
    imgs = []
    for widener in ("collapse", "promote", "bvh2"):
        pt = PathTracer(width=48, height=48, widener=widener)
        pt.set_scene(Scene().set_triangles(tris))
        imgs.append(np.asarray(pt.render()))
    np.testing.assert_array_equal(imgs[0], imgs[1])
    np.testing.assert_array_equal(imgs[0], imgs[2])


def test_ploc_builder_renders_identically_to_brute():
    import numpy as np
    from raytracer.utils import procgen
    from raytracer.reference import cpu_tracer

    tris = procgen.make_icosphere(2)
    pt = PathTracer(width=48, height=48, builder="ploc")
    pt.set_scene(Scene().set_triangles(tris))
    img = np.asarray(pt.render())
    want, _, _ = cpu_tracer.render_oracle(
        tris, pt.camera_position, pt.camera_quaternion, 48, 48
    )
    diff = np.abs(img.astype(int) - want.astype(int))
    assert (diff <= 1).mean() > 0.999


def test_fast_build_options_cpu():
    """On the CPU test backend the fast configuration is the
    reference-parity single-triangle LBVH (the K sweep that picks the
    GPU's cluster size is measured on the card)."""
    from raytracer.pathtracer import fast_build_options

    builder, leaf = fast_build_options()
    assert (builder, leaf) == ("lbvh", 1)


def test_from_config_and_phase_timer():
    """RenderConfig drives construction (SURVEY.md §5.6) and build timing is
    produced by utils.profiling.PhaseTimer (§5.1) — both wired, not padded."""
    from raytracer.utils.config import CameraConfig, RenderConfig

    cfg = RenderConfig(width=32, height=16, fov_degrees=60.0,
                       camera=CameraConfig(position=(0.0, 0.0, 2.0)))
    pt = PathTracer.from_config(cfg)
    assert (pt.width, pt.height) == (32, 16)
    assert pt.fov_degrees == 60.0
    assert pt.config is cfg

    pt.build_bvh(procgen.make_icosphere(1))
    # PhaseTimer-sourced build stats (reference report PathTracer.js:745-748)
    for key in ("lbvh2_ms", "collapse_ms", "widen_ms", "total_ms"):
        assert key in pt.build_stats and pt.build_stats[key] >= 0.0
    img = np.asarray(pt.render())
    assert img.shape == (16, 32, 4)
