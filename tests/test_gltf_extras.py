"""glTF parser extras: node hierarchies, TRS vs matrix, instancing, and a
golden-image regression anchor."""

import json
import struct

import numpy as np

from raytracer.models.scene import Scene
from raytracer.ops.collapse import collapse_lbvh2_to_bvh4
from raytracer.ops.lbvh import build_lbvh2
from raytracer.ops.trace import make_wide_bvh, pack_bvh
from raytracer.render import render_frame_u8
from raytracer.utils import procgen
from raytracer.utils.gltf import extract_triangles, load_gltf


def _gltf_with_nodes(tmp_path, nodes, scene_nodes):
    """Build a .gltf with one triangle mesh instanced by the given nodes."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    buf = verts.tobytes()
    import base64

    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": scene_nodes}],
        "nodes": nodes,
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}, "mode": 4}]}],
        "buffers": [{
            "byteLength": len(buf),
            "uri": "data:application/octet-stream;base64," + base64.b64encode(buf).decode(),
        }],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": len(buf)}],
        "accessors": [{
            "bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3",
            "min": [0, 0, 0], "max": [1, 1, 0],
        }],
    }
    p = tmp_path / "scene.gltf"
    p.write_text(json.dumps(doc))
    return p


def test_trs_hierarchy_baking(tmp_path):
    # parent translates by (2,0,0), child scales by 3: v' = 3v + (2,0,0)
    nodes = [
        {"translation": [2.0, 0.0, 0.0], "children": [1]},
        {"scale": [3.0, 3.0, 3.0], "mesh": 0},
    ]
    p = _gltf_with_nodes(tmp_path, nodes, [0])
    tris = extract_triangles(load_gltf(p))
    want = np.array([[2, 0, 0], [5, 0, 0], [2, 3, 0]], np.float32)
    np.testing.assert_allclose(tris[0], want, atol=1e-6)


def test_matrix_node(tmp_path):
    # column-major matrix: rotate 90° about z then translate (0,0,5)
    m = [0, 1, 0, 0, -1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 5, 1]
    nodes = [{"matrix": m, "mesh": 0}]
    p = _gltf_with_nodes(tmp_path, nodes, [0])
    tris = extract_triangles(load_gltf(p))
    want = np.array([[0, 0, 5], [0, 1, 5], [-1, 0, 5]], np.float32)
    np.testing.assert_allclose(tris[0], want, atol=1e-6)


def test_mesh_instancing(tmp_path):
    # the same mesh referenced by two nodes → two triangles
    nodes = [
        {"mesh": 0},
        {"translation": [10.0, 0.0, 0.0], "mesh": 0},
    ]
    p = _gltf_with_nodes(tmp_path, nodes, [0, 1])
    tris = extract_triangles(load_gltf(p))
    assert tris.shape == (2, 3, 3)
    np.testing.assert_allclose(tris[1] - tris[0], np.tile([10.0, 0.0, 0.0], (3, 1)), atol=1e-6)


def test_rotation_quaternion_node(tmp_path):
    # 180° about y: (x,y,z) → (−x,y,−z)
    nodes = [{"rotation": [0.0, 1.0, 0.0, 0.0], "mesh": 0}]
    p = _gltf_with_nodes(tmp_path, nodes, [0])
    tris = extract_triangles(load_gltf(p))
    want = np.array([[0, 0, 0], [-1, 0, 0], [0, 1, 0]], np.float32)
    np.testing.assert_allclose(tris[0], want, atol=1e-6)


def test_golden_image_regression():
    """Anchor the whole pipeline: a fixed scene/camera must keep producing
    the same image signature across refactors (regenerate consciously if the
    math intentionally changes)."""
    tris = procgen.make_icosphere(2)
    rec = pack_bvh(make_wide_bvh(collapse_lbvh2_to_bvh4(build_lbvh2(tris))), tris)
    img = np.asarray(
        render_frame_u8(
            *rec,
            np.array([0.1, -0.05, 3.2], np.float32),
            np.array([0.0, 0.0, 0.0, 1.0], np.float32),
            64, 64,
        )
    )
    sig = {
        "sum": int(img[..., :3].astype(np.int64).sum()),
        "hits": int((img[..., 0] > 3).sum()),
        "center": img[32, 32, :3].tolist(),
    }
    # pinned from the first recorded run:
    pinned = {"sum": 224103, "hits": 695, "center": [164, 128, 55]}
    if pinned["sum"] is not None:
        assert sig == pinned, f"golden drift: {sig}"
