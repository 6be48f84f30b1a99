"""Scene / GLB ingest tests: parser correctness + normalization semantics."""

import numpy as np

from raytracer.models.scene import Scene
from raytracer.utils import procgen
from raytracer.utils.gltf import extract_triangles, load_gltf


def test_glb_roundtrip_indexed(tmp_path, rng):
    tris = procgen.make_icosphere(2)
    p = tmp_path / "ico.glb"
    procgen.write_glb(p, tris, indexed=True)
    doc = load_gltf(p)
    out = extract_triangles(doc)
    assert out.shape == tris.shape
    np.testing.assert_allclose(out, tris, rtol=0, atol=0)


def test_glb_roundtrip_soup(tmp_path):
    tris = procgen.make_cube()
    p = tmp_path / "cube.glb"
    procgen.write_glb(p, tris, indexed=False)
    out = extract_triangles(load_gltf(p))
    np.testing.assert_array_equal(out, tris)


def test_reference_steve_parses(steve_glb_path):
    s = Scene().load_glb(steve_glb_path)
    assert s.num_triangles > 0
    assert s.triangles.dtype == np.float32
    assert np.isfinite(s.triangles).all()


def test_reference_dodecahedron_parses(dodecahedron_glb_path):
    s = Scene().load_glb(dodecahedron_glb_path)
    # a dodecahedron surface: 12 pentagons = 36 triangles
    assert s.num_triangles == 36


def test_normalize_cube_semantics(tmp_path):
    tris = procgen.make_cube() * np.float32(3.0) + np.float32(7.0)
    p = tmp_path / "c.glb"
    procgen.write_glb(p, tris)
    s = Scene().load_glb(p, normalize=True, mode="cube")
    v = s.triangles.reshape(-1, 3)
    # cube mode: longest dimension spans exactly [-1, 1] (Scene.js:139)
    np.testing.assert_allclose(v.min(axis=0), -1.0, atol=1e-6)
    np.testing.assert_allclose(v.max(axis=0), 1.0, atol=1e-6)


def test_normalize_sphere_semantics(tmp_path):
    tris = procgen.make_icosphere(1, radius=5.0) + np.float32(2.0)
    p = tmp_path / "s.glb"
    procgen.write_glb(p, tris)
    s = Scene().load_glb(p, normalize=True, mode="sphere")
    v = s.triangles.reshape(-1, 3)
    ext = v.max(axis=0) - v.min(axis=0)
    # sphere mode: scale = 1/(maxDim/2) → longest dimension spans 2 (Scene.js:141-144)
    np.testing.assert_allclose(ext.max(), 2.0, atol=1e-5)


def test_flat_export_layout():
    tris = procgen.make_quad()
    s = Scene().set_triangles(tris)
    flat = s.get_triangles_float32()
    assert flat.shape == (18,)
    np.testing.assert_array_equal(flat.reshape(2, 3, 3), tris)


def test_sort_triangles_is_permutation():
    tris = procgen.make_icosphere(2)
    s = Scene().set_triangles(tris.copy())
    s.sort_triangles()
    assert s.triangles.shape == tris.shape
    a = np.sort(tris.reshape(len(tris), -1), axis=0)
    b = np.sort(s.triangles.reshape(len(tris), -1), axis=0)
    np.testing.assert_array_equal(a, b)


def test_centroids():
    tris = procgen.make_quad()
    c = Scene().set_triangles(tris).centroids()
    np.testing.assert_allclose(c, tris.mean(axis=1), rtol=1e-6)
