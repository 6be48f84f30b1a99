"""The trace entry (ops/trace.py): packed layout, XLA reference, the CUDA
kernel's wrapper, and the choice between them.

On the CPU every test here runs the XLA reference, which is the CUDA
kernel's oracle (same layout, same visiting order); the kernel itself is
compared with it on the card by the ``gpu``-marked tests and by
``chip_smoke.py``. Oracle per path, after the reference's own discipline
(tests/test.py:149-230).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracer.models.scene import Scene
from raytracer.ops.camera import INF, generate_rays
from raytracer.ops.collapse import collapse_lbvh2_to_bvh4, collapse_lbvh2_to_bvh8
from raytracer.ops.lbvh import build_lbvh2
from raytracer.ops.trace import (
    make_wide_bvh,
    pack_bvh,
    trace,
    trace_rays_brute,
    trace_reference,
    unpack_nodes,
)
from raytracer.render import trace_frame
from raytracer.utils import procgen


def _normalized(tris_np):
    scene = Scene().set_triangles(tris_np)
    scene._normalize_enabled, scene._normalize_mode = True, "cube"
    scene.normalize_mesh()
    return jnp.asarray(scene.triangles)


def _pipeline(tris_np):
    tris = _normalized(tris_np)
    wide = make_wide_bvh(collapse_lbvh2_to_bvh4(build_lbvh2(tris)))
    return tris, wide, pack_bvh(wide, tris)


CAM_POS = jnp.array([0.15, -0.1, 2.5], jnp.float32)
CAM_QUAT = jnp.array([0.0, 0.1, 0.0, 0.9949874], jnp.float32)


@pytest.fixture(scope="module")
def sphere():
    return _pipeline(procgen.make_icosphere(2))


def _brute(tris, w, h):
    o, d = generate_rays(w, h, CAM_POS, CAM_QUAT)
    t, tri = trace_rays_brute(tris, o.reshape(-1, 3), d.reshape(-1, 3))
    return np.asarray(t).reshape(h, w), np.asarray(tri).reshape(h, w)


def _scattered_rays(seed, n=2048):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 0.1 + np.array([0, 0, 2.0])).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return jnp.asarray(o), jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True))


@pytest.mark.parametrize("w,h", [(128, 64),
    pytest.param(96, 80, marks=pytest.mark.full)])
def test_tiles_parity_vs_brute(sphere, w, h):
    """Exact tri-id parity of a primary frame incl. sizes that are not a
    multiple of the ray tiling (pad rays are inactive)."""
    tris, wide, (nodes, trec) = sphere
    t, nx, ny, nz, tri = trace_frame(nodes, trec, CAM_POS, CAM_QUAT, w, h)
    bt, btri = _brute(tris, w, h)
    assert (np.asarray(tri) == btri).all()
    hit = btri >= 0
    assert np.allclose(np.asarray(t)[hit], bt[hit], rtol=1e-5)
    # normals are unit where hit, zero where miss
    n = np.stack([np.asarray(nx), np.asarray(ny), np.asarray(nz)], -1)
    ln = np.linalg.norm(n, axis=-1)
    assert np.allclose(ln[hit], 1.0, atol=1e-4)
    assert np.allclose(ln[~hit], 0.0)


@pytest.mark.full
def test_jitter_deterministic_and_seeded(sphere):
    tris, wide, (nodes, trec) = sphere
    w = h = 64
    a = trace_frame(nodes, trec, CAM_POS, CAM_QUAT, w, h, jitter=True,
                    jitter_seed=3)
    b = trace_frame(nodes, trec, CAM_POS, CAM_QUAT, w, h, jitter=True,
                    jitter_seed=3)
    c = trace_frame(nodes, trec, CAM_POS, CAM_QUAT, w, h, jitter=True,
                    jitter_seed=4)
    centered = trace_frame(nodes, trec, CAM_POS, CAM_QUAT, w, h)
    assert (np.asarray(a[0]) == np.asarray(b[0])).all()
    assert not (np.asarray(a[0]) == np.asarray(c[0])).all()
    assert not (np.asarray(a[0]) == np.asarray(centered[0])).all()


def test_raybuf_parity_and_padding(sphere):
    """Arbitrary ray buffer: exact parity on a ray count that is not a
    multiple of the reference's chunk (pad rays must not corrupt real ones)."""
    tris, wide, (nodes, trec) = sphere
    o, d = generate_rays(64, 48, CAM_POS, CAM_QUAT)
    o = o.reshape(-1, 3)[:2500]
    d = d.reshape(-1, 3)[:2500]
    t, nx, ny, nz, tri = trace_reference(nodes, trec, o, d,
                                         jnp.full((2500,), INF), chunk=1024)
    bt, btri = trace_rays_brute(tris, o, d)
    assert (np.asarray(tri) == np.asarray(btri)).all()


def test_golden_image_pallas():
    """Pin the primary path's image signature — the analog of the render
    anchor in test_gltf_extras.py."""
    tris, wide, (nodes, trec) = _pipeline(procgen.make_icosphere(2))
    t, nx, ny, nz, tri = trace_frame(
        nodes, trec,
        jnp.array([0.1, -0.05, 3.2], jnp.float32),
        jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32),
        64, 64,
    )
    tri = np.asarray(tri)
    sig = {
        "hits": int((tri >= 0).sum()),
        "tri_sum": int(tri[tri >= 0].astype(np.int64).sum()),
        "t_center": round(float(np.asarray(t)[32, 32]), 5),
    }
    pinned = {"hits": 695, "tri_sum": 108566, "t_center": 2.22341}
    assert sig == pinned, f"golden drift: {sig}"


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.full
def test_packed_leaf_parity(k):
    """Packed-leaf (K tris/leaf, ops/cluster.py) pipeline vs brute force,
    on a triangle count that is NOT a multiple of K (tail cluster short)."""
    from raytracer.ops.cluster import build_lbvh2_clustered, records_pipeline

    tris = _normalized(procgen.make_icosphere(2)[: 320 - 3])
    nodes, trec = records_pipeline(build_lbvh2_clustered(tris, leaf_size=k))

    w, h = 96, 64
    t, nx, ny, nz, tri = trace_frame(nodes, trec, CAM_POS, CAM_QUAT, w, h)
    bt, btri = _brute(tris, w, h)
    assert (np.asarray(tri) == btri).all()
    hit = btri >= 0
    assert np.allclose(np.asarray(t)[hit], bt[hit], rtol=1e-5)

    # arbitrary ray buffers (bounce waves / shadow rays) agree too
    o, d = generate_rays(48, 32, CAM_POS, CAM_QUAT)
    o, d = o.reshape(-1, 3)[:1200], d.reshape(-1, 3)[:1200]
    rt, _, _, _, rtri = trace(nodes, trec, o, d)
    rbt, rbtri = trace_rays_brute(tris, o, d)
    assert (np.asarray(rtri) == np.asarray(rbtri)).all()


def test_batch_kernel_matches_single_calls(sphere):
    """A frame batch traced as ONE call over F·H·W rays equals F separate
    per-frame calls: exact tri ids, t and normals."""
    tris, wide, (nodes, trec) = sphere
    poss = jnp.stack([CAM_POS, CAM_POS + jnp.array([0.3, 0.0, -0.3])])
    quats = jnp.stack([CAM_QUAT, CAM_QUAT])
    rays = [generate_rays(96, 64, poss[i], quats[i]) for i in range(2)]
    singles = [trace(nodes, trec, o, d) for o, d in rays]
    batch = trace(nodes, trec, jnp.stack([o for o, _ in rays]),
                  jnp.stack([d for _, d in rays]))
    for i in range(2):
        for p in range(5):
            assert np.array_equal(np.asarray(singles[i][p]),
                                  np.asarray(batch[p][i])), (i, p)


# -- layout, reference and entry --------------------------------------------------


@pytest.mark.parametrize("width", [4, 8])
def test_pack_roundtrips_wide_bvh(sphere, width):
    """pack_bvh → unpack_nodes gives back the WideBVH's boxes, node refs and
    leaf refs (K=1: triangle row = leaf index), and the triangle records
    hold [v0, e1, e2, e1×e2]."""
    tris = sphere[0]
    collapse = collapse_lbvh2_to_bvh4 if width == 4 else collapse_lbvh2_to_bvh8
    wide = make_wide_bvh(collapse(build_lbvh2(tris)))
    nodes, trec = pack_bvh(wide, tris)
    assert nodes.shape == (wide.cref.shape[0], 8 * width)
    cmn, cmx, ref, cnt = map(np.asarray, unpack_nodes(nodes))
    np.testing.assert_array_equal(cmn, np.asarray(wide.cmn))
    np.testing.assert_array_equal(cmx, np.asarray(wide.cmx))
    cref = np.asarray(wide.cref)
    empty, leaf = cref < 0, (cref >= 0) & ((cref & (1 << 30)) != 0)
    internal = ~empty & ~leaf
    assert (cnt[empty] == -1).all() and (cnt[internal] == 0).all()
    assert (cnt[leaf] == 1).all()
    np.testing.assert_array_equal(ref[internal], cref[internal])
    np.testing.assert_array_equal(ref[leaf], cref[leaf] & ((1 << 30) - 1))
    t = np.asarray(tris)
    rec = np.asarray(trec.rec)
    np.testing.assert_array_equal(rec[:, 0:3], t[:, 0])
    np.testing.assert_array_equal(rec[:, 3:6], t[:, 1] - t[:, 0])
    np.testing.assert_array_equal(rec[:, 6:9], t[:, 2] - t[:, 0])
    np.testing.assert_allclose(rec[:, 9:12], np.cross(rec[:, 3:6], rec[:, 6:9]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(np.asarray(trec.ids), np.arange(len(t)))


@pytest.mark.parametrize("k", [4, 8, 32])
def test_reference_width8_packed_leaves_vs_brute(k):
    """The reference at K ∈ {4, 8, 32} triangles per leaf on an 8-wide SAH
    cluster tree: exact ids vs brute force, closest-hit and any-hit."""
    from raytracer.ops.cluster import build_sah2_clustered, records_pipeline

    tris = _normalized(procgen.make_icosphere(2)[:301])   # short tail leaf
    cs, height = build_sah2_clustered(tris, leaf_size=k)
    nodes, trec = records_pipeline(cs, height=height, width=8)
    assert nodes.shape[1] == 64
    o, d = _scattered_rays(k)
    t, _, _, _, tri = trace(nodes, trec, o, d)
    bt, btri = trace_rays_brute(tris, o, d)
    assert (np.asarray(tri) == np.asarray(btri)).all()
    hit = np.asarray(btri) >= 0
    assert np.allclose(np.asarray(t)[hit], np.asarray(bt)[hit], rtol=1e-5)
    _, _, _, _, atri = trace(nodes, trec, o, d, any_hit=True)
    assert ((np.asarray(atri) >= 0) == hit).all()


def test_t_max_semantics(sphere):
    """Only hits with t < t_max count; t_max ≤ 0 makes a ray inactive; an
    unbounded ray is unaffected by its neighbours' bounds."""
    tris, wide, (nodes, trec) = sphere
    o, d = generate_rays(32, 32, jnp.array([0.0, 0.0, 2.5]),
                         jnp.array([0.0, 0.0, 0.0, 1.0]))
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    t0, _, _, _, tri0 = map(np.asarray, trace(nodes, trec, o, d))
    hit = tri0 >= 0
    assert hit.any()
    # a bound just above the nearest hit keeps it; just below removes it
    # (the sphere's far side lies beyond the bound too)
    above = trace(nodes, trec, o, d, t_max=jnp.asarray(t0 * 1.001))
    np.testing.assert_array_equal(np.asarray(above[4]), tri0)
    below = np.asarray(trace(nodes, trec, o, d,
                             t_max=jnp.asarray(t0 * 0.999))[4])
    assert (below[hit] == -1).all()
    # inactive rays report a miss; the others are untouched
    tm = jnp.where(jnp.arange(o.shape[0]) % 2 == 0, 0.0, INF)
    t2, nx2, _, _, tri2 = map(np.asarray, trace(nodes, trec, o, d, t_max=tm))
    assert (tri2[0::2] == -1).all() and (t2[0::2] >= 1e29).all()
    assert (nx2[0::2] == 0).all()
    np.testing.assert_array_equal(tri2[1::2], tri0[1::2])


def test_ffi_wrapper_shapes():
    """The CUDA kernel's FFI call, traced abstractly (no card needed): one
    (R,) output per plane for R rays, tri as int32; ``trace`` keeps any
    leading ray shape."""
    from raytracer.ops.cuda_trace import trace_cuda
    from raytracer.ops.trace import TriRecords

    r = 1000
    nodes = jax.ShapeDtypeStruct((7, 32), jnp.float32)
    trec = TriRecords(jax.ShapeDtypeStruct((20, 12), jnp.float32),
                      jax.ShapeDtypeStruct((20,), jnp.int32))
    ray = jax.ShapeDtypeStruct((r, 3), jnp.float32)
    tmax = jax.ShapeDtypeStruct((r,), jnp.float32)
    for any_hit in (False, True):
        out = jax.eval_shape(
            lambda n, tr, o, d, tm: trace_cuda(n, tr, o, d, tm,
                                               any_hit=any_hit),
            nodes, trec, ray, ray, tmax)
        assert [a.shape for a in out] == [(r,)] * 5
        assert [a.dtype for a in out] == [jnp.float32] * 4 + [jnp.int32]

    shaped = jax.ShapeDtypeStruct((2, 5, 7, 3), jnp.float32)
    out = jax.eval_shape(lambda n, tr, o, d: trace(n, tr, o, d), nodes, trec,
                         shaped, shaped)
    assert [a.shape for a in out] == [(2, 5, 7)] * 5


def test_trace_picks_reference_on_cpu(sphere):
    """On the CPU the entry is the XLA reference, bit for bit."""
    tris, wide, (nodes, trec) = sphere
    o, d = _scattered_rays(11, n=700)
    got = trace(nodes, trec, o, d)
    want = trace_reference(nodes, trec, o, d, jnp.full((700,), INF))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w_))


def test_trace_raises_on_unknown_platform(sphere, monkeypatch):
    """A platform with neither the kernel nor the reference is an error,
    never a silent fallback."""
    tris, wide, (nodes, trec) = sphere
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    o, d = _scattered_rays(1, n=8)
    with pytest.raises(RuntimeError, match="no BVH traversal"):
        trace(nodes, trec, o + 0.5, d)   # fresh shapes: traced anew


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache directory; unset,
    the cache goes to the fixed in-checkout path."""
    from raytracer.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
        assert compile_cache.enable_compile_cache() == str(tmp_path / "c")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        path = compile_cache.enable_compile_cache()
        assert path == str(compile_cache.DEFAULT_CACHE_DIR)
        assert path.endswith(".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.gpu
def test_kernel_matches_reference_on_card(gpu):
    """The CUDA kernel against the XLA reference on the card: closest-hit
    ids, t and normals, and the any-hit occlusion flags, on 4- and 8-wide
    trees with packed leaves."""
    from raytracer.ops.cluster import build_sah2_clustered, records_pipeline

    tris = _normalized(procgen.make_icosphere(4))
    o, d = generate_rays(256, 256, CAM_POS, CAM_QUAT)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    tm = jnp.full((o.shape[0],), INF)
    for k, width in ((1, 4), (8, 4), (8, 8), (32, 4)):
        cs, height = build_sah2_clustered(tris, leaf_size=k)
        nodes, trec = records_pipeline(cs, height=height, width=width)
        got = [np.asarray(a) for a in trace(nodes, trec, o, d)]
        want = [np.asarray(a) for a in trace_reference(nodes, trec, o, d, tm)]
        assert (got[4] == want[4]).mean() >= 0.9999, (k, width)
        same = (got[4] == want[4]) & (want[4] >= 0)
        assert np.all(np.abs(got[0] - want[0])[same]
                      <= 1e-5 * np.maximum(1.0, want[0][same]))
        for p in (1, 2, 3):
            assert np.all(np.abs(got[p] - want[p])[same] <= 1e-5)
        occ = np.asarray(trace(nodes, trec, o, d, any_hit=True)[4]) >= 0
        occ_r = np.asarray(trace_reference(nodes, trec, o, d, tm,
                                           any_hit=True)[4]) >= 0
        assert (occ == occ_r).mean() >= 0.9999, (k, width)
