"""Native binned-SAH quality builder (raytracer/native/sah_build.cpp).

The beyond-reference quality option (reference is "BVH-only, no SAH",
README.md:79). Checks the LBVH2-ABI contract, structural invariants,
conservative fp16 packing (incl. the subnormal range that broke round-2's
first build), and end-to-end traversal parity through the device collapse.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from raytracer.native import bvhtool
from raytracer.ops.collapse import bvh2_as_bvh4, collapse_lbvh2_to_bvh4
from raytracer.ops.camera import generate_rays
from raytracer.ops.lbvh import LEAF_FLAG, build_sah2
from raytracer.ops.trace import make_wide_bvh, pack_bvh, trace, trace_rays_brute
from raytracer.utils import procgen

pytestmark = pytest.mark.skipif(
    not bvhtool.available() or getattr(bvhtool._lib, "bvh_build_sah", None) is None,
    reason="libbvhtool.so with bvh_build_sah not built",
)


def _scene(n_sub=2):
    tris = procgen.make_icosphere(n_sub).astype(np.float32)
    return tris


def test_structure_invariants():
    tris = _scene(3)
    n = len(tris)
    bvh, height = build_sah2(tris)
    m = bvh.bounds_u32.shape[0]
    assert m == 2 * n - 1
    assert 0 < height < 64

    meta = np.asarray(bvh.meta)
    left = np.asarray(bvh.left)
    right = np.asarray(bvh.right)
    leaves = (meta & LEAF_FLAG) != 0
    assert leaves.sum() == n
    assert len(np.unique(meta[leaves] & 0x7FFFFFFF)) == n

    # every non-root node has in-degree exactly 1; children in range
    internal = ~leaves
    assert (left[internal] < m).all() and (right[internal] < m).all()
    deg = np.zeros(m, np.int64)
    np.add.at(deg, left[internal], 1)
    np.add.at(deg, right[internal], 1)
    assert deg[0] == 0 and (deg[1:] == 1).all()


def test_bounds_conservative_and_finite():
    # includes coordinates in the f16 subnormal range (|x| < 6.1e-5): the
    # first native build's RNE used a wrong subnormal shift and emitted NaNs
    rng = np.random.RandomState(7)
    scales = np.concatenate(
        [np.full(200, 1e-6), np.full(200, 1e-4), np.full(600, 1.0)]
    )[:, None, None]
    tris = (rng.randn(1000, 3, 3) * scales).astype(np.float32)
    bvh, _ = build_sah2(tris)

    from raytracer.ops import fp16_jax as f16

    mn, mx = map(np.asarray, f16.unpack_bounds(bvh.bounds_u32))
    assert np.isfinite(mn).all() and np.isfinite(mx).all()

    # root bounds contain all geometry
    assert (mn[0] <= tris.reshape(-1, 3).min(0)).all()
    assert (mx[0] >= tris.reshape(-1, 3).max(0)).all()

    # parent boxes contain child boxes
    meta = np.asarray(bvh.meta)
    leaves = (meta & LEAF_FLAG) != 0
    L, R = np.asarray(bvh.left), np.asarray(bvh.right)
    for i in np.nonzero(~leaves)[0][::7]:
        for c in (L[i], R[i]):
            assert (mn[i] <= mn[c] + 1e-6).all() and (mx[i] >= mx[c] - 1e-6).all()


def test_traversal_parity_direct_and_collapsed():
    tris_np = _scene(3)
    bvh, height = build_sah2(tris_np)
    tris = jnp.asarray(tris_np)
    o, d = generate_rays(64, 64, jnp.array([0.0, 0.0, 2.5]), jnp.array([0.0, 0.0, 0.0, 1.0]))
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    bt, btri = trace_rays_brute(tris, o, d)

    t1, _, _, _, tri1 = trace(
        *pack_bvh(make_wide_bvh(bvh2_as_bvh4(bvh)), tris), o, d)
    assert bool(jnp.all(tri1 == btri))

    bvh4 = collapse_lbvh2_to_bvh4(bvh, sweeps=height + 2)
    t2, _, _, _, tri2 = trace(*pack_bvh(make_wide_bvh(bvh4), tris), o, d)
    assert bool(jnp.all(tri2 == btri))


def test_pathtracer_sah_builder():
    from raytracer.pathtracer import PathTracer

    pt = PathTracer(width=64, height=64, builder="sah")
    pt.build_bvh(_scene(2))
    img = np.asarray(pt.render())
    assert img.shape == (64, 64, 4)
    assert (img[..., :3].sum(-1) > 10).sum() > 100
