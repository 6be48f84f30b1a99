"""PLOC quality-builder tests: same invariants as LBVH, identical renders,
better-or-equal traversal cost."""

import numpy as np
import pytest

from raytracer.ops.collapse import collapse_lbvh2_to_bvh4
from raytracer.ops.lbvh import LEAF_FLAG, build_lbvh2
from raytracer.ops.ploc import build_ploc2
from raytracer.ops.trace import make_wide_bvh, pack_bvh
from raytracer.reference import cpu_tracer
from raytracer.render import render_ldr, render_ldr_brute
from raytracer.utils import procgen
from raytracer.utils.fp16 import unpack_bounds_u32

CAM_POS = np.array([0.0, 0.0, 3.5], np.float32)
CAM_QUAT = np.array([0.0, 0.0, 0.0, 1.0], np.float32)


def _check_invariants(bvh, tris):
    n = len(tris)
    m = bvh.num_nodes
    assert m == 2 * n - 1
    ni = bvh.num_internal
    left = np.asarray(bvh.left)
    right = np.asarray(bvh.right)
    meta = np.asarray(bvh.meta)
    mn, mx = unpack_bounds_u32(np.asarray(bvh.bounds_u32))

    leaf_tris = meta[ni:] & 0x7FFFFFFF
    assert np.all(meta[ni:] & LEAF_FLAG != 0)
    np.testing.assert_array_equal(np.sort(leaf_tris), np.arange(n, dtype=np.uint32))

    if ni:
        children = np.concatenate([left[:ni], right[:ni]])
        np.testing.assert_array_equal(np.sort(children), np.arange(1, m, dtype=np.uint32))
        for cset in (left[:ni], right[:ni]):
            ci = cset.astype(np.int64)
            assert np.all(mn[:ni] <= mn[ci] + 1e-6)
            assert np.all(mx[:ni] >= mx[ci] - 1e-6)


@pytest.mark.parametrize("n", [1, 2, 3, 9, 64, 257])
def test_ploc_invariants_random(rng, n):
    v0 = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    e = rng.uniform(-0.4, 0.4, (n, 2, 3)).astype(np.float32)
    tris = np.stack([v0, v0 + e[:, 0], v0 + e[:, 1]], axis=1)
    _check_invariants(build_ploc2(tris), tris)


def test_ploc_invariants_icosphere():
    tris = procgen.make_icosphere(3)
    _check_invariants(build_ploc2(tris), tris)


def test_ploc_renders_identically_to_brute():
    tris = procgen.make_icosphere(2)
    rec = pack_bvh(make_wide_bvh(collapse_lbvh2_to_bvh4(build_ploc2(tris))), tris)
    _, t_p, tri_p = render_ldr(*rec, CAM_POS, CAM_QUAT, 64, 48)
    _, t_b, tri_b = render_ldr_brute(tris, CAM_POS, CAM_QUAT, 64, 48)
    np.testing.assert_array_equal(np.asarray(t_p), np.asarray(t_b))


def test_ploc_traversal_not_worse_than_lbvh():
    """Scalar-oracle visit counts: PLOC should need no more box tests than
    LBVH on an elongated scene (where Morton splits are weakest)."""
    tris = procgen.make_trefoil(nu=48, nv=24)
    o = np.array([0.0, 0.0, 8.0], np.float32)

    def visits(builder):
        bvh4 = collapse_lbvh2_to_bvh4(builder(tris))
        n4 = int(bvh4.num_nodes)
        b4 = np.asarray(bvh4.bounds_u32)[:n4]
        c4 = np.asarray(bvh4.children)[:n4]
        m4 = np.asarray(bvh4.meta)[:n4]
        total = 0
        for px in np.linspace(-0.4, 0.4, 9):
            d = np.array([px, 0.13, -1.0], np.float32)
            d /= np.linalg.norm(d)
            _, _, stats = cpu_tracer.traverse_bvh4_scalar(b4, c4, m4, tris, o, d)
            total += stats["box_tests"]
        return total

    v_lbvh = visits(build_lbvh2)
    v_ploc = visits(build_ploc2)
    assert v_ploc <= v_lbvh * 1.05  # allow small noise; typically well below
