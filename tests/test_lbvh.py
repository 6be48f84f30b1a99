"""LBVH2 builder tests: oracle parity + structural invariants."""

import numpy as np
import pytest

from raytracer.io import artifacts
from raytracer.ops.lbvh import INVALID, LEAF_FLAG, build_lbvh2, refit_lbvh2
from raytracer.ops.morton import build_morton_and_sort
from raytracer.reference.lbvh_oracle import build_lbvh2_oracle, morton_codes_py
from raytracer.utils import procgen
from raytracer.utils.fp16 import unpack_bounds_u32


def _random_tris(rng, n):
    v0 = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    e = rng.uniform(-0.4, 0.4, (n, 2, 3)).astype(np.float32)
    return np.stack([v0, v0 + e[:, 0], v0 + e[:, 1]], axis=1)


def test_morton_matches_oracle(rng):
    tris = _random_tris(rng, 257)
    codes_sorted, order = build_morton_and_sort(tris)
    codes_py = morton_codes_py(tris.mean(axis=1))
    order_py = np.argsort(codes_py, kind="stable")
    np.testing.assert_array_equal(np.asarray(order), order_py.astype(np.uint32))
    np.testing.assert_array_equal(np.asarray(codes_sorted), codes_py[order_py])


@pytest.mark.parametrize("n", [1, 2, 3, 5, 17, 64, 211])
def test_lbvh_matches_sequential_oracle(rng, n):
    tris = _random_tris(rng, n)
    bvh = build_lbvh2(tris)
    want = build_lbvh2_oracle(tris)
    np.testing.assert_array_equal(np.asarray(bvh.left), want["left"])
    np.testing.assert_array_equal(np.asarray(bvh.right), want["right"])
    np.testing.assert_array_equal(np.asarray(bvh.meta), want["meta"])
    np.testing.assert_array_equal(np.asarray(bvh.parent), want["parent"])
    np.testing.assert_array_equal(np.asarray(bvh.bounds_u32), want["bounds_u32"])


def test_lbvh_duplicate_positions(rng):
    # identical centroids force the index tie-break path (delta on i^j)
    tri = _random_tris(rng, 1)
    tris = np.repeat(tri, 33, axis=0)
    bvh = build_lbvh2(tris)
    want = build_lbvh2_oracle(tris)
    np.testing.assert_array_equal(np.asarray(bvh.left), want["left"])
    np.testing.assert_array_equal(np.asarray(bvh.bounds_u32), want["bounds_u32"])


def _check_invariants(bvh, tris):
    n = len(tris)
    m = bvh.num_nodes
    assert m == 2 * n - 1
    num_internal = bvh.num_internal
    left = np.asarray(bvh.left)
    right = np.asarray(bvh.right)
    meta = np.asarray(bvh.meta)
    mn, mx = unpack_bounds_u32(np.asarray(bvh.bounds_u32))

    # every leaf holds exactly one triangle, each triangle exactly once
    leaf_tris = meta[num_internal:] & 0x7FFFFFFF
    assert np.all(meta[num_internal:] & LEAF_FLAG != 0)
    np.testing.assert_array_equal(np.sort(leaf_tris), np.arange(n, dtype=np.uint32))

    if num_internal:
        # each non-root node has exactly one parent reference
        children = np.concatenate([left[:num_internal], right[:num_internal]])
        np.testing.assert_array_equal(np.sort(children), np.arange(1, m, dtype=np.uint32))
        # parent bounds contain child bounds
        for cset in (left[:num_internal], right[:num_internal]):
            ci = cset.astype(np.int64)
            assert np.all(mn[:num_internal] <= mn[ci] + 1e-6)
            assert np.all(mx[:num_internal] >= mx[ci] - 1e-6)

    # leaf bounds conservatively contain their triangle
    tmn = tris.min(axis=1)
    tmx = tris.max(axis=1)
    order = leaf_tris.astype(np.int64)
    assert np.all(mn[num_internal:] <= tmn[order])
    assert np.all(mx[num_internal:] >= tmx[order])


def test_invariants_icosphere():
    tris = procgen.make_icosphere(3)
    _check_invariants(build_lbvh2(tris), tris)


def test_invariants_cornell():
    tris = procgen.make_cornell_box()
    _check_invariants(build_lbvh2(tris), tris)


def test_bvh2_artifact_roundtrip(rng):
    tris = _random_tris(rng, 100)
    bvh = build_lbvh2(tris)
    buf = artifacts.bvh2_to_u32(
        np.asarray(bvh.bounds_u32), np.asarray(bvh.left), np.asarray(bvh.right), np.asarray(bvh.meta)
    )
    assert buf[0] == 199 and buf.shape == (1 + 199 * 6,)
    b, l, r, mta = artifacts.bvh2_from_u32(buf)
    np.testing.assert_array_equal(b, np.asarray(bvh.bounds_u32))
    np.testing.assert_array_equal(l, np.asarray(bvh.left))
    np.testing.assert_array_equal(r, np.asarray(bvh.right))
    np.testing.assert_array_equal(mta, np.asarray(bvh.meta))


def test_refit_tracks_moved_geometry(rng):
    tris = _random_tris(rng, 128)
    bvh = build_lbvh2(tris)
    moved = tris + np.float32(2.5)
    refit = refit_lbvh2(bvh, moved)
    # topology unchanged
    np.testing.assert_array_equal(np.asarray(refit.left), np.asarray(bvh.left))
    np.testing.assert_array_equal(np.asarray(refit.meta), np.asarray(bvh.meta))
    # root bounds track the moved mesh
    mn, mx = unpack_bounds_u32(np.asarray(refit.bounds_u32[0]))
    assert np.all(mn <= moved.reshape(-1, 3).min(axis=0))
    assert np.all(mx >= moved.reshape(-1, 3).max(axis=0))
    # refit equals a fresh build's bounds for the same topology? not in
    # general (morton order changes), but it must still satisfy invariants
    _check_invariants(refit, moved)
