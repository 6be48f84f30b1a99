"""BVH2→BVH4 widener tests: device collapse vs host oracle, toy trees,
promotion parity."""

import numpy as np
import pytest

from raytracer.io import artifacts
from raytracer.ops.collapse import (
    INVALID,
    LEAF_FLAG,
    collapse_lbvh2_to_bvh4,
    promote_lbvh2_to_bvh4_wide,
)
from raytracer.ops.lbvh import LBVH2, build_lbvh2
from raytracer.reference.collapse_oracle import collapse_oracle, promote_wide_oracle
from raytracer.utils import procgen
from raytracer.utils.fp16 import pack_bounds_u32, unpack_bounds_u32


def _random_tris(rng, n):
    v0 = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    e = rng.uniform(-0.4, 0.4, (n, 2, 3)).astype(np.float32)
    return np.stack([v0, v0 + e[:, 0], v0 + e[:, 1]], axis=1)


def _toy_tree():
    """Hand-built 9-node BVH2 (the test2.py-style toy): root, two internals,
    one deeper internal, 5 leaves. Node ids: 0=root(1,2), 1=(3,5), 2=(6,7),
    3=(4,8) internal, rest leaves."""
    mn = np.zeros((9, 3), np.float32)
    mx = np.ones((9, 3), np.float32)
    bounds = pack_bounds_u32(mn, mx)
    left = np.array([1, 3, 6, 4, 0, 0, 0, 0, 0], np.uint32)
    right = np.array([2, 5, 7, 8, 0, 0, 0, 0, 0], np.uint32)
    meta = np.array(
        [0, 0, 0, 0] + [LEAF_FLAG | t for t in (0, 1, 2, 3, 4)], np.uint32
    )
    return bounds, left, right, meta


def test_oracle_toy_tree_structure():
    bounds, left, right, meta = _toy_tree()
    b4, c4, m4 = collapse_oracle(bounds, left, right, meta)
    # greedy: root kids = expand 1 → [3, 5, 2] → expand 3 → [4, 8, 5, 2];
    # BVH2 nodes 1 and 3 contract away → 7 BVH4 nodes in pre-order
    assert len(m4) == 7
    assert (m4[0] & LEAF_FLAG) == 0
    assert list(c4[0]) == [1, 2, 3, 4]
    assert m4[1] == (LEAF_FLAG | 0)  # bvh2 leaf 4 holds tri 0
    assert m4[2] == (LEAF_FLAG | 4)  # bvh2 leaf 8 holds tri 4
    assert m4[3] == (LEAF_FLAG | 1)  # bvh2 leaf 5 holds tri 1
    assert (m4[4] & LEAF_FLAG) == 0  # bvh2 node 2 stays internal
    assert list(c4[4][:2]) == [5, 6] and c4[4][2] == INVALID
    assert m4[5] == (LEAF_FLAG | 2) and m4[6] == (LEAF_FLAG | 3)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 33, 100, 257])
def test_device_collapse_matches_oracle(rng, n):
    tris = _random_tris(rng, n)
    bvh2 = build_lbvh2(tris)
    b2 = np.asarray(bvh2.bounds_u32)
    l2, r2, m2 = np.asarray(bvh2.left), np.asarray(bvh2.right), np.asarray(bvh2.meta)

    want_b, want_c, want_m = collapse_oracle(b2, l2, r2, m2)
    got = collapse_lbvh2_to_bvh4(bvh2)
    n4 = int(got.num_nodes)
    assert n4 == len(want_m)
    np.testing.assert_array_equal(np.asarray(got.meta)[:n4], want_m)
    np.testing.assert_array_equal(np.asarray(got.children)[:n4], want_c)
    np.testing.assert_array_equal(np.asarray(got.bounds_u32)[:n4], want_b)


def test_device_promote_matches_oracle(rng):
    tris = _random_tris(rng, 150)
    bvh2 = build_lbvh2(tris)
    b2 = np.asarray(bvh2.bounds_u32)
    l2, r2, m2 = np.asarray(bvh2.left), np.asarray(bvh2.right), np.asarray(bvh2.meta)
    want_b, want_c, want_m = promote_wide_oracle(b2, l2, r2, m2)
    got = promote_lbvh2_to_bvh4_wide(bvh2)
    assert int(got.num_nodes) == len(m2)
    np.testing.assert_array_equal(np.asarray(got.bounds_u32), want_b)
    np.testing.assert_array_equal(np.asarray(got.children), want_c)
    np.testing.assert_array_equal(np.asarray(got.meta), want_m)


def _check_bvh4_invariants(b4, c4, m4, n_tris):
    n4 = len(m4)
    leaf = (m4 & LEAF_FLAG) != 0
    # every tri in exactly one leaf
    tris = np.sort(m4[leaf] & 0x7FFFFFFF)
    np.testing.assert_array_equal(tris, np.arange(n_tris, dtype=np.uint32))
    # children of internal nodes are valid, unique, and form a tree rooted at 0
    seen = np.zeros(n4, bool)
    seen[0] = True
    internal_children = c4[~leaf]
    valid = internal_children[internal_children != INVALID]
    assert valid.max(initial=0) < n4
    assert len(np.unique(valid)) == len(valid)
    np.testing.assert_array_equal(np.sort(valid), np.arange(1, n4, dtype=np.uint32))
    # leaves have no children
    assert np.all(c4[leaf] == INVALID)
    # parent bounds contain child bounds
    mn, mx = unpack_bounds_u32(b4)
    pidx = np.repeat(np.arange(n4)[~leaf], 4)
    cidx = internal_children.reshape(-1)
    ok = cidx != INVALID
    pidx, cidx = pidx[ok], cidx[ok].astype(np.int64)
    assert np.all(mn[pidx] <= mn[cidx] + 1e-6)
    assert np.all(mx[pidx] >= mx[cidx] - 1e-6)


def test_collapse_invariants_icosphere():
    tris = procgen.make_icosphere(3)
    bvh4 = collapse_lbvh2_to_bvh4(build_lbvh2(tris))
    n4 = int(bvh4.num_nodes)
    _check_bvh4_invariants(
        np.asarray(bvh4.bounds_u32)[:n4],
        np.asarray(bvh4.children)[:n4],
        np.asarray(bvh4.meta)[:n4],
        len(tris),
    )


def test_bvh4_artifact_roundtrip(rng):
    tris = _random_tris(rng, 64)
    bvh4 = collapse_lbvh2_to_bvh4(build_lbvh2(tris))
    n4 = int(bvh4.num_nodes)
    buf = artifacts.bvh4_to_u32(
        np.asarray(bvh4.bounds_u32)[:n4],
        np.asarray(bvh4.children)[:n4],
        np.asarray(bvh4.meta)[:n4],
    )
    assert buf[0] == n4
    b, c, m = artifacts.bvh4_from_u32(buf)
    np.testing.assert_array_equal(b, np.asarray(bvh4.bounds_u32)[:n4])
    np.testing.assert_array_equal(c, np.asarray(bvh4.children)[:n4])
    np.testing.assert_array_equal(m, np.asarray(bvh4.meta)[:n4])


def test_single_triangle_collapse(rng):
    tris = _random_tris(rng, 1)
    bvh4 = collapse_lbvh2_to_bvh4(build_lbvh2(tris))
    assert int(bvh4.num_nodes) == 1
    assert int(np.asarray(bvh4.meta)[0]) == LEAF_FLAG | 0
    assert np.all(np.asarray(bvh4.children)[0] == INVALID)


@pytest.mark.parametrize("builder", ["morton", "sah"])
def test_collapse_plan_refit_parity(rng, builder):
    """collapse_plan + collapse_apply_refit over a refitted tree must be
    bit-identical to the full collapse — the dynamic-scene fast path
    replaces four per-frame fixed-point sweeps with one static gather."""
    import jax.numpy as jnp

    from raytracer.ops.cluster import (
        build_lbvh2_clustered,
        build_sah2_clustered,
        refit_lbvh2_clustered,
    )
    from raytracer.ops.collapse import collapse_apply_refit, collapse_plan

    tris = _random_tris(rng, 257)
    if builder == "sah":
        try:
            cs, hgt = build_sah2_clustered(tris, leaf_size=8)
        except Exception as e:
            pytest.skip(f"native SAH unavailable: {e}")
        sweeps = hgt + 2
    else:
        cs = build_lbvh2_clustered(tris, leaf_size=8)
        sweeps = None

    plan = collapse_plan(cs.bvh2, sweeps=sweeps)
    for phase in (0.0, 0.7, 2.1):
        deformed = tris * (1.0 + 0.1 * np.sin(phase)) + np.float32(phase)
        cs_r = refit_lbvh2_clustered(cs, jnp.asarray(deformed),
                                     num_sweeps=sweeps)
        full = collapse_lbvh2_to_bvh4(cs_r.bvh2, sweeps=sweeps)
        fast = collapse_apply_refit(plan, cs_r.bvh2.bounds_u32)
        assert int(fast.num_nodes) == int(full.num_nodes)
        np.testing.assert_array_equal(np.asarray(fast.children),
                                      np.asarray(full.children))
        np.testing.assert_array_equal(np.asarray(fast.meta),
                                      np.asarray(full.meta))
        np.testing.assert_array_equal(np.asarray(fast.bounds_u32),
                                      np.asarray(full.bounds_u32))


def test_collapse_plan_refit_parity_subnormal_bounds(rng):
    """Parity must hold for fp16-SUBNORMAL bound components (|x| < 2^-14,
    incl. exactly 0.0 after the conservative 1-ULP leaf expansion) — common
    in ground-plane-at-y=0 scenes. The full collapse's truncating re-pack
    flushes such halfwords to signed zero (e.g. a flat plane's max-y packs
    0x0001 → 0x0000); collapse_apply_refit reproduces that flush (ADVICE
    r4)."""
    import jax.numpy as jnp

    from raytracer.ops.cluster import (
        build_lbvh2_clustered,
        refit_lbvh2_clustered,
    )
    from raytracer.ops.collapse import collapse_apply_refit, collapse_plan

    # every tri flat at y=0 (so internal rows carry subnormal max-y words),
    # plus sub-2^-14 x extents on a tail cluster
    n = 129
    tris = _random_tris(rng, n)
    tris[:, :, 1] = 0.0
    tris[-8:, :, 0] *= np.float32(1e-6)
    tris = tris.astype(np.float32)

    cs = build_lbvh2_clustered(tris, leaf_size=8)
    plan = collapse_plan(cs.bvh2)
    cs_r = refit_lbvh2_clustered(cs, jnp.asarray(tris))
    full = collapse_lbvh2_to_bvh4(cs_r.bvh2)
    fast = collapse_apply_refit(plan, cs_r.bvh2.bounds_u32)
    np.testing.assert_array_equal(np.asarray(fast.bounds_u32),
                                  np.asarray(full.bounds_u32))
    np.testing.assert_array_equal(np.asarray(fast.children),
                                  np.asarray(full.children))
    # sanity: the flush actually fired (internal rows carried subnormal
    # max-y halfwords before it)
    m = plan.src.shape[0]
    raw = np.asarray(cs_r.bvh2.bounds_u32)[
        np.clip(np.asarray(plan.src), 0, m - 1)]
    raw = np.where(np.asarray(plan.emitted)[:, None], raw, 0)
    assert (raw != np.asarray(fast.bounds_u32)).any()

    # Bit parity is promised for REFITTED bounds. Raw BUILD bounds keep the
    # builder's per-sweep conservative internal expansion, so the plan path
    # may be a few fp16 ULPs LARGER there — assert containment instead (the
    # render contract).
    fast0 = collapse_apply_refit(plan, cs.bvh2.bounds_u32)
    full0 = collapse_lbvh2_to_bvh4(cs.bvh2)
    np.testing.assert_array_equal(np.asarray(fast0.children),
                                  np.asarray(full0.children))
    fmn, fmx = unpack_bounds_u32(np.asarray(full0.bounds_u32))
    qmn, qmx = unpack_bounds_u32(np.asarray(fast0.bounds_u32))
    emitted = np.asarray(plan.emitted)
    assert (qmn[emitted] <= fmn[emitted]).all()
    assert (qmx[emitted] >= fmx[emitted]).all()
