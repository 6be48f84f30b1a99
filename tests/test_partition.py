"""Matrix-product bucket partition (ops/partition.py) — the wave-compaction
sort."""

import numpy as np
import jax.numpy as jnp
import pytest

from raytracer.ops.partition import bucket_partition_perm, bucket_positions


@pytest.mark.parametrize("r,b", [(1000, 2), (4096, 16), (100000, 256),
                                 (257, 16)])
def test_partition_matches_stable_argsort(r, b, rng):
    keys = rng.integers(0, b, size=r).astype(np.int32)
    perm = np.asarray(bucket_partition_perm(jnp.asarray(keys), b))
    assert np.array_equal(perm, np.argsort(keys, kind="stable"))


def test_positions_are_a_permutation(rng):
    keys = rng.integers(0, 16, size=5000).astype(np.int32)
    pos = np.asarray(bucket_positions(jnp.asarray(keys), 16))
    assert sorted(pos.tolist()) == list(range(5000))
    k_sorted = keys[np.argsort(pos, kind="stable")]
    assert (np.diff(k_sorted) >= 0).all()


def test_compaction_impl_equivalence():
    """render_pt's two compaction impls order rays identically per bucket
    class: same (alive, octant, coarse-cell) grouping, stable within."""
    rng = np.random.default_rng(7)
    r = 8192
    alive = rng.random(r) < 0.7
    octant = rng.integers(0, 8, size=r).astype(np.uint32)
    m = rng.integers(0, 1 << 30, size=r).astype(np.uint32)
    key_full = ((~alive).astype(np.uint32) << 31 | (octant << 28) | (m >> 2))
    key_small = (((~alive).astype(np.int32) << 7)
                 | (octant.astype(np.int32) << 4)
                 | ((m >> 26) & 0xF).astype(np.int32))
    perm = np.asarray(bucket_partition_perm(jnp.asarray(key_small), 256))
    # the partition groups by the small key exactly and stably
    ks = key_small[perm]
    assert (np.diff(ks) >= 0).all()
    # and the small key is a prefix-coarsening of the full argsort key:
    # equal small keys <=> equal (alive, octant, top-4 Morton)
    assert np.array_equal(np.sort(ks), np.sort(key_small))
