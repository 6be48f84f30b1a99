"""Stable bucket partition by matrix product — an alternative to argsort
for the wave-compaction sort.

Wavefront PT can re-sort rays between bounce waves by a small key
(alive, direction octant[, coarse origin cell]) so neighbouring rays stay
direction-coherent (render_pt.py, ``compact=True``). The key space is
tiny, and a stable partition into B small buckets needs only per-bucket
RANKS, which a triangular matrix product computes directly:

  one_hot(keys) (R, B)  →  reshape (nblk, blk, B)
  within-block exclusive ranks = strictly-lower-triangular(blk, blk) @ onehot
  block offsets = exclusive scan over per-block counts (tiny)
  position[i] = bucket_base[k_i] + block_base[blk_i, k_i] + rank[i]

The triangular matmul is ~blk·R·B MACs (at R=262k, B=16, blk=256: 17 G
MACs). Float32 accumulation is exact (counts ≤ blk ≤ 2^24).

``bucket_partition_perm`` returns the permutation that stably sorts keys
ascending — a drop-in replacement for ``jnp.argsort(keys)`` whenever keys
take < ~hundreds of distinct values.

render_pt defaults to argsort (``RT_COMPACT``); this op has not been
measured against it on the GPU (PERF.md, open questions).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["bucket_partition_perm", "bucket_positions"]


@partial(jax.jit, static_argnames=("num_buckets", "block"))
def bucket_positions(keys: jax.Array, num_buckets: int,
                     block: int = 256) -> jax.Array:
    """Destination position of each element under a stable ascending
    partition of ``keys`` (int, values in [0, num_buckets))."""
    r = keys.shape[0]
    pad = (-r) % block
    keys_p = jnp.pad(keys, (0, pad), constant_values=num_buckets - 1)
    n = keys_p.shape[0]
    nblk = n // block

    onehot = jax.nn.one_hot(keys_p.reshape(nblk, block),
                            num_buckets, dtype=jnp.float32)   # (nblk, blk, B)

    # within-block exclusive rank of each element among same-bucket elements
    tri = jnp.tril(jnp.ones((block, block), jnp.float32), k=-1)
    ranks = jnp.einsum("ij,njb->nib", tri, onehot,
                       preferred_element_type=jnp.float32)     # (nblk, blk, B)
    rank = jnp.sum(ranks * onehot, axis=-1)                    # (nblk, blk)

    counts = jnp.sum(onehot, axis=1)                           # (nblk, B)
    # base of (block, bucket) = total of all smaller buckets + same-bucket
    # counts of earlier blocks
    blk_excl = jnp.cumsum(counts, axis=0) - counts             # (nblk, B)
    bucket_tot = jnp.sum(counts, axis=0)                       # (B,)
    bucket_base = jnp.cumsum(bucket_tot) - bucket_tot          # (B,)
    base = bucket_base[None, :] + blk_excl                     # (nblk, B)
    pos = jnp.sum(base[:, None, :] * onehot, axis=-1) + rank   # (nblk, blk)
    return pos.reshape(n)[:r].astype(jnp.int32)


@partial(jax.jit, static_argnames=("num_buckets", "block"))
def bucket_partition_perm(keys: jax.Array, num_buckets: int,
                          block: int = 256) -> jax.Array:
    """Permutation ``perm`` with ``keys[perm]`` stably ascending — the
    argsort replacement for small key spaces. ``x[perm]`` gathers payloads
    into partitioned order exactly like ``x[jnp.argsort(keys)]``."""
    r = keys.shape[0]
    pos = bucket_positions(keys, num_buckets, block)
    return jnp.zeros((r,), jnp.int32).at[pos].set(
        jnp.arange(r, dtype=jnp.int32))
