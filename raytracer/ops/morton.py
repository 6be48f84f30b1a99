"""Morton (Z-order) codes over triangle centroids — device-side, jittable.

Device-side replacement for the reference's CPU Morton phase
(PathTracer.js:409-481): the whole quantize→interleave→sort pipeline is
vector ops + one ``jnp.argsort``, so it runs on-device inside the fused BVH
build program instead of on the host (eliminating the upload of sorted
arrays — SURVEY.md §3.2 hot loop #2).

Semantics preserved:
* 10 bits/axis quantization of centroids against the centroid AABB with
  extents clamped to ≥1e-20 (PathTracer.js:446-448)
* ``(n * 1023) | 0`` truncation-toward-zero then clamp to [0, 1023]
  (PathTracer.js:462-464)
* bit layout code = (x << 2) | (y << 1) | z (PathTracer.js:420-425)
* stable sort by (code, triangle index) (PathTracer.js:470)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["expand_bits10", "morton3d", "morton_codes", "build_morton_and_sort"]


def expand_bits10(v: jax.Array) -> jax.Array:
    """Spread the low 10 bits of v to every 3rd bit (PathTracer.js:411-418)."""
    v = v.astype(jnp.uint32) & jnp.uint32(1023)
    v = (v | (v << jnp.uint32(16))) & jnp.uint32(0x030000FF)
    v = (v | (v << jnp.uint32(8))) & jnp.uint32(0x0300F00F)
    v = (v | (v << jnp.uint32(4))) & jnp.uint32(0x030C30C3)
    v = (v | (v << jnp.uint32(2))) & jnp.uint32(0x09249249)
    return v


def morton3d(x: jax.Array, y: jax.Array, z: jax.Array) -> jax.Array:
    """30-bit Morton code, x in bit 2, y in bit 1, z in bit 0
    (PathTracer.js:420-425)."""
    return (
        (expand_bits10(x) << jnp.uint32(2))
        | (expand_bits10(y) << jnp.uint32(1))
        | expand_bits10(z)
    )


def morton_codes(centroids: jax.Array) -> jax.Array:
    """Quantize centroids against their own AABB → 30-bit codes, shape (N,)."""
    mn = jnp.min(centroids, axis=0)
    mx = jnp.max(centroids, axis=0)
    ext = jnp.maximum(mx - mn, jnp.float32(1e-20))
    n = (centroids - mn[None, :]) / ext[None, :]
    # (n * 1023) | 0 → truncate toward zero, then clamp (PathTracer.js:462-464)
    q = jnp.clip(jnp.trunc(n * jnp.float32(1023.0)).astype(jnp.int32), 0, 1023)
    q = q.astype(jnp.uint32)
    return morton3d(q[:, 0], q[:, 1], q[:, 2])


def build_morton_and_sort(triangles: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(N,3,3) triangles → (morton_sorted u32, tri_index_sorted u32).

    Stable sort on the code gives the (code, index) tie-break of the
    reference comparator (PathTracer.js:470) for free.
    """
    centroids = jnp.mean(triangles, axis=1)
    codes = morton_codes(centroids)
    order = jnp.argsort(codes, stable=True)
    return codes[order], order.astype(jnp.uint32)
