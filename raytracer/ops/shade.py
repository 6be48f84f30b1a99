"""Shading, framebuffer quantization, tonemap — reference-exact constants.

* Lambert shade: fixed directional light normalize(1, 1.5, 1), base color
  (0.9, 0.7, 0.3), ambient 0.15, miss color 0.01 (renderer.wgsl:348-353,410).
  Normals are the raw geometric normal normalize(cross(e1, e2)) — not flipped
  toward the ray (renderer.wgsl:269).
* Framebuffer: rgba8unorm storage-texture semantics — round(clamp(v,0,1)·255)
  (the WGSL compute pass writes LDR into an rgba8 texture,
  PathTracer.js:163-172).
* Present: Reinhard x/(x+1) + gamma 1/2.2 applied to that LDR image
  (tonemapper.wgsl:30-40). The reference's double-tonemap quirk
  (SURVEY.md §2, tonemapper row) is preserved in `present_frame` for parity;
  `render_hdr`-style pipelines can tonemap true radiance instead.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = [
    "triangle_normals",
    "shade_lambert",
    "quantize_rgba8",
    "downscale_rgb8",
    "present_frame",
    "MISS_COLOR",
]

_LIGHT_DIR = (1.0, 1.5, 1.0)
_BASE_COLOR = (0.9, 0.7, 0.3)
_AMBIENT = 0.15
MISS_COLOR = 0.01


def triangle_normals(tris: jax.Array, tri_idx: jax.Array) -> jax.Array:
    """Geometric normal of tris[tri_idx]: normalize(cross(v1-v0, v2-v0))."""
    n_tris = tris.shape[0]
    v = tris[jnp.clip(tri_idx, 0, n_tris - 1)]
    e1 = v[..., 1, :] - v[..., 0, :]
    e2 = v[..., 2, :] - v[..., 0, :]
    n = jnp.cross(e1, e2)
    return n / jnp.linalg.norm(n, axis=-1, keepdims=True)


def shade_lambert(normals: jax.Array, hit: jax.Array) -> jax.Array:
    """(..., 3) normals + (...) hit mask → (..., 3) linear LDR color."""
    light = jnp.asarray(_LIGHT_DIR, jnp.float32)
    light = light / jnp.linalg.norm(light)
    base = jnp.asarray(_BASE_COLOR, jnp.float32)
    ndotl = jnp.maximum(jnp.sum(normals * light, axis=-1), 0.0)
    lit = base * (jnp.float32(_AMBIENT) + ndotl)[..., None]
    return jnp.where(hit[..., None], lit, jnp.float32(MISS_COLOR))


def quantize_rgba8(rgb: jax.Array) -> jax.Array:
    """(..., 3) f32 → (..., 4) uint8 with rgba8unorm store rounding."""
    q = jnp.round(jnp.clip(rgb, 0.0, 1.0) * 255.0).astype(jnp.uint8)
    alpha = jnp.full(q.shape[:-1] + (1,), 255, jnp.uint8)
    return jnp.concatenate([q, alpha], axis=-1)


@partial(jax.jit, static_argnames=("scale",))
def downscale_rgb8(rgb: jax.Array, scale: int) -> jax.Array:
    """(H, W, 3) f32 in [0,1] → (H/scale, W/scale, 3) uint8 by box filter.

    Runs ON DEVICE so bandwidth-bound consumers (the live viewer's frame
    pull) transfer scale²× fewer bytes; trailing rows/cols that don't fill
    a box are dropped."""
    h, w = rgb.shape[0] - rgb.shape[0] % scale, rgb.shape[1] - rgb.shape[1] % scale
    a = rgb[:h, :w].reshape(h // scale, scale, w // scale, scale, 3)
    m = a.mean(axis=(1, 3))
    return jnp.round(jnp.clip(m, 0.0, 1.0) * 255.0).astype(jnp.uint8)


def present_frame(ldr_u8: jax.Array) -> jax.Array:
    """Tonemap pass over the rgba8 framebuffer → display rgba8
    (tonemapper.wgsl fmain: Reinhard + gamma 1/2.2 on the sampled LDR)."""
    c = ldr_u8[..., :3].astype(jnp.float32) / 255.0
    mapped = c / (c + 1.0)
    color = jnp.power(mapped, jnp.float32(1.0 / 2.2))
    return quantize_rgba8(color)
