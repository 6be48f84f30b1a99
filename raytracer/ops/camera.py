"""Primary-ray generation — pinhole camera, quaternion orientation.

Matches the reference ray setup exactly (renderer.wgsl:364-396 +
PathTracer.js:761-762): FOV 70° vertical→focal = 1/tan(fov/2), pixel centers
at (px+0.5, py+0.5)/res mapped to NDC [-1,1], direction
normalize(p.x·aspect, p.y, −focal) rotated by the camera quaternion
(xyzw). Note the reference's texture-space convention: py grows downward, and
p.y is *not* flipped — we reproduce that exactly so images match texel-for-
texel.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

__all__ = ["rotate_by_quat", "generate_rays", "generate_rays_jittered", "subpixel_hash01", "safe_inv_dir", "INF"]

INF = jnp.float32(1e30)


def rotate_by_quat(v: jax.Array, q: jax.Array) -> jax.Array:
    """v' = 2(s·(u×v) + u×(u×v)) + v with q = [x,y,z,w]
    (renderer.wgsl:66-72)."""
    u = q[..., :3]
    s = q[..., 3:4]
    uv = jnp.cross(u, v)
    uuv = jnp.cross(u, uv)
    return jnp.float32(2.0) * (s * uv + uuv) + v


def safe_inv_dir(d: jax.Array) -> jax.Array:
    """1/d with |d|<=1e-8 clamped to INF (renderer.wgsl:74-80)."""
    return jnp.where(jnp.abs(d) > jnp.float32(1e-8), jnp.float32(1.0) / d, INF)


def generate_rays(
    width: int,
    height: int,
    cam_pos: jax.Array,
    cam_quat: jax.Array,
    fov_degrees: float = 70.0,
) -> tuple[jax.Array, jax.Array]:
    """Primary rays for every pixel → (origins (H,W,3), dirs (H,W,3)).

    Row 0 is the top image row, matching the storage-texture convention of
    the reference (renderer.wgsl:387-396).
    """
    fov = fov_degrees * math.pi / 180.0
    focal = jnp.float32(1.0 / math.tan(0.5 * fov))
    aspect = jnp.float32(width / height)

    px = (jnp.arange(width, dtype=jnp.float32) + 0.5) / jnp.float32(width)
    py = (jnp.arange(height, dtype=jnp.float32) + 0.5) / jnp.float32(height)
    u = px * 2.0 - 1.0          # (W,)
    v = py * 2.0 - 1.0          # (H,)

    dx = jnp.broadcast_to(u[None, :] * aspect, (height, width))
    dy = jnp.broadcast_to(v[:, None], (height, width))
    dz = jnp.full((height, width), -focal, dtype=jnp.float32)
    d = jnp.stack([dx, dy, dz], axis=-1)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    d = rotate_by_quat(d, jnp.asarray(cam_quat, jnp.float32)[None, None, :])

    o = jnp.broadcast_to(jnp.asarray(cam_pos, jnp.float32)[None, None, :], d.shape)
    return o, d


def subpixel_hash01(px, py, seed):
    """Counter-based subpixel jitter in [0,1): integer finalizer hash of
    (pixel-x, pixel-y, seed). Every jittered ray of the framework —
    progressive AA samples, path-traced camera waves, the sharded sample
    streams — comes from this one function, so all of them draw identical
    sample positions on every backend.
    """
    h = (px * jnp.int32(-1640531535) + py * jnp.int32(-2048144777)
         + seed * jnp.int32(-1028477379)).astype(jnp.uint32)
    h = h ^ (h >> jnp.uint32(16))
    h = h * jnp.uint32(0x7FEB352D)
    h = h ^ (h >> jnp.uint32(15))
    h = h * jnp.uint32(0x846CA68B)
    h = h ^ (h >> jnp.uint32(16))
    h24 = (h >> jnp.uint32(8)).astype(jnp.int32)
    return h24.astype(jnp.float32) * jnp.float32(2.0 ** -24)


def generate_rays_jittered(width, height, cam_pos, cam_quat, seed,
                           fov_degrees: float = 70.0):
    """Primary rays with hash-jittered subpixel offsets
    (:func:`subpixel_hash01`)."""
    px = jnp.arange(width, dtype=jnp.int32)[None, :]
    py = jnp.arange(height, dtype=jnp.int32)[:, None]
    seed = jnp.asarray(seed, jnp.int32)
    jx = subpixel_hash01(px, py, seed * 2 + 0)
    jy = subpixel_hash01(px, py, seed * 2 + 1)

    focal = jnp.float32(1.0 / math.tan(0.5 * math.radians(fov_degrees)))
    aspect = jnp.float32(width / height)
    u = (px.astype(jnp.float32) + jx) / width * 2.0 - 1.0
    v = (py.astype(jnp.float32) + jy) / height * 2.0 - 1.0
    d = jnp.stack(
        [u * aspect, jnp.broadcast_to(v, (height, width)),
         jnp.full((height, width), -focal)], axis=-1
    )
    # rsqrt-multiply, NOT d/||d||: the temporal-repair path re-generates
    # these rays and needs bit-identical directions, so a razor-edge
    # repair ray hits the same triangle
    d = d * jax.lax.rsqrt(jnp.sum(d * d, axis=-1, keepdims=True))
    d = rotate_by_quat(d, jnp.asarray(cam_quat, jnp.float32))
    o = jnp.broadcast_to(jnp.asarray(cam_pos, jnp.float32), (height, width, 3))
    return o, d
