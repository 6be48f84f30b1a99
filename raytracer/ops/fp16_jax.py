"""JAX (device-side) fp16 packing ops — tracer-compatible twins of utils.fp16.

These run inside ``jit`` on the device as pure integer/float vector ops (no
host round-trip). Bit-exact with the NumPy codecs in
:mod:`raytracer.utils.fp16`, which mirror WGSL ``pack2x16float`` /
``unpack2x16float`` (reference BVHBuilder.wgsl:65,99-113) and the ordered-u16
±ULP stepping of ``incrementF16`` (BVHBuilder.wgsl:63-81).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "f32_to_f16_bits",
    "f16_bits_to_f32",
    "pack16x2",
    "unpack16x2",
    "increment_f16",
    "pack_bounds",
    "unpack_bounds",
    "pack_bounds_conservative",
]


def f32_to_f16_bits(x: jax.Array) -> jax.Array:
    """f32 → fp16 bit pattern (round-to-nearest-even), dtype uint16."""
    h = x.astype(jnp.float16)
    return jax.lax.bitcast_convert_type(h, jnp.uint16)


def f16_bits_to_f32(bits: jax.Array) -> jax.Array:
    """fp16 bit pattern (uint16/uint32 low half) → f32."""
    bits16 = bits.astype(jnp.uint16)
    return jax.lax.bitcast_convert_type(bits16, jnp.float16).astype(jnp.float32)


def pack16x2(a: jax.Array, b: jax.Array) -> jax.Array:
    """Two f32 → one u32: lo = fp16(a), hi = fp16(b) (WGSL pack2x16float)."""
    lo = f32_to_f16_bits(a).astype(jnp.uint32)
    hi = f32_to_f16_bits(b).astype(jnp.uint32)
    return lo | (hi << jnp.uint32(16))


def unpack16x2(u: jax.Array, idx: int) -> jax.Array:
    """fp16 lane idx (0=lo, 1=hi) of packed u32 → f32 (WGSL unpack2x16float)."""
    return f16_bits_to_f32((u >> jnp.uint32(16 * idx)) & jnp.uint32(0xFFFF))


def increment_f16(value: jax.Array, up: bool, iterations: int = 1) -> jax.Array:
    """Round to fp16 then step ±N ULPs in ordered-u16 space, back to f32.

    The conservative-bounds expansion of the GPU builder
    (BVHBuilder.wgsl:63-81): monotonic across ±0 and signs.
    """
    bits = f32_to_f16_bits(value).astype(jnp.uint32)
    sign = (bits & jnp.uint32(0x8000)) != 0
    ordv = jnp.where(sign, (~bits) & jnp.uint32(0xFFFF), bits ^ jnp.uint32(0x8000))
    step = jnp.uint32(iterations)
    ordv = (ordv + step if up else ordv - step) & jnp.uint32(0xFFFF)
    ord_sign = (ordv & jnp.uint32(0x8000)) != 0
    bits2 = jnp.where(ord_sign, ordv ^ jnp.uint32(0x8000), (~ordv) & jnp.uint32(0xFFFF))
    return f16_bits_to_f32(bits2)


def pack_bounds(mn: jax.Array, mx: jax.Array) -> jax.Array:
    """AABB (..., 3) min/max → (..., 3) u32 words:
    [pack(mn.x,mn.y), pack(mn.z,mx.x), pack(mx.y,mx.z)] (BVHBuilder.wgsl:99-101)."""
    b0 = pack16x2(mn[..., 0], mn[..., 1])
    b1 = pack16x2(mn[..., 2], mx[..., 0])
    b2 = pack16x2(mx[..., 1], mx[..., 2])
    return jnp.stack([b0, b1, b2], axis=-1)


def unpack_bounds(b: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(..., 3) u32 → (min, max) f32 (..., 3) (renderer.wgsl:94-99)."""
    mn = jnp.stack(
        [unpack16x2(b[..., 0], 0), unpack16x2(b[..., 0], 1), unpack16x2(b[..., 1], 0)],
        axis=-1,
    )
    mx = jnp.stack(
        [unpack16x2(b[..., 1], 1), unpack16x2(b[..., 2], 0), unpack16x2(b[..., 2], 1)],
        axis=-1,
    )
    return mn, mx


def pack_bounds_conservative(mn: jax.Array, mx: jax.Array) -> jax.Array:
    """writeBounds2 semantics (BVHBuilder.wgsl:83-102): expand min down / max
    up by exactly 1 fp16 ULP, then pack."""
    return pack_bounds(increment_f16(mn, False, 1), increment_f16(mx, True, 1))
