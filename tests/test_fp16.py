"""FP16 codec tests — bit-exact parity with the two reference conversions."""

import numpy as np

from raytracer.utils import fp16


def _js_f32_to_f16(v: float) -> int:
    """Scalar transliteration of the reference truncating codec
    (PathTracer.js:42-51) used as the oracle."""
    u = np.float32(v).view(np.uint32)
    s = (int(u) >> 16) & 0x8000
    e = ((int(u) >> 23) & 0xFF) - 112
    m = (int(u) >> 13) & 0x03FF
    if e <= 0:
        return s
    if e >= 31:
        return s | 0x7C00
    return s | (e << 10) | m


def _js_f16_to_f32(h: int) -> float:
    """Scalar transliteration of the reference decoder (PathTracer.js:16-40)."""
    s = (h & 0x8000) << 16
    e = (h >> 10) & 0x1F
    m = h & 0x03FF
    if e == 0:
        if m == 0:
            return float(np.uint32(s).view(np.float32))
        e = 1
        while (m & 0x0400) == 0:
            m <<= 1
            e -= 1
        m &= 0x03FF
    elif e == 31:
        return float(np.uint32(s | 0x7F800000 | (m << 13)).view(np.float32))
    return float(np.uint32(s | ((e + 112) << 23) | (m << 13)).view(np.float32))


def test_trunc_matches_js_oracle(rng):
    vals = np.concatenate(
        [
            rng.uniform(-70000, 70000, 2000).astype(np.float32),
            rng.uniform(-1e-5, 1e-5, 500).astype(np.float32),
            np.array([0.0, -0.0, 1.0, -1.0, 65504.0, -65504.0, 1e-8, 1e9, -1e9], np.float32),
        ]
    )
    got = fp16.f32_to_f16_bits_trunc(vals)
    want = np.array([_js_f32_to_f16(float(v)) for v in vals], dtype=np.uint16)
    np.testing.assert_array_equal(got, want)


def test_decode_matches_js_oracle():
    bits = np.arange(0, 1 << 16, dtype=np.uint16)
    got = fp16.f16_bits_to_f32(bits)
    # spot-check dense ranges incl. subnormals, normals, inf
    for h in list(range(0, 64)) + list(range(0x3C00 - 8, 0x3C00 + 8)) + [0x7C00, 0xFC00, 0x8000]:
        assert got[h] == np.float32(_js_f16_to_f32(h)), hex(h)


def test_rne_vs_numpy(rng):
    vals = rng.uniform(-100, 100, 4096).astype(np.float32)
    got = fp16.f32_to_f16_bits_rne(vals)
    want = vals.astype(np.float16).view(np.uint16)
    np.testing.assert_array_equal(got, want)


def test_pack_unpack_roundtrip(rng):
    a = rng.uniform(-10, 10, 512).astype(np.float32)
    b = rng.uniform(-10, 10, 512).astype(np.float32)
    u = fp16.pack16x2_rne(a, b)
    a16 = a.astype(np.float16).astype(np.float32)
    b16 = b.astype(np.float16).astype(np.float32)
    np.testing.assert_array_equal(fp16.unpack16x2(u, 0), a16)
    np.testing.assert_array_equal(fp16.unpack16x2(u, 1), b16)


def test_increment_f16_is_one_ulp():
    # stepping up then down in ordered space returns to start
    vals = np.array([0.5, 1.0, -3.25, 1000.0, -0.0009765], dtype=np.float32)
    up = fp16.increment_f16(vals, True, 1)
    down = fp16.increment_f16(vals, False, 1)
    as16 = vals.astype(np.float16).astype(np.float32)
    assert np.all(up > as16)
    assert np.all(down < as16)
    # adjacent representable: no f16 value strictly between
    for v, u in zip(as16, up):
        mid = np.float32((v + u) / 2).astype(np.float16).astype(np.float32)
        assert mid == v or mid == u


def test_increment_crosses_zero():
    # the ordered-u16 space includes both zeros: one step below +0.0 is -0.0
    # (matching WGSL incrementF16 semantics, BVHBuilder.wgsl:63-81), and a
    # second step reaches the smallest negative subnormal
    z = np.array([0.0, 0.0], dtype=np.float32)
    below = fp16.increment_f16(z, False, np.array([1, 2]))
    assert below[0] == 0.0 and np.signbit(below[0])
    assert below[1] < 0.0


def test_bounds_pack_layout(rng):
    mn = rng.uniform(-5, 0, (16, 3)).astype(np.float32)
    mx = rng.uniform(0, 5, (16, 3)).astype(np.float32)
    b = fp16.pack_bounds_u32(mn, mx)
    assert b.shape == (16, 3) and b.dtype == np.uint32
    mn2, mx2 = fp16.unpack_bounds_u32(b)
    np.testing.assert_array_equal(mn2, mn.astype(np.float16).astype(np.float32))
    np.testing.assert_array_equal(mx2, mx.astype(np.float16).astype(np.float32))
