"""CPU reference tracer — the NumPy oracle for every render test.

Independent reimplementation of the render math (ray-gen, slab test,
Möller–Trumbore, Lambert shade, rgba8 quantize, Reinhard present) following
the reference kernels (renderer.wgsl, tonemapper.wgsl), mirroring the
reference's own oracle strategy (tests/test.py — a scalar CPU tracer with a
visited-node counter, SURVEY.md §4). Used to validate the XLA/CUDA paths
per-pixel; also provides a scalar BVH4 traversal with traversal statistics
for debugging (the test.py analog).
"""

from __future__ import annotations

import math

import numpy as np

from ..utils.fp16 import unpack_bounds_u32

LEAF_FLAG = 0x80000000
INVALID = 0xFFFFFFFF
INF = np.float32(1e30)
MT_EPS = 1e-7

LIGHT_DIR = np.array([1.0, 1.5, 1.0], np.float32)
BASE_COLOR = np.array([0.9, 0.7, 0.3], np.float32)
AMBIENT = np.float32(0.15)
MISS = np.float32(0.01)


def rotate_by_quat(v: np.ndarray, q) -> np.ndarray:
    q = np.asarray(q, np.float32)
    u, s = q[:3], q[3]
    uv = np.cross(u, v)
    uuv = np.cross(u, uv)
    return np.float32(2.0) * (s * uv + uuv) + v


def generate_rays(width, height, cam_pos, cam_quat, fov_degrees=70.0):
    focal = np.float32(1.0 / math.tan(0.5 * math.radians(fov_degrees)))
    aspect = np.float32(width / height)
    px = (np.arange(width, dtype=np.float32) + 0.5) / np.float32(width)
    py = (np.arange(height, dtype=np.float32) + 0.5) / np.float32(height)
    u = px * 2 - 1
    v = py * 2 - 1
    d = np.stack(
        [
            np.broadcast_to(u[None, :] * aspect, (height, width)),
            np.broadcast_to(v[:, None], (height, width)),
            np.full((height, width), -focal, np.float32),
        ],
        axis=-1,
    )
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    d = rotate_by_quat(d, cam_quat)
    o = np.broadcast_to(np.asarray(cam_pos, np.float32), d.shape)
    return o.astype(np.float32), d.astype(np.float32)


def moller_trumbore(o, d, v0, v1, v2):
    """Vectorized MT; shapes broadcast. Returns (t, ok)."""
    e1 = v1 - v0
    e2 = v2 - v0
    p = np.cross(d, e2)
    det = np.sum(e1 * p, axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_det = np.where(det == 0, 1.0, 1.0 / det).astype(np.float32)
        s = o - v0
        u = inv_det * np.sum(s * p, axis=-1)
        q = np.cross(s, e1)
        v = inv_det * np.sum(d * q, axis=-1)
        t = inv_det * np.sum(e2 * q, axis=-1)
    ok = (
        (np.abs(det) >= MT_EPS)
        & (u >= 0)
        & (u <= 1)
        & (v >= 0)
        & (u + v <= 1)
        & (t > MT_EPS)
    )
    return t.astype(np.float32), ok


def brute_force_trace(tris: np.ndarray, o: np.ndarray, d: np.ndarray):
    """Closest hit over all triangles. o/d (R,3) → (t (R,), tri (R,) int32)."""
    t, ok = moller_trumbore(
        o[:, None, :], d[:, None, :],
        tris[None, :, 0, :], tris[None, :, 1, :], tris[None, :, 2, :],
    )
    t = np.where(ok, t, INF)
    idx = np.argmin(t, axis=-1)
    best = t[np.arange(len(o)), idx]
    return best, np.where(best < INF, idx, -1).astype(np.int32)


def shade(tris, tri_idx, hit):
    light = LIGHT_DIR / np.linalg.norm(LIGHT_DIR)
    v = tris[np.clip(tri_idx, 0, len(tris) - 1)]
    n = np.cross(v[..., 1, :] - v[..., 0, :], v[..., 2, :] - v[..., 0, :])
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    ndotl = np.maximum(np.sum(n * light, axis=-1), 0.0)
    lit = BASE_COLOR * (AMBIENT + ndotl)[..., None]
    return np.where(hit[..., None], lit, MISS).astype(np.float32)


def quantize_rgba8(rgb: np.ndarray) -> np.ndarray:
    q = np.round(np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    a = np.full(q.shape[:-1] + (1,), 255, np.uint8)
    return np.concatenate([q, a], axis=-1)


def present(ldr_u8: np.ndarray) -> np.ndarray:
    c = ldr_u8[..., :3].astype(np.float32) / 255.0
    mapped = c / (c + 1.0)
    return quantize_rgba8(np.power(mapped, np.float32(1 / 2.2)))


def render_oracle(tris, cam_pos, cam_quat, width, height, fov_degrees=70.0):
    """Full-frame brute-force reference image → (rgba8 (H,W,4), t, tri)."""
    o, d = generate_rays(width, height, cam_pos, cam_quat, fov_degrees)
    t, tri = brute_force_trace(tris, o.reshape(-1, 3), d.reshape(-1, 3))
    t = t.reshape(height, width)
    tri = tri.reshape(height, width)
    rgb = shade(tris, tri, tri >= 0)
    return quantize_rgba8(rgb), t, tri


# ---------------------------------------------------------------------------
# Scalar BVH4 traversal with statistics (the tests/test.py analog)
# ---------------------------------------------------------------------------

def traverse_bvh4_scalar(bounds4, children4, meta4, tris, o, d, verbose=False):
    """Single-ray wide-node traversal with a visited-node counter.

    Same child-ordering semantics as ops.trace (near-first, leaf children
    intersected at the parent). Returns (t, tri, stats dict).

    ``verbose=True`` narrates every pop / child accept / reject / MT result
    step by step — the debugging surface of the reference's oracle
    (tests/test.py:149-230), which prints each traversal decision.
    """
    mn, mx = unpack_bounds_u32(bounds4)
    with np.errstate(divide="ignore"):
        inv = np.where(np.abs(d) > 1e-8, 1.0 / d, INF).astype(np.float32)
    best_t, best_tri = float(INF), -1
    visits = 0
    box_tests = 0
    tri_tests = 0

    def slab(lo, hi, limit):
        nonlocal box_tests
        box_tests += 1
        t1 = (lo - o) * inv
        t2 = (hi - o) * inv
        tmin = np.max(np.minimum(t1, t2))
        tmax = np.min(np.maximum(t1, t2))
        return (tmax >= max(tmin, 0.0)) and (tmin < limit), float(tmin)

    hit0, tmin0 = slab(mn[0], mx[0], best_t)
    if np.any(mn[0] > mx[0]) or not hit0:
        return INF, -1, {"visits": 0, "box_tests": box_tests, "tri_tests": 0}

    stack = [(0, -INF)]
    while stack:
        node, dist = stack.pop()
        if dist >= best_t:
            if verbose:
                print(f"POP  node {node:>7} dist {dist:.5f} >= best "
                      f"{best_t:.5f} -> PRUNED")
            continue
        visits += 1
        if verbose:
            print(f"POP  node {node:>7} dist {dist:.5f} best {best_t:.5f} "
                  f"stack {len(stack)}")
        kids = []
        for k in range(4):
            c = int(children4[node, k])
            if c == INVALID or c >= len(meta4):
                if verbose and c != INVALID:
                    print(f"  child[{k}] {c:>7} OUT-OF-RANGE -> reject")
                continue
            if np.any(mn[c] > mx[c]):
                if verbose:
                    print(f"  child[{k}] {c:>7} degenerate box -> reject")
                continue
            ok, tmin = slab(mn[c], mx[c], best_t)
            if not ok:
                if verbose:
                    print(f"  child[{k}] {c:>7} slab MISS (tmin {tmin:.5f})")
                continue
            cmeta = int(meta4[c])
            if cmeta & LEAF_FLAG:
                ti = cmeta & 0x7FFFFFFF
                if ti < len(tris):
                    tri_tests += 1
                    v = tris[ti]
                    t, okm = moller_trumbore(o, d, v[0], v[1], v[2])
                    if okm and t < best_t:
                        if verbose:
                            print(f"  child[{k}] {c:>7} LEAF tri {ti} "
                                  f"HIT t {t:.6f} (new best)")
                        best_t, best_tri = float(t), ti
                    elif verbose:
                        why = f"t {t:.6f} >= best" if okm else "MT reject"
                        print(f"  child[{k}] {c:>7} LEAF tri {ti} {why}")
            else:
                if verbose:
                    print(f"  child[{k}] {c:>7} slab HIT tmin {tmin:.5f} "
                          "-> queue")
                kids.append((tmin, c))
        kids.sort(key=lambda x: x[0], reverse=True)  # push far→near
        for tmin, c in kids:
            if len(stack) < 64:
                stack.append((c, tmin))
            elif verbose:
                print(f"  PUSH node {c:>7} DROPPED (stack full)")
    return (
        np.float32(best_t),
        best_tri,
        {"visits": visits, "box_tests": box_tests, "tri_tests": tri_tests},
    )
