"""ctypes bindings for the native BVH tooling (lib/libbvhtool.so).

Gives the host runtime the C++ fast paths for the two wideners when the
shared library is built (``raytracer/native/build.sh``); callers fall
back to the pure-Python oracles otherwise. This mirrors the reference's
split: a JS (host) collapse for the live pipeline + a native offline tool
(test.cpp) — here both native entry points live in one library.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
_LIB_PATHS = [
    _REPO_ROOT / "lib" / "libbvhtool.so",
]

NODE4_STRIDE = 8


def _load_lib():
    for p in _LIB_PATHS:
        if p.exists():
            lib = ctypes.CDLL(str(p))
            lib.bvh_promote_wide.restype = ctypes.c_uint32
            lib.bvh_promote_wide.argtypes = [
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint64),
            ]
            lib.bvh_collapse4.restype = ctypes.c_uint32
            lib.bvh_collapse4.argtypes = [
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32),
            ]
            try:
                lib.bvh_build_sah.restype = ctypes.c_uint32
                lib.bvh_build_sah.argtypes = [
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.c_uint32,
                ] + [ctypes.POINTER(ctypes.c_uint32)] * 5
            except AttributeError:  # stale .so from round 1
                lib.bvh_build_sah = None
            return lib
    return None


_lib = _load_lib()


def ensure_built(log=None) -> bool:
    """Build lib/libbvhtool.so via native/build.sh if it is missing or stale
    (missing a required symbol), then (re)load it.

    The round-4 driver capture regressed 2× because the bench environment
    never ran the 6.6-second build and bench.py silently fell back to the
    Morton/K=8 path — the benchmark must be self-sufficient. Returns True
    when the library is loaded with the full symbol set; False (after
    logging the compiler output) only when the compile itself fails.
    """
    global _lib
    if _lib is not None and getattr(_lib, "bvh_build_sah_clustered", None) is not None:
        return True
    import subprocess

    script = Path(__file__).resolve().parent / "build.sh"
    if log:
        log(f"[bvhtool] lib/libbvhtool.so missing or stale — building via {script}")
    try:
        proc = subprocess.run(
            ["bash", str(script)], capture_output=True, text=True, timeout=300
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        if log:
            log(f"[bvhtool] native build FAILED to run: {e}")
        return False
    if proc.returncode != 0:
        if log:
            log(f"[bvhtool] native build FAILED (rc={proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}")
        return False
    _lib = _load_lib()
    ok = _lib is not None and getattr(_lib, "bvh_build_sah_clustered", None) is not None
    if log:
        log("[bvhtool] native build OK" if ok else
            "[bvhtool] native build ran but symbols still missing")
    return ok


def available() -> bool:
    return _lib is not None


def _as_u32_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def promote_wide_native(bvh2_buf: np.ndarray) -> tuple[np.ndarray, int, int]:
    """BVH2 artifact image → BVH4_wide image via the C++ O(N) promotion.
    Returns (bvh4_buf, leaf_count, internal_count)."""
    if _lib is None:
        raise RuntimeError("libbvhtool.so not built — run raytracer/native/build.sh")
    bvh2_buf = np.ascontiguousarray(bvh2_buf, dtype=np.uint32)
    m = int(bvh2_buf[0])
    out = np.zeros(1 + m * NODE4_STRIDE, dtype=np.uint32)
    leaves = ctypes.c_uint64(0)
    internals = ctypes.c_uint64(0)
    _lib.bvh_promote_wide(
        _as_u32_ptr(bvh2_buf), _as_u32_ptr(out), ctypes.byref(leaves), ctypes.byref(internals)
    )
    return out, leaves.value, internals.value


def build_sah_native(tris: np.ndarray) -> tuple[dict, int]:
    """Binned-SAH BVH2 build (native/sah_build.cpp) → LBVH2-layout arrays.

    The quality builder the reference lacks ("BVH-only, no SAH",
    reference README.md:79). Returns ({bounds,left,right,meta,parent}, height).
    """
    if _lib is None or getattr(_lib, "bvh_build_sah", None) is None:
        raise RuntimeError(
            "libbvhtool.so with bvh_build_sah not built — run raytracer/native/build.sh"
        )
    tris = np.ascontiguousarray(tris, dtype=np.float32).reshape(-1, 9)
    n = len(tris)
    m = max(2 * n - 1, 1)
    bounds = np.zeros((m, 3), dtype=np.uint32)
    left = np.zeros(m, dtype=np.uint32)
    right = np.zeros(m, dtype=np.uint32)
    meta = np.zeros(m, dtype=np.uint32)
    parent = np.zeros(m, dtype=np.uint32)
    height = int(
        _lib.bvh_build_sah(
            tris.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_uint32(n),
            _as_u32_ptr(bounds),
            _as_u32_ptr(left),
            _as_u32_ptr(right),
            _as_u32_ptr(meta),
            _as_u32_ptr(parent),
        )
    )
    arrays = {"bounds": bounds, "left": left, "right": right, "meta": meta,
              "parent": parent}
    return arrays, height


def build_sah_clustered_native(tris: np.ndarray, leaf_size: int) -> tuple[dict, np.ndarray, int]:
    """Binned-SAH build with packed-cluster leaves of exactly ``leaf_size``
    triangles (except the global tail) — native/sah_build.cpp
    bvh_build_sah_clustered. Splits snap to multiples of K so cluster c is
    order[cK, min((c+1)K, n)), the same indexing contract as the Morton
    clustering (ops/cluster.py).

    Returns ({bounds,left,right,meta,parent} sized 2·ceil(n/K)−1,
    order (n,) u32, height)."""
    if _lib is None or getattr(_lib, "bvh_build_sah_clustered", None) is None:
        raise RuntimeError(
            "libbvhtool.so with bvh_build_sah_clustered not built — run "
            "raytracer/native/build.sh"
        )
    tris = np.ascontiguousarray(tris, dtype=np.float32).reshape(-1, 9)
    n = len(tris)
    k = max(int(leaf_size), 1)
    nc = max(-(-n // k), 1)
    m = max(2 * nc - 1, 1)
    bounds = np.zeros((m, 3), dtype=np.uint32)
    left = np.zeros(m, dtype=np.uint32)
    right = np.zeros(m, dtype=np.uint32)
    meta = np.zeros(m, dtype=np.uint32)
    parent = np.zeros(m, dtype=np.uint32)
    order = np.zeros(n, dtype=np.uint32)
    height = int(
        _lib.bvh_build_sah_clustered(
            tris.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_uint32(n),
            ctypes.c_uint32(k),
            _as_u32_ptr(bounds),
            _as_u32_ptr(left),
            _as_u32_ptr(right),
            _as_u32_ptr(meta),
            _as_u32_ptr(parent),
            _as_u32_ptr(order),
        )
    )
    arrays = {"bounds": bounds, "left": left, "right": right, "meta": meta,
              "parent": parent}
    return arrays, order, height


def collapse4_native(bvh2_buf: np.ndarray) -> np.ndarray:
    """BVH2 artifact image → collapsed BVH4 image via the C++ greedy
    re-emission collapse. Output trimmed to the emitted node count."""
    if _lib is None:
        raise RuntimeError("libbvhtool.so not built — run raytracer/native/build.sh")
    bvh2_buf = np.ascontiguousarray(bvh2_buf, dtype=np.uint32)
    m = int(bvh2_buf[0])
    out = np.zeros(1 + m * NODE4_STRIDE, dtype=np.uint32)
    n4 = int(_lib.bvh_collapse4(_as_u32_ptr(bvh2_buf), _as_u32_ptr(out)))
    return out[: 1 + n4 * NODE4_STRIDE]
