"""Host-side BVH2→BVH4 collapse oracle — exact reference semantics.

Scalar transliteration of the reference's CPU collapse
(PathTracer.js:506-667): pre-order re-emission with greedy treelet gathering
of ≤4 grandchildren (expand the *first* internal kid repeatedly), children
recursed before the parent's bounds are merged in f32 from the children's
*decoded fp16* BVH4 bounds and re-packed with the **truncating** JS codec
(PathTracer.js:53-54 pack16x2 → f32ToF16). Leaves pass their BVH2 record
through verbatim.

Used as ground truth for the vectorized device collapse in
:mod:`raytracer.ops.collapse`, and as a host fallback. Iterative DFS so
large trees don't hit the recursion limit.
"""

from __future__ import annotations

import numpy as np

from ..utils.fp16 import pack_bounds_u32, unpack_bounds_u32

LEAF_FLAG = 0x80000000
INVALID = 0xFFFFFFFF
NODE4_STRIDE = 8


def collapse_oracle(bounds2: np.ndarray, left2: np.ndarray, right2: np.ndarray, meta2: np.ndarray):
    """Collapse an LBVH2 (SoA arrays) → BVH4 SoA (bounds_u32, children, meta).

    Returns (bounds4 (M4,3) u32, children4 (M4,4) u32, meta4 (M4,) u32).
    """
    num_nodes2 = len(meta2)
    is_leaf = (meta2 & np.uint32(LEAF_FLAG)) != 0

    def gather_kids(n: int) -> list[int]:
        kids = [int(left2[n]), int(right2[n])]
        changed = True
        while len(kids) < 4 and changed:
            changed = False
            for i, k in enumerate(kids):
                if k != INVALID and not is_leaf[k]:
                    kids[i : i + 1] = [int(left2[k]), int(right2[k])]
                    changed = True
                    break
        return kids

    bounds4: list[list[int]] = []
    children4: list[list[int]] = []
    meta4: list[int] = []
    mins: list[np.ndarray] = []
    maxs: list[np.ndarray] = []

    def emit() -> int:
        bounds4.append([0, 0, 0])
        children4.append([INVALID] * 4)
        meta4.append(0)
        mins.append(np.zeros(3, np.float32))
        maxs.append(np.zeros(3, np.float32))
        return len(meta4) - 1

    # iterative pre-order DFS: each frame is (bvh2_node, out_idx, kids, next_kid)
    root_idx = emit()
    stack = [[0, root_idx, None, 0]]
    while stack:
        frame = stack[-1]
        n, idx4, kids, next_kid = frame

        if kids is None:
            if is_leaf[n]:
                bounds4[idx4] = [int(v) for v in bounds2[n]]
                mn, mx = unpack_bounds_u32(bounds2[n])
                mins[idx4], maxs[idx4] = mn.astype(np.float32), mx.astype(np.float32)
                children4[idx4] = [INVALID] * 4
                meta4[idx4] = int(meta2[n])
                stack.pop()
                continue
            frame[2] = gather_kids(n)
            frame[3] = 0
            kids = frame[2]

        if next_kid < len(kids) and next_kid < 4:
            child_idx = emit()
            children4[idx4][next_kid] = child_idx
            frame[3] = next_kid + 1
            stack.append([kids[next_kid], child_idx, None, 0])
            continue

        # all children done: merge their final bounds in f32, truncate-pack
        mn = np.full(3, np.inf, np.float32)
        mx = np.full(3, -np.inf, np.float32)
        for ci in children4[idx4]:
            if ci != INVALID:
                mn = np.minimum(mn, mins[ci])
                mx = np.maximum(mx, maxs[ci])
        bounds4[idx4] = [int(v) for v in pack_bounds_u32(mn, mx, trunc=True)]
        mins[idx4], maxs[idx4] = mn, mx
        meta4[idx4] = 0
        stack.pop()

    return (
        np.asarray(bounds4, dtype=np.uint32).reshape(-1, 3),
        np.asarray(children4, dtype=np.uint32).reshape(-1, 4),
        np.asarray(meta4, dtype=np.uint32),
    )


def promote_wide_oracle(bounds2, left2, right2, meta2):
    """The native tool's O(N) index-preserving promotion (test.cpp:104-196):
    same node index space, bounds copied verbatim, (left,right) replaced by up
    to 4 grandchildren. Out-of-range child indices count as leaves."""
    num_nodes2 = len(meta2)
    is_leaf = (meta2 & np.uint32(LEAF_FLAG)) != 0

    def leafish(c: int) -> bool:
        return c >= num_nodes2 or bool(is_leaf[c])

    children4 = np.full((num_nodes2, 4), INVALID, dtype=np.uint32)
    meta4 = np.zeros(num_nodes2, dtype=np.uint32)
    for n in range(num_nodes2):
        if is_leaf[n]:
            meta4[n] = meta2[n]
            continue
        kids: list[int] = []
        for c in (int(left2[n]), int(right2[n])):
            if c == INVALID:
                continue
            if leafish(c):
                if len(kids) < 4:
                    kids.append(c)
            else:
                if len(kids) < 4:
                    kids.append(int(left2[c]))
                if len(kids) < 4:
                    kids.append(int(right2[c]))
        children4[n, : len(kids)] = kids
    return np.asarray(bounds2, np.uint32).copy(), children4, meta4
