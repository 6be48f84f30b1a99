"""Progressive path tracing — the north-star extension the reference stubs.

The shipped reference traces primary rays only, but plumbs ``frameCount``
into the UBO for never-wired progressive accumulation
(PathTracer.js:76,:783,:832-834; renderer.wgsl:18 — SURVEY.md scope note).
This module completes that design:

* **Light model** — chosen so 1-bounce direct lighting reproduces the
  shipped Lambert shade exactly in expectation: Lambert BRDF ρ/π with
  ρ = (0.9, 0.7, 0.3); directional sun along normalize(1, 1.5, 1) with
  irradiance scaled so direct = ρ·max(n·l, 0); constant ambient sky of
  radiance 0.15 (the reference's ambient term) for non-primary rays; primary
  rays that miss still show the 0.01 background (renderer.wgsl:410).
* **Sampling** — subpixel-jittered camera rays (the shared counter hash,
  ops.camera.subpixel_hash01), cosine-hemisphere BSDF sampling, next-event
  estimation to the sun (shadow rays), Russian-roulette-free fixed bounce
  budget (static unroll — XLA-friendly).
* **Waves** — each bounce is one batched trace over all rays; lanes whose
  result is not needed are made inactive (``t_max`` 0), so they cost no
  traversal (SURVEY.md §5.7: rays are the "sequence"; masking controls
  divergence).
* **Accumulation** — running mean keyed on frame_count, reset on camera
  move (handled by the PathTracer orchestrator).
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp

from .ops.camera import INF, generate_rays_jittered
from .ops.shade import MISS_COLOR
from .ops.trace import TriRecords, trace
from .render import TILE   # wave lanes are kept in TILE×TILE pixel blocks

__all__ = ["pt_sample_frame", "accumulate"]

_BASE = (0.9, 0.7, 0.3)
_SUN_DIR = (1.0, 1.5, 1.0)
_SKY = 0.15
_EPS_OFFSET = 1e-4
# wave-compaction permutation: "argsort" (XLA sort — default) or
# "partition" (bucket ranks by a triangular matmul, ops/partition.py)
_COMPACT_IMPL = os.environ.get("RT_COMPACT", "argsort")


def _sun() -> jax.Array:
    l = jnp.asarray(_SUN_DIR, jnp.float32)
    return l / jnp.linalg.norm(l)


def _onb(n: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Orthonormal basis around normal n (Frisvad-style, branchless)."""
    s = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = jnp.stack(
        [1.0 + s * n[..., 0] ** 2 * a, s * b, -s * n[..., 0]], axis=-1
    )
    bt = jnp.stack([b, s + n[..., 1] ** 2 * a, -n[..., 1]], axis=-1)
    return t, bt


def _cosine_sample(n: jax.Array, u1: jax.Array, u2: jax.Array) -> jax.Array:
    """Cosine-weighted hemisphere direction around n."""
    r = jnp.sqrt(u1)
    phi = 2.0 * jnp.pi * u2
    x = r * jnp.cos(phi)
    y = r * jnp.sin(phi)
    z = jnp.sqrt(jnp.maximum(1.0 - u1, 0.0))
    t, bt = _onb(n)
    return t * x[..., None] + bt * y[..., None] + n * z[..., None]


def _tile_order(width: int, height: int):
    """Lane → pixel permutation that groups lanes by TILE×TILE pixel block,
    so consecutive lanes trace neighbouring pixels; the final
    ``.at[pix].set`` scatter restores pixel positions. Partial edge tiles
    simply pack fewer lanes per block.
    """
    import numpy as np

    idx = np.arange(height * width, dtype=np.int32).reshape(height, width)
    blocks = [idx[y:y + TILE, x:x + TILE].ravel()
              for y in range(0, height, TILE)
              for x in range(0, width, TILE)]
    return np.concatenate(blocks)


def _img_to_lanes(img, width: int, height: int):
    """(H, W[, C]) image → flat lane order per ``_tile_order``."""
    ch = img.shape[2:]
    if width % TILE == 0 and height % TILE == 0:
        a = img.reshape(height // TILE, TILE, width // TILE, TILE, *ch)
        return a.transpose(0, 2, 1, 3, *range(4, 4 + len(ch))).reshape(
            height * width, *ch)
    flat = img.reshape(height * width, *ch)
    return flat[jnp.asarray(_tile_order(width, height))]


def _lanes_to_img(lanes, width: int, height: int):
    """Inverse of :func:`_img_to_lanes` for TILE-aligned frames — a pure
    reshape/transpose, no (H·W) scatter."""
    ch = lanes.shape[1:]
    a = lanes.reshape(height // TILE, width // TILE, TILE, TILE, *ch)
    return a.transpose(0, 2, 1, 3, *range(4, 4 + len(ch))).reshape(
        height, width, *ch)


def _trace(nodes, tris, o, d, active, reference):
    """One closest-hit wave → (t, tri, normals flipped to face the ray);
    inactive lanes are not traced."""
    t, nx, ny, nz, tri = trace(nodes, tris, o, d, reference=reference,
                               t_max=jnp.where(active, INF, 0.0))
    n = jnp.stack([nx, ny, nz], axis=-1)
    flip = jnp.sign(-jnp.sum(n * d, axis=-1, keepdims=True))
    return t, tri, n * jnp.where(flip == 0.0, 1.0, flip)


def _occluded(nodes, tris, o, d, active, reference):
    """NEE shadow query: True where an active ray hits anything (any-hit —
    a ray stops at its first accepted intersection)."""
    _, _, _, _, tri = trace(nodes, tris, o, d, any_hit=True,
                            reference=reference,
                            t_max=jnp.where(active, INF, 0.0))
    return tri >= 0


@partial(
    jax.jit,
    static_argnames=("width", "height", "bounces", "fov_degrees", "compact",
                     "stats", "reference"),
)
def pt_sample_frame(
    nodes: jax.Array,
    tris: TriRecords,
    cam_pos: jax.Array,
    cam_quat: jax.Array,
    key: jax.Array,
    width: int,
    height: int,
    bounces: int = 3,
    fov_degrees: float = 70.0,
    compact: bool = False,
    stats: bool = False,
    reference: bool = False,
):
    """One progressive sample: jittered primary rays + path-traced bounces.

    ``compact=True`` re-sorts surviving rays between bounce waves by
    (alive, direction octant, origin Morton code) so neighbouring lanes
    stay spatially coherent after the first bounce scrambles them
    (SURVEY.md §5.7's wavefront compaction). Costs one argsort + gathers
    per wave. ``reference=True`` traces every wave with the XLA reference
    (ops.trace.trace), for comparing the estimator with the kernel's.

    Returns linear radiance (H, W, 3) float32.
    """
    r = width * height
    keys = jax.random.split(key, 1 + 2 * bounces)

    # camera wave: hash-jittered subpixel positions seeded from the key
    pseed = jax.random.randint(keys[0], (), 0, 1 << 22)
    o2, d2 = generate_rays_jittered(width, height, cam_pos, cam_quat, pseed,
                                    fov_degrees)
    o = _img_to_lanes(o2, width, height)
    d = _img_to_lanes(d2, width, height)

    sun = _sun()
    base = jnp.asarray(_BASE, jnp.float32)

    radiance = jnp.zeros((r, 3), jnp.float32)
    throughput = jnp.ones((r, 3), jnp.float32)
    alive = jnp.ones((r,), bool)
    # ray → pixel: lanes start in tile-block order (see _tile_order) and are
    # further permuted by compaction; the final scatter restores pixels
    pix = jnp.asarray(_tile_order(width, height))
    alive_rays = jnp.int32(0)   # honest ray accounting: lanes that MATTER
    lane_rays = jnp.int32(0)    # lanes in the waves (incl. inactive)

    for b in range(bounces):
        # path wave and NEE wave; alive accounting counts only the lanes
        # whose result is used (alive paths, and shadow rays for lanes that
        # hit a surface facing the sun)
        lane_rays = lane_rays + jnp.int32(2 * r)
        alive_rays = alive_rays + jnp.sum(alive, dtype=jnp.int32)
        t, tri, n = _trace(nodes, tris, o, d, alive, reference)
        hit = (tri >= 0) & alive
        miss = ~(tri >= 0) & alive

        # miss → environment: dark background for camera rays, ambient sky after
        env = jnp.float32(MISS_COLOR) if b == 0 else jnp.float32(_SKY)
        radiance = radiance + jnp.where(
            miss[:, None], throughput * env, 0.0
        )

        p = o + d * t[:, None] + n * _EPS_OFFSET

        # next-event estimation: any-hit shadow ray toward the sun, only
        # for lanes whose surface faces it (direct ∝ max(n·l, 0))
        ndotl = jnp.maximum(jnp.sum(n * sun, axis=-1), 0.0)
        nee_rel = hit & (ndotl > 0.0)
        alive_rays = alive_rays + jnp.sum(nee_rel, dtype=jnp.int32)
        occ = _occluded(nodes, tris, p, jnp.broadcast_to(sun, p.shape),
                        nee_rel, reference)
        lit = ~occ
        direct = base[None, :] * (ndotl * lit)[:, None]
        radiance = radiance + jnp.where(hit[:, None], throughput * direct, 0.0)

        # continue the path with a cosine sample; albedo absorbs the brdf/pdf
        u1 = jax.random.uniform(keys[1 + 2 * b], (r,))
        u2 = jax.random.uniform(keys[2 + 2 * b], (r,))
        new_d = _cosine_sample(n, u1, u2)
        throughput = jnp.where(hit[:, None], throughput * base[None, :], throughput)
        o = jnp.where(hit[:, None], p, o)
        d = jnp.where(hit[:, None], new_d, d)
        alive = hit

        if compact and b < bounces - 1:
            from .ops.morton import morton3d

            # dead rays sink to the end; live rays cluster by direction
            # octant then coarse origin cell (scene is normalized ≈[-1,1]).
            # Full per-lane re-sort every wave: each bounce re-samples every
            # lane's direction, so octant purity can never be preserved by
            # cheaper grouped/segmented sorts.
            q = jnp.clip((o + 2.0) * (1023.0 / 4.0), 0.0, 1023.0).astype(jnp.uint32)
            m = morton3d(q[:, 0], q[:, 1], q[:, 2])
            octant = (
                (d[:, 0] < 0).astype(jnp.uint32) * 4
                + (d[:, 1] < 0).astype(jnp.uint32) * 2
                + (d[:, 2] < 0).astype(jnp.uint32)
            )
            if _COMPACT_IMPL == "argsort":
                # full 31-bit key through XLA's sort
                key = (
                    (~alive).astype(jnp.uint32) << jnp.uint32(31)
                    | (octant << jnp.uint32(28))
                    | (m >> jnp.uint32(2))
                )
                perm = jnp.argsort(key)
            else:
                # stable bucket partition (ops/partition.py): the key space
                # that matters is tiny — (alive, octant, top Morton bits) —
                # so per-bucket ranks come from a triangular matmul
                from .ops.partition import bucket_partition_perm

                key = (
                    (~alive).astype(jnp.int32) << 7
                    | (octant.astype(jnp.int32) << 4)
                    | ((m >> jnp.uint32(26)).astype(jnp.int32) & 0xF)
                )
                perm = bucket_partition_perm(key, 256)
            o, d = o[perm], d[perm]
            radiance, throughput = radiance[perm], throughput[perm]
            alive, pix = alive[perm], pix[perm]

    # paths still alive after the last bounce collect the ambient sky
    radiance = radiance + jnp.where(alive[:, None], throughput * jnp.float32(_SKY), 0.0)
    if not compact and width % TILE == 0 and height % TILE == 0:
        # lanes never left tile-block order: undo it with a reshape instead
        # of an (H·W)-scatter
        img = _lanes_to_img(radiance, width, height)
    else:
        radiance = jnp.zeros((r, 3), jnp.float32).at[pix].set(radiance)
        img = radiance.reshape(height, width, 3)
    if stats:
        return img, {"alive_rays": alive_rays, "lane_rays": lane_rays}
    return img


@jax.jit
def accumulate(accum: jax.Array, sample: jax.Array, frame_count: jax.Array):
    """Running mean: frame_count samples already in accum, add one more."""
    n = frame_count.astype(jnp.float32)
    return (accum * n + sample) / (n + 1.0)
