"""Full benchmark suite — the five BASELINE.json configurations.

  1. Cornell-box-style low-poly scene, 256×256, 1 spp, diffuse-only, BVH2
     traversal
  2. Stanford-Bunny-class (~80k tris), 512×512, 4 spp path traced (NEE,
     1 bounce), BVH4-wide traversal
  3. Dragon-class (871k tris), 1920×1080 primary rays (the headline — the
     same measurement as bench.py, run in this process)
  4. Interior scene (Sponza-class geometry) with NEE + 4-bounce paths
  5. Dynamic scene: per-frame BVH refit + multi-camera batch rendering
     (sharded across all visible devices)

Each config prints one JSON line naming the device; stderr carries details.
Every timing ends in jax.block_until_ready. A run that finds no GPU fails.

Usage: python bench_suite.py [--config N] [--frames N]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

BASELINE_MRAYS = 75.0  # reference iGPU, BASELINE.md


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _scene(tris_np):
    from raytracer.models.scene import Scene

    s = Scene().set_triangles(tris_np)
    s._normalize_enabled, s._normalize_mode = True, "cube"
    s.normalize_mesh()
    return s


def _records(tris):
    """(nodes, TriRecords) built as PathTracer builds them on this backend
    (SAH clusters of the measured best size on the GPU)."""
    from raytracer.pathtracer import PathTracer

    pt = PathTracer.from_config()
    pt.build_bvh(np.asarray(tris))
    return pt.records


def _time_calls(fn, calls):
    """ms per call over ``calls`` back-to-back calls after one warm call."""
    import jax

    jax.block_until_ready(fn(0))
    t0 = time.perf_counter()
    jax.block_until_ready([fn(i + 1) for i in range(calls)])
    return (time.perf_counter() - t0) / calls * 1e3


def _emit(name, mrays, ms, device, extra=None):
    print(json.dumps({
        "metric": name,
        "value": mrays,
        "unit": "Mrays/s",
        "vs_baseline": mrays / BASELINE_MRAYS,
        "detail": {"ms_per_frame": ms, "device": device, **(extra or {})},
    }), flush=True)


def config1(frames, device, size=256):
    """Cornell box, 256×256, BVH2 traversal, diffuse primary shading."""
    import jax
    import jax.numpy as jnp

    from raytracer.ops.collapse import bvh2_as_bvh4
    from raytracer.ops.lbvh import build_lbvh2
    from raytracer.ops.shade import shade_lambert
    from raytracer.ops.trace import make_wide_bvh, pack_bvh
    from raytracer.render import trace_frames
    from raytracer.utils import procgen

    s = _scene(procgen.make_cornell_box())
    tris = jnp.asarray(s.triangles)
    nodes, trec = pack_bvh(make_wide_bvh(bvh2_as_bvh4(build_lbvh2(tris))), tris)
    quat = jnp.asarray([0.0, 0.0, 0.0, 1.0], jnp.float32)
    poss = jnp.asarray([[1e-3 * i, 0, 2.2] for i in range(frames)], jnp.float32)

    quats = jnp.broadcast_to(quat, (frames, 4))

    @jax.jit
    def render_n(poss_):
        # every frame's rays in one trace call; Lambert shading kept live
        _, nx, ny, nz, tri = trace_frames(nodes, trec, poss_, quats, size, size)
        rgb = shade_lambert(jnp.stack([nx, ny, nz], -1), tri >= 0)
        return jnp.sum(tri >= 0, axis=(1, 2)), jnp.sum(rgb)

    ms = _time_calls(lambda i: render_n(poss + 1e-4 * i), 3) / frames
    hits = np.asarray(render_n(poss)[0])
    _emit("cornell_256_bvh2", size * size / ms / 1e3, ms, device,
          {"tris": s.num_triangles, "batch": frames,
           "hit_rate": float(hits[0]) / (size * size)})


def _pt_config(name, tris_np, pos, frames, device, size, spp, bounces):
    """Path-traced samples (NEE + ``bounces``) of one scene, ``spp`` per
    frame, ``frames`` frames per jitted scan."""
    import jax
    import jax.numpy as jnp

    from raytracer.render_pt import pt_sample_frame

    s = _scene(tris_np)
    nodes, trec = _records(s.triangles)
    quat = jnp.asarray([0.0, 0.0, 0.0, 1.0], jnp.float32)
    pos = jnp.asarray(pos, jnp.float32)

    @jax.jit
    def render_frames(seed):
        def frame(carry, i):
            total, alive = carry
            for j in range(spp):
                img, st = pt_sample_frame(
                    nodes, trec, pos, quat,
                    jax.random.key(seed + i * spp + j), size, size,
                    bounces=bounces, stats=True)
                total = total + jnp.sum(img) / spp
                alive = alive + st["alive_rays"]
            return (total, alive), 0

        (total, alive), _ = jax.lax.scan(
            frame, (jnp.float32(0), jnp.int32(0)), jnp.arange(frames))
        return total, alive

    ms = _time_calls(lambda i: render_frames(1000 * (i + 1)), 2) / frames
    alive = int(np.asarray(render_frames(0)[1])) / frames
    rays = size * size * spp * bounces * 2   # path + shadow ray per bounce
    _emit(name, rays / ms / 1e3, ms, device,
          {"tris": s.num_triangles, "spp": spp, "bounces": bounces,
           "batch": frames, "alive_mrays_per_s": alive / ms / 1e3})


def config2(frames, device, size=512):
    """Bunny-class icosphere (~82k tris), 512×512, 4 spp, NEE + 1 bounce."""
    from raytracer.utils import procgen

    _pt_config("bunny_512_4spp_bvh4wide", procgen.make_icosphere(6),
               [0.0, 0.0, 2.8], frames, device, size, spp=4, bounces=1)


def config4(frames, device, size=512):
    """Interior (Sponza-class procedural hall), NEE + 4-bounce paths, 512×512."""
    from raytracer.utils import procgen

    # interior hall: cornell box + colonnade of boxes + high-poly centerpiece
    parts = [procgen.make_cornell_box(4.0)]
    for i in range(8):
        parts.append(procgen.make_cube(0.3) + np.array(
            [(-1.5 + 0.4 * i), -1.6, (-1.2 if i % 2 else 1.2)], np.float32))
    parts.append(procgen.make_icosphere(4, radius=0.7))
    _pt_config("interior_nee_4bounce",
               np.concatenate(parts).astype(np.float32), [0.0, 0.0, 0.8],
               frames, device, size, spp=1, bounces=4)


def config5(frames, device, size=256):
    """Dynamic: per-frame refit of deforming geometry + a camera batch
    traced in one call per device (sharded across all visible devices)."""
    import jax
    import jax.numpy as jnp

    from raytracer.ops.cluster import refit_lbvh2_clustered
    from raytracer.ops.collapse import collapse_apply_refit, collapse_plan
    from raytracer.ops.trace import make_wide_bvh, pack_bvh
    from raytracer.parallel.mesh import make_mesh, render_cameras_sharded
    from raytracer.pathtracer import PathTracer
    from raytracer.utils import procgen

    s = _scene(procgen.make_icosphere(4))
    pt = PathTracer.from_config()
    if pt.leaf_size == 1:
        pt = PathTracer(builder="lbvh", leaf_size=2)   # refit needs clusters
    pt.build_bvh(s.triangles)
    cs, k = pt._cluster, pt.leaf_size
    sweeps = pt._bvh2_height + 2 if pt._bvh2_height is not None else None
    plan = collapse_plan(cs.bvh2, sweeps=sweeps)
    tris0 = jnp.asarray(s.triangles)
    n_dev = len(jax.devices())
    mesh = make_mesh(n_dev)
    n_cam = 8 * n_dev
    poss = np.tile(np.array([0, 0, 3.0], np.float32), (n_cam, 1))
    poss[:, 0] = np.linspace(-0.3, 0.3, n_cam)
    quats = np.tile(np.array([0, 0, 0, 1], np.float32), (n_cam, 1))

    @jax.jit
    def step(phase):
        # deform (breathing sphere) → refit the cluster tree (topology and
        # cluster assignment kept) → re-pack → trace every camera
        deformed = tris0 * (1.0 + 0.1 * jnp.sin(phase))
        cs_r = refit_lbvh2_clustered(cs, deformed, num_sweeps=sweeps)
        bvh4 = collapse_apply_refit(plan, cs_r.bvh2.bounds_u32)
        nodes, trec = pack_bvh(make_wide_bvh(bvh4), cs_r.tris_sorted,
                               tri_ids=cs_r.tri_order, leaf_size=k)
        rgb = render_cameras_sharded(nodes, trec, poss, quats, size, size, mesh)
        return jnp.sum(rgb)

    ms = _time_calls(lambda i: step(jnp.float32(0.1 * i)), frames)
    _emit("dynamic_refit_multicam", size * size * n_cam / ms / 1e3, ms, device,
          {"tris": s.num_triangles, "cameras": n_cam, "devices": n_dev,
           "frames": frames, "leaf_size": k})


def config3(frames, device):
    """The headline dragon measurement (bench.py), in this process — a
    child process could not open the card this process already holds."""
    import bench

    out = bench.run(frames=frames)
    print(json.dumps(out), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=0, help="1-5, 0 = all")
    ap.add_argument("--frames", type=int, default=8)
    args = ap.parse_args(argv)

    from bench import device_info
    from raytracer.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    device = device_info()
    configs = {1: config1, 2: config2, 3: config3, 4: config4, 5: config5}
    for c in [args.config] if args.config else [1, 2, 3, 4, 5]:
        log(f"[suite] running config {c}")
        configs[c](args.frames, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
