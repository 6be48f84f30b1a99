"""Headline benchmark — one JSON line on stdout, detail on stderr.

Headline metric (BASELINE.md): primary Mrays/s on the Dragon-benchmark
scene (Stanford Dragon is stripped from the mirror, so the substitute is
the deterministic 871,200-triangle solid displaced blob —
procgen.make_dragon_stand_in; the reference scene is the solid dragon,
README.md:96) at 1920×1080, 1 primary ray per pixel, with the camera framed
so the model fills the frame (hit rate ≥ 0.4) and, in detail, a sparse
camera. vs_baseline is against the reference's ~75 Mrays/s (Intel UHD 600,
README.md:74-80 → BASELINE.md).

Two timings per camera, both ending in jax.block_until_ready:
  * latency — one frame per call with the camera moving every frame, as an
    interactive loop runs (p50 over the frames);
  * throughput — ``--frames`` frames with distinct cameras traced as ONE
    call over frames·H·W rays (render.trace_frames) that returns per-frame
    hit counts (data-dependent, so no work can be elided).

A run that finds no GPU fails: this is a measurement of the card.

Usage: python bench.py [--frames N] [--leaf K] [--width W] [--height H]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

BASELINE_MRAYS = 75.0  # reference iGPU, BASELINE.md
FRAMED = (0.0, 0.0, 1.15)
SPARSE = (0.0, 0.0, 2.5)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def device_info() -> dict:
    """The device every number of this run was taken on; fails off-GPU."""
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(f"this benchmark measures the GPU; JAX backend is "
                         f"{jax.default_backend()!r}")
    dev = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card.splitlines()[0]}


def headline_scene():
    """The dragon-class stand-in, through the GLB ingest layer exactly as
    the reference loads its scene (src/main.js:20-23)."""
    from raytracer.models.scene import Scene
    from raytracer.utils import procgen

    glb = Path(__file__).resolve().parent / "data" / "dragon_standin.glb"
    if not glb.exists():
        glb.parent.mkdir(parents=True, exist_ok=True)
        procgen.write_glb(glb, procgen.make_dragon_stand_in())
    t0 = time.perf_counter()
    scene = Scene().load_glb(glb, normalize=True, mode="cube")
    log(f"[bench] GLB ingest (parse+de-index+normalize): "
        f"{time.perf_counter() - t0:.3f}s")
    return scene


def run(frames: int = 32, leaf: int | None = None, width: int = 1920,
        height: int = 1080, scene=None) -> dict:
    import jax
    import jax.numpy as jnp

    from raytracer.pathtracer import PathTracer
    from raytracer.render import trace_frames

    device = device_info()
    scene = scene if scene is not None else headline_scene()
    auto = PathTracer.from_config()
    pt = PathTracer(width=width, height=height, builder=auto.builder,
                    leaf_size=leaf if leaf is not None else auto.leaf_size)
    t0 = time.perf_counter()
    pt.set_scene(scene)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pt.build_bvh(pt.triangles_data)
    build_steady_s = time.perf_counter() - t0
    nodes, trec = pt.records
    quat = jnp.asarray([0.0, 0.0, 0.0, 1.0], jnp.float32)

    @jax.jit
    def render_n(poss):
        quats = jnp.broadcast_to(quat, (poss.shape[0], 4))
        tri = trace_frames(nodes, trec, poss, quats, width, height)[4]
        return jnp.sum(tri >= 0, axis=(1, 2))

    detail = {"device": device, "resolution": [width, height],
              "num_triangles": int(scene.num_triangles),
              "builder": pt.builder, "leaf_size": pt.leaf_size,
              "build_seconds_first_run": build_s,
              "build_seconds_steady": build_steady_s,
              "build_stats": {k: v for k, v in pt.build_stats.items()
                              if isinstance(v, (int, float))}}
    for name, cam in (("framed", FRAMED), ("sparse", SPARSE)):
        pt.set_camera_position(*cam)
        t0 = time.perf_counter()
        jax.block_until_ready(pt.render())
        first_s = time.perf_counter() - t0
        lat = []
        for i in range(32):   # camera moves every frame; every frame waits
            pt.set_camera_position(cam[0] + 1e-4 * i, cam[1], cam[2])
            t0 = time.perf_counter()
            jax.block_until_ready(pt.render())
            lat.append((time.perf_counter() - t0) * 1e3)
        poss = np.asarray(cam, np.float32)[None, :] + np.stack(
            [np.linspace(0, 1e-3, frames), np.zeros(frames),
             np.zeros(frames)], axis=1).astype(np.float32)
        hits = np.asarray(render_n(poss))            # warm + compile
        reps = []
        for _ in range(3):
            t0 = time.perf_counter()
            hits = np.asarray(jax.block_until_ready(render_n(poss)))
            reps.append((time.perf_counter() - t0) / frames * 1e3)
        ms = float(np.median(reps))
        hit_rate = float(hits[0]) / (width * height)
        detail[name] = {
            "camera": list(cam), "hit_rate": hit_rate,
            "first_frame_seconds": first_s,
            "latency_ms_p50": float(np.median(lat)),
            "latency_ms_p90": float(np.percentile(lat, 90)),
            "throughput_ms_per_frame": ms,
            "throughput_reps_ms": reps,
            "mrays_per_s": width * height / ms / 1e3,
        }
        log(f"[bench] {name}: hit rate {hit_rate:.4f}, latency p50 "
            f"{np.median(lat):.3f} ms, throughput {ms:.3f} ms/frame "
            f"({width * height / ms / 1e3:.1f} Mrays/s)")
    value = detail["framed"]["mrays_per_s"]
    return {
        "metric": "primary_rays_per_second_dragon_class_1080p",
        "value": value,
        "unit": "Mrays/s",
        "vs_baseline": value / BASELINE_MRAYS,
        "detail": detail,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=32,
                    help="frames per trace call of the throughput timing")
    ap.add_argument("--leaf", type=int, default=None,
                    help="triangles per SAH cluster leaf (default: the "
                         "measured best, pathtracer.GPU_LEAF_SIZE)")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    args = ap.parse_args(argv)

    from raytracer.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    result = run(args.frames, args.leaf, args.width, args.height)
    assert result["detail"]["framed"]["hit_rate"] >= 0.4, (
        "framed camera no longer fills the frame — headline would be "
        "dishonest")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
