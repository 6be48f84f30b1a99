#!/usr/bin/env python3
"""Smoke test of the renderer on NVIDIA GPUs: the quickest proof that the
system starts on the card, that its traversal kernel is right, and how it
compares with XLA's compile of the plain reference.

    python chip_smoke.py            # one card: phases 1-7 below
    python chip_smoke.py --cards 4  # four cards: the sharded paths only

Phases (one card), each failing loudly:
  1. device check — the card's name and power limit; a run that finds no
     GPU exits non-zero and prints no result.
  2. kernel library — built from native/trace_kernel.cu.
  3. headline scene — the 871,200-triangle dragon-class stand-in, written
     to data/ as a GLB, loaded through Scene.load_glb, built and rendered
     at 1920×1080 through PathTracer (framed and sparse cameras).
  4. parity on the card — the kernel against the XLA reference on the
     headline tree and 1080p rays (the default 4-wide tree and an 8-wide
     K=8 tree), both against brute force on a small scene, and the
     ``gpu``-marked tests of tests/ run in this process.
  5. progressive path tracing — 4 samples, 3 bounces, 81,920 triangles at
     512², and the estimator against the same estimator on the reference.
  6. kernel against XLA — traversal times per leaf size K, framed, sparse
     and one any-hit NEE wave.
  7. the last line: {"ok": true, "device": {...}}.

With ``--cards 4``: render_cameras_sharded, render_tiles_sharded and
render_pt_spp_sharded on a 1-D mesh of four cards, each compared with the
same work on one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
FRAMED = (0.0, 0.0, 1.15)    # headline camera: the model fills the frame
SPARSE = (0.0, 0.0, 2.5)
QUAT = (0.0, 0.0, 0.0, 1.0)
LEAF_SIZES = (1, 4, 8, 16, 32)
REF_CHUNK = 1 << 17          # rays per while_loop of the XLA reference


def log(msg: str = "") -> None:
    print(msg, flush=True)


def _timed(fn, reps: int) -> tuple[float, list[float]]:
    """(median ms, all ms) of ``reps`` calls after one warm call; each call
    ends in jax.block_until_ready."""
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2], times


def _throughput_ms(fn, calls: int = 20, reps: int = 3) -> float:
    """Device ms per call: ``calls`` back-to-back dispatches ended by one
    jax.block_until_ready, so host dispatch overlaps device work; the
    median of ``reps`` such loops."""
    import jax

    jax.block_until_ready(fn())
    per_call = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready([fn() for _ in range(calls)])
        per_call.append((time.perf_counter() - t0) * 1e3 / calls)
    per_call.sort()
    return per_call[len(per_call) // 2]


def _normalized(tris):
    from raytracer.models.scene import Scene

    s = Scene().set_triangles(tris)
    s._normalize_enabled, s._normalize_mode = True, "cube"
    s.normalize_mesh()
    return s


# -- phase 1 ------------------------------------------------------------------

def device_check(cards: int) -> None:
    import jax

    log(f"jax {jax.__version__}, devices {jax.devices()}")
    if jax.default_backend() != "gpu":
        raise SystemExit(f"no GPU: JAX backend is {jax.default_backend()!r}")
    if len(jax.devices()) < cards:
        raise SystemExit(f"need {cards} cards, JAX sees {len(jax.devices())}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    for line in smi.splitlines():
        log(f"card: {line}")


# -- phase 2 ------------------------------------------------------------------

def kernel_library() -> None:
    from raytracer.ops import cuda_trace

    t0 = time.perf_counter()
    path = cuda_trace.build(log=log)
    cuda_trace.ensure_registered()
    log(f"phase 2: kernel library {path.name} ready in "
        f"{time.perf_counter() - t0:.3f} s")


# -- phase 3 ------------------------------------------------------------------

def headline_scene():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytracer import PathTracer, Scene
    from raytracer.render import render_ldr, trace_frame
    from raytracer.utils import procgen
    from raytracer.utils.config import RenderConfig

    glb = REPO / "data" / "dragon_standin.glb"
    if not glb.exists():
        glb.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procgen.write_glb(glb, procgen.make_dragon_stand_in())
        log(f"wrote {glb.name} in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    scene = Scene().load_glb(glb, normalize=True, mode="cube")
    log(f"phase 3: GLB ingest {scene.num_triangles} triangles in "
        f"{time.perf_counter() - t0:.3f} s")
    assert scene.num_triangles == 871_200, scene.num_triangles

    pt = PathTracer.from_config(RenderConfig(width=1920, height=1080))
    t0 = time.perf_counter()
    pt.set_scene(scene)
    log(f"set_scene ({pt.builder}, K={pt.leaf_size}, {pt.widener}) "
        f"{time.perf_counter() - t0:.3f} s; build_stats "
        + json.dumps({k: (round(float(v), 3) if isinstance(v, float) else
                          int(v) if v is not None else None)
                      for k, v in pt.build_stats.items()}))
    nodes, trec = pt.records
    log(f"records: nodes {nodes.shape} ({nodes.nbytes / 1e6:.1f} MB), "
        f"triangles {trec.rec.shape} ({trec.rec.nbytes / 1e6:.1f} MB)")

    results = {}
    for name, pos in (("framed", FRAMED), ("sparse", SPARSE)):
        pt.set_camera_position(*pos)
        t0 = time.perf_counter()
        jax.block_until_ready(pt.render())
        first_s = time.perf_counter() - t0
        if name == "framed":
            # first frame again after dropping in-memory executables: what a
            # fresh process pays on the persistent compile cache
            jax.clear_caches()
            t0 = time.perf_counter()
            jax.block_until_ready(pt.render())
            log(f"first frame {first_s:.3f} s cold (compile), "
                f"{time.perf_counter() - t0:.3f} s after jax.clear_caches() "
                "(persistent compile cache)")
        tri = np.asarray(trace_frame(nodes, trec, jnp.asarray(pos),
                                     jnp.asarray(QUAT), 1920, 1080)[4])
        hit_rate = float((tri >= 0).mean())
        per_frame = []
        for i in range(30):   # camera moves every frame; every frame waits
            pt.set_camera_position(pos[0] + 1e-3 * i, pos[1], pos[2])
            t0 = time.perf_counter()
            jax.block_until_ready(pt.render())
            per_frame.append((time.perf_counter() - t0) * 1e3)
        per_frame.sort()
        ms = per_frame[len(per_frame) // 2]
        jax.block_until_ready(pt.render_presented())
        log(f"{name} {pos}: first frame {first_s:.3f} s, steady "
            f"{ms:.3f} ms/frame (p50 of 30, p90 {per_frame[26]:.3f}) = "
            f"{1920 * 1080 / ms / 1e3:.1f} Mrays/s, hit rate {hit_rate:.4f}")
        results[name] = (ms, hit_rate)
    assert results["framed"][1] >= 0.4, f"framed hit rate {results['framed'][1]}"

    mem = render_ldr.lower(nodes, trec, jnp.asarray(FRAMED), jnp.asarray(QUAT),
                           1920, 1080, 70.0).compile().memory_analysis()
    log(f"frame step memory_analysis: {mem}")
    log(f"peak device bytes in use: "
        f"{jax.devices()[0].memory_stats().get('peak_bytes_in_use')}")
    return scene, pt


# -- phase 4 ------------------------------------------------------------------

def _compare(name, got, want, *, any_hit_got=None, any_hit_want=None):
    """Kernel vs reference at the tolerance of ops/trace.py's contract:
    ids equal on ≥ 99.99 % of rays, a disagreement only where both found a
    hit within 1e-6 relative t; where ids agree |Δt| ≤ 1e-5·max(1, t) and
    normals within 1e-5; rgba8 within 1 LSB on ≥ 99.99 % of pixels."""
    import jax.numpy as jnp
    import numpy as np

    from raytracer.ops.shade import quantize_rgba8, shade_lambert

    g = [np.asarray(a).reshape(-1) for a in got]
    w = [np.asarray(a).reshape(-1) for a in want]
    same = g[4] == w[4]
    agree = float(same.mean())
    diff = ~same
    both = diff & (g[4] >= 0) & (w[4] >= 0)
    close = both & (np.abs(g[0] - w[0]) <= 1e-6 * np.maximum(1.0, w[0]))
    bad_diff = int(diff.sum() - close.sum())
    hit = same & (w[4] >= 0)
    dt = float((np.abs(g[0] - w[0]) / np.maximum(1.0, w[0]))[hit].max(initial=0))
    dn = float(max(np.abs(g[p] - w[p])[hit].max(initial=0) for p in (1, 2, 3)))

    def rgba(p):
        n = jnp.stack([jnp.asarray(p[1]), jnp.asarray(p[2]),
                       jnp.asarray(p[3])], -1)
        return np.asarray(quantize_rgba8(shade_lambert(n, jnp.asarray(p[4]) >= 0)))

    lsb = float((np.abs(rgba(g).astype(int) - rgba(w).astype(int)).max(-1)
                 <= 1).mean())
    log(f"{name}: rays {len(g[4])}, hit rate {float((w[4] >= 0).mean()):.4f}; "
        f"ids agree {agree:.6f} (limit >= 0.9999), disagreements {int(diff.sum())} "
        f"of which outside 1e-6 relative t {bad_diff} (limit 0); "
        f"max |dt|/max(1,t) {dt:.3e} (limit 1e-5); max |dn| {dn:.3e} "
        f"(limit 1e-5); rgba8 within 1 LSB {lsb:.6f} (limit >= 0.9999)")
    ok = agree >= 0.9999 and bad_diff == 0 and dt <= 1e-5 and dn <= 1e-5 \
        and lsb >= 0.9999
    if any_hit_got is not None:
        occ = float(((np.asarray(any_hit_got) >= 0)
                     == (np.asarray(any_hit_want) >= 0)).mean())
        log(f"{name} any-hit: occlusion flags agree {occ:.6f} (limit >= 0.9999)")
        ok = ok and occ >= 0.9999
    assert ok, f"{name}: kernel and reference disagree beyond tolerance"


def parity(pt, headline) -> None:
    import jax.numpy as jnp
    import numpy as np

    from raytracer.ops.camera import INF, generate_rays
    from raytracer.ops.cluster import build_sah2_clustered, records_pipeline
    from raytracer.ops.collapse import collapse_lbvh2_to_bvh4
    from raytracer.ops.lbvh import build_lbvh2
    from raytracer.ops.trace import (make_wide_bvh, pack_bvh, trace,
                                     trace_rays_brute, trace_reference)
    from raytracer.utils import procgen

    o, d = generate_rays(1920, 1080, jnp.asarray(FRAMED), jnp.asarray(QUAT))
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    tm = jnp.full((o.shape[0],), INF)
    cs, height = build_sah2_clustered(jnp.asarray(headline.triangles),
                                      leaf_size=8)
    for name, (nodes, trec) in (
            (f"default tree (K={pt.leaf_size}, 4-wide)", pt.records),
            ("K=8 8-wide tree", records_pipeline(cs, height=height, width=8))):
        _compare(f"phase 4: headline 1080p framed, {name}",
                 trace(nodes, trec, o, d),
                 trace_reference(nodes, trec, o, d, tm, chunk=REF_CHUNK),
                 any_hit_got=trace(nodes, trec, o, d, any_hit=True)[4],
                 any_hit_want=trace_reference(nodes, trec, o, d, tm,
                                              any_hit=True, chunk=REF_CHUNK)[4])

    tris = jnp.asarray(_normalized(procgen.make_icosphere(2)).triangles)
    nodes_s, trec_s = pack_bvh(
        make_wide_bvh(collapse_lbvh2_to_bvh4(build_lbvh2(tris))), tris)
    o, d = generate_rays(256, 256, jnp.asarray([0.15, -0.1, 2.5]),
                         jnp.asarray([0.0, 0.1, 0.0, 0.9949874]))
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    bt, btri = trace_rays_brute(tris, o, d)
    got = trace(nodes_s, trec_s, o, d)
    want = trace_reference(nodes_s, trec_s, o, d, jnp.full((o.shape[0],), INF))
    _compare("phase 4: icosphere(2) 256² kernel vs reference", got, want)
    for name, out in (("kernel", got), ("reference", want)):
        ids = float((np.asarray(out[4]) == np.asarray(btri)).mean())
        hit = np.asarray(btri) >= 0
        dt = float(np.abs(np.asarray(out[0]) - np.asarray(bt))[hit].max())
        log(f"phase 4: icosphere(2) 256² {name} vs brute force: ids agree "
            f"{ids:.6f} (limit >= 0.9999), max |dt| {dt:.3e} (limit 1e-5)")
        assert ids >= 0.9999 and dt <= 1e-5, name


def gpu_tests() -> None:
    """The ``gpu``-marked tests of tests/, in this process (a second process
    could not open the card this one holds)."""
    import os

    import pytest

    os.environ["RAYTRACER_TEST_GPU"] = "1"   # tests/conftest.py: stay on the GPU
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      str(REPO / "tests")])
    log(f"phase 4: pytest -m gpu exit code {int(rc)} in "
        f"{time.perf_counter() - t0:.1f} s")
    assert rc == pytest.ExitCode.OK, f"gpu-marked tests failed: {rc!r}"


# -- phase 5 ------------------------------------------------------------------

def progressive():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytracer import PathTracer
    from raytracer.render_pt import pt_sample_frame
    from raytracer.utils import procgen
    from raytracer.utils.config import RenderConfig

    scene = _normalized(procgen.make_icosphere(6))
    pt = PathTracer.from_config(RenderConfig(width=512, height=512))
    pt.set_scene(scene)
    pt.set_camera_position(0.0, 0.0, 2.8)
    times = []
    for _ in range(4):
        t0 = time.perf_counter()
        acc = jax.block_until_ready(pt.render_progressive(bounces=3))
        times.append((time.perf_counter() - t0) * 1e3)
    acc = np.asarray(acc)
    assert acc.shape == (512, 512, 3) and np.isfinite(acc).all(), "PT not finite"
    assert acc.max() > 0
    log(f"phase 5: {scene.num_triangles} triangles 512² bounces=3: 4 samples, "
        f"ms/sample {[round(t, 3) for t in times]} (first includes compile); "
        f"mean radiance {acc.mean():.5f}, finite")

    nodes, trec = pt.records
    pos, quat = jnp.asarray([0.0, 0.0, 2.8]), jnp.asarray(QUAT)
    waves = 2 * 3
    worst = 0.0
    for s in range(4):
        key = jax.random.key(s)
        a = np.asarray(pt_sample_frame(nodes, trec, pos, quat, key, 512, 512,
                                       bounces=3))
        b = np.asarray(pt_sample_frame(nodes, trec, pos, quat, key, 512, 512,
                                       bounces=3, reference=True))
        off = float((np.abs(a - b).max(-1) > 1e-4).mean())
        worst = max(worst, off)
    log(f"phase 5: kernel vs reference estimator, same keys: worst share of "
        f"pixels off by > 1e-4 {worst:.6f} (limit {waves} waves x 1e-4 = "
        f"{waves * 1e-4:.4f})")
    assert worst <= waves * 1e-4, "PT estimator differs from the reference"
    return scene


# -- phase 6 ------------------------------------------------------------------

def kernel_vs_xla(headline, pt_scene) -> None:
    import jax
    import jax.numpy as jnp

    from raytracer.ops.camera import INF, generate_rays
    from raytracer.ops.cluster import build_sah2_clustered, records_pipeline
    from raytracer.ops.trace import trace, trace_reference
    from raytracer.render_pt import _sun

    def records(tris, k):
        t0 = time.perf_counter()
        cs, height = build_sah2_clustered(tris, leaf_size=k)
        rec = records_pipeline(cs, height=height)
        jax.block_until_ready(rec[0])
        return rec, time.perf_counter() - t0

    def pair(nodes, trec, o, d, tm, any_hit=False):
        kern = _throughput_ms(lambda: trace(nodes, trec, o, d, t_max=tm,
                                            any_hit=any_hit))
        xla = _throughput_ms(lambda: trace_reference(
            nodes, trec, o, d, tm, any_hit=any_hit, chunk=REF_CHUNK),
            calls=2, reps=1)
        return kern, xla

    quat = jnp.asarray(QUAT)
    rays = {}
    for name, pos in (("framed", FRAMED), ("sparse", SPARSE)):
        o, d = generate_rays(1920, 1080, jnp.asarray(pos), quat)
        rays[name] = (o.reshape(-1, 3), d.reshape(-1, 3))
    tm = jnp.full((1920 * 1080,), INF)

    # the NEE wave of phase 5's scene: shadow rays from primary hits
    ptris = jnp.asarray(pt_scene.triangles)
    o, d = generate_rays(512, 512, jnp.asarray([0.0, 0.0, 2.8]), quat)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)

    htris = jnp.asarray(headline.triangles)
    rows = []
    for k in LEAF_SIZES:
        (nodes, trec), build_s = records(htris, k)
        row = {"K": k, "build_s": build_s}
        for name, (ro, rd) in rays.items():
            row[name] = pair(nodes, trec, ro, rd, tm)
        (pn, ptr), _ = records(ptris, k)
        t, nx, ny, nz, tri = trace(pn, ptr, o, d)
        n = jnp.stack([nx, ny, nz], -1)
        n = n * jnp.where(jnp.sum(n * d, -1, keepdims=True) > 0, -1.0, 1.0)
        sun = _sun()
        active = (tri >= 0) & (jnp.sum(n * sun, -1) > 0)
        p = o + d * t[:, None] + n * 1e-4
        row["nee"] = pair(pn, ptr, p, jnp.broadcast_to(sun, p.shape),
                          jnp.where(active, INF, 0.0), any_hit=True)
        rows.append(row)
        log(f"phase 6: K={k} headline records {nodes.shape} built in "
            f"{build_s:.3f} s")

    log("phase 6: traversal ms per call on identical rays, back-to-back "
        "calls (kernel = CUDA via FFI, xla = XLA's compile of "
        f"trace_reference, chunk {REF_CHUNK})")
    log(f"{'K':>3} {'framed kernel':>14} {'framed xla':>11} "
        f"{'sparse kernel':>14} {'sparse xla':>11} {'NEE kernel':>11} "
        f"{'NEE xla':>9}")
    for r in rows:
        log(f"{r['K']:>3} {r['framed'][0]:>14.3f} {r['framed'][1]:>11.3f} "
            f"{r['sparse'][0]:>14.3f} {r['sparse'][1]:>11.3f} "
            f"{r['nee'][0]:>11.3f} {r['nee'][1]:>9.3f}")
    for col in ("framed", "sparse", "nee"):
        bk = min(rows, key=lambda r: r[col][0])
        bx = min(rows, key=lambda r: r[col][1])
        log(f"phase 6: {col}: best kernel K={bk['K']} {bk[col][0]:.3f} ms, "
            f"best xla K={bx['K']} {bx[col][1]:.3f} ms, "
            f"xla/kernel {bx[col][1] / bk[col][0]:.1f}x")
        assert bk[col][0] < bx[col][1], f"{col}: kernel slower than XLA"


# -- four cards -----------------------------------------------------------------

def four_cards(scene, width=1920, height=1080, pt_size=512) -> None:
    """The sharded paths on a 4-device mesh, each against the same work on
    one device; also checks that every output spans all four devices."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytracer import PathTracer
    from raytracer.parallel.mesh import (make_mesh, render_cameras_sharded,
                                         render_pt_spp_sharded,
                                         render_tiles_sharded)
    from raytracer.render import render_ldr
    from raytracer.render_pt import pt_sample_frame
    from raytracer.utils.config import RenderConfig

    mesh = make_mesh(4)
    pt = PathTracer.from_config(RenderConfig(width=width, height=height))
    pt.set_scene(scene)
    nodes, trec = pt.records
    quat = jnp.asarray(QUAT)
    framed = jnp.asarray(FRAMED)

    def devices_of(x):
        return {s.device for s in x.addressable_shards}

    # camera batch: 8 cameras, 2 per device
    n_cam = 8
    poss = np.tile(np.asarray(FRAMED, np.float32), (n_cam, 1))
    poss[:, 0] = np.linspace(-0.3, 0.3, n_cam)
    quats = np.tile(np.asarray(QUAT, np.float32), (n_cam, 1))
    out = render_cameras_sharded(nodes, trec, poss, quats, width, height, mesh)
    assert len(devices_of(out)) == 4, devices_of(out)
    single = np.stack([np.asarray(render_ldr(
        nodes, trec, jnp.asarray(p), quat, width, height)[0]) for p in poss])
    np.testing.assert_array_equal(np.asarray(out), single)
    ms_s, _ = _timed(lambda: render_cameras_sharded(
        nodes, trec, poss, quats, width, height, mesh), 5)
    ms_1, _ = _timed(lambda: [render_ldr(nodes, trec, jnp.asarray(p), quat,
                                         width, height)[0] for p in poss], 5)
    log(f"cards 4: render_cameras_sharded {n_cam} x {width}x{height} equals "
        f"one device; {ms_s:.3f} ms on 4 devices vs {ms_1:.3f} ms on one")

    # row bands of one frame
    rgb, t, tri = render_tiles_sharded(nodes, trec, framed, quat, width,
                                       height, mesh)
    assert len(devices_of(rgb)) == 4, devices_of(rgb)
    rgb1, t1, tri1 = render_ldr(nodes, trec, framed, quat, width, height)
    np.testing.assert_array_equal(np.asarray(tri), np.asarray(tri1))
    np.testing.assert_array_equal(np.asarray(t), np.asarray(t1))
    np.testing.assert_array_equal(np.asarray(rgb), np.asarray(rgb1))
    ms_s, _ = _timed(lambda: render_tiles_sharded(
        nodes, trec, framed, quat, width, height, mesh), 10)
    ms_1, _ = _timed(lambda: render_ldr(nodes, trec, framed, quat, width,
                                        height), 10)
    log(f"cards 4: render_tiles_sharded {width}x{height} equals one device; "
        f"{ms_s:.3f} ms on 4 devices vs {ms_1:.3f} ms on one")

    # path-traced samples, one per device, mean over the mesh
    seeds = jnp.arange(4, dtype=jnp.int32)
    pos = jnp.asarray([0.0, 0.0, 1.6])
    acc = render_pt_spp_sharded(nodes, trec, pos, quat, seeds, pt_size,
                                pt_size, mesh, bounces=3)
    ref = np.mean([np.asarray(pt_sample_frame(
        nodes, trec, pos, quat, jax.random.key(s), pt_size, pt_size,
        bounces=3)) for s in range(4)], axis=0)
    err = float(np.abs(np.asarray(acc) - ref).max())
    ms_s, _ = _timed(lambda: render_pt_spp_sharded(
        nodes, trec, pos, quat, seeds, pt_size, pt_size, mesh, bounces=3), 3)
    log(f"cards 4: render_pt_spp_sharded 4 x {pt_size}² bounces=3: max |diff| "
        f"vs mean of 4 one-device samples {err:.3e} (limit 1e-5); "
        f"{ms_s:.3f} ms on 4 devices")
    assert np.isfinite(np.asarray(acc)).all() and err <= 1e-5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded paths on four cards")
    args = ap.parse_args(argv)

    import jax

    from raytracer.utils.compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    t_start = time.perf_counter()
    device_check(args.cards)
    kernel_library()
    if args.cards == 4:
        from raytracer.models.scene import Scene

        glb = REPO / "data" / "dragon_standin.glb"
        if not glb.exists():
            from raytracer.utils import procgen

            glb.parent.mkdir(parents=True, exist_ok=True)
            procgen.write_glb(glb, procgen.make_dragon_stand_in())
        four_cards(Scene().load_glb(glb, normalize=True, mode="cube"))
    else:
        headline, pt = headline_scene()
        parity(pt, headline)
        gpu_tests()
        pt_scene = progressive()
        kernel_vs_xla(headline, pt_scene)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
