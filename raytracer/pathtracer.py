"""PathTracer — the framework's main orchestrator, API-parity with the
reference class (src/libs/PathTracer.js:59-835).

Reference surface preserved (snake_case):
  initialize() / set_scene(scene) / build_bvh(triangles) / render() /
  set_camera_position(x,y,z) / set_camera_quaternion(x,y,z,w) /
  set_frame_count(n), plus the default 4-triangle tetrahedron mesh
  (PathTracer.js:79-84) and the build-phase timing report
  (PathTracer.js:745-748).

Deliberate differences (SURVEY.md §7):
  * initialize() does no device plumbing — JAX owns the device; "pipeline
    creation" is jit compilation, warmed lazily per resolution.
  * The build (BVH2 → wide BVH → packed traversal records) runs as jitted
    device programs — the reference's 4 host↔device round-trips (upload,
    CPU sort, readback, re-upload — PathTracer.js:671-749) collapse into
    device programs over one upload.
  * render() traces through ops.trace.trace — the CUDA kernel on the GPU,
    the XLA reference on the CPU; tiny scenes use the brute-force path
    (every triangle vs every ray — faster below the BVH's break-even).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .io import artifacts
from .models.scene import Scene
from .ops.collapse import (
    BVH4,
    bvh2_as_bvh4,
    collapse_lbvh2_to_bvh4,
    promote_lbvh2_to_bvh4_wide,
)
from .ops.lbvh import LBVH2, build_lbvh2
from .ops.shade import present_frame, quantize_rgba8, shade_lambert
from .ops.trace import make_wide_bvh, pack_bvh
from .render import render_ldr, render_ldr_brute, trace_frame
from .utils.profiling import PhaseTimer

__all__ = ["PathTracer", "fast_build_options"]

# leaf size of the SAH cluster tree on the GPU: the best of the K sweep
# (1, 4, 8, 16, 32) of chip_smoke.py phase 6 on the headline scene, framed
# and sparse (PERF.md)
GPU_LEAF_SIZE = 4


def fast_build_options() -> tuple[str, int]:
    """(builder, leaf_size) for the fastest configuration on this backend:
    SAH-snapped K-triangle clusters (native builder, built on first use) on
    the GPU, the reference-parity single-triangle LBVH on the CPU."""
    backend = jax.default_backend()
    if backend == "cpu":
        return "lbvh", 1
    if backend != "gpu":
        raise RuntimeError(f"no build configuration for platform {backend!r}")
    from .native import bvhtool

    build_log: list[str] = []
    if not bvhtool.ensure_built(log=build_log.append):
        raise RuntimeError("native SAH builder failed to build "
                           "(raytracer/native/build.sh):\n" + "\n".join(build_log))
    return "sah", GPU_LEAF_SIZE


_BRUTE_FORCE_MAX_TRIS = 8


def _default_tetrahedron() -> np.ndarray:
    """The reference's built-in default mesh (PathTracer.js:79-84)."""
    return np.array(
        [
            [[1, 1, 1], [-1, -1, 1], [-1, 1, -1]],
            [[1, 1, 1], [-1, 1, -1], [1, -1, -1]],
            [[1, 1, 1], [1, -1, -1], [-1, -1, 1]],
            [[-1, -1, 1], [1, -1, -1], [-1, 1, -1]],
        ],
        dtype=np.float32,
    )


class PathTracer:
    """Scene + camera + BVH state and the per-frame render entry point."""

    @classmethod
    def from_config(cls, config=None, *, builder: str | None = None,
                    leaf_size: int | None = None) -> "PathTracer":
        """Construct from a utils.config.RenderConfig (SURVEY.md §5.6's
        one-dataclass flag system; defaults are reference-identical).
        ``builder``/``leaf_size`` default to the fastest available on this
        backend (fast_build_options)."""
        from .utils.config import DEFAULT_CONFIG

        cfg = config or DEFAULT_CONFIG
        auto_builder, auto_leaf = fast_build_options()
        pt = cls(
            width=cfg.width, height=cfg.height, widener=cfg.widener,
            builder=builder if builder is not None else auto_builder,
            leaf_size=leaf_size if leaf_size is not None else auto_leaf,
        )
        pt.fov_degrees = cfg.fov_degrees
        pt.config = cfg
        return pt

    def __init__(self, width: int = 1920, height: int = 1080,
                 widener: str = "collapse", builder: str = "lbvh",
                 leaf_size: int = 1) -> None:
        if widener not in ("collapse", "collapse8", "promote", "bvh2"):
            raise ValueError(f"unknown widener {widener!r}")
        if builder not in ("lbvh", "ploc", "sah"):
            raise ValueError(f"unknown builder {builder!r}")
        if leaf_size < 1:
            raise ValueError("leaf_size must be >= 1")
        if leaf_size > 1 and builder not in ("lbvh", "sah"):
            raise ValueError("leaf_size > 1 requires the lbvh builder "
                             "(Morton-run clusters) or the sah builder "
                             "(SAH-snapped clusters)")
        self.widener = widener
        self.builder = builder
        self.leaf_size = int(leaf_size)
        self.width = int(width)
        self.height = int(height)
        self.camera_position = [0.0, 0.0, 3.5]        # PathTracer.js:67
        self.camera_quaternion = [0.0, 0.0, 0.0, 1.0]
        self.frame_count = 0
        self.fov_degrees = 70.0                        # PathTracer.js:761

        self.triangles_data: np.ndarray = _default_tetrahedron()
        self._tris_dev: jax.Array | None = None
        self._bvh2: LBVH2 | None = None
        self._bvh4_c: BVH4 | None = None
        self._wide_c = None
        self._nodes: jax.Array | None = None   # packed traversal records
        self._tri_rec = None                   # (ops.trace.TriRecords)
        self._cluster = None
        self.build_stats: dict = {}

    # _bvh4/_wide are lazy on the fused clustered path (build_bvh packs the
    # records in ONE jitted program and never materializes the
    # intermediates); consumers that do need them — checkpoints, artifact
    # dumps — trigger the compute here on first access.
    @property
    def _bvh4(self):
        if self._bvh4_c is None and self._bvh2 is not None:
            self._bvh4_c = self._widen(self._bvh2)
        return self._bvh4_c

    @_bvh4.setter
    def _bvh4(self, v):
        self._bvh4_c = v

    @property
    def _wide(self):
        if self._wide_c is None and self._bvh4 is not None:
            self._wide_c = make_wide_bvh(self._bvh4)
        return self._wide_c

    @_wide.setter
    def _wide(self, v):
        self._wide_c = v

    # -- lifecycle -------------------------------------------------------------

    def initialize(self) -> "PathTracer":
        """Build acceleration data for the current (default) mesh — the
        analog of the reference's initialize() buffer/pipeline setup."""
        self.build_bvh(self.triangles_data)
        return self

    def set_scene(self, scene: Scene) -> None:
        """Install a Scene and rebuild (PathTracer.js:751-754)."""
        self.triangles_data = scene.get_triangles()
        self.build_bvh(self.triangles_data)

    # -- BVH build --------------------------------------------------------------

    def _widen(self, bvh2):
        """Apply the configured widener (shared by build_bvh and
        load_checkpoint — restoring no longer silently switches layout)."""
        if self.widener in ("collapse", "collapse8"):
            sweeps = None
            if getattr(self, "_bvh2_height", None) is not None:
                sweeps = self._bvh2_height + 2
            if self.widener == "collapse8":
                from .ops.collapse import collapse_lbvh2_to_bvh8

                return collapse_lbvh2_to_bvh8(bvh2, sweeps=sweeps)
            return collapse_lbvh2_to_bvh4(bvh2, sweeps=sweeps)
        return {
            "promote": promote_lbvh2_to_bvh4_wide,
            "bvh2": bvh2_as_bvh4,
        }[self.widener](bvh2)

    def build_bvh(self, triangles) -> None:
        """Full on-device build with the reference's phase timing report
        (PathTracer.js:745-748), timed via utils.profiling.PhaseTimer."""
        tris = np.asarray(triangles, dtype=np.float32)
        if tris.ndim == 1:
            tris = tris.reshape(-1, 3, 3)
        self.triangles_data = tris
        n = len(tris)
        timer = PhaseTimer()

        self._tris_dev = jnp.asarray(tris)
        if n == 0:
            self._bvh2 = self._bvh4 = self._wide = None
            self._nodes = self._tri_rec = None
            self._cluster = None
            self.build_stats = {"num_triangles": 0, "total_ms": 0.0}
            return

        self._bvh2_height = None
        self._cluster = None
        self._collapse_plan = None  # new topology → new plan (refit_bvh)
        with timer.phase("lbvh2_ms"):
            if self.leaf_size > 1 and self.builder == "sah":
                from .ops.cluster import build_sah2_clustered

                self._cluster, self._bvh2_height = build_sah2_clustered(
                    self._tris_dev, self.leaf_size)
                self._bvh2 = self._cluster.bvh2
            elif self.leaf_size > 1:
                from .ops.cluster import build_lbvh2_clustered

                self._cluster = build_lbvh2_clustered(self._tris_dev,
                                                      self.leaf_size)
                self._bvh2 = self._cluster.bvh2
            elif self.builder == "ploc":
                from .ops.ploc import build_ploc2

                self._bvh2 = build_ploc2(self._tris_dev)
            elif self.builder == "sah":
                from .ops.lbvh import build_sah2

                self._bvh2, self._bvh2_height = build_sah2(tris)
            else:
                self._bvh2 = build_lbvh2(self._tris_dev)
            jax.block_until_ready(self._bvh2.bounds_u32)

        if self._cluster is not None and self.widener in ("collapse",
                                                          "collapse8"):
            # fused path: collapse→widen→pack in one jitted program;
            # _bvh4/_wide stay lazy (see properties)
            self._bvh4 = None
            self._wide = None
            timer.phases["collapse_ms"] = 0.0
            with timer.phase("widen_ms"):
                from .ops.cluster import records_pipeline

                self._nodes, self._tri_rec = records_pipeline(
                    self._cluster, height=self._bvh2_height,
                    width=8 if self.widener == "collapse8" else 4)
                jax.block_until_ready(self._nodes)
        else:
            with timer.phase("collapse_ms"):
                self._bvh4 = self._widen(self._bvh2)
                jax.block_until_ready(self._bvh4.bounds_u32)

            with timer.phase("widen_ms"):
                self._wide = make_wide_bvh(self._bvh4)
                self._pack()
                jax.block_until_ready(self._nodes)

        self.build_stats = {
            "num_triangles": n,
            "num_nodes2": self._bvh2.num_nodes,
            "num_nodes4": (int(self._bvh4_c.num_nodes)
                           if self._bvh4_c is not None else None),
            **timer.to_dict(),
            "total_ms": timer.total_ms(),
        }
        # the reference's console report (PathTracer.js:745-748)
        print(f"LBVH2 Build Time: {self.build_stats['lbvh2_ms']:.2f} ms")
        print(f"BVH Collapse Time: {self.build_stats['collapse_ms']:.2f} ms")
        print(f"Widen/Upload Time: {self.build_stats['widen_ms']:.2f} ms")
        print(f"BVH Build Time: {self.build_stats['total_ms']:.2f} ms")

    def refit_bvh(self, triangles) -> None:
        """Refit the existing BVH to deformed geometry — same triangle count,
        moved vertices — instead of rebuilding.

        The reference has no refit: every deformation pays the full rebuild
        (PathTracer.js:671-749, seconds per frame). Here topology, cluster
        assignment, AND the BVH2→BVH4 collapse decisions all survive a
        deformation, so a refit is one bottom-up bounds sweep
        (ops/cluster.py::refit_lbvh2_clustered) plus a static bounds gather
        (ops/collapse.py::collapse_apply_refit — bit-identical to the full
        collapse, tests/test_collapse.py) and a records refresh. Falls back
        to build_bvh when the tree can't be reused (different triangle
        count, non-clustered build, or a non-collapse widener)."""
        tris = np.asarray(triangles, dtype=np.float32)
        if tris.ndim == 1:
            tris = tris.reshape(-1, 3, 3)
        if (self._cluster is None or self.widener != "collapse"
                or self._bvh2 is None
                or len(tris) != len(self.triangles_data)):
            self.build_bvh(tris)
            return
        from .ops.cluster import refit_lbvh2_clustered
        from .ops.collapse import collapse_apply_refit, collapse_plan

        timer = PhaseTimer()
        sweeps = (self._bvh2_height + 2
                  if self._bvh2_height is not None else None)
        if getattr(self, "_collapse_plan", None) is None:
            with timer.phase("plan_ms"):
                self._collapse_plan = collapse_plan(self._bvh2, sweeps=sweeps)
        with timer.phase("refit_ms"):
            cs_r = refit_lbvh2_clustered(self._cluster, jnp.asarray(tris),
                                         num_sweeps=sweeps)
            self._cluster = cs_r
            self._bvh2 = cs_r.bvh2
            self._bvh4 = collapse_apply_refit(self._collapse_plan,
                                              cs_r.bvh2.bounds_u32)
            self._wide = make_wide_bvh(self._bvh4)
            self._pack()
            jax.block_until_ready(self._nodes)
        self.triangles_data = tris
        self._tris_dev = jnp.asarray(tris)
        self.build_stats = {**self.build_stats, **timer.to_dict()}

    def _pack(self) -> None:
        """Packed traversal records (ops.trace.pack_bvh) from the wide
        BVH — cluster-aware."""
        if self._cluster is not None:
            self._nodes, self._tri_rec = pack_bvh(
                self._wide, self._cluster.tris_sorted,
                tri_ids=self._cluster.tri_order, leaf_size=self.leaf_size)
        else:
            self._nodes, self._tri_rec = pack_bvh(self._wide, self._tris_dev)

    @property
    def records(self):
        """(nodes, TriRecords) of the current build — the arrays every
        ops.trace.trace call of this tracer reads."""
        return self._nodes, self._tri_rec

    # -- rendering ---------------------------------------------------------------

    def _render_planes(self):
        """(rgb, t, tri) planes for the current frame."""
        pos = jnp.asarray(self.camera_position, jnp.float32)
        quat = jnp.asarray(self.camera_quaternion, jnp.float32)
        w, h = self.width, self.height
        if len(self.triangles_data) <= _BRUTE_FORCE_MAX_TRIS:
            return render_ldr_brute(self._tris_dev, pos, quat, w, h,
                                    self.fov_degrees)
        return render_ldr(self._nodes, self._tri_rec, pos, quat, w, h,
                          self.fov_degrees)

    def render(self) -> jax.Array:
        """One frame → rgba8 framebuffer (H,W,4) — the storage-texture image
        of the reference's compute pass (renderer.wgsl main)."""
        rgb, _, _ = self._render_planes()
        return quantize_rgba8(rgb)

    def render_presented(self) -> jax.Array:
        """render() + the tonemap present pass (tonemapper.wgsl)."""
        return present_frame(self.render())

    def render_stream(self, scale: int = 2) -> jax.Array:
        """One frame → scale×-box-filtered (H/s, W/s, 3) uint8, ON DEVICE.

        Downscaling before the device→host transfer cuts the pulled bytes
        scale²×·(3/4) for bandwidth-bound consumers such as the live
        viewer; the browser upscales the <img> (the reference letterboxes
        its canvas the same way, public/app/styles.css)."""
        from .ops.shade import downscale_rgb8

        rgb, _, _ = self._render_planes()
        return downscale_rgb8(rgb, int(scale))

    # -- progressive path tracing (the frameCount scaffolding completed) -----------

    def render_progressive(self, bounces: int = 3) -> jax.Array:
        """One progressive sample accumulated into the running-mean buffer.

        The accumulation resets whenever the camera moves — the behavior the
        reference's frameCount plumbing points at (PathTracer.js:76,:783).
        Returns the current HDR mean radiance (H, W, 3) float32.
        """
        from .render_pt import accumulate, pt_sample_frame

        cam_sig = (tuple(self.camera_position), tuple(self.camera_quaternion))
        if getattr(self, "_accum_sig", None) != cam_sig:
            self._accum_sig = cam_sig
            self._accum = jnp.zeros((self.height, self.width, 3), jnp.float32)
            self.frame_count = 0

        if bounces == 0:
            # AA-progressive: jittered primary rays with the shipped shading
            sample = self._primary_sample_jittered()
        else:
            sample = pt_sample_frame(
                self._nodes, self._tri_rec,
                jnp.asarray(self.camera_position, jnp.float32),
                jnp.asarray(self.camera_quaternion, jnp.float32),
                jax.random.key(self.frame_count), self.width, self.height,
                bounces=bounces, fov_degrees=self.fov_degrees,
            )
        self._accum = accumulate(self._accum, sample, jnp.int32(self.frame_count))
        self.frame_count += 1
        return self._accum

    def _primary_sample_jittered(self) -> jax.Array:
        """One subpixel-jittered primary-ray frame, linear radiance (H,W,3);
        sample positions come from ops.camera.subpixel_hash01."""
        _, nx, ny, nz, tri = trace_frame(
            self._nodes, self._tri_rec,
            jnp.asarray(self.camera_position, jnp.float32),
            jnp.asarray(self.camera_quaternion, jnp.float32),
            self.width, self.height, self.fov_degrees,
            jitter=True, jitter_seed=self.frame_count + 1)
        return shade_lambert(jnp.stack([nx, ny, nz], axis=-1), tri >= 0)

    def present_progressive(self) -> jax.Array:
        """Tonemap the HDR accumulation buffer → display rgba8 (true HDR
        Reinhard, not the LDR double-tonemap of the primary pipeline)."""
        c = self._accum
        mapped = c / (c + 1.0)
        return quantize_rgba8(jnp.power(mapped, jnp.float32(1.0 / 2.2)))

    # -- camera state (PathTracer.js:824-834) -------------------------------------

    def set_camera_position(self, x: float, y: float, z: float) -> None:
        self.camera_position = [x, y, z]

    def set_camera_quaternion(self, x: float, y: float, z: float, w: float) -> None:
        self.camera_quaternion = [x, y, z, w]

    def set_frame_count(self, frame_count: int) -> None:
        self.frame_count = frame_count

    # -- artifacts (SURVEY.md §5.4 checkpoint pipeline) ----------------------------

    def bvh2_artifact(self) -> np.ndarray:
        """The BVH2.bin u32 image of the current build (api.js dump path)."""
        if self._bvh2 is None:
            return np.array([0], dtype=np.uint32)
        return artifacts.bvh2_to_u32(
            np.asarray(self._bvh2.bounds_u32),
            np.asarray(self._bvh2.left),
            np.asarray(self._bvh2.right),
            np.asarray(self._bvh2.meta),
        )

    def bvh4_artifact(self) -> np.ndarray:
        """The collapsed BVH4 u32 image (stride-8 layout)."""
        if self._bvh4 is None:
            return np.array([0], dtype=np.uint32)
        n4 = int(self._bvh4.num_nodes)
        return artifacts.bvh4_to_u32(
            np.asarray(self._bvh4.bounds_u32)[:n4],
            np.asarray(self._bvh4.children)[:n4],
            np.asarray(self._bvh4.meta)[:n4],
        )

    def dump_bvh_json(self, path) -> None:
        """Working debug export (fixes the reference's broken debug surface,
        SURVEY.md §3.5)."""
        artifacts.dump_bvh_json(path, self.bvh2_artifact(), stride=6)

    def save_checkpoint(self, path) -> None:
        """Persist triangles + LBVH2 SoA so builds are resumable offline
        (first-class version of the reference's file hand-off checkpointing,
        SURVEY.md §5.4)."""
        if self._bvh2 is None:
            artifacts.save_scene_npz(path, self.triangles_data)
            return
        extra = {}
        if self._cluster is not None:
            extra["tri_order"] = np.asarray(self._cluster.tri_order)
            extra["leaf_size"] = np.asarray([self.leaf_size], np.int32)
        artifacts.save_scene_npz(
            path,
            self.triangles_data,
            bvh2_bounds=np.asarray(self._bvh2.bounds_u32),
            bvh2_left=np.asarray(self._bvh2.left),
            bvh2_right=np.asarray(self._bvh2.right),
            bvh2_meta=np.asarray(self._bvh2.meta),
            bvh2_parent=np.asarray(self._bvh2.parent),
            **extra,
        )

    def load_checkpoint(self, path) -> None:
        """Restore a checkpoint: triangles + LBVH2 are loaded verbatim (no
        rebuild); the widened/traversal layouts are re-derived on device."""
        data = artifacts.load_scene_npz(path)
        self.triangles_data = data["triangles"].reshape(-1, 3, 3)
        self._tris_dev = jnp.asarray(self.triangles_data)
        # The restored tree is a different topology: a stale CollapsePlan
        # (or height) from a previously built scene with the same triangle
        # count would pass refit_bvh's guard and silently corrupt the BVH4
        # (ADVICE r4). build_bvh resets these; checkpoint load must too.
        self._collapse_plan = None
        self._bvh2_height = None
        if "bvh2_bounds" not in data:
            self.build_bvh(self.triangles_data)
            return
        self._bvh2 = LBVH2(
            bounds_u32=jnp.asarray(data["bvh2_bounds"]),
            left=jnp.asarray(data["bvh2_left"]),
            right=jnp.asarray(data["bvh2_right"]),
            meta=jnp.asarray(data["bvh2_meta"]),
            parent=jnp.asarray(data["bvh2_parent"]),
        )
        self._cluster = None
        if "tri_order" not in data:
            # legacy/parity checkpoint (single-triangle leaves): reset
            # leaf_size so _pack and the render path agree on K=1
            # even when the tracer was constructed with a clustered default
            self.leaf_size = 1
        else:
            from .ops.cluster import ClusteredScene

            self.leaf_size = int(data["leaf_size"][0])
            order = jnp.asarray(data["tri_order"])
            self._cluster = ClusteredScene(
                bvh2=self._bvh2,
                tris_sorted=self._tris_dev[order.astype(jnp.int32)],
                tri_order=order,
                leaf_size=self.leaf_size,
            )
        self._bvh4 = self._widen(self._bvh2)
        self._wide = make_wide_bvh(self._bvh4)
        self._pack()
