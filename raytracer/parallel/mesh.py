"""Multi-device scaling — jax.sharding over image rows / samples / cameras.

The reference is strictly single-GPU; its only "distributed" pattern is
artifact hand-off through files (SURVEY.md §3.4). Rendering is
embarrassingly parallel over pixels (SURVEY.md §5.8), so the scene records
are replicated (tens of MB) and the work is sharded over a 1-D device mesh;
every device traces through the same :func:`raytracer.ops.trace.trace`
entry as a single-device render. Four shardings are provided:

* :func:`render_tiles_sharded` — data-parallel pixels: each device renders
  its horizontal band; the framebuffer comes back row-sharded.
* :func:`render_spp_sharded` — samples-per-pixel parallel: each device
  renders the full frame with a different sample seed; a ``psum``/mean over
  the mesh axis accumulates radiance (the progressive-accumulation axis).
* :func:`render_cameras_sharded` — batch of cameras sharded across devices
  (BASELINE config 5's multi-camera batch); each device traces all of its
  cameras' rays in one call.
* :func:`render_pt_spp_sharded` — path-traced samples, one per device,
  mean-reduced like the spp sharding.

The mesh is a plain 1-D list of devices: on a CPU host it runs on virtual
devices (``xla_force_host_platform_device_count``); on GPUs the collectives
go to NCCL, and every card of one host reaches every other at the same rate.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.camera import generate_rays, generate_rays_jittered
from ..ops.shade import shade_lambert
from ..ops.trace import TriRecords, trace
from ..render import trace_frames

__all__ = [
    "make_mesh",
    "render_tiles_sharded",
    "render_spp_sharded",
    "render_cameras_sharded",
    "render_pt_spp_sharded",
]


def make_mesh(n_devices: int | None = None, axis: str = "tiles") -> Mesh:
    """1-D device mesh over the first n (default: all) local devices.

    Fails loudly when fewer devices exist — a silently truncated mesh makes
    every sharded computation degenerate to single-device and "pass"."""
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only {len(devs)} "
                f"device(s) are visible ({devs[0].platform}); for CPU tests "
                "set XLA_FLAGS=--xla_force_host_platform_device_count=N "
                "before the first jax import"
            )
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def _shade(nodes, tris, o, d):
    """Trace + Lambert-shade rays (..., 3) → (rgb (..., 3), t, tri)."""
    t, nx, ny, nz, tri = trace(nodes, tris, o, d)
    rgb = shade_lambert(jnp.stack([nx, ny, nz], axis=-1), tri >= 0)
    return rgb, t, tri


@partial(jax.jit, static_argnames=("width", "height", "fov_degrees", "mesh"))
def render_tiles_sharded(
    nodes: jax.Array,
    tris: TriRecords,
    cam_pos: jax.Array,
    cam_quat: jax.Array,
    width: int,
    height: int,
    mesh: Mesh,
    fov_degrees: float = 70.0,
):
    """Full frame with pixel rows sharded across the mesh's first axis.

    height must divide evenly by the mesh size (callers pad). The scene is
    replicated; each device traces only its band's rays."""
    axis = mesh.axis_names[0]
    assert height % mesh.shape[axis] == 0, "pad height to a multiple of the mesh size"
    o, d = generate_rays(width, height, cam_pos, cam_quat, fov_degrees)

    fn = jax.shard_map(
        _shade,
        mesh=mesh,
        in_specs=(P(), P(), P(axis, None, None), P(axis, None, None)),
        out_specs=(P(axis, None, None), P(axis, None), P(axis, None)),
        check_vma=False,
    )
    return fn(nodes, tris, o, d)


@partial(jax.jit, static_argnames=("width", "height", "fov_degrees", "mesh"))
def render_spp_sharded(
    nodes: jax.Array,
    tris: TriRecords,
    cam_pos: jax.Array,
    cam_quat: jax.Array,
    seeds: jax.Array,          # (n_devices,) int32 — one sample stream per device
    width: int,
    height: int,
    mesh: Mesh,
    fov_degrees: float = 70.0,
):
    """Samples-per-pixel across devices: device i draws the SAME
    hash-jittered subpixel sample stream as single-device progressive frame
    seeds[i] (ops.camera.subpixel_hash01), and the mesh-mean radiance comes
    back via psum. n devices therefore accumulate exactly n frames of the
    single-device progressive stream."""
    axis = mesh.axis_names[0]
    n = mesh.shape[axis]

    def shard_render(nodes_l, tris_l, seed_l):
        o, d = generate_rays_jittered(width, height, cam_pos, cam_quat,
                                      seed_l[0], fov_degrees)
        rgb, _, _ = _shade(nodes_l, tris_l, o, d)
        return jax.lax.psum(rgb, axis) / n

    fn = jax.shard_map(
        shard_render,
        mesh=mesh,
        in_specs=(P(), P(), P(axis)),
        out_specs=P(),
        check_vma=False,
    )
    return fn(nodes, tris, seeds)


@partial(jax.jit, static_argnames=("width", "height", "fov_degrees", "mesh"))
def render_cameras_sharded(
    nodes: jax.Array,
    tris: TriRecords,
    cam_pos_batch: jax.Array,   # (C, 3)
    cam_quat_batch: jax.Array,  # (C, 4)
    width: int,
    height: int,
    mesh: Mesh,
    fov_degrees: float = 70.0,
):
    """Multi-camera batch sharded across devices (BASELINE config 5): each
    device generates the rays of its C/n cameras and traces them in ONE
    call → (C, H, W, 3) rgb."""
    axis = mesh.axis_names[0]
    assert cam_pos_batch.shape[0] % mesh.shape[axis] == 0

    def shard_render(nodes_l, tris_l, pos_l, quat_l):
        _, nx, ny, nz, tri = trace_frames(nodes_l, tris_l, pos_l, quat_l,
                                          width, height, fov_degrees)
        return shade_lambert(jnp.stack([nx, ny, nz], axis=-1), tri >= 0)

    fn = jax.shard_map(
        shard_render,
        mesh=mesh,
        in_specs=(P(), P(), P(axis, None), P(axis, None)),
        out_specs=P(axis, None, None, None),
        check_vma=False,
    )
    return fn(nodes, tris, cam_pos_batch, cam_quat_batch)


@partial(
    jax.jit,
    static_argnames=("width", "height", "bounces", "fov_degrees", "mesh",
                     "compact"),
)
def render_pt_spp_sharded(
    nodes: jax.Array,
    tris: TriRecords,
    cam_pos: jax.Array,
    cam_quat: jax.Array,
    seeds: jax.Array,          # (n_devices,) int32
    width: int,
    height: int,
    mesh: Mesh,
    bounces: int = 2,
    fov_degrees: float = 70.0,
    compact: bool = False,
):
    """Full path-traced samples (NEE + bounces) sharded across devices:
    device i renders pt_sample_frame with key seeds[i]; the mesh-mean comes
    back via psum — n devices accumulate n progressive PT frames per step."""
    from ..render_pt import pt_sample_frame

    axis = mesh.axis_names[0]
    n = mesh.shape[axis]

    def shard_render(nodes_l, tris_l, seed_l):
        sample = pt_sample_frame(
            nodes_l, tris_l, cam_pos, cam_quat, jax.random.key(seed_l[0]),
            width, height, bounces=bounces, fov_degrees=fov_degrees,
            compact=compact,
        )
        return jax.lax.psum(sample, axis) / n

    fn = jax.shard_map(
        shard_render,
        mesh=mesh,
        in_specs=(P(), P(), P(axis)),
        out_specs=P(),
        check_vma=False,
    )
    return fn(nodes, tris, seeds)
