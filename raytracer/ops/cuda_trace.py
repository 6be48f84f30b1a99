"""The CUDA traversal kernel (``native/trace_kernel.cu``) as a JAX operation.

The kernel is compiled for Hopper (``sm_90a``) with ``nvcc`` into the
git-ignored ``lib/`` at first use — or ahead of time with
``python -m raytracer.ops.cuda_trace`` — and called through the XLA foreign
function interface. The library name carries a hash of the source, so an
edited kernel (or changed compiler flags) is rebuilt, never silently
reused. The handler only enqueues
the kernel on XLA's stream. Callers go through :func:`raytracer.ops.trace.trace`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["build", "ensure_registered", "trace_cuda", "TARGET"]

TARGET = "raytracer_trace"
_SRC = Path(__file__).resolve().parents[1] / "native" / "trace_kernel.cu"
_LIB_DIR = Path(__file__).resolve().parents[2] / "lib"
_registered = False
# --fmad=false: no FMA contraction, as in XLA's compile of the reference,
# so kernel and reference agree to the last bits of t; contraction bought
# no measurable time (PERF.md)
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "--fmad=false",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-w"]


def _lib_path() -> Path:
    key = _SRC.read_bytes() + " ".join(_NVCC_FLAGS).encode()
    digest = hashlib.sha256(key).hexdigest()[:12]
    return _LIB_DIR / f"libraytrace-{digest}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin): the CUDA toolkit is needed "
                           "to build the traversal kernel")
    return found


def build(log=None) -> Path:
    """Compile the kernel library if this source has not been built yet;
    returns its path. Raises with the compiler output on failure."""
    out = _lib_path()
    if out.exists():
        return out
    _LIB_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_LIB_DIR)
    os.close(fd)
    cmd = [_nvcc(), *_NVCC_FLAGS, "-I", jax.ffi.include_dir(), "-o", tmp,
           str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed (rc={proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: concurrent builders never see a partial .so
    if log:
        log(f"[cuda_trace] built {out.name} in {time.perf_counter() - t0:.1f}s")
    return out


def ensure_registered(log=None) -> None:
    """Build (if needed), load and register the kernel's FFI target once."""
    global _registered
    if _registered:
        return
    lib = ctypes.cdll.LoadLibrary(str(build(log=log)))
    jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.RtTrace),
                                platform="CUDA")
    _registered = True


def trace_cuda(nodes, tris, o, d, t_max, *, any_hit: bool = False):
    """(R,3) rays through the kernel → (t, nx, ny, nz, tri), each (R,).

    Shapes and dtypes only — the caller (``trace``) flattens and broadcasts
    and registers the target before this lowers."""
    r = o.shape[0]
    f32 = jax.ShapeDtypeStruct((r,), jnp.float32)
    out = (f32, f32, f32, f32, jax.ShapeDtypeStruct((r,), jnp.int32))
    return jax.ffi.ffi_call(TARGET, out, vmap_method="sequential")(
        nodes, tris.rec, tris.ids, o, d, t_max, any_hit=np.bool_(any_hit))


if __name__ == "__main__":
    print(build(log=lambda m: print(m, file=sys.stderr)))
