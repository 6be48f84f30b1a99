"""raytracer — a JAX path-tracing framework for NVIDIA GPUs.

From-scratch reimplementation of the capabilities of the WebGPU reference
``31415Hacker/RayTracer-public`` (see SURVEY.md for the blueprint): the
whole build+render pipeline is jitted device code, the hot traversal is one
CUDA kernel called through the XLA FFI (ops/trace.py, with a plain XLA
reference beside it), and multi-device scaling rides ``jax.sharding`` over
image rows, samples and cameras.

Public surface:
  PathTracer      — orchestrator (initialize / set_scene / render / camera)
  Scene           — GLB ingest + normalization
  FPSCamera       — WASD/mouse camera controller
"""

from .models.camera import FPSCamera
from .models.scene import Scene
from .pathtracer import PathTracer

__version__ = "0.1.0"

__all__ = ["PathTracer", "Scene", "FPSCamera", "__version__"]
