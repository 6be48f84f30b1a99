"""Profiling / metrics utilities (SURVEY.md §5.1, §5.5).

The reference instruments with wall-clock phase timers and a DOM FPS badge.
The equivalents here:

* :class:`PhaseTimer` — named wall-clock phases; callers end each phase in
  ``jax.block_until_ready`` (JAX returns before the device finishes), or
  in :func:`sync` where a host copy is wanted anyway.
* :class:`FrameStats` — rolling FPS/Mrays/s with a 1 Hz report line (the
  src/main.js:64-68 analog) and a JSON-appendable record.
* :func:`trace_annotated` — context manager wrapping jax.profiler traces
  when a profile dir is given (no-op otherwise).
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

import numpy as np

__all__ = ["PhaseTimer", "FrameStats", "trace_annotated", "sync"]


def sync(*arrays) -> None:
    """Force completion observably: host-materialize one element per array."""
    for a in arrays:
        if hasattr(a, "addressable_shards") or hasattr(a, "device"):
            np.asarray(a).ravel()[:1]


class PhaseTimer:
    """Named wall-clock phases, printed like the reference's build report
    (PathTracer.js:745-748) and exportable as a dict."""

    def __init__(self) -> None:
        self.phases: dict[str, float] = {}
        self._start: float | None = None
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name: str, *sync_arrays):
        t0 = time.perf_counter()
        yield
        sync(*sync_arrays)
        self.phases[name] = (time.perf_counter() - t0) * 1e3

    def total_ms(self) -> float:
        """Wall time since construction — the build's end-to-end total."""
        return (time.perf_counter() - self._t0) * 1e3

    def report(self, prefix: str = "") -> None:
        for name, ms in self.phases.items():
            print(f"{prefix}{name}: {ms:.2f} ms")
        print(f"{prefix}total: {self.total_ms():.2f} ms")

    def to_dict(self) -> dict:
        return dict(self.phases)


class FrameStats:
    """Rolling frame statistics with a 1 Hz console report."""

    def __init__(self, width: int, height: int, report_every: float = 1.0) -> None:
        self.rays_per_frame = width * height
        self.report_every = report_every
        self._last = time.perf_counter()
        self._frames = 0
        self.history: list[dict] = []

    def tick(self, quiet: bool = False) -> dict | None:
        self._frames += 1
        now = time.perf_counter()
        dt = now - self._last
        if dt < self.report_every:
            return None
        fps = self._frames / dt
        rec = {
            "fps": round(fps, 2),
            "mrays_per_s": round(fps * self.rays_per_frame / 1e6, 2),
            "t": now,
        }
        self.history.append(rec)
        if not quiet:
            print(f"{rec['fps']:7.1f} FPS  {rec['mrays_per_s']:8.1f} Mrays/s")
        self._last = now
        self._frames = 0
        return rec

    def dump_json(self, path) -> None:
        Path(path).write_text(json.dumps(self.history))


@contextlib.contextmanager
def trace_annotated(profile_dir: str | None = None):
    """jax.profiler trace when a directory is given, else a no-op."""
    if profile_dir is None:
        yield
        return
    import jax

    with jax.profiler.trace(profile_dir):
        yield
