"""Tracing & timing — the nvToolsExt / BenchmarkTimer analog.

The reference wraps every render pass in Nsight nvtx ranges
(``RenderEngine/helpers/nsight.h:12-199``, used around each launch in
``OptixRenderer.cpp:520-672``) and times with a pausable wall timer
(``util/BenchmarkTimer.h:11-29``) plus ``sutilCurrentTime``. Under JAX the
equivalents are:

- ``pass_scope(name)`` — ``jax.named_scope`` inside traced code, so each
  render pass is a named region in the XLA HLO and shows up as such in
  profiler traces and compiler dumps (the nvtx::ScopedRange analog);
- ``trace(logdir)`` — ``jax.profiler.trace`` around a host-side region,
  producing a TensorBoard/Perfetto trace of device activity (the Nsight
  capture analog); no-ops gracefully if profiling is unavailable;
- ``BenchmarkTimer`` — the reference's pausable wall timer, used by the
  render loop for the render-vs-total efficiency stat the server piggybacks
  on result packets (``Server/server/RenderServer.cpp:136-149``).
"""
from __future__ import annotations

import contextlib
import time

import jax


def pass_scope(name: str):
    """Named region for a render pass inside jitted code
    (nvtx::ScopedRange analog, helpers/nsight.h)."""
    return jax.named_scope(name)


@contextlib.contextmanager
def trace(logdir: str | None):
    """Capture a device profile into ``logdir`` (view with TensorBoard or
    Perfetto). ``logdir=None`` disables — the same code path runs untraced."""
    if logdir is None:
        yield
        return
    try:
        jax.profiler.start_trace(logdir)
    except Exception as e:          # backend without profiler support
        import warnings
        warnings.warn(f"jax.profiler.start_trace failed ({e}); "
                      "continuing untraced")
        yield
        return
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class BenchmarkTimer:
    """Pausable wall-clock timer (util/BenchmarkTimer.h:11-29): accumulates
    elapsed time across start/pause cycles; ``seconds`` reads the running
    total without stopping."""

    def __init__(self, start: bool = False):
        self._accum = 0.0
        self._started_at: float | None = None
        if start:
            self.start()

    def start(self) -> None:
        if self._started_at is None:
            self._started_at = time.perf_counter()

    def pause(self) -> None:
        if self._started_at is not None:
            self._accum += time.perf_counter() - self._started_at
            self._started_at = None

    def reset(self) -> None:
        self._accum = 0.0
        self._started_at = None

    def restart(self) -> None:
        self.reset()
        self.start()

    @property
    def running(self) -> bool:
        return self._started_at is not None

    @property
    def seconds(self) -> float:
        live = (time.perf_counter() - self._started_at
                if self._started_at is not None else 0.0)
        return self._accum + live
