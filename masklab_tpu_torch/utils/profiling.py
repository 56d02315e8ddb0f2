"""Tracing / profiling utilities.

The port's counterparts of ``masklab_tpu/utils/profiling.py``: a stage
timer, a device trace through ``torch.profiler`` (CUDA activity where a card
is present), a steady-state timer that synchronizes the card, and the
kernels' build directory.
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Dict

import torch


class StageTimer:
    """Named wall-clock stages; replaces the reference's ad-hoc
    ``time.time()`` print brackets (retinamasklab.py:505-638)."""

    def __init__(self, log_fn=print):
        self.log = log_fn
        self.stages: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            self.stages[name] = self.stages.get(name, 0.0) + elapsed
            if self.log:
                self.log(f'[{name}] {elapsed:.3f}s')

    def summary(self) -> str:
        return json.dumps({k: round(v, 4) for k, v in self.stages.items()})


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the host and, where a card is present, its kernels:
    ``with device_trace('traces'): step()`` writes a Chrome trace
    (``<host>_<pid>.<time>.pt.trace.json``, which TensorBoard's profiler
    plugin and chrome://tracing read) into ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)):
        yield


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed_blocked(fn, *args, iters: int = 10, warmup: int = 2,
                  **kwargs) -> float:
    """Mean steady-state seconds an iteration, the card synchronized
    before the clock starts and after it stops."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    _synchronize()
    start = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    _synchronize()
    return (time.perf_counter() - start) / iters


def enable_compilation_cache(path: str) -> None:
    """Build the CUDA kernels into, and load them from, ``path``: the
    port's only compiled artifacts (``ops/cuda/_build.py``). Call it before
    the first kernel launch; a library already loaded stays."""
    from ..ops.cuda import _build
    _build.BUILD_DIR = path
