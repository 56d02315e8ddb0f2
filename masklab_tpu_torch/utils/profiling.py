"""Tracing / profiling utilities.

The port's counterparts of ``masklab_tpu/utils/profiling.py``: a stage
timer, a device trace through ``torch.profiler`` (CUDA activity where a card
is present), a steady-state timer that synchronizes the card, and the
kernels' build directory.

The program's spans and counters: ``span(name, **attrs)`` around a piece
of host work, ``count(name, n)`` where something countable happens. They
record nothing until ``start_recording()``; while off a call checks the
recorder and ``torch.profiler``'s running flag and returns. While a
``torch.profiler`` trace runs, a span also opens a ``record_function`` of
its name, so the profiler's own traces (``device_trace``) carry it. While
recording, each span closed in any thread is kept with its thread, its
parent (the span open around it in that thread), its start and end on the
wall clock in ns (``time.time_ns``: the clock of the profiler's device
trace, whose events sit at ``trace_start_ns()`` plus their offset), the
thread's CPU time over it and its attributes; ``drain()`` hands over what
was kept.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler


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


class Span(NamedTuple):
    """One closed span: ``thread`` is ``threading.get_ident()``, ``parent``
    the ``id`` of the span open around it in that thread (None: none),
    ``start_ns`` / ``end_ns`` wall clock, ``cpu_ns`` the thread's CPU time
    over it."""
    name: str
    id: int
    parent: Optional[int]
    thread: int
    start_ns: int
    end_ns: int
    cpu_ns: int
    attrs: Dict


class Recorder:
    """What ``start_recording`` collects: the closed spans and the
    counters, from any thread."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = {}
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self._local = threading.local()

    def stack(self) -> List[int]:
        """The ids of this thread's open spans, innermost last."""
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def keep(self, closed: Span) -> None:
        with self._lock:
            self.spans.append(closed)

    def add(self, name: str, n: int) -> None:
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + n

    def drain(self) -> Tuple[List[Span], Dict[str, int]]:
        with self._lock:
            spans, self.spans = self.spans, []
            counts, self.counts = self.counts, {}
        return spans, counts


_recorder: Optional[Recorder] = None     # None: not recording


class _Off:
    """The span of a call made while nothing records or traces."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ('recorder', 'name', 'attrs', 'annotation', 'id', 'parent',
                 'start_ns', 'cpu_ns')

    def __init__(self, recorder: Optional[Recorder], name: str, attrs):
        self.recorder, self.name, self.attrs = recorder, name, attrs
        self.annotation = None

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span (a batch's index)."""
        self.attrs.update(attrs)

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        rec = self.recorder
        if rec is not None:
            stack = rec.stack()
            self.parent = stack[-1] if stack else None
            self.id = next(rec._ids)
            stack.append(self.id)
            self.cpu_ns = time.thread_time_ns()
            self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        rec = self.recorder
        if rec is not None:
            end_ns = time.time_ns()
            cpu_ns = time.thread_time_ns() - self.cpu_ns
            rec.stack().pop()
            rec.keep(Span(self.name, self.id, self.parent,
                                  threading.get_ident(), self.start_ns,
                                  end_ns, cpu_ns, self.attrs))
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """``with span('stage:upload'): ...``; ``with span('step') as s:
    ... s.set(k=3)`` adds attributes inside it."""
    rec = _recorder
    if rec is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(rec, name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording."""
    rec = _recorder
    if rec is not None:
        rec.add(name, n)


def start_recording() -> None:
    """Keep every span and count from now on (a new, empty record)."""
    global _recorder
    _recorder = Recorder()


def stop_recording() -> None:
    """Record nothing more; what was kept is dropped."""
    global _recorder
    _recorder = None


def drain() -> Tuple[List[Span], Dict[str, int]]:
    """The spans closed and the counts made since recording started or
    the last drain, handed over (none while not recording)."""
    rec = _recorder
    return rec.drain() if rec is not None else ([], {})
