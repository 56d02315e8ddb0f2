"""The program's own spans and counters (``masklab_tpu_torch.utils.profiling``)
in a traced run, and what per-layer metrics read from them.

While the recorder runs, every span the program closes in any thread is
kept with its thread, parent, start and end (wall-clock ns, the clock of
the profiler's device trace) and the thread's CPU time over it. A run
that holds them has ``run['spans']`` (the program's ``Span`` records) and
``run['program_counts']`` (its counters); its ``trace`` is a
``SpannedTrace``, which keeps the device's busy intervals on the same
clock. The loop thread is the one whose spans are named ``step``.

The device's idle time is put down to what the loop thread was doing:
each idle interval of the window (the complement of the merged busy
intervals) is split by the loop thread's innermost open span, and a piece
under no open span is ``untraced``. Each reader returns None where the
run holds nothing to read (a program without the recorder, an untraced
run)."""
from __future__ import annotations

import time
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .trace import MARK_ORDER, MARK_SYMBOL, Trace, _merged, short_name

UNTRACED = 'untraced'
# the loop's spans each idle-attribution metric reads
IDLE_GROUPS = {
    'data_wait': ('stage:data_wait',),
    'pad_upload': ('stage:pad', 'stage:upload'),
    'step_host': ('stage:forward', 'stage:losses', 'stage:backward',
                  'stage:optimizer'),
}

Interval = Tuple[int, int]


class SpannedTrace(Trace):
    """A ``Trace`` that also keeps the window's bounds and the device's
    merged busy intervals in wall-clock ns (``t0_ns``, ``t1_ns``,
    ``busy_ns``), and, given the program's spans before it stops
    (``spans``), labels the idle gaps of a trace without marks by the loop
    thread's innermost open span.

    The clock check: where the spans hold two ``clock`` spans, each opened
    around a ``torch.cuda._sleep`` launch at the window's start and end,
    the first and last spin kernels of the trace are theirs (taken out
    before the marks are read) and ``clock`` holds each kernel's start
    less its span's start, and its span's end plus 1 ms less the kernel's
    start, ms: both >= 0 where the span's clock and the trace's agree.
    The trace's clock can drift from the wall clock over a window (a few
    ms in 51 s on the H100): the busy intervals are mapped back through
    the line through the two kernels' offsets from their spans' ends
    (``drift_ms``, the end's offset less the start's)."""

    def __init__(self, device: str = 'cuda'):
        super().__init__(device)
        self.t0_ns = self.t1_ns = 0
        self.busy_ns: List[Interval] = []
        self.spans: list = []
        self.clock: Optional[Dict] = None

    def start(self) -> None:
        super().start()
        self.t0_ns = time.time_ns()

    def stop(self) -> None:
        if self.device != 'cpu':
            torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        super().stop()

    def _read(self, events) -> None:
        cuda = torch.autograd.DeviceType.CUDA
        base = self.prof.profiler.kineto_results.trace_start_ns()
        events = list(events)
        clocks = sorted((s for s in self.spans if s.name == 'clock'),
                        key=lambda s: s.start_ns)
        spins = sorted((e for e in events if e.device_type == cuda
                        and short_name(e.name) == MARK_SYMBOL),
                       key=lambda e: e.time_range.start)
        if (len(clocks) == 2 and len(spins) >= 2
                and (len(spins) - 2) % len(MARK_ORDER) == 0):
            kernels = (spins[0], spins[-1])
            events = [e for e in events
                      if all(e is not k for k in kernels)]
            starts = [base + int(e.time_range.start * 1e3) for e in kernels]
            after = [(k - s.start_ns) / 1e6 for k, s in zip(starts, clocks)]
            before = [(s.end_ns + 1_000_000 - k) / 1e6
                      for k, s in zip(starts, clocks)]
            offsets = [k - s.end_ns for k, s in zip(starts, clocks)]
            self.clock = dict(
                kernel_after_span_start_ms=after,
                span_end_plus_1ms_after_kernel_ms=before,
                inside=min(after + before) >= 0,
                drift_ms=(offsets[1] - offsets[0]) / 1e6)
            to_wall = _line_back(starts, offsets)
        else:
            if clocks:
                self.clock = dict(error=f'{len(spins)} spin kernels')
            to_wall = _line_back([0, 1], [0, 0])
        super()._read(events)
        busy = []
        for e in events:
            if (e.device_type != cuda
                    or getattr(e, 'is_user_annotation', False)
                    or short_name(e.name) == MARK_SYMBOL):
                continue
            busy.append((to_wall(base + int(e.time_range.start * 1e3)),
                         to_wall(base + int(e.time_range.end * 1e3))))
        self.busy_ns = _merged(busy)
        if not self.marks and self.spans:
            gaps = labelled_gaps(self.busy_ns, self.spans, self.t0_ns,
                                 self.t1_ns)
            if gaps:
                self.idle_gaps = gaps


def _line_back(at: Sequence[int], offsets: Sequence[int]):
    """t -> t less the offset interpolated on the line through
    (at[0], offsets[0]) and (at[1], offsets[1])."""
    slope = (offsets[1] - offsets[0]) / max(at[1] - at[0], 1)
    return lambda t: t - offsets[0] - round(slope * (t - at[0]))


def loop_thread(spans) -> Optional[int]:
    """The thread of the ``step`` spans (the most common one)."""
    threads = Counter(s.thread for s in spans if s.name == 'step')
    return threads.most_common(1)[0][0] if threads else None


def innermost(spans, thread: int) -> List[Tuple[int, int, str]]:
    """The thread's timeline as (start, end, innermost open span's name)
    pieces, in order, where a span of it is open."""
    mine = sorted((s for s in spans if s.thread == thread),
                  key=lambda s: (s.start_ns, -s.end_ns))
    bounds = sorted({t for s in mine for t in (s.start_ns, s.end_ns)})
    pieces, stack, i = [], [], 0
    for a, b in zip(bounds, bounds[1:]):
        while stack and stack[-1].end_ns <= a:
            stack.pop()
        while i < len(mine) and mine[i].start_ns <= a:
            stack.append(mine[i])
            i += 1
        while stack and stack[-1].end_ns <= a:
            stack.pop()
        if stack:
            pieces.append((a, b, stack[-1].name))
    return pieces


def idle_intervals(busy: Sequence[Interval], t0: int, t1: int
                   ) -> List[Interval]:
    """The window [t0, t1] less the merged ``busy`` intervals."""
    out, cursor = [], t0
    for a, b in busy:
        if b <= cursor:
            continue
        if a >= t1:
            break
        if a > cursor:
            out.append((cursor, a))
        cursor = max(cursor, b)
    if cursor < t1:
        out.append((cursor, t1))
    return out


def _label_pieces(busy, spans, t0, t1):
    """Each idle interval of the window cut by the loop thread's innermost
    open span: -> [(idle interval, [(ns, label), ...])]."""
    thread = loop_thread(spans)
    pieces = innermost(spans, thread) if thread is not None else []
    out, j = [], 0
    for a, b in idle_intervals(busy, t0, t1):
        parts, cursor = [], a
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            pa, pb, name = pieces[k]
            lo, hi = max(pa, a), min(pb, b)
            if lo > cursor:
                parts.append((lo - cursor, UNTRACED))
            parts.append((hi - lo, name))
            cursor = hi
            k += 1
        if cursor < b:
            parts.append((b - cursor, UNTRACED))
        out.append(((a, b), parts))
    return out


def idle_by_span(busy: Sequence[Interval], spans, t0: int, t1: int
                 ) -> Dict[str, float]:
    """Seconds of device idle in the window under each innermost span name
    of the loop thread (``untraced``: under none)."""
    out: Dict[str, float] = {}
    for _, parts in _label_pieces(busy, spans, t0, t1):
        for ns, label in parts:
            out[label] = out.get(label, 0.0) + ns / 1e9
    return out


def labelled_gaps(busy, spans, t0, t1) -> List[Tuple[str, float]]:
    """The breakdown's idle gaps: each label's longest piece of an idle
    gap, s, the ten longest."""
    named: Dict[str, float] = {}
    for _, parts in _label_pieces(busy, spans, t0, t1):
        for ns, label in parts:
            named[label] = max(named.get(label, 0.0), ns / 1e9)
    return sorted(named.items(), key=lambda kv: -kv[1])[:10]


# ---- readers: run -> a number, or None ----

def _spans(run: Dict) -> list:
    return run.get('spans') or []


def _steps(run: Dict) -> list:
    return [s for s in _spans(run) if s.name == 'step']


def built_batches(run: Dict) -> list:
    """The prefetch thread's ``data:batch`` spans that built a batch (they
    carry its index ``k``; the one that found the data's end does not)."""
    return [s for s in _spans(run) if s.name == 'data:batch'
            and 'k' in s.attrs]


def idle_in(group: str):
    """Device idle under the group's loop spans, % of the window."""
    names = IDLE_GROUPS[group]

    def read(run: Dict) -> Optional[float]:
        tr, spans = run.get('trace'), _spans(run)
        if (tr is None or not getattr(tr, 't1_ns', 0) or tr.window_s <= 0
                or loop_thread(spans) is None):
            return None
        by = idle_by_span(tr.busy_ns, spans, tr.t0_ns, tr.t1_ns)
        return 100.0 * sum(by.get(n, 0.0) for n in names) / tr.window_s
    return read


def _wall_ns(s) -> int:
    return s.end_ns - s.start_ns


def span_mean_ms(name: str):
    """Mean wall ms of the spans ``name`` (``data:batch``: those that built
    a batch)."""
    def read(run: Dict) -> Optional[float]:
        found = (built_batches(run) if name == 'data:batch' else
                 [s for s in _spans(run) if s.name == name])
        if not found:
            return None
        return sum(map(_wall_ns, found)) / len(found) / 1e6
    return read


def build_cpu_share(run: Dict) -> Optional[float]:
    """The prefetch thread's CPU time over its wall time while it builds a
    batch (``data:batch`` less its ``data:queue_put``, the wait on a full
    queue), %: well under 100 means it waits on the GIL or on I/O."""
    batches = built_batches(run)
    ids = {s.id for s in batches}
    puts = [s for s in _spans(run) if s.name == 'data:queue_put'
            and s.parent in ids]
    wall = sum(map(_wall_ns, batches)) - sum(map(_wall_ns, puts))
    cpu = sum(s.cpu_ns for s in batches) - sum(s.cpu_ns for s in puts)
    return 100.0 * cpu / wall if batches and wall > 0 else None


def queue_empty_share(run: Dict) -> Optional[float]:
    """``data.queue_empty`` over the window's steps, %."""
    steps = _steps(run)
    if not steps:
        return None
    return 100.0 * run['program_counts'].get('data.queue_empty', 0) / len(
        steps)


def upload_pageable_mib(run: Dict) -> Optional[float]:
    """``upload.pageable_bytes`` a step, MiB."""
    steps, counts = _steps(run), run.get('program_counts') or {}
    if not steps or 'upload.pageable_bytes' not in counts:
        return None
    return counts['upload.pageable_bytes'] / len(steps) / 2 ** 20


def step_host_ms(run: Dict) -> Optional[float]:
    """Mean host ms of a ``step`` span less its ``stage:data_wait``."""
    steps = _steps(run)
    if not steps:
        return None
    waits: Dict[int, int] = {}
    for s in _spans(run):
        if s.name == 'stage:data_wait' and s.parent is not None:
            waits[s.parent] = waits.get(s.parent, 0) + _wall_ns(s)
    return sum(_wall_ns(s) - waits.get(s.id, 0) for s in steps) / len(
        steps) / 1e6


def data_wait_share(run: Dict) -> Optional[float]:
    """``stage:data_wait`` summed over the window, % of it (beside the
    patched ``train.data_wait_share``)."""
    tr, spans = run.get('trace'), _spans(run)
    waits = [s for s in spans if s.name == 'stage:data_wait']
    window = (tr.window_s if tr is not None else
              run['counters'].get('window_s'))
    if not waits or not window:
        return None
    return 100.0 * sum(map(_wall_ns, waits)) / 1e9 / window
