"""The traced run's reading of ``torch.profiler``: the card's activity
(kernels, copies) over the window, wherever in the process it was launched,
and from it the device's busy time, the device time of the model's forward
and of the postprocess, the kernels' launches with their own device time,
the operations that took most time, and the longest idle gaps by where in
a call the host was.

The harness marks the calls in the card's own stream (the profiler's host
records cover only the thread that starts it): a short spin kernel
(``Marks``) at a predict call's start, at the model forward's start and
end (hooks on the program's model) and at the call's end. The marks come
in that order, four a call, on one stream, and are read by their place in
that cycle (``MARK_ORDER``); a trace whose marks are not four a call is
refused (``check_marks``). Kernels between the forward's marks are the
forward's (the program's ``stage:raw_heads``, ``stage:nms`` and
``stage:mask_branch``); kernels between the forward's end and the call's
end, copies left out, the postprocess's (``stage:postprocess``, its
analytics).

The program's own spans reach the trace as GPU-side user annotations (the
``record_function`` that ``utils.profiling.span`` opens while a profiler
runs; the profiler gives each the device range of the kernels launched
inside it). They arrive only when the session records the host's activity
as well as the card's; of the host's it records the annotations alone
(``USER_SCOPE``), since recording every operator doubles the trainer's host
time a step; a session that records an operator is refused
(``user_scope_only``, ``Trace.stop``). ``span_busy_s`` maps each
annotation's name to the merged busy time of the kernels inside its
ranges, marks and copies left out, nested and repeated annotations of one
name counted once. The profiler ties a kernel to the innermost span open at
its launch, so a span's range runs from the first to the last kernel
launched in it outside its nested spans: an outer span holds its nested
spans' kernels only where its own come before and after them. The device records are read from the profiler's raw
results (``device_events``).

The tracer can lose the device records of a session's first milliseconds
(on the H100, in about one session in four: the first kernel and a burst
some 2 ms later, under either session), which would refuse the run by its
marks. So a session starts in a warm-up step whose records the profiler
discards, with a burst of kernels launched and finished in it (``_prime``),
and the trace starts at the next step.

The kernels of the program's CUDA library (K1, K1's backward, K2, K3) are
matched by their symbols (device_split's rule: the short name before any
template argument list, entries of one short name summed); their call
shapes come from ``KernelCalls``, which records each wrapper's arguments
while the trace runs."""
from __future__ import annotations

import contextlib
import re
import time
from typing import Dict, List, NamedTuple, Tuple

import torch

# kernel -> the short symbol names its launches carry
KERNEL_SYMBOLS = {
    'band_groupnorm': ('band_groupnorm_warp_kernel', 'band_groupnorm_kernel'),
    'band_groupnorm_backward': ('band_groupnorm_bwd_warp_kernel',
                                'band_groupnorm_bwd_scalar_kernel',
                                'band_groupnorm_bwd_reduce_kernel'),
    'segment_topk': ('segment_topk_kernel',),
    'nms_keep': ('nms_keep_kernel',),
}
MARK_SYMBOL = 'spin_kernel'          # torch.cuda._sleep's kernel
MARK_CYCLES = 10_000                 # a mark's spin (about 5 us)
# the marks of one call, in the order they are set
MARK_ORDER = ('call', 'forward', 'forward_end', 'call_end')
# where a call is after each mark, for the idle gaps' labels
AFTER_MARK = {'call': 'upload and downsample', 'forward': 'forward',
              'forward_end': 'postprocess and download',
              'call_end': 'between calls'}


def short_name(symbol: str) -> str:
    m = re.search(r'(\w+)(?:<|\(|$)', symbol)
    return m.group(1) if m else symbol


class Range(NamedTuple):
    start: float                     # us from the trace's start
    end: float


class DeviceEvent(NamedTuple):
    """A device record of the trace, as ``prof.events()`` gives it."""
    name: str
    device_type: object
    time_range: Range
    is_user_annotation: bool


@contextlib.contextmanager
def user_scope_only():
    """Profiler sessions started inside record, of the host's operators,
    only the ``record_function`` ranges (``torch.profiler`` has no option
    for it: its start is given the scopes to record). Raises where no
    session started inside went through the restriction."""
    from torch._C._profiler import RecordScope
    from torch.autograd import profiler as autograd_profiler
    enable, started = autograd_profiler._enable_profiler, []

    def user_scope(config, activities):
        enable(config, activities, {RecordScope.USER_SCOPE})
        started.append(True)
    autograd_profiler._enable_profiler = user_scope
    try:
        yield
    finally:
        autograd_profiler._enable_profiler = enable
    if not started:
        raise RuntimeError('the profiler started without its scopes '
                           'restricted to record_function ranges')


def device_events(prof, device_type=None) -> Tuple[List[DeviceEvent], int]:
    """The session's device records (kernels, copies, GPU-side annotations;
    or those of ``device_type``) from the profiler's raw results, with the
    names and times that ``prof.events()`` would give them (that call
    parses every host record into Python and builds their tree, minutes
    over a 51-s window), and the number of the other records that are
    operators (``aten::``)."""
    from torch.autograd.profiler_util import _rewrite_name
    results = prof.profiler.kineto_results
    base = results.trace_start_ns()
    device_type = device_type or torch.autograd.DeviceType.CUDA
    out, operators = [], 0
    for k in results.events():
        if k.device_type() != device_type:
            operators += k.name().startswith('aten::')
            continue
        if k.is_hidden_event():
            continue
        start = k.start_ns() - base
        out.append(DeviceEvent(
            _rewrite_name(name=k.name(), with_wildcard=True), device_type,
            Range(start / 1e3, (start + k.duration_ns()) / 1e3),
            k.is_user_annotation()))
    return out, operators


def _merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _overlap_s(a: List[Tuple[float, float]],
               b: List[Tuple[float, float]]) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


class Marks:
    """Marks in the card's stream, on while a trace runs."""

    def __init__(self):
        self.on = False

    def __call__(self, name: str) -> None:
        if self.on:
            torch.cuda._sleep(MARK_CYCLES)


def check_marks(marks: int, calls) -> None:
    """Refuse a trace whose marks are not ``MARK_ORDER``'s four for each
    of the window's ``calls`` (None: a driver that sets no marks)."""
    want = len(MARK_ORDER) * (calls or 0)
    if marks != want:
        raise RuntimeError(f'the trace holds {marks} marks, the window '
                           f'made {calls} calls: {want} expected')


def _prime() -> None:
    """A burst of the kernels the window launches (marks and elementwise
    ops), finished before the trace starts."""
    x = torch.zeros(256, device='cuda')
    for _ in range(8):
        torch.cuda._sleep(MARK_CYCLES)
        for _ in range(50):
            x.add_(1.0)
    torch.cuda.synchronize()
    time.sleep(0.01)


class Trace:
    """One profiler session of the card's activity and what was read from
    it (times in s)."""

    def __init__(self, device: str = 'cuda'):
        self.device = device
        self.prof = None
        self.window_s = 0.0
        self.busy_s = 0.0
        self.stage_busy_s: Dict[str, float] = {}
        self.span_busy_s: Dict[str, float] = {}
        self.kernel_s: Dict[str, List[float]] = {}
        self.device_ops: List[Tuple[str, float]] = []
        self.idle_gaps: List[Tuple[str, float]] = []
        self.marks = 0
        self.active = False

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, schedule
        activities = [ProfilerActivity.CPU]
        if self.device != 'cpu':
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities,
                            schedule=schedule(wait=0, warmup=1, active=1))
        self.prof.record_steps = False       # no ProfilerStep annotation
        self.prof.__enter__()
        if self.device != 'cpu':
            _prime()
        with user_scope_only():
            self.prof.step()
        self.active = True
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self.device != 'cpu':
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)
        self.active = False
        events, operators = device_events(self.prof)
        if operators:
            self.prof = None
            raise RuntimeError(f'the profiler recorded {operators} host '
                               'operators: its session was not restricted '
                               'to record_function ranges')
        self._read(events)
        self.prof = None

    def _read(self, events) -> None:
        cuda = torch.autograd.DeviceType.CUDA
        ops, annotations = [], {}
        for e in events:
            if e.device_type != cuda:
                continue
            interval = (e.time_range.start / 1e6, e.time_range.end / 1e6)
            if getattr(e, 'is_user_annotation', False):
                annotations.setdefault(e.name, []).append(interval)
                continue
            ops.append(interval + (e.name,))
        ops.sort()
        busy, by_name, gaps, kernels = [], {}, [], []
        where, cursor = 'between calls', None
        stage = {'forward': 0.0, 'postprocess': 0.0}
        for start, end, name in ops:
            short = short_name(name)
            if cursor is not None and start > cursor:
                gaps.append((start - cursor, where))
            cursor = end if cursor is None else max(cursor, end)
            if short == MARK_SYMBOL:
                self.marks += 1
                where = AFTER_MARK[MARK_ORDER[(self.marks - 1)
                                              % len(MARK_ORDER)]]
                continue
            busy.append((start, end))
            by_name[short[:80]] = by_name.get(short[:80], 0.0) + end - start
            for kernel, symbols in KERNEL_SYMBOLS.items():
                if short in symbols:
                    self.kernel_s.setdefault(kernel, []).append(end - start)
            if not name.startswith('Memcpy'):
                kernels.append((start, end))
            if where == 'forward':
                stage['forward'] += end - start
            elif where == 'postprocess and download' and \
                    not name.startswith('Memcpy'):
                stage['postprocess'] += end - start
        self.busy_s = sum(b - a for a, b in _merged(busy))
        kernels = _merged(kernels)
        self.span_busy_s = {name: _overlap_s(kernels, _merged(ranges))
                            for name, ranges in annotations.items()}
        if self.marks:
            self.stage_busy_s = stage
        self.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        named = {}
        for length, label in gaps:
            named[label] = max(named.get(label, 0.0), length)
        self.idle_gaps = sorted(named.items(), key=lambda kv: -kv[1])[:10]


def warm_profiler(tries: int = 5) -> int:
    """Trace 100 small kernels until a trace holds a record of them (the
    tracer's first sessions in a process can deliver none): -> the traces
    it took."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.zeros(1 << 20, device='cuda')
    cuda = torch.autograd.DeviceType.CUDA
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(100):
                x.add_(1.0)
            torch.cuda.synchronize()
        if any(e.device_type == cuda for e in prof.events()):
            return attempt
    raise RuntimeError(f'profiler saw no kernel in {tries} warm-up traces')


class KernelCalls:
    """Records the shapes of each call of the program's kernel wrappers on
    a CUDA tensor while installed: K1 (``band_groupnorm`` through
    ``BandGroupNormFn``), K1's backward, K2 (``segment_topk_rows``) and K3
    (``nms_keep_mask``), as the program's modules look them up."""

    def __init__(self):
        self.calls: Dict[str, List[tuple]] = {}
        self._saved = []

    def _wrap(self, module, attr: str, kernel: str, shape_of) -> None:
        original = getattr(module, attr)

        def wrapper(*args, **kwargs):
            if args[0].is_cuda:
                self.calls.setdefault(kernel, []).append(
                    shape_of(*args, **kwargs))
            return original(*args, **kwargs)
        self._saved.append((module, attr, original))
        setattr(module, attr, wrapper)

    def install(self) -> 'KernelCalls':
        from masklab_tpu_torch.ops import nms
        from masklab_tpu_torch.ops.cuda import groupnorm, topk

        def gn(x, scale, bias, groups, eps=1e-5, fuse_relu=False):
            return (*x.shape, x.element_size(), bool(fuse_relu))

        def gn_bwd(x, dy, scale, groups, eps=1e-5, fuse_relu=False):
            return (*x.shape, x.element_size(), bool(fuse_relu))

        def k2(scores, cap, m=topk.SEGMENT_ROWS):
            n = scores.shape[-1]
            return (scores.numel() // n, n, cap, m)

        def k3(boxes, valid, iou_threshold, max_outputs):
            return tuple(boxes.shape[:2])
        self._wrap(groupnorm, 'band_groupnorm', 'band_groupnorm', gn)
        self._wrap(groupnorm, 'band_groupnorm_backward',
                   'band_groupnorm_backward', gn_bwd)
        self._wrap(nms, 'segment_topk_rows', 'segment_topk', k2)
        self._wrap(nms, 'nms_keep_mask', 'nms_keep', k3)
        return self

    def remove(self) -> None:
        for module, attr, original in reversed(self._saved):
            setattr(module, attr, original)
        self._saved.clear()



def roofline_shares(trace: Trace, calls: KernelCalls) -> Dict[str, float]:
    """Each kernel's time-weighted share of its roofline, in %: the least
    time of its recorded calls over their device time, per call (a call's
    time the mean launch time times the launches a call makes), and
    ``kernels`` over all four together. A kernel with no recorded call or
    no launch in the trace is left out."""
    from ..reference import roofline
    count = {'band_groupnorm': roofline.band_groupnorm,
             'band_groupnorm_backward': roofline.band_groupnorm_backward,
             'segment_topk': roofline.segment_topk,
             'nms_keep': roofline.nms_keep}
    shares, least_all, time_all = {}, 0.0, 0.0
    for kernel, fn in count.items():
        made = calls.calls.get(kernel, [])
        times = trace.kernel_s.get(kernel, [])
        if not made or not times:
            continue
        least = sum(roofline.bound_s(*fn(*shape)) for shape in made)
        per_call = max(1, round(len(times) / len(made)))
        spent = sum(times) / len(times) * per_call * len(made)
        shares[kernel] = 100.0 * least / spent
        least_all += least
        time_all += spent
    if time_all:
        shares['kernels'] = 100.0 * least_all / time_all
    return shares
