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

The kernels of the program's CUDA library (K1, K1's backward, K2, K3) are
matched by their symbols (device_split's rule: the short name before any
template argument list, entries of one short name summed); their call
shapes come from ``KernelCalls``, which records each wrapper's arguments
while the trace runs."""
from __future__ import annotations

import re
import time
from typing import Dict, List, Tuple

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


def _merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


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


class Trace:
    """One profiler session of the card's activity and what was read from
    it (times in s)."""

    def __init__(self, device: str = 'cuda'):
        self.device = device
        self.prof = None
        self.window_s = 0.0
        self.busy_s = 0.0
        self.stage_busy_s: Dict[str, float] = {}
        self.kernel_s: Dict[str, List[float]] = {}
        self.device_ops: List[Tuple[str, float]] = []
        self.idle_gaps: List[Tuple[str, float]] = []
        self.marks = 0
        self.active = False

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device != 'cpu':
            torch.cuda.synchronize()
            activities = [ProfilerActivity.CUDA]
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self.active = True
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self.device != 'cpu':
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)
        self.active = False
        self._read(self.prof.events())
        self.prof = None

    def _read(self, events) -> None:
        cuda = torch.autograd.DeviceType.CUDA
        ops = []
        for e in events:
            if e.device_type != cuda or getattr(e, 'is_user_annotation',
                                                False):
                continue
            ops.append((e.time_range.start / 1e6, e.time_range.end / 1e6,
                        e.name))
        ops.sort()
        busy, by_name, gaps = [], {}, []
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
            if where == 'forward':
                stage['forward'] += end - start
            elif where == 'postprocess and download' and \
                    not name.startswith('Memcpy'):
                stage['postprocess'] += end - start
        self.busy_s = sum(b - a for a, b in _merged(busy))
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
