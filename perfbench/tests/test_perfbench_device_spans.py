"""The device time under the program's spans (``Trace.span_busy_s``) on
synthetic profiler events: GPU-side annotations nested, overlapping and
repeated, kernels outside every annotation, kernels of two streams that
overlap, marks and copies. What the trace read before it kept the spans
(``_parent_read``, a copy of that reading) is read the same."""
import contextlib
from types import SimpleNamespace

import pytest
import torch

from perfbench.harness import spec, trace
from perfbench.harness.trace import (AFTER_MARK, KERNEL_SYMBOLS,
                                     MARK_ORDER, MARK_SYMBOL, Trace,
                                     _merged, short_name)

SPIN = 'at::cuda::(anonymous namespace)::spin_kernel(long)'
FORWARD_SPANS = ('raw_heads', 'nms', 'mask_branch')


def _event(name, start_us, end_us, annotation=False):
    return SimpleNamespace(
        name=name, device_type=torch.autograd.DeviceType.CUDA,
        time_range=SimpleNamespace(start=start_us, end=end_us),
        is_user_annotation=annotation)


def _parent_read(events):
    """The trace's reading of the card's activity as it was before the
    spans' device time was kept, marks read by their place in the cycle:
    (stage_busy_s, kernel_s, busy_s, device_ops, idle_gaps, marks)."""
    cuda = torch.autograd.DeviceType.CUDA
    ops = sorted((e.time_range.start / 1e6, e.time_range.end / 1e6, e.name)
                 for e in events if e.device_type == cuda
                 and not getattr(e, 'is_user_annotation', False))
    busy, by_name, gaps, kernel_s = [], {}, [], {}
    where, cursor, marks = 'between calls', None, 0
    stage = {'forward': 0.0, 'postprocess': 0.0}
    for start, end, name in ops:
        short = short_name(name)
        if cursor is not None and start > cursor:
            gaps.append((start - cursor, where))
        cursor = end if cursor is None else max(cursor, end)
        if short == MARK_SYMBOL:
            marks += 1
            where = AFTER_MARK[MARK_ORDER[(marks - 1) % len(MARK_ORDER)]]
            continue
        busy.append((start, end))
        by_name[short[:80]] = by_name.get(short[:80], 0.0) + end - start
        for kernel, symbols in KERNEL_SYMBOLS.items():
            if short in symbols:
                kernel_s.setdefault(kernel, []).append(end - start)
        if where == 'forward':
            stage['forward'] += end - start
        elif where == 'postprocess and download' and \
                not name.startswith('Memcpy'):
            stage['postprocess'] += end - start
    named = {}
    for length, label in gaps:
        named[label] = max(named.get(label, 0.0), length)
    return (stage if marks else {}, kernel_s,
            sum(b - a for a, b in _merged(busy)),
            sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
            sorted(named.items(), key=lambda kv: -kv[1])[:10], marks)


def _nested():
    """``stage:a`` over [0, 30) and again over [40, 45), ``stage:b`` inside
    it, ``stage:c`` across both; kernels of two streams overlap on
    [25, 30)."""
    events = [_event('stage:a', 0, 30, True), _event('stage:b', 12, 20, True),
              _event('stage:c', 18, 45, True), _event('stage:a', 40, 45, True),
              _event('conv(x)', 0, 10), _event('gemm(x)', 12, 20),
              _event('reduce(x)', 25, 30), _event('elementwise(x)', 26, 35),
              _event('nms_keep_kernel(x)', 40, 50)]
    # merged kernels [0, 10), [12, 20), [25, 35), [40, 50)
    return events, {'stage:a': 10 + 8 + 5 + 5, 'stage:b': 8,
                    'stage:c': 2 + 10 + 5}


def _outside():
    """Kernels before, between and after the annotations count in the
    busy time and in no span."""
    events = [_event('conv(x)', 0, 5), _event('stage:a', 10, 20, True),
              _event('gemm(x)', 10, 20), _event('conv(x)', 22, 27),
              _event('stage:b', 30, 32, True), _event('gemm(x)', 30, 32),
              _event('segment_topk_kernel<16>(x)', 40, 48)]
    return events, {'stage:a': 10, 'stage:b': 2}


def _marked():
    """One predict call's four marks; the forward's three spans, the postprocess's span with its
    download inside; a mark and a copy inside annotations count in none."""
    events = [
        _event(SPIN, 0, 1), _event('Memcpy HtoD', 2, 4), _event(SPIN, 5, 6),
        _event('stage:raw_heads', 7, 30, True), _event('conv(x)', 7, 20),
        _event('band_groupnorm_warp_kernel(x)', 21, 30),
        _event('stage:nms', 31, 35, True), _event('reduce(x)', 31, 35),
        _event('segment_topk_kernel<16>(x)', 32, 34),
        _event('stage:mask_branch', 36, 50, True), _event('gemm(x)', 36, 50),
        _event(SPIN, 50, 51),
        _event('stage:postprocess', 55, 70, True),
        _event('elementwise(x)', 55, 62), _event('Memcpy DtoH', 62, 70),
        _event(SPIN, 71, 72),
        _event('stage:upload', 2, 4, True),
        _event('stage:late', 62, 90, True), _event(SPIN, 85, 86)]
    return events, {'stage:raw_heads': 13 + 9, 'stage:nms': 4,
                    'stage:mask_branch': 14, 'stage:postprocess': 7,
                    'stage:upload': 0, 'stage:late': 0}


@pytest.mark.parametrize('case', [_nested, _outside, _marked])
def test_span_busy_time_by_hand_and_the_rest_as_before(case):
    events, want_us = case()
    tr = Trace('cuda')
    tr._read(events)
    assert tr.span_busy_s.keys() == want_us.keys()
    for name, us in want_us.items():
        assert tr.span_busy_s[name] == pytest.approx(us * 1e-6), name
    stages, kernel_s, busy_s, ops, gaps, marks = _parent_read(events)
    assert tr.stage_busy_s == stages
    assert tr.kernel_s == kernel_s
    assert tr.busy_s == busy_s
    assert tr.device_ops == ops and tr.idle_gaps == gaps
    assert tr.marks == marks


def test_events_without_annotations_read_no_spans():
    tr = Trace('cuda')
    tr._read([e for e in _marked()[0] if not e.is_user_annotation])
    assert tr.span_busy_s == {}
    assert tr.stage_busy_s['forward'] == pytest.approx((13 + 9 + 4 + 2 + 14)
                                                       * 1e-6)


def test_overlap_of_interval_lists():
    assert trace._overlap_s([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert trace._overlap_s([(0, 1)], [(2, 3)]) == 0
    assert trace._overlap_s([], [(0, 1)]) == 0


@pytest.mark.parametrize('span', FORWARD_SPANS)
def test_forward_span_readers(span):
    """Each reader divides its span's device time by the traced frames,
    and reads nothing where the run has no trace or no such annotation."""
    read = spec.reader(f'forward.{span}_busy_ms_per_frame.batch')
    tr = Trace('cuda')
    tr._read(_marked()[0])
    run = dict(trace=tr, counters={'traced_frames': 2}, roofline={},
               flops_per_frame=0.0, peak_bytes=0, device='cuda')
    want = {'raw_heads': 22, 'nms': 4, 'mask_branch': 14}[span]
    assert read(run) == pytest.approx(want * 1e-3 / 2)
    assert read(dict(run, trace=None)) is None
    bare = Trace('cuda')
    bare._read([_event('conv(x)', 0, 5)])
    assert read(dict(run, trace=bare)) is None
    assert read(dict(run, counters={})) is None


def test_raw_records_read_as_the_parsed_events():
    """``device_events`` gives every record of a device type that
    ``prof.events()`` gives, with its name, times and annotation flag (here
    the host's records, which a CPU session holds), and counts the other
    records that are operators."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function('stage:x'):
            torch.randn(64, 64).matmul(torch.randn(64, 64)).sum()
    cpu = torch.autograd.DeviceType.CPU
    events, operators = trace.device_events(prof, cpu)
    got = {(e.name, e.time_range.start, e.time_range.end,
            e.is_user_annotation) for e in events}
    want = {(e.name, e.time_range.start, e.time_range.end,
             bool(e.is_user_annotation))
            for e in prof.events() if e.device_type == cpu}
    assert len(want) > 5 and want <= got and operators == 0
    assert ('stage:x', True) in {(n, a) for n, _, _, a in want}
    events, operators = trace.device_events(prof)
    assert events == [] and operators >= 4


def _profiled_matmul():
    tr = Trace('cpu')
    tr.start()
    with torch.profiler.record_function('stage:x'):
        torch.randn(64, 64).matmul(torch.randn(64, 64)).sum()
    return tr


def test_the_session_records_only_record_function_ranges():
    """Under ``Trace.start`` a profiled matmul leaves the ``stage:x`` range
    and no operator among the host's records."""
    tr = _profiled_matmul()
    prof = tr.prof
    tr.stop()
    names = {e.name for e in prof.events()}
    assert 'stage:x' in names
    assert not any(n.startswith('aten::') for n in names), names


def test_a_session_that_records_operators_is_refused(monkeypatch):
    """Where the scopes' restriction does not reach the profiler, the
    session starts with none and ``Trace.stop`` refuses what it recorded."""
    from torch.autograd import profiler as autograd_profiler
    enable = autograd_profiler._enable_profiler
    with pytest.raises(RuntimeError, match='restricted'):
        with trace.user_scope_only():
            pass
    assert autograd_profiler._enable_profiler is enable
    monkeypatch.setattr(trace, 'user_scope_only', contextlib.nullcontext)
    tr = _profiled_matmul()
    with pytest.raises(RuntimeError, match='host operators'):
        tr.stop()
