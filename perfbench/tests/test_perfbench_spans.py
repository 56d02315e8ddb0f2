"""The readers of the program's spans and counters (``harness/spans.py``):
the device's idle time put down to the loop thread's innermost span on a
synthetic trace, gaps under no span included; each reader's None where a
run holds nothing; and a small traced train run on the CPU through
``tools/spans.py``."""
from types import SimpleNamespace

import pytest

from masklab_tpu_torch.utils.profiling import Span
from perfbench.harness import spans as sp
from perfbench.harness import spec
from perfbench.tests import small
from perfbench.tools import spans as tool

LOOP, PREFETCH = 1, 2
MS = 1_000_000


def _span(name, id, parent, start, end, thread=LOOP, cpu=0, **attrs):
    return Span(name, id, parent, thread, start * MS, end * MS, cpu * MS,
                attrs)


def _loop_spans():
    """Two steps on [0, 40) and [50, 90) ms; nothing open in [40, 50)."""
    out = []
    for i, t in enumerate((0, 50)):
        s = 10 * i
        out += [_span('step', s, None, t, t + 40, k=i),
                _span('stage:data_wait', s + 1, s, t, t + 10),
                _span('stage:pad', s + 2, s, t + 10, t + 12),
                _span('stage:upload', s + 3, s, t + 12, t + 15),
                _span('stage:forward', s + 4, s, t + 15, t + 25),
                _span('stage:backward', s + 5, s, t + 25, t + 35),
                _span('stage:optimizer', s + 6, s, t + 36, t + 40)]
    return out


def _trace(busy_ms, t0=0, t1=100):
    return SimpleNamespace(busy_ns=[(a * MS, b * MS) for a, b in busy_ms],
                           t0_ns=t0 * MS, t1_ns=t1 * MS,
                           window_s=(t1 - t0) / 1e3)


def test_innermost_span_pieces():
    pieces = sp.innermost(_loop_spans(), LOOP)
    assert pieces[:3] == [(0, 10 * MS, 'stage:data_wait'),
                          (10 * MS, 12 * MS, 'stage:pad'),
                          (12 * MS, 15 * MS, 'stage:upload')]
    # the step itself between the backward and the optimizer
    assert (35 * MS, 36 * MS, 'step') in pieces
    assert all(not (40 * MS <= a < 50 * MS) for a, _, _ in pieces)


def test_idle_attribution_on_a_synthetic_trace():
    """Busy [20, 30) and [60, 65) ms of a 100 ms window: the idle rest is
    split by the loop's innermost span, [40, 50) and [90, 100) under
    none."""
    busy = [(20, 30), (60, 65)]
    by = sp.idle_by_span(_trace(busy).busy_ns, _loop_spans(), 0, 100 * MS)
    want = {'stage:data_wait': 0.020, 'stage:pad': 0.002,
            'stage:upload': 0.003, 'stage:forward': 0.015,
            'stage:backward': 0.015, 'step': 0.002,
            'stage:optimizer': 0.008, 'untraced': 0.020}
    assert by.keys() == want.keys()
    for k, v in want.items():
        assert by[k] == pytest.approx(v), k
    assert sum(by.values()) == pytest.approx(0.085)
    run = dict(trace=_trace(busy), spans=_loop_spans(), program_counts={})
    assert sp.idle_in('data_wait')(run) == pytest.approx(20.0)
    assert sp.idle_in('pad_upload')(run) == pytest.approx(5.0)
    assert sp.idle_in('step_host')(run) == pytest.approx(38.0)
    gaps = dict(sp.labelled_gaps(_trace(busy).busy_ns, _loop_spans(), 0,
                                 100 * MS))
    assert gaps['untraced'] == pytest.approx(0.010)
    assert gaps['stage:data_wait'] == pytest.approx(0.010)


def test_idle_intervals_clip_to_the_window():
    assert sp.idle_intervals([(-5, 3), (4, 6), (9, 12)], 0, 10) == [
        (3, 4), (6, 9)]
    assert sp.idle_intervals([], 0, 10) == [(0, 10)]


def test_readers_of_spans_and_counters():
    spans = _loop_spans() + [
        _span('data:batch', 100, None, 0, 30, PREFETCH, cpu=15, k=0),
        _span('data:read', 101, 100, 0, 20, PREFETCH, cpu=12),
        _span('data:queue_put', 102, 100, 25, 30, PREFETCH, cpu=0),
        _span('data:batch', 103, None, 30, 50, PREFETCH, cpu=20, k=1),
        _span('data:read', 104, 103, 30, 40, PREFETCH, cpu=10),
        # the data's end: no batch, no k
        _span('data:batch', 105, None, 50, 51, PREFETCH, cpu=1)]
    run = dict(trace=None, spans=spans, counters={'window_s': 0.1},
               program_counts={'data.queue_empty': 1,
                               'upload.pageable_bytes': 3 * 2 ** 20})
    assert sp.span_mean_ms('data:batch')(run) == pytest.approx(25.0)
    assert sp.span_mean_ms('data:read')(run) == pytest.approx(15.0)
    assert sp.build_cpu_share(run) == pytest.approx(100.0 * 35 / 45)
    assert sp.queue_empty_share(run) == pytest.approx(50.0)
    assert sp.upload_pageable_mib(run) == pytest.approx(1.5)
    assert sp.step_host_ms(run) == pytest.approx(30.0)
    assert sp.data_wait_share(run) == pytest.approx(20.0)


@pytest.mark.parametrize('name', list(tool.SPAN_METRICS))
def test_each_reader_returns_none_where_the_run_holds_nothing(name):
    read = spec.reader(name)
    parent_run = dict(trace=None, counters={'window_s': 1.0, 'steps': 3},
                      roofline={}, flops_per_frame=0.0, peak_bytes=0,
                      device='cuda')
    assert read(parent_run) is None
    assert read(dict(parent_run, spans=[], program_counts={})) is None


def test_tool_runs_a_small_traced_train_cell_on_the_cpu():
    """The program's counters and spans reach the readers through the
    harness's own run: every metric that does not need the device's
    intervals reads a number, and the run is correct."""
    bench = spec.load_benchmark()
    out = tool.run(small.args('road-train-all', 2 ** 31 + 5, 2.0, trace=1),
                   bench, device='cpu', check_card=False,
                   config=small.small_train_config(),
                   traffic=small.small_train_traffic(),
                   limits=dict(grad_gap=0.05, change_gap=0.05,
                               grad_group_gap=0.1, change_group_gap=0.1,
                               stats_gap=0.1, box_gap=0.1, start_gap=0.0,
                               data_rows_off=0, data_boxes_gap=1.0))
    assert out['correct'], out['checks']
    got = set(out['span_metrics'])
    # the CPU trainer uploads nothing
    assert got >= {'train.data.build_ms', 'train.data.read_ms',
                   'train.data.build_cpu_share',
                   'train.data.queue_empty_share', 'train.step_host_ms'}
    assert 'train.upload_pageable_mib' not in got
    extras = out['span_extras']
    assert extras['decoded_images_a_batch'] == pytest.approx(3.0)
    assert extras['data_wait_span_share'] > 0
    assert out['e2e_traced']['train_img_per_s'] > 0
    # the benchmark's own metrics are read as before
    assert 'device.idle_share.train' not in out['metrics']


def _event(name, start_us, end_us):
    import torch
    return SimpleNamespace(
        name=name, device_type=torch.autograd.DeviceType.CUDA,
        time_range=SimpleNamespace(start=start_us, end=end_us),
        is_user_annotation=False)


@pytest.mark.parametrize('calls', [0, 2])
def test_clock_kernels_are_taken_out_of_the_marks(calls):
    """The first and last spin kernels belong to the two ``clock`` spans:
    the marks are read without them, and each kernel's start is measured
    against its span."""
    base = 10 ** 18
    tr = sp.SpannedTrace('cuda')
    tr.prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(trace_start_ns=lambda: base)))
    tr.spans = [Span('clock', 0, None, LOOP, base, base + 50_000, 0, {}),
                Span('clock', 1, None, LOOP, base + 10 * MS,
                     base + 10 * MS + 40_000, 0, {})]
    events = [_event('spin_kernel', 100, 105),
              _event('spin_kernel', 10_000 + 700, 10_000 + 705)]
    for c in range(calls):
        t = 1000 + 2000 * c
        events[1:1] = [_event('spin_kernel', t + i * 100, t + i * 100 + 5)
                       for i in range(4)]
        events.append(_event('elementwise_kernel', t + 150, t + 250))
    tr._read(events)
    assert tr.marks == 4 * calls
    assert tr.clock['kernel_after_span_start_ms'] == pytest.approx(
        [0.1, 0.7])
    assert tr.clock['span_end_plus_1ms_after_kernel_ms'] == pytest.approx(
        [0.95, 0.34])
    assert tr.clock['inside']
    # the kernels' offsets from their spans' ends: +50 us, then +660 us
    assert tr.clock['drift_ms'] == pytest.approx(0.61)
    assert tr.busy_s == pytest.approx(calls * 100e-6)
    if calls:
        # mapped back through the line: at 1.15 ms the offset is 50 us +
        # 0.61 ms x 1.05 / 10.6
        a, b = tr.busy_ns[0]
        shift = 50_000 + 610_000 * (1_150_000 - 100_000) / 10_600_000
        assert a - base == pytest.approx(1_150_000 - shift, abs=2)
        assert b - a == pytest.approx(100_000 * (1 - 0.61 / 10.6), abs=2)
