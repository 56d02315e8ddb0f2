"""The port's span recorder (``utils.profiling``): off by default and then
silent, spans with their threads, parents, CPU time and attributes, the
trainer's spans on its prefetch thread and its loop paired by batch, the
counters, and the clock shared with the profiler's trace."""
import json
import os
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch

import masklab_tpu_torch as mt
from masklab_tpu_torch.data import (MaskLabGenerator, PrefetchIterator,
                                    make_random_batch, make_synthetic_dataset)
from masklab_tpu_torch.data.process import process_dataset
from masklab_tpu_torch.train import as_batch
from masklab_tpu_torch.train.trainer import (MaskLabTrainer,
                                             construct_masklab_datasets)
from masklab_tpu_torch.utils import count, device_trace, profiling, span

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_STAGES = {'stage:data_wait', 'stage:pad', 'stage:upload',
               'stage:forward', 'stage:losses', 'stage:backward',
               'stage:optimizer'}


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off."""
    profiling.stop_recording()
    yield
    profiling.stop_recording()


@pytest.fixture(scope='module')
def trainer(tmp_path_factory):
    """A narrow CPU trainer over 6 synthetic 128x160 frames, batch 2."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    root = str(tmp_path_factory.mktemp('tracing'))
    data_dir = os.path.join(root, 'data')
    make_synthetic_dataset(data_dir, num_images=6, image_hw=(128, 160),
                           seed=3)
    process_dataset(data_dir, num_workers=1)
    cfg = mt.ModelConfiguration()
    cfg.backbone.backbone_type = 'mobilenet'
    cfg.backbone.num_features = 16
    cfg.backbone.backbone_outputs = ('C3', 'C4', 'C5')
    cfg.detection.feature_pyramid_inputs = ('C3', 'C4', 'C5')
    for g in (cfg.detection, cfg.instance, cfg.semantic):
        g.num_features = 16
        g.num_depth = 1
    cfg.instance.crop_size = (7, 7)
    cfg.semantic.num_aspp_features = 16
    cfg.detection.nms_max_output_size = 4
    cfg.loss.nms_max_output_size = 4
    cfg.compute.nms_candidates_per_class = 8
    cfg.compute.scale_buckets = (0.5,)
    cfg.train.scale_ratio = (0.5, 0.5)
    cfg.train.batch_size = 2
    cfg.dataset.data_dir = data_dir
    cfg.dataset.min_area = 50.0
    cfg.train.save_dir = os.path.join(root, 'run')
    trainset, _ = construct_masklab_datasets(cfg)
    t = MaskLabTrainer(cfg, device='cpu', log_fn=lambda *a: None)
    t.init_state(None)
    t.generator = MaskLabGenerator(trainset.get_config(), scale_ratio=(0.5,
                                   0.5), batch_size=2, scale_buckets=(0.5,),
                                   seed=0)
    yield t
    torch.set_num_threads(before)


def _train_two_steps(t):
    t.run_phase('all', t.generator, None, 1, 1e-4, 1e-3, 4, 'C0',
                steps_per_epoch=2)


def test_spans_and_counts_off_by_default_record_nothing(trainer,
                                                        monkeypatch):
    """With the recorder off and no profiler running, a train step and a
    prefetched batch make no span object and keep nothing."""
    made = []

    class Counting(profiling._Span):
        __slots__ = ()

        def __init__(self, *args):
            made.append(args[1])
            super().__init__(*args)
    monkeypatch.setattr(profiling, '_Span', Counting)
    assert profiling._recorder is None
    _train_two_steps(trainer)
    pf = PrefetchIterator(trainer.generator, prefetch=1)
    assert next(iter(pf))['images'].shape[0] == 2
    pf.close()
    count('data.decoded_images')
    assert made == []
    assert span('stage:pad') is profiling._OFF
    assert profiling.drain() == ([], {})


def test_nested_spans_carry_their_parents_and_attributes():
    profiling.start_recording()
    with span('outer', k=7) as outer:
        with span('inner'):
            pass
        outer.set(extra=1)
    with span('after'):
        pass
    spans, counts = profiling.drain()
    by = {s.name: s for s in spans}
    assert set(by) == {'outer', 'inner', 'after'} and counts == {}
    assert by['inner'].parent == by['outer'].id
    assert by['outer'].parent is None and by['after'].parent is None
    assert by['outer'].attrs == {'k': 7, 'extra': 1}
    assert by['outer'].start_ns <= by['inner'].start_ns
    assert by['inner'].end_ns <= by['outer'].end_ns
    assert {s.thread for s in spans} == {threading.get_ident()}
    assert profiling.drain() == ([], {})


def test_thread_cpu_time_is_recorded():
    """A span around 30 ms of this thread's CPU work records at least that
    and at most its wall time; one around a 50 ms sleep records little."""
    profiling.start_recording()
    with span('spin'):
        end = time.thread_time_ns() + 30_000_000
        while time.thread_time_ns() < end:
            pass
    with span('sleep'):
        time.sleep(0.05)
    by = {s.name: s for s in profiling.drain()[0]}
    spin, sleep = by['spin'], by['sleep']
    assert 30_000_000 <= spin.cpu_ns <= spin.end_ns - spin.start_ns + 1e6
    assert sleep.end_ns - sleep.start_ns >= 50_000_000
    assert sleep.cpu_ns < 10_000_000


def test_trainer_spans_pair_the_prefetch_thread_with_the_loop(trainer):
    """The prefetch thread's ``data:batch`` spans (with ``data:read``,
    ``data:rescale`` and ``data:queue_put`` inside) carry the batch's
    ``k``, and the loop's ``step`` span of that batch the same ``k``, its
    stages inside it; the slice decodes its first image twice."""
    profiling.start_recording()
    _train_two_steps(trainer)
    spans, counts = profiling.drain()
    profiling.stop_recording()
    loop = threading.get_ident()
    steps = [s for s in spans if s.name == 'step']
    assert len(steps) == 2 and {s.thread for s in steps} == {loop}
    batches = {s.attrs['k']: s for s in spans if s.name == 'data:batch'
               and 'k' in s.attrs}
    assert {s.attrs['k'] for s in steps} <= set(batches)
    assert {s.thread for s in batches.values()} - {loop}, \
        'data:batch spans belong to the prefetch thread'
    by_id = {s.id: s for s in spans}
    for b in batches.values():
        kids = {s.name for s in spans if s.parent == b.id
                and s.thread == b.thread}
        assert kids == {'data:read', 'data:rescale', 'data:queue_put'}, kids
    for st in steps:
        kids = {s.name for s in spans if s.parent == st.id
                and s.thread == loop}
        assert {'stage:data_wait', 'stage:pad', 'stage:upload'} <= kids
        inner = {s.name for s in spans if s.thread == loop
                 and _inside(s, st.id, by_id)}
        assert STEP_STAGES <= inner, inner
    reads = [s for s in spans if s.name == 'data:read']
    assert counts['data.decoded_images'] == 3 * len(reads)
    # the CPU trainer uploads nothing
    assert 'upload.bytes' not in counts


def _inside(s, ancestor, by_id):
    while s.parent is not None:
        if s.parent == ancestor:
            return True
        s = by_id[s.parent]
    return False


def test_prefetch_queue_empty_is_counted():
    release = threading.Event()

    def slow():
        release.wait(5)
        yield {'images': np.zeros(1)}

    profiling.start_recording()
    pf = PrefetchIterator(slow(), prefetch=1)
    it = iter(pf)
    threading.Timer(0.2, release.set).start()
    next(it)
    assert pf.k is not None
    pf.close()
    assert profiling.drain()[1]['data.queue_empty'] == 1


def test_upload_counters_count_pageable_and_pinned_bytes():
    batch = make_random_batch(2, (64, 64), 4, seed=0)
    profiling.start_recording()
    as_batch(batch, 'meta')
    counts = profiling.drain()[1]
    want = sum(np.asarray(v).nbytes for v in batch.values())
    assert counts == {'upload.bytes': want, 'upload.pageable_bytes': want}
    as_batch(batch, 'cpu')
    assert profiling.drain()[1] == {}


def test_counts_and_spans_from_many_threads_lose_nothing():
    """16 threads, a short switch interval: every count and span kept,
    each thread's spans nested under that thread's own outer span."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    profiling.start_recording()
    try:
        # every thread alive at once, so that no two share an ident
        together = threading.Barrier(16)

        def work():
            together.wait(timeout=30)
            with span('outer'):
                for _ in range(200):
                    count('n')
                    with span('inner'):
                        pass
        threads = [threading.Thread(target=work) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    spans, counts = profiling.drain()
    assert counts == {'n': 16 * 200}
    outer = {s.thread: s.id for s in spans if s.name == 'outer'}
    inner = [s for s in spans if s.name == 'inner']
    assert len(outer) == 16 and len(inner) == 16 * 200
    assert all(s.parent == outer[s.thread] for s in inner)


def test_span_and_its_record_function_share_the_profilers_clock():
    """Under ``torch.profiler`` a span opens a ``record_function`` of its
    name; its start and end, at the trace's ``trace_start_ns()`` plus the
    event's offset, agree with the recorder's within 1 ms (the median of
    seven spans: a busy host can stall one thread between the two
    stamps)."""
    from torch.profiler import ProfilerActivity, profile
    profiling.start_recording()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(7):
            with span(f'stage:clock{i}'):
                time.sleep(0.005)
    ours = {s.name: s for s in profiling.drain()[0]}
    base = prof.profiler.kineto_results.trace_start_ns()
    events = {e.name: e for e in prof.events() if e.name in ours}
    assert events.keys() == ours.keys()
    starts = [base + e.time_range.start * 1e3 - ours[n].start_ns
              for n, e in events.items()]
    ends = [base + e.time_range.end * 1e3 - ours[n].end_ns
            for n, e in events.items()]
    assert abs(float(np.median(starts))) < 1e6, starts
    assert abs(float(np.median(ends))) < 1e6, ends


def test_device_trace_keeps_the_stage_names(trainer, tmp_path):
    """The recorder off, ``device_trace``'s Chrome trace still names the
    program's spans: the model forward's and the trainer's."""
    log_dir = str(tmp_path / 'trace')
    model = trainer.model.eval()
    with device_trace(log_dir), torch.no_grad():
        model(torch.zeros(1, 128, 128, 3))
        trainer._prepare(make_random_batch(1, (64, 64), 2, seed=0))
    trainer.model.train()
    [name] = [f for _, _, fs in os.walk(log_dir) for f in fs
              if f.endswith('.pt.trace.json')]
    names = {e.get('name') for e in json.load(open(
        os.path.join(log_dir, name)))['traceEvents']}
    assert {'stage:raw_heads', 'stage:nms', 'stage:mask_branch',
            'stage:pad', 'stage:upload'} <= names


def test_no_record_function_outside_the_recorder():
    """Every span of the port goes through ``utils.profiling.span``."""
    call = re.compile(r'record_function\s*\(|import\s+record_function')
    offenders = []
    for base, _, files in os.walk(os.path.join(ROOT, 'masklab_tpu_torch')):
        for f in files:
            path = os.path.join(base, f)
            if not f.endswith('.py') or path.endswith(
                    os.path.join('utils', 'profiling.py')):
                continue
            with open(path) as fh:
                offenders += [f'{path}:{n}' for n, line in enumerate(fh, 1)
                              if call.search(line)]
    assert offenders == []
