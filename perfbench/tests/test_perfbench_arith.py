"""The benchmark's arithmetic on hand-made inputs: medians and spreads, the error measures, the kernels' operation counts, roofline
shares and MFU."""
import math
import statistics
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench.harness import readings, stats
from perfbench.harness.trace import KernelCalls, Trace, roofline_shares
from perfbench.reference import judge, roofline


def test_median_and_spread():
    assert stats.median([3, 1, 2]) == 2
    q1, q2, q3 = statistics.quantiles([1, 2, 3, 4, 5, 6], n=4)
    assert stats.spread([1, 2, 3, 4, 5, 6]) == pytest.approx((q3 - q1) / q2)


def test_nrmse_is_scale_free():
    want = torch.tensor([2.0, 2.1, 1.9, 2.0])
    got = want + torch.tensor([0.01, -0.01, 0.01, -0.01])
    rms_spread = math.sqrt(0.005)
    assert stats.nrmse(got, want) == pytest.approx(0.01 / rms_spread)
    assert stats.nrmse(want * 10, want * 10) == 0.0


def test_rows_gap():
    want = np.array([[0, 10, 10, 4, 4, .9, 100, 1, 1, 1, 1.0],
                     [5, 50, 50, 8, 8, .5, 30, 1, 1, 1, 0.0]])
    assert judge.rows_gap(want, want) == 0.0
    got = want.copy()
    got[0, 1] = 12          # a box moved
    assert judge.rows_gap(got, want) == pytest.approx(2 / 62)
    got = want.copy()
    got[0, 6] = 110
    assert judge.rows_gap(got, want) == pytest.approx(10 / 140)
    assert judge.rows_gap(np.zeros((0, 11)), want) == 1.0


def test_kernel_counts():
    flops, nbytes = roofline.band_groupnorm(1600, 196, 128, 2, True)
    assert nbytes == 2 * 1600 * 196 * 128 * 2 + 2 * 128 * 4
    assert flops == 1600 * 196 * 128 * 8
    # PR 10's bound of K1 at this map: 0.0479 ms, set by the bytes
    assert roofline.bound_s(flops, nbytes) * 1e3 == pytest.approx(0.0479,
                                                                   abs=2e-4)
    flops, nbytes = roofline.segment_topk(16 * 5, 81840, 16, 128)
    assert nbytes == 80 * 81840 * 4 + 80 * 16 * 640 * 8
    flops, nbytes = roofline.nms_keep(80, 256)
    assert flops == 80 * 256 * 255 / 2 * 12


def test_roofline_share_time_weighted():
    tr = Trace('cpu')
    calls = KernelCalls()
    calls.calls = {'band_groupnorm': [(10, 196, 128, 2, False)] * 2,
                   'nms_keep': [(80, 256)]}
    gn = roofline.bound_s(*roofline.band_groupnorm(10, 196, 128, 2, False))
    nk = roofline.bound_s(*roofline.nms_keep(80, 256))
    tr.kernel_s = {'band_groupnorm': [2 * gn, 2 * gn], 'nms_keep': [10 * nk]}
    shares = roofline_shares(tr, calls)
    assert shares['band_groupnorm'] == pytest.approx(50.0)
    assert shares['nms_keep'] == pytest.approx(10.0)
    assert shares['kernels'] == pytest.approx(
        100 * (2 * gn + nk) / (4 * gn + 10 * nk))
    assert 'segment_topk' not in shares


def test_mfu_idle_and_per_frame():
    tr = SimpleNamespace(window_s=2.0, busy_s=0.5,
                         stage_busy_s={'forward': 0.3, 'postprocess': 0.1})
    run = dict(trace=tr, counters={'traced_frames': 100},
               flops_per_frame=1.5e11, peak_bytes=2 ** 31, roofline={})
    assert readings.mfu(run) == pytest.approx(
        100 * 1.5e11 * 100 / 2.0 / 989e12)
    assert readings.idle_share(run) == pytest.approx(75.0)
    assert readings.forward_busy_ms_per_frame(run) == pytest.approx(3.0)
    assert readings.post_busy_ms_per_frame(run) == pytest.approx(1.0)
    assert readings.peak_gib(run) == 2.0
    assert readings.mfu(dict(run, trace=None)) is None
    empty = SimpleNamespace(window_s=2.0, busy_s=0.0, stage_busy_s={})
    assert readings.idle_share(dict(run, trace=empty)) is None
    assert readings.forward_busy_ms_per_frame(dict(run, trace=empty)) is None


def test_marks_split_the_device_time():
    from perfbench.harness import trace
    cuda = torch.autograd.DeviceType.CUDA

    def op(name, start_us, end_us):
        return SimpleNamespace(device_type=cuda, name=name,
                               time_range=SimpleNamespace(start=start_us,
                                                          end=end_us))
    spin = 'at::cuda::(anonymous namespace)::spin_kernel(long)'
    # every mark spins alike: each is read by its place in the cycle
    events = [op(spin, 0, 5), op('Memcpy HtoD', 6, 10),
              op(spin, 12, 17), op('conv<bf16>(x)', 27, 127),
              op('segment_topk_kernel<16>(float)', 130, 140),
              op(spin, 140, 145), op('reduce_kernel', 170, 200),
              op('Memcpy DtoH', 200, 210), op(spin, 210, 215),
              op(spin, 1260, 1265), op('elementwise', 1300, 1301)]
    tr = trace.Trace('cuda')
    tr._read(events)
    assert tr.marks == 5
    assert tr.stage_busy_s['forward'] == pytest.approx(110e-6)
    assert tr.stage_busy_s['postprocess'] == pytest.approx(30e-6)
    assert tr.busy_s == pytest.approx((4 + 100 + 10 + 30 + 10 + 1) * 1e-6)
    assert tr.kernel_s == {'segment_topk': [pytest.approx(10e-6)]}
    assert dict(tr.idle_gaps) == {
        'between calls': pytest.approx(1045e-6),
        'upload and downsample': pytest.approx(35e-6),
        'postprocess and download': pytest.approx(25e-6),
        'forward': pytest.approx(10e-6)}


def test_marks_must_be_four_a_call():
    from perfbench.harness.trace import check_marks
    check_marks(8, 2)
    check_marks(0, None)
    for marks, calls in ((5, 1), (7, 2), (4, None)):
        with pytest.raises(RuntimeError):
            check_marks(marks, calls)


def test_idle_gaps_and_busy_from_intervals():
    from perfbench.harness.trace import _merged
    assert _merged([(0, 1), (0.5, 2), (3, 4)]) == [(0, 2), (3, 4)]
