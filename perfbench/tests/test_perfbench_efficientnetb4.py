"""The cell ``efficientnetb4-batch-summarize``: its configuration is the
CLI's default deployment with the EfficientNet-B4 body and nothing else
changed; the plain reference agrees with the program on it in float32 at a
small size; the readers of the MBConv blocks' spans read each span's device
time a frame, and nothing where the span is absent; and each of the cell's
limits lies between the readings it was set from."""
import copy
import json
import os

import pytest

from perfbench.harness import spec
from perfbench.harness.trace import Trace
from perfbench.tests import test_perfbench_reference
from perfbench.tests.test_perfbench_device_spans import SPIN, _event

CELL = 'efficientnetb4-batch-summarize'
CONFIG = 'efficientnetb4-bf16'
PARTS = ('expand', 'depthwise', 'se', 'project')
# keys that describe the configuration and change no number of it
DESCRIPTIVE = ('name', 'source', 'deployment', 'input')


def _json(*parts):
    with open(os.path.join(spec.PERFBENCH, *parts)) as f:
        return json.load(f)


def test_configuration_is_resnet50s_with_the_b4_body():
    b4 = _json('configs', CONFIG + '.json')
    r50 = _json('configs', 'resnet50-bf16.json')
    assert b4['model']['backbone']['backbone_type'] == 'efficientnetb4'
    assert b4['reduced'] == {} and b4['assumed'] == r50['assumed']
    swapped = copy.deepcopy(r50['model'])
    swapped['backbone']['backbone_type'] = 'efficientnetb4'
    assert b4['model'] == swapped
    rest = {k: v for k, v in b4.items() if k not in DESCRIPTIVE + ('model',)}
    assert rest == {k: v for k, v in r50.items()
                    if k not in DESCRIPTIVE + ('model',)}
    assert b4['name'] == CONFIG
    [entry] = [c for c in spec.load_benchmark()['configs']
               if c['name'] == CONFIG]
    assert entry['file'] == f'perfbench/configs/{CONFIG}.json'
    assert entry['reduced'] == [] and len(entry['source']) <= 200


def test_reference_equals_program_in_float32():
    """``test_perfbench_reference``'s comparison, with its tolerances, on
    this configuration's own file."""
    test_perfbench_reference.test_reference_equals_program_in_float32(
        CONFIG)


def _b4_call():
    """One predict call: its four marks; ``stage:raw_heads`` whose own
    kernels (the stem, the top conv, the heads) come before and after two
    blocks, the first without an expansion; then ``stage:nms``."""
    events = [
        _event(SPIN, 0, 1), _event(SPIN, 2, 3),
        _event('stage:raw_heads', 4, 80, True), _event('conv(stem)', 4, 8),
        _event('mbconv:depthwise', 8, 14, True), _event('dw(x)', 8, 12),
        _event('elementwise(bn)', 12, 14),
        _event('mbconv:se', 15, 18, True), _event('reduce(x)', 15, 16),
        _event('gemm(x)', 16, 17), _event('elementwise(x)', 17, 18),
        _event('mbconv:project', 18, 25, True), _event('gemm(x)', 18, 25),
        _event('mbconv:expand', 26, 36, True), _event('gemm(x)', 26, 30),
        _event('elementwise(bn)', 30, 36),
        _event('mbconv:depthwise', 36, 44, True), _event('dw(x)', 36, 44),
        _event('mbconv:se', 44, 46, True), _event('reduce(x)', 44, 46),
        _event('mbconv:project', 46, 50, True), _event('gemm(x)', 46, 50),
        _event('conv(top)', 50, 60), _event('conv(heads)', 62, 80),
        _event('stage:nms', 81, 85, True), _event('reduce(x)', 81, 85),
        _event(SPIN, 86, 87), _event(SPIN, 90, 91)]
    return events, {'expand': 10, 'depthwise': 6 + 8, 'se': 3 + 2,
                    'project': 7 + 4}


@pytest.mark.parametrize('part', PARTS)
def test_mbconv_span_readers(part):
    """Each reader gives its span's device ms a frame; the four lie inside
    ``stage:raw_heads``' reading; a trace without the span (the parent's
    program) reads None."""
    read = spec.reader(f'forward.mbconv_{part}_busy_ms_per_frame.batch')
    events, want_us = _b4_call()
    tr = Trace('cuda')
    tr._read(events)
    run = dict(trace=tr, counters={'traced_frames': 4}, roofline={},
               flops_per_frame=0.0, peak_bytes=0, device='cuda')
    assert read(run) == pytest.approx(want_us[part] * 1e-3 / 4)
    raw = spec.reader('forward.raw_heads_busy_ms_per_frame.batch')(run)
    assert raw == pytest.approx((80 - 4 - 1 - 1 - 2) * 1e-3 / 4)
    assert sum(want_us.values()) * 1e-3 / 4 <= raw
    bare = Trace('cuda')
    bare._read([e for e in events if not e.name.startswith('mbconv:')])
    assert read(dict(run, trace=bare)) is None
    assert read(dict(run, trace=None)) is None


def test_limits_lie_between_their_readings():
    """Each limit lies between its lower reading (the largest sound one)
    and its upper (the float8 control's least), earlier seeds' extremes
    counted; every sound seed recorded passes every limit and the control
    fails on every seed recorded."""
    data = _json('limits', CELL + '.json')
    limits = spec.limits_of(CELL)
    sound, control = data['sound'], data['control']
    earlier, earlier_control = data['sound_earlier'], data['control_earlier']
    assert len(sound) >= 12 and len(sound) + earlier['seeds'] >= 28
    assert len(control) >= 5
    for name, n in data['numbers'].items():
        assert n['lower'] <= n['limit'], name
        assert n['lower'] == max([r[name] for r in sound.values()]
                                 + [earlier['max'][name]]), name
        if n['upper'] is None:
            continue
        assert n['limit'] < n['upper'], name
        assert n['upper'] == min([r[name] for r in control.values()]
                                 + [earlier_control['min'][name]]), name
    for seed, r in sound.items():
        assert all(r[k] <= limits[k] for k in limits), seed
    for seed, r in control.items():
        assert any(r[k] > limits[k] for k in ('heads_nrmse', 'masks_nrmse'))
