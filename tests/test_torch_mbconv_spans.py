"""The EfficientNet body's spans (``nn/backbone/efficientnet.py``): a small
efficientnetb4 MaskLab on the CPU (the body at B4's own widths and depth,
the heads 16 wide and forced dense, 128x128 frames) records one
``mbconv:depthwise``, ``mbconv:se`` and ``mbconv:project`` a block and one
``mbconv:expand`` a block that expands (30 of B4's 32; stage 0's blocks do
not), under a profiler as under the recorder; every such span lies inside
``stage:raw_heads`` and holds no other; and the spans change no bit of the
model's outputs."""
import collections

import pytest
import torch

import masklab_tpu_torch as mt
from masklab_tpu_torch.nn.backbone.efficientnet import _MBConv
from masklab_tpu_torch.utils import profiling

PARTS = ('mbconv:expand', 'mbconv:depthwise', 'mbconv:se', 'mbconv:project')


@pytest.fixture(autouse=True)
def recorder_off():
    profiling.stop_recording()
    yield
    profiling.stop_recording()


@pytest.fixture(scope='module')
def model():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    cfg = mt.ModelConfiguration()
    cfg.backbone.backbone_type = 'efficientnetb4'
    cfg.backbone.num_features = 16
    cfg.backbone.backbone_outputs = ('C3', 'C4', 'C5')
    cfg.detection.feature_pyramid_inputs = ('C3', 'C4', 'C5')
    for g in (cfg.detection, cfg.instance, cfg.semantic):
        g.num_features = 16
        g.num_depth = 1
    cfg.instance.crop_size = (7, 7)
    cfg.semantic.num_aspp_features = 16
    cfg.semantic.num_skip_features = 8
    cfg.detection.nms_max_output_size = 4
    cfg.compute.nms_candidates_per_class = 8
    yield mt.force_dense(mt.build_masklab(cfg, device='cpu', seed=0))
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def images():
    gen = torch.Generator().manual_seed(5)
    return torch.rand(2, 128, 128, 3, generator=gen) * 255


def _want(model):
    """Each part's spans a forward, from the model's own blocks."""
    blocks = [m for m in model.modules() if isinstance(m, _MBConv)]
    expanding = sum(b.expand != 1 for b in blocks)
    assert (len(blocks), expanding) == (32, 30)
    return {'mbconv:expand': expanding, 'mbconv:depthwise': len(blocks),
            'mbconv:se': len(blocks), 'mbconv:project': len(blocks)}


def test_profiler_sees_each_part_once_a_block(model, images):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            torch.no_grad():
        model(images)
    names = collections.Counter(e.name for e in prof.events())
    assert {p: names[p] for p in PARTS} == _want(model)
    assert names['stage:raw_heads'] == 1


def test_recorded_parts_sit_in_raw_heads_and_hold_no_other(model, images):
    profiling.start_recording()
    with torch.no_grad():
        model(images)
    spans, _ = profiling.drain()
    by_id = {s.id: s for s in spans}
    parts = [s for s in spans if s.name.startswith('mbconv:')]
    assert collections.Counter(s.name for s in parts) == _want(model)
    for s in parts:
        chain, parent = [], s.parent
        while parent is not None:
            chain.append(by_id[parent].name)
            parent = by_id[parent].parent
        assert 'stage:raw_heads' in chain, (s.name, chain)
        assert not any(n.startswith('mbconv:') for n in chain), (s.name,
                                                                 chain)


def test_spans_change_no_bit_of_the_outputs(model, images):
    """The same forward with both off, with the recorder on and under a
    profiler: every output equal bit for bit."""
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        off = model(images)
        profiling.start_recording()
        recorded = model(images)
        profiling.stop_recording()
        with profile(activities=[ProfilerActivity.CPU]):
            profiled = model(images)
    assert (off['roi_boxes'][..., 4] >= 0).any()
    for out in (recorded, profiled):
        assert out.keys() == off.keys()
        for k, v in off.items():
            assert torch.equal(out[k], v), k
