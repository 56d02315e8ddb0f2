"""The benchmark's seeded weights (``harness/weights.py``): every entry of
an efficientnetb4 MaskLab at its published widths is filled, and on a
540x960 road frame in float32 its stage outputs stay O(1) with no
squeeze-excite gate saturated; the two configurations' states are bit for
bit those of the rules as they were before the body's (``_parent_state``,
a copy of them); the reference builds the three EfficientNet bodies and
still refuses the fused head, the recomputed backbone and separable
heads."""
import copy
import math

import numpy as np
import pytest
import torch
from torch import nn

from perfbench.harness import frames, spec
from perfbench.harness.main import Context
from perfbench.harness.weights import (PIXEL_MEAN, PIXEL_VAR, TRUNC,
                                       generator)
from perfbench.reference import pipeline
from perfbench.reference.masklab_plain.models.detection import \
    ClassificationSubNet
from perfbench.reference.masklab_plain.models.masklab import MaskLab
from perfbench.reference.masklab_plain.nn.backbone import efficientnet
from perfbench.reference.masklab_plain.nn.layers import (BatchNorm,
                                                         GroupNorm,
                                                         SqueezeExcite)

SEED = 2 ** 31 + 17


def _config(name: str, body: str = None) -> dict:
    bench = spec.load_benchmark()
    config = copy.deepcopy(spec.config_of(bench, {'config': name}))
    if body:
        config['model']['backbone']['backbone_type'] = body
    return config


def _parent_state(model, seed, device, force_dense):
    """The seeded state by the rules before the EfficientNet body's."""
    cls_outputs, dense_scale = set(), {}
    for m in model.modules():
        if isinstance(m, ClassificationSubNet):
            cls_outputs.update(getattr(m, f'output_{i}')
                               for i in range(m.num_blocks))
        elif isinstance(m, SqueezeExcite):
            d0, d1 = m.Dense_0, m.Dense_1
            dense_scale[d0] = 2.0 / d0.in_features
            dense_scale[d1] = 2.0 / (d1.in_features + d1.out_features)
    random, constant = {}, {}
    for prefix, m in model.named_modules():
        p = prefix + '.' if prefix else ''
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = m.in_channels // m.groups * math.prod(m.kernel_size)
            random[p + 'weight'] = math.sqrt(1.0 / fan_in) / TRUNC
            if m.bias is not None:
                constant[p + 'bias'] = force_dense if m in cls_outputs else 0.0
        elif isinstance(m, nn.Linear):
            random[p + 'weight'] = math.sqrt(
                dense_scale.get(m, 1.0 / m.in_features)) / TRUNC
            if m.bias is not None:
                constant[p + 'bias'] = 0.0
        elif isinstance(m, (GroupNorm, BatchNorm)):
            if m.weight is not None:
                constant[p + 'weight'] = 1.0
            constant[p + 'bias'] = 0.0
            if isinstance(m, BatchNorm):
                image = m.running_mean.numel() == 3
                constant[p + 'running_mean'] = PIXEL_MEAN if image else 0.0
                constant[p + 'running_var'] = PIXEL_VAR if image else 1.0
    entries = model.state_dict()
    total = sum(entries[n].numel() for n in random)
    flat = torch.randn(total, generator=generator(seed, device),
                       device=device).clamp_(-2.0, 2.0)
    state, at = {}, 0
    for name, t in entries.items():
        if name in random:
            n = t.numel()
            state[name] = flat[at:at + n].view(t.shape).mul(random[name])
            at += n
        elif isinstance(constant.get(name), list):
            state[name] = torch.tensor(constant[name], dtype=torch.float32,
                                       device=device)
        elif name in constant:
            state[name] = torch.full(t.shape, constant[name],
                                     dtype=torch.float32, device=device)
        else:
            state[name] = t.to(device)
    return state


@pytest.mark.parametrize('name', ['road-seresnet34-bf16', 'resnet50-bf16'])
def test_seeded_states_of_the_configurations_are_unchanged(name):
    config = _config(name)
    ctx = Context({}, config, {}, SEED, 1.0, False, 'cpu')
    got = ctx.weights()
    ctx.close()
    with torch.device('meta'):
        shape = MaskLab(pipeline.config(config['model']))
    want = _parent_state(shape, SEED, 'cpu',
                         config['weights']['force_dense'])
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k


def test_weights_fill_an_efficientnetb4_model_at_its_widths():
    """resnet50-bf16's configuration with the efficientnetb4 body: every
    floating entry filled, the body's BatchNorm statistics calibrated; on a
    540x960 road frame in float32 each stage's output RMS lies in [0.1, 30]
    and no squeeze-excite gate is under 0.01 or over 0.99."""
    config = _config('resnet50-bf16', 'efficientnetb4')
    ctx = Context({}, config, {}, SEED, 1.0, False, 'cpu')
    state = ctx.weights()
    ctx.close()
    model = pipeline.build(config['model'], state, 'cpu')
    entries = model.state_dict()
    assert set(entries) == set(state)
    for k, v in state.items():
        assert v.shape == entries[k].shape, k
        assert bool(torch.isfinite(v).all()), k
    body = model.backbone.EfficientNet_0
    assert sum(p.numel() for p in body.parameters()) == 17_548_616
    calibrated = [v for k, v in state.items()
                  if k.startswith('backbone.EfficientNet_0.')
                  and k.endswith('running_var')]
    assert len(calibrated) == 96
    assert all(bool((v > 0).all()) and not bool((v == 1).all())
               for v in calibrated)
    rms, gates = {}, []
    last = {si: bi for si, bi in body.blocks}
    hooks = [getattr(body, f'stage{si}_block{bi}').register_forward_hook(
        lambda m, a, o, si=si: rms.__setitem__(
            si, float(o[0].square().mean().sqrt())))
        for si, bi in last.items()]
    for m in body.modules():
        if isinstance(m, efficientnet._MBConv):
            gate = getattr(m, f'Conv_{3 if m.expand != 1 else 2}')
            hooks.append(gate.register_forward_hook(
                lambda m, a, o: gates.append(torch.sigmoid(o).flatten())))
    frame = frames.road_frame(np.random.default_rng(5), (540, 960), 3.0)
    with torch.no_grad():
        model.raw_heads(torch.from_numpy(frame)[None].float())
    for h in hooks:
        h.remove()
    assert len(rms) == 7 and all(0.1 <= v <= 30 for v in rms.values()), rms
    g = torch.cat(gates)
    assert g.numel() == 27_864
    assert float(((g < 0.01) | (g > 0.99)).float().mean()) == 0.0


@pytest.mark.parametrize('body', ['efficientnetb2', 'efficientnetb3',
                                  'efficientnetb4'])
def test_reference_builds_the_efficientnet_bodies(body):
    model_dict = _config('resnet50-bf16', body)['model']
    with torch.device('meta'):
        model = MaskLab(pipeline.config(model_dict))
    channels = efficientnet.CHANNELS[body]
    fpn_inputs = {m.in_channels for m in model.modules()
                  if isinstance(m, nn.Conv2d)}
    assert {channels['C3'], channels['C4'], channels['C5']} <= fpn_inputs


@pytest.mark.parametrize('change', [
    ('compute', 'fused_mask_head'), ('compute', 'remat_backbone'),
    ('detection', 'use_separable_conv'), ('instance', 'use_separable_conv'),
    ('semantic', 'use_separable_conv')])
def test_reference_refuses_what_it_does_not_run(change):
    model_dict = _config('resnet50-bf16', 'efficientnetb4')['model']
    group, key = change
    model_dict[group][key] = True
    with pytest.raises(NotImplementedError), torch.device('meta'):
        MaskLab(pipeline.config(model_dict))
