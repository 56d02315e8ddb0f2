"""The benchmark's own seeded weights for a MaskLab-shaped model.

Every conv, transposed conv and dense layer takes flax's truncated-normal
variance scaling (lecun: 1 over the fan-in; he / glorot for the
squeeze-excite denses), the heads' stacks and outputs included, where the
reference starts them at normal(0.01): so the class scores, box deltas,
masks and semantic maps vary by O(1) about their biases, as a trained
model's do, and a mask's threshold or a score's order is not decided by
the last bits of values crowded at one point. Norm scales are 1 and shifts
0, running statistics 0 / 1, except a BatchNorm over the image's 3 colour
channels (the input norm of the seresnet family), whose running statistics
are the pixels' moments as an ImageNet-trained backbone carries them:
unnormalised pixels would drive every squeeze-excite gate into saturation,
where a gate's last bit decides a channel.

The EfficientNet body takes rules of its own. With its BatchNorms at
running statistics 0 / 1 nothing renormalizes the map, and each swish and
squeeze-excite gate shrinks it: over B4's 32 blocks the stage outputs' RMS
fell from 0.56 to 2e-6 on a 540x960 road frame. So the body's BatchNorms
carry running statistics as a trained model's do (``calibrate_norms``),
taken from one road frame drawn from the seed at the configuration's model
input, in one float32 forward of the body in which each BatchNorm
normalizes by them: the running mean is the input's mean per channel, the
running variance the mean of its channels' variances, one number a layer
(a variance per channel gives a channel that is nearly constant on that
frame a gain of hundreds, and bfloat16's rounding then decides the
outputs: heads 0.75 off float32 on the card). A residual block's branch
then adds a map as large as the one it is added to, and over a stage of
eight such blocks a rounding grows tenfold; so the projection's BatchNorm
in a block with a residual scales by ``RESIDUAL_SCALE``, as a trained
network's last norm of a residual branch starts small, and the
BatchNorms in front of a swish by ``SWISH_INPUT_SCALE``. On the card the
bfloat16 program's heads then read 0.048-0.079 off float32 over fourteen
seeds where they read 0.06-0.86 before, the stage outputs stay O(1) and no
gate saturates (PERF.md gives the readings).

The plan is read off the plain reference's
module tree; the program's model has the same parameter names, so both
sides load the one state dict. Every random value comes from one
``torch.randn`` on the device from a generator seeded by ``--seed``,
truncated at two standard deviations; the class outputs' biases are set to
the configuration's ``force_dense`` value (nearly every anchor clears
``min_confidence``, so every NMS slot fills).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..reference.masklab_plain.models.detection import ClassificationSubNet
from ..reference.masklab_plain.nn.backbone import BackboneNetwork
from ..reference.masklab_plain.nn.backbone.efficientnet import (
    EfficientNet, _MBConv)
from ..reference.masklab_plain.nn.backbone.preprocess import preprocess_for
from ..reference.masklab_plain.nn.layers import (BatchNorm, GroupNorm,
                                                 SqueezeExcite)

TRUNC = 0.87962566103423978   # std of a unit normal truncated at 2 sigma
PIXEL_MEAN = [123.68, 116.78, 103.94]     # ImageNet's RGB moments
PIXEL_VAR = [58.4 ** 2, 57.1 ** 2, 57.4 ** 2]
MASK64 = (1 << 64) - 1
CALIBRATION_NOISE = 3.0              # the calibration frame's sensor noise
RESIDUAL_SCALE = 0.25                # a residual branch's last BatchNorm
SWISH_INPUT_SCALE = 0.5              # a BatchNorm in front of a swish


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & MASK64)
    return g


def plan(model: nn.Module, force_dense: float) -> Tuple[Dict, Dict]:
    """(random: name -> std, constant: name -> value) over the model's
    state dict entries."""
    cls_outputs, dense_scale, norm_scale = set(), {}, {}
    for m in model.modules():
        if isinstance(m, ClassificationSubNet):
            cls_outputs.update(getattr(m, f'output_{i}')
                               for i in range(m.num_blocks))
        elif isinstance(m, SqueezeExcite):
            d0, d1 = m.Dense_0, m.Dense_1
            dense_scale[d0] = 2.0 / d0.in_features
            dense_scale[d1] = 2.0 / (d1.in_features + d1.out_features)
        elif isinstance(m, EfficientNet):
            for bn in (m.stem_bn, m.top_bn):
                norm_scale[bn.BatchNorm_0] = SWISH_INPUT_SCALE
        elif isinstance(m, _MBConv):
            norms = [getattr(m, f'_BN_{i}').BatchNorm_0
                     for i in range(3 if m.expand != 1 else 2)]
            for bn in norms[:-1]:
                norm_scale[bn] = SWISH_INPUT_SCALE
            if m.residual:
                norm_scale[norms[-1]] = RESIDUAL_SCALE
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
                constant[p + 'weight'] = norm_scale.get(m, 1.0)
            constant[p + 'bias'] = 0.0
            if isinstance(m, BatchNorm):
                image = m.running_mean.numel() == 3
                constant[p + 'running_mean'] = PIXEL_MEAN if image else 0.0
                constant[p + 'running_var'] = PIXEL_VAR if image else 1.0
    return random, constant


def seeded_state(model: nn.Module, seed: int, device,
                 force_dense: float) -> Dict[str, torch.Tensor]:
    """A full float32 state dict for ``model`` (a plain reference model of
    the configuration) on ``device``, drawn from ``seed``."""
    random, constant = plan(model, force_dense)
    entries = model.state_dict()
    missing = [n for n in entries if n not in random and n not in constant
               and entries[n].is_floating_point()]
    if missing:
        raise KeyError(f'no weight rule for {missing[:6]}')
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
    calibrate_norms(model, state, seed, device)
    return state


def calibrate_norms(model: nn.Module, state: Dict[str, torch.Tensor],
                    seed: int, device) -> None:
    """Set, in place, the running statistics in ``state`` of an
    EfficientNet body's BatchNorms from their inputs on a road frame drawn
    from ``seed`` at the configuration's model input (float32, TF32 off):
    each BatchNorm's per-channel mean and the mean of its per-channel
    variances, set just before it runs. The model's body takes the state's
    tensors for that forward. Other bodies are left as they are."""
    from ..reference.pipeline import tf32_off
    from .frames import road_frame
    found = [(p, m) for p, m in model.named_modules()
             if isinstance(m, BackboneNetwork)
             and m.backbone_type.startswith('efficientnet')]
    if not found:
        return
    prefix, backbone = found[0]
    prefix = f'{prefix}.{backbone.body_name}.'
    body = getattr(backbone, backbone.body_name).eval()
    # the body's tensors are the state's own: the hooks write into it
    body.load_state_dict({k[len(prefix):]: v for k, v in state.items()
                          if k.startswith(prefix)}, assign=True)

    def calibrate(norm, args):
        x = args[0].float()
        norm.running_mean.copy_(x.mean((0, 2, 3)))
        norm.running_var.copy_(x.var((0, 2, 3), unbiased=False).mean()
                               .expand_as(norm.running_var))
    hooks = [m.register_forward_pre_hook(calibrate)
             for m in body.modules() if isinstance(m, BatchNorm)]
    hw = tuple(model.config.postprocess.resolution)
    frame = road_frame(np.random.default_rng(int(seed) & MASK64), hw,
                       CALIBRATION_NOISE)
    x = preprocess_for(backbone.backbone_type,
                       torch.from_numpy(frame)[None].to(device))
    x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.no_grad(), tf32_off():
        body(x)
    for hook in hooks:
        hook.remove()
