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
where a gate's last bit decides a channel. The plan is read off the plain reference's
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

import torch
from torch import nn

from ..reference.masklab_plain.models.detection import ClassificationSubNet
from ..reference.masklab_plain.nn.layers import (BatchNorm, GroupNorm,
                                                 SqueezeExcite)

TRUNC = 0.87962566103423978   # std of a unit normal truncated at 2 sigma
PIXEL_MEAN = [123.68, 116.78, 103.94]     # ImageNet's RGB moments
PIXEL_VAR = [58.4 ** 2, 57.1 ** 2, 57.4 ** 2]
MASK64 = (1 << 64) - 1


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & MASK64)
    return g


def plan(model: nn.Module, force_dense: float) -> Tuple[Dict, Dict]:
    """(random: name -> std, constant: name -> value) over the model's
    state dict entries."""
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
    return state
