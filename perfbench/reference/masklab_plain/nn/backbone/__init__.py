"""Backbone: preprocess -> body -> endpoints -> P6/P7 extras.

Port of ``BackboneNetwork`` (``masklab_tpu/nn/backbone/__init__.py:56-127``)
over the bodies the reference runs: seresnet34, resnet50 and efficientnet
b2 / b3 / b4. Another name raises ``NotImplementedError``.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..layers import GroupNorm, conv2d, pad_same_s2
from . import efficientnet, resnet
from .preprocess import preprocess_for


def _effnet(name):
    return (functools.partial(efficientnet.efficientnet, name),
            efficientnet.CHANNELS[name], 'EfficientNet_0')


# name -> (body factory, endpoint channels, the body's flax module name)
_BODIES = {
    'resnet50': (resnet.resnet50, resnet.RESNET50_CHANNELS, 'ResNet_0'),
    'seresnet34': (resnet.seresnet34, resnet.CHANNELS, 'CMResNet_0'),
    'efficientnetb2': _effnet('efficientnetb2'),
    'efficientnetb3': _effnet('efficientnetb3'),
    'efficientnetb4': _effnet('efficientnetb4'),
}


def _check_ported(backbone_type: str) -> str:
    name = backbone_type.lower()
    if name not in _BODIES:
        raise NotImplementedError(
            f'backbone_type must be one of {sorted(_BODIES)}')
    return name


def backbone_channels(backbone_type: str) -> Dict[str, int]:
    """Channels of the body's C1..C5 endpoints."""
    return _BODIES[_check_ported(backbone_type)][1]


class BackboneNetwork(nn.Module):
    """Takes NHWC float images, returns {name: NCHW map} for every name in
    ``backbone_outputs``. P6 is the relu'd stride-2 3x3 conv of the last C
    endpoint (before any norm); P7 convolves GroupNorm(32) of P6. The
    extras pad as XLA's 'SAME' does, which depends on each map's parity."""

    def __init__(self, backbone_type: str = 'mobilenet',
                 backbone_outputs: Sequence[str] = ('C3', 'C4', 'C5', 'P6',
                                                    'P7'),
                 num_features: int = 128, dtype=torch.float32):
        super().__init__()
        name = _check_ported(backbone_type)
        factory, channels, self.body_name = _BODIES[name]
        self.backbone_type = name
        self.backbone_outputs = tuple(backbone_outputs)
        self.dtype = dtype
        self.add_module(self.body_name, factory(dtype))
        c_taps = [k for k in ('C1', 'C2', 'C3', 'C4', 'C5')
                  if k in self.backbone_outputs]
        if not c_taps:
            raise ValueError(
                'backbone_outputs must include at least one C1-C5 '
                f'endpoint (got {self.backbone_outputs}); the P6/P7 extras '
                'are built from the last included C endpoint')
        self.last_c = c_taps[-1]
        last_ch = channels[self.last_c]
        if 'P6' in self.backbone_outputs or 'P7' in self.backbone_outputs:
            self.extras_P6_conv = conv2d(last_ch, num_features, 3, stride=2,
                                         dtype=dtype)
        if 'P7' in self.backbone_outputs:
            self.extras_P6_norm = GroupNorm(num_features, 32)
            self.extras_P7_conv = conv2d(num_features, num_features, 3,
                                         stride=2, dtype=dtype)

    def _check_nonempty(self, level_name, t):
        rows = t.shape[-2]
        if rows == 0 or t.shape[-1] == 0:
            raise ValueError(
                f'input too small: extras level {level_name} came out '
                f'{rows}x{t.shape[-1]}; use a larger input or drop '
                'P6/P7 from backbone_outputs')

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """``generator`` draws a body's random layers in train mode (each
        body takes it; those with no random layer ignore it)."""
        x = preprocess_for(self.backbone_type, images)
        x = x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        endpoints = getattr(self, self.body_name)(x, generator)
        outputs = {k: v for k, v in endpoints.items()
                   if k in self.backbone_outputs}
        if hasattr(self, 'extras_P6_conv'):
            p6 = torch.relu(self.extras_P6_conv(
                pad_same_s2(endpoints[self.last_c])))
            self._check_nonempty('P6', p6)
            if 'P6' in self.backbone_outputs:
                outputs['P6'] = p6
            if 'P7' in self.backbone_outputs:
                p7 = self.extras_P7_conv(pad_same_s2(self.extras_P6_norm(p6)))
                self._check_nonempty('P7', p7)
                outputs['P7'] = torch.relu(p7)
        return outputs


__all__ = ['BackboneNetwork', 'backbone_channels']
