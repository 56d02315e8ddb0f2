"""Backbone: preprocess -> body -> endpoints -> P6/P7 extras.

Port of ``BackboneNetwork`` (``masklab_tpu/nn/backbone/__init__.py:56-127``)
over every body of the reference's zoo (``BACKBONE_REGISTRY``, ``:33-47``):
mobilenet, mobilenetv2, resnet50, resnet50v2, resnet101v2, resnext50,
seresnet34, seresnet50, seresnext50, vgg16 and efficientnet b2 / b3 / b4;
and a copy of ``module_frozen`` (``:142-277``), the progressive-unfreeze
rule the train state's trainable mask reads. A name the reference rejects
raises ``NotImplementedError`` here too.
"""
from __future__ import annotations

import functools
import re
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from .. import spatial
from ..layers import GroupNorm, conv2d, pad_same_s2, pad_valid_s2
from . import efficientnet, mobilenet, mobilenetv2, resnet, vgg
from .preprocess import PREPROCESS_COMBOS, preprocess_for


def _effnet(name):
    return (functools.partial(efficientnet.efficientnet, name),
            efficientnet.CHANNELS[name], 'EfficientNet_0')


# name -> (body factory, endpoint channels, the body's flax module name)
_BODIES = {
    'mobilenet': (lambda dtype: mobilenet.MobileNetV1(dtype=dtype),
                  mobilenet.CHANNELS, 'MobileNetV1_0'),
    'mobilenetv2': (mobilenetv2.MobileNetV2, mobilenetv2.CHANNELS,
                    'MobileNetV2_0'),
    'resnet50': (resnet.resnet50, resnet.RESNET50_CHANNELS, 'ResNet_0'),
    'resnet50v2': (resnet.resnet50v2, resnet.RESNET50_CHANNELS,
                   'ResNetV2_0'),
    'resnet101v2': (resnet.resnet101v2, resnet.RESNET101V2_CHANNELS,
                    'ResNetV2_0'),
    'resnext50': (resnet.resnext50, resnet.RESNET50_CHANNELS, 'ResNet_0'),
    'seresnet34': (resnet.seresnet34, resnet.CHANNELS, 'CMResNet_0'),
    'seresnet50': (resnet.seresnet50, resnet.RESNET50_CHANNELS, 'ResNet_0'),
    'seresnext50': (resnet.seresnext50, resnet.RESNET50_CHANNELS,
                    'ResNet_0'),
    'vgg16': (vgg.VGG16, vgg.CHANNELS, 'VGG16_0'),
    'efficientnetb2': _effnet('efficientnetb2'),
    'efficientnetb3': _effnet('efficientnetb3'),
    'efficientnetb4': _effnet('efficientnetb4'),
}
PORTED_BACKBONES = tuple(_BODIES)


def body_module_name(backbone_type: str) -> str:
    """The body's child name inside ``BackboneNetwork`` (its flax module
    name, e.g. ``'MobileNetV1_0'``)."""
    return _BODIES[_check_ported(backbone_type)][2]


def _check_ported(backbone_type: str) -> str:
    name = backbone_type.lower()
    if name not in _BODIES:
        raise NotImplementedError(
            f'backbone_type must be one of {sorted(_BODIES)}')
    return name


def backbone_channels(backbone_type: str) -> Dict[str, int]:
    """Channels of the body's C1..C5 endpoints."""
    return _BODIES[_check_ported(backbone_type)][1]


def grid_padding(backbone_type: str) -> str:
    """'valid' (floor) prior-grid rounding for mobilenet, 'same' otherwise."""
    return 'valid' if backbone_type.lower() == 'mobilenet' else 'same'


class BackboneNetwork(nn.Module):
    """Takes NHWC float images, returns {name: NCHW map} for every name in
    ``backbone_outputs``. P6 is the relu'd stride-2 3x3 conv of the last C
    endpoint (before any norm); P7 convolves GroupNorm(32) of P6.
    Mobilenet's extras zero-pad (0, 1) and convolve VALID; the others pad
    as XLA's 'SAME' does, which depends on each map's parity. Sharded
    (``nn.spatial``), the images are this rank's rows of each frame: the
    forward first learns the frame's rows."""

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
        self.pad_s2 = pad_valid_s2 if name == 'mobilenet' else pad_same_s2
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
        sp = spatial.active()
        rows = (t.shape[-2] if sp is None
                else sp.rows((self, level_name), t.shape[-2]))
        if rows == 0 or t.shape[-1] == 0:
            raise ValueError(
                f'input too small: extras level {level_name} came out '
                f'{rows}x{t.shape[-1]}; use a larger input or drop '
                'P6/P7 from backbone_outputs')

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """``generator`` draws a body's random layers in train mode (each
        body takes it; those with no random layer ignore it)."""
        sp = spatial.active()
        if sp is not None:
            sp.start(images.shape[1])
        x = preprocess_for(self.backbone_type, images)
        x = x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        endpoints = getattr(self, self.body_name)(x, generator)
        outputs = {k: v for k, v in endpoints.items()
                   if k in self.backbone_outputs}
        if hasattr(self, 'extras_P6_conv'):
            p6 = torch.relu(self.extras_P6_conv(
                self.pad_s2(endpoints[self.last_c])))
            self._check_nonempty('P6', p6)
            if 'P6' in self.backbone_outputs:
                outputs['P6'] = p6
            if 'P7' in self.backbone_outputs:
                p7 = self.extras_P7_conv(self.pad_s2(self.extras_P6_norm(p6)))
                self._check_nonempty('P7', p7)
                outputs['P7'] = torch.relu(p7)
        return outputs


# ---- progressive-unfreeze masks ----

# per family: map freeze depth 'C1'..'C5' -> regex matching *frozen* top-level
# submodule names inside the backbone scope.
_RESNET_STAGE_OF_DEPTH = {'C1': 1, 'C2': 2, 'C3': 3, 'C4': 4, 'C5': 5}
_MOBILENET_LAST_FROZEN_BLOCK = {'C1': 1, 'C2': 3, 'C3': 5, 'C4': 11, 'C5': 13}
_VGG_LAST_FROZEN_BLOCK = {'C1': 2, 'C2': 3, 'C3': 4, 'C4': 5, 'C5': 5}
# efficientnet taps sit in the first block of stages 1/2/3/5 -> everything
# strictly before that stage freezes at the corresponding depth
_EFFNET_LAST_FROZEN_STAGE = {'C1': 0, 'C2': 1, 'C3': 2, 'C4': 4, 'C5': 6}


def module_frozen(backbone_type: str, module_name: str,
                  freeze_depth: str) -> bool:
    """Is a backbone submodule (e.g. 'stage3', 'dw7', 'block2_conv1') frozen
    at the given depth? Extras (P6/P7) are never frozen, matching the
    reference where layers after the C5 tap stay trainable (base.py:337-341).
    """
    if freeze_depth == 'C0':
        return False
    if module_name.startswith('extras'):
        return False
    bt = backbone_type.lower()
    if bt == 'seresnet34':
        # classification_models pre-activation family: the C2-C4 taps are
        # the pre-activation ReLU *inside* the next stage's first unit
        # (base.py:126-132), so at depth Ck stages <k freeze fully and
        # stage k's unit 1 freezes only its preact BN ('bn1'), mirroring
        # freeze_backbone's layer-order cutoff (base.py:319-345).
        head, _, child = module_name.partition('/')
        if head in ('bn_data', 'conv0', 'bn0'):
            return True
        if freeze_depth == 'C5':
            return True
        if head == 'bn1':
            return False
        m = re.match(r'stage(\d+)_unit(\d+)$', head)
        if m:
            stage, unit = int(m.group(1)), int(m.group(2))
            depth = int(freeze_depth[1])
            if stage < depth:
                return True
            # in-unit preact rule applies to the C2-C4 taps only: the C1
            # tap is 'relu0' (base.py:127), BEFORE stage1, so
            # stage1_unit1 stays fully trainable at C1 (round-4 review)
            if stage == depth and unit == 1 and depth >= 2:
                return child.partition('/')[0] == 'bn1'
        return False
    if bt in ('resnet50v2', 'resnet101v2'):
        # keras v2 taps sit mid-stage (base.py:112-125): at depth Ck the
        # layer-order cutoff (base.py:336-340) freezes whole blocks before
        # the tap block and, inside it, only the layers built before the
        # tap activation — preact_bn for the preact_relu taps (50v2),
        # preact_bn+conv1+bn1 for the _1_relu taps (101v2).
        if module_name.startswith('stem'):
            return True
        if freeze_depth == 'C5':
            return True
        if freeze_depth == 'C1' or module_name.startswith('post_bn'):
            return False
        tap = {'resnet50v2': {2: (2, 3), 3: (3, 4), 4: (4, 4)},
               'resnet101v2': {2: (2, 3), 3: (3, 4), 4: (4, 23)}}
        ts, tb = tap[bt][int(freeze_depth[1])]
        head, _, child = module_name.partition('/')
        m = re.match(r'stage(\d+)_block(\d+)$', head)
        if not m:
            return False
        stage, block = int(m.group(1)), int(m.group(2))
        if (stage, block) < (ts, tb):
            return True
        if (stage, block) == (ts, tb):
            sub = child.partition('/')[0]
            frozen = ({'preact_bn'} if bt == 'resnet50v2'
                      else {'preact_bn', 'conv1', 'bn1'})
            return sub in frozen
        return False
    if bt == 'mobilenetv2':
        # taps sit at the first block of stages 1/2/3/5, same layout as
        # efficientnet's stage table
        if module_name.startswith('stem'):
            return True
        if module_name.startswith('top'):
            return freeze_depth == 'C5'
        m = re.match(r'stage(\d+)_', module_name)
        if m:
            return int(m.group(1)) <= _EFFNET_LAST_FROZEN_STAGE[freeze_depth]
        return False
    if bt == 'mobilenet':
        if module_name.startswith('stem'):
            return True
        m = re.match(r'(?:dw|pw)(\d+)', module_name)
        if m:
            return int(m.group(1)) <= _MOBILENET_LAST_FROZEN_BLOCK[freeze_depth]
        return False
    if bt == 'vgg16':
        m = re.match(r'block(\d+)_', module_name)
        if m:
            return int(m.group(1)) <= _VGG_LAST_FROZEN_BLOCK[freeze_depth]
        return False
    if bt.startswith('efficientnet'):
        if module_name.startswith('stem'):
            return True
        if module_name.startswith('top'):
            return freeze_depth == 'C5'
        m = re.match(r'stage(\d+)_block(\d+)', module_name)
        if m:
            stage, block = int(m.group(1)), int(m.group(2))
            last = _EFFNET_LAST_FROZEN_STAGE[freeze_depth]
            if stage <= last:
                return True
            # the C1-C4 taps are the expand ACTIVATION inside the next
            # stage's first block (block{2,3,4,6}a_expand_activation,
            # base.py:168-181): the reference's layer-order cutoff also
            # freezes that block's expand conv + BN, which are built
            # BEFORE the tap (same partial-block rule as seresnext50;
            # round-4 review)
            if freeze_depth != 'C5' and stage == last + 1 and block == 0:
                parts = module_name.split('/')
                return (len(parts) >= 2
                        and parts[1] in ('Conv_0', '_BN_0'))
        return False
    if bt == 'seresnext50':
        # inner taps (base.py:139-145): C2-C4 are the post-conv1 relus
        # inside the NEXT stage's first block, so the reference's
        # layer-order cutoff (base.py:319-345) additionally freezes that
        # block's conv1 + bn1 — Conv_0/_BN_0 here — at depths C2-C4
        # (everything built before the tap activation; ADVICE r3).
        if module_name.startswith('stem'):
            return True
        m = re.match(r'stage(\d+)', module_name)
        if not m:
            return False
        stage = int(m.group(1))
        depth = _RESNET_STAGE_OF_DEPTH[freeze_depth]
        if stage <= depth:
            return True
        if freeze_depth in ('C2', 'C3', 'C4') and stage == depth + 1:
            parts = module_name.split('/')
            return (len(parts) >= 3 and parts[1] == 'BottleneckBlock_0'
                    and parts[2] in ('Conv_0', '_BN_0'))
        return False
    # resnet family: stem + stage{2..5}
    if module_name.startswith('stem'):
        return True
    m = re.match(r'stage(\d+)', module_name)
    if m:
        return int(m.group(1)) <= _RESNET_STAGE_OF_DEPTH[freeze_depth]
    return False


__all__ = ['BackboneNetwork', 'backbone_channels', 'grid_padding',
           'module_frozen', 'preprocess_for', 'PREPROCESS_COMBOS',
           'PORTED_BACKBONES', 'body_module_name']
