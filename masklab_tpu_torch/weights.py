"""Weights for the port: seeded init, the flax -> torch bridge, force_dense.

``load_flax_variables`` fills the port's modules from a flax variable tree
given as nested dicts of numpy arrays (``params`` and ``batch_stats``). The
port's submodules carry the flax module names, so a torch module at
``a.b.c`` takes the flax leaves under ``a/b/c``. Conversions:

  * conv kernel HWIO -> OIHW, biased or not (a depthwise [kh, kw, 1, C]
    lands as [C, 1, kh, kw] and a grouped [kh, kw, C_in/G, out] as [out,
    C_in/G, kh, kw] by the same transpose);
  * the mask head's ``upsample`` kernel [2, 2, C_in, F] -> the transposed
    conv's [C_in, F, 2, 2], flipped in both spatial axes (the reference
    applies ``kernel[::-1, ::-1]``);
  * Dense kernel [in, out] -> the linear layer's [out, in] weight (the
    squeeze-excite layers);
  * BatchNorm scale/bias + batch_stats mean/var -> weight/bias +
    running_mean/running_var (no scale where the BatchNorm has none);
    GroupNorm scale/bias as they are;
  * the fused mask head's level-stacked parameters (``conv0_kernel``, ...)
    as they are, under the module's own path.

Any flax leaf left unused, or torch parameter left unfilled, raises.
``flax_names`` and ``to_flax_tree`` expose the same mapping the other way
(torch name -> flax path; torch tensors -> flax layouts), so that a model's
parameters, gradients and statistics can be compared with the reference's
by path. This module never imports JAX.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from .models.detection import BoxRegressionSubNet, ClassificationSubNet
from .models.fused_mask_head import FusedMaskSubNet
from .models.instance import LevelMaskHead, PixelShuffleUp
from .nn.layers import BatchNorm, GroupNorm, HeadBlock, SqueezeExcite

_LEAF_TYPES = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear, GroupNorm,
               BatchNorm, FusedMaskSubNet)
# focal-loss prior bias of the class outputs, -log((1 - .01) / .01)
PRIOR_BIAS = -float(np.log((1 - 0.01) / 0.01))


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict:
    out = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if hasattr(value, 'items'):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def _pixel_shuffle_to_torch(k):
    return k[::-1, ::-1].transpose(2, 3, 0, 1)


def _pixel_shuffle_to_flax(w):
    return w.transpose(2, 3, 0, 1)[::-1, ::-1]


def _same(a):
    return a


def _leaf_specs(module: nn.Module):
    """[(torch attribute, flax collection, flax leaf name, to_torch,
    to_flax)] of one leaf module: how each of its tensors maps to a flax
    leaf and back."""
    if isinstance(module, FusedMaskSubNet):
        return [(name, 'params', name, _same, _same)
                for name, _ in module.named_parameters(recurse=False)]
    if isinstance(module, PixelShuffleUp):
        specs = [('weight', 'params', 'kernel', _pixel_shuffle_to_torch,
                  _pixel_shuffle_to_flax)]
    elif isinstance(module, nn.Conv2d):      # HWIO <-> OIHW
        specs = [('weight', 'params', 'kernel',
                  lambda k: k.transpose(3, 2, 0, 1),
                  lambda w: w.transpose(2, 3, 1, 0))]
    elif isinstance(module, nn.Linear):
        specs = [('weight', 'params', 'kernel', np.transpose, np.transpose)]
    elif isinstance(module, GroupNorm):
        return [('weight', 'params', 'scale', _same, _same),
                ('bias', 'params', 'bias', _same, _same)]
    else:   # BatchNorm
        specs = [('bias', 'params', 'bias', _same, _same),
                 ('running_mean', 'batch_stats', 'mean', _same, _same),
                 ('running_var', 'batch_stats', 'var', _same, _same)]
        if module.weight is not None:
            specs.append(('weight', 'params', 'scale', _same, _same))
        return specs
    if module.bias is not None:
        specs.append(('bias', 'params', 'bias', _same, _same))
    return specs


def _leaves(model: nn.Module):
    """(torch name, leaf module, spec) for every tensor the bridge maps;
    the torch name is the module's path and the attribute."""
    for name, module in model.named_modules():
        if isinstance(module, _LEAF_TYPES):
            for spec in _leaf_specs(module):
                yield (f'{name}.{spec[0]}' if name else spec[0]), module, spec


def flax_names(model: nn.Module) -> Dict[str, Tuple[str, Tuple[str, ...]]]:
    """{torch parameter / buffer name: (flax collection, flax path)} of every
    tensor the bridge maps, e.g. ``'backbone.ResNet_0.stem.weight'`` ->
    ``('params', ('backbone', 'ResNet_0', 'stem', 'kernel'))``."""
    return {tname: (coll, tuple(tname.split('.')[:-1]) + (leaf,))
            for tname, _, (_, coll, leaf, _, _) in _leaves(model)}


def to_flax_tree(model: nn.Module, values: Mapping = None) -> Dict:
    """The model's tensors as a flax variable tree of numpy arrays
    ({'params': ..., 'batch_stats': ...}, in the layouts
    ``load_flax_variables`` reads). With ``values`` ({torch name: tensor},
    e.g. the parameters' gradients) those tensors instead, each laid out like
    the one it stands for; names without a value are left out."""
    tree = {}
    for tname, module, (attr, coll, leaf, _, to_flax) in _leaves(model):
        if values is None:
            value = getattr(module, attr)
        elif tname in values:
            value = values[tname]
        else:
            continue
        node = tree.setdefault(coll, {})
        for key in tname.split('.')[:-1]:
            node = node.setdefault(key, {})
        node[leaf] = np.array(to_flax(value.detach().float().cpu().numpy()),
                              order='C')          # a copy, never a view
    return tree


def load_flax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Fill ``model`` from a flax variable tree (nested dicts of numpy
    arrays under ``params`` and, for BatchNorm, ``batch_stats``)."""
    tables = {'params': _flatten(variables['params']),
              'batch_stats': _flatten(variables.get('batch_stats', {}))}
    used = 0
    for tname, module, (attr, coll, leaf, to_torch, _) in _leaves(model):
        path = tuple(tname.split('.')[:-1]) + (leaf,)
        if path not in tables[coll]:
            raise KeyError(f'flax variables lack {"/".join(path)}')
        value = to_torch(tables[coll].pop(path))
        target = getattr(module, attr)
        if tuple(target.shape) != value.shape:
            raise ValueError(f'{tname}: torch shape {tuple(target.shape)} != '
                             f'flax shape {value.shape}')
        with torch.no_grad():
            target.copy_(torch.from_numpy(np.array(value, np.float32)))
        used += 1
    leftover = ['/'.join(p) for t in tables.values() for p in t]
    if leftover:
        raise KeyError(f'flax leaves with no torch module: {leftover[:8]}'
                       f'{" ..." if len(leftover) > 8 else ""}')
    if used == 0:
        raise KeyError('no flax leaf matched the model')
    return model


def _small_init_convs(model: nn.Module) -> set:
    """Convs the reference initializes with normal(0.01): head stacks,
    head outputs and the mask upsample."""
    small = set()
    for m in model.modules():
        if isinstance(m, HeadBlock):
            small.update(c for c in m.children() if isinstance(c, nn.Conv2d))
        elif isinstance(m, (ClassificationSubNet, BoxRegressionSubNet)):
            small.update(getattr(m, f'output_{i}')
                         for i in range(m.num_blocks))
        elif isinstance(m, LevelMaskHead):
            small.update((m.upsample, m.output))
    return small


def _variance_scaling(shape, scale: float, fan: int, gen) -> torch.Tensor:
    """flax's truncated-normal variance scaling: std sqrt(scale / fan),
    truncated at 2 sigma and rescaled."""
    w = torch.empty(shape, dtype=torch.float32)
    std = math.sqrt(scale / fan) / .87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=gen)


def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights after the reference's initializers:
    truncated-normal lecun init for convs and Dense layers (flax's
    default), normal(0.01) for the head convs and the fused mask head's
    kernels, he / glorot normal for the
    heads' squeeze-excite layers, the focal prior bias -log(99) on the
    class outputs, unit scales and zero biases for the norms. Drawn on the
    CPU from one ``torch.Generator``, so a seed gives the same model on any
    device."""
    gen = torch.Generator().manual_seed(seed)
    small = _small_init_convs(model)
    cls_outputs = set()
    se_scaling = {}          # Dense layer -> (scale, fan) of its init
    for m in model.modules():
        if isinstance(m, ClassificationSubNet):
            cls_outputs.update(getattr(m, f'output_{i}')
                               for i in range(m.num_blocks))
        elif isinstance(m, SqueezeExcite):
            # he normal, then glorot normal (fan_avg: scale 2 over the sum)
            d0, d1 = m.Dense_0, m.Dense_1
            se_scaling[d0] = (2.0, d0.in_features)
            se_scaling[d1] = (2.0, d1.in_features + d1.out_features)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
                if module in small:
                    w = torch.empty(module.weight.shape, dtype=torch.float32)
                    nn.init.normal_(w, 0.0, 0.01, generator=gen)
                else:
                    fan_in = (module.in_channels // module.groups
                              * math.prod(module.kernel_size))
                    w = _variance_scaling(module.weight.shape, 1.0, fan_in,
                                          gen)
                module.weight.copy_(w)
                if module.bias is not None:
                    module.bias.fill_(PRIOR_BIAS if module in cls_outputs
                                      else 0.0)
            elif isinstance(module, FusedMaskSubNet):
                for name, p in module.named_parameters(recurse=False):
                    if name.endswith('_kernel'):
                        w = torch.empty(p.shape, dtype=torch.float32)
                        p.copy_(nn.init.normal_(w, 0.0, 0.01, generator=gen))
                    else:
                        p.fill_(1.0 if name.endswith('_scale') else 0.0)
            elif isinstance(module, nn.Linear):
                scale, fan = se_scaling.get(module,
                                            (1.0, module.in_features))
                module.weight.copy_(_variance_scaling(
                    module.weight.shape, scale, fan, gen))
                if module.bias is not None:
                    module.bias.fill_(0.0)
            elif isinstance(module, (GroupNorm, BatchNorm)):
                if module.weight is not None:
                    module.weight.fill_(1.0)
                module.bias.fill_(0.0)
                if isinstance(module, BatchNorm):
                    module.running_mean.fill_(0.0)
                    module.running_var.fill_(1.0)
    return model


def force_dense(model: nn.Module, value: float = 2.0) -> nn.Module:
    """Set every class-output bias to ``value`` (bench.py's forced-dense
    regime): all candidates clear min_confidence, every NMS slot fills and
    the mask branch runs over every pyramid level, without trained
    weights."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, ClassificationSubNet):
                for i in range(m.num_blocks):
                    getattr(m, f'output_{i}').bias.fill_(value)
    return model
