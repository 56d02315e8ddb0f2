"""Weights for the port: seeded init, the flax -> torch bridge, force_dense.

``load_flax_variables`` fills the port's modules from a flax variable tree
given as nested dicts of numpy arrays (``params`` and ``batch_stats``). The
port's submodules carry the flax module names, so a torch module at
``a.b.c`` takes the flax leaves under ``a/b/c``. Conversions:

  * conv kernel HWIO -> OIHW (a depthwise [kh, kw, 1, C] lands as
    [C, 1, kh, kw] by the same transpose);
  * the mask head's ``upsample`` kernel [2, 2, C_in, F] -> the transposed
    conv's [C_in, F, 2, 2], flipped in both spatial axes (the reference
    applies ``kernel[::-1, ::-1]``);
  * Dense kernel [in, out] -> the linear layer's [out, in] weight (the
    squeeze-excite layers);
  * BatchNorm scale/bias + batch_stats mean/var -> weight/bias +
    running_mean/running_var (no scale where the BatchNorm has none);
    GroupNorm scale/bias as they are.

Any flax leaf left unused, or torch parameter left unfilled, raises.
This module never imports JAX.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from .models.detection import BoxRegressionSubNet, ClassificationSubNet
from .models.instance import LevelMaskHead, PixelShuffleUp
from .nn.layers import BatchNorm, GroupNorm, HeadBlock, SqueezeExcite

_LEAF_TYPES = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear, GroupNorm,
               BatchNorm)
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


def _module_leaves(module: nn.Module, params: Dict, stats: Dict):
    """-> {torch attribute: numpy array} for one leaf module, reading the
    flax leaves it consumes out of ``params`` / ``stats`` (popped)."""
    def take(table, name):
        if name not in table:
            raise KeyError(name)
        return table.pop(name)

    if isinstance(module, PixelShuffleUp):
        kernel = take(params, 'kernel')
        out = {'weight': np.ascontiguousarray(
            kernel[::-1, ::-1].transpose(2, 3, 0, 1))}
    elif isinstance(module, nn.Conv2d):
        out = {'weight': np.ascontiguousarray(
            take(params, 'kernel').transpose(3, 2, 0, 1))}
    elif isinstance(module, nn.Linear):
        out = {'weight': np.ascontiguousarray(take(params, 'kernel').T)}
    elif isinstance(module, GroupNorm):
        return {'weight': take(params, 'scale'), 'bias': take(params, 'bias')}
    else:   # BatchNorm
        out = {'bias': take(params, 'bias'),
               'running_mean': take(stats, 'mean'),
               'running_var': take(stats, 'var')}
        if module.weight is not None:
            out['weight'] = take(params, 'scale')
        return out
    if module.bias is not None:
        out['bias'] = take(params, 'bias')
    return out


def load_flax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Fill ``model`` from a flax variable tree (nested dicts of numpy
    arrays under ``params`` and, for BatchNorm, ``batch_stats``)."""
    params = _flatten(variables['params'])
    stats = _flatten(variables.get('batch_stats', {}))
    used = 0
    for name, module in model.named_modules():
        if not isinstance(module, _LEAF_TYPES):
            continue
        path = tuple(name.split('.')) if name else ()
        mod_params = {p[-1]: params.pop(p) for p in list(params)
                      if p[:-1] == path}
        mod_stats = {p[-1]: stats.pop(p) for p in list(stats)
                     if p[:-1] == path}
        try:
            leaves = _module_leaves(module, mod_params, mod_stats)
        except KeyError as e:
            raise KeyError(f'flax variables lack {"/".join(path)}/{e.args[0]}'
                           ) from None
        if mod_params or mod_stats:
            raise KeyError(f'unused flax leaves under {"/".join(path)}: '
                           f'{sorted(mod_params) + sorted(mod_stats)}')
        with torch.no_grad():
            for attr, value in leaves.items():
                target = getattr(module, attr)
                if tuple(target.shape) != value.shape:
                    raise ValueError(
                        f'{name}.{attr}: torch shape {tuple(target.shape)} '
                        f'!= flax shape {value.shape}')
                target.copy_(torch.from_numpy(np.array(value, np.float32)))
                used += 1
    leftover = ['/'.join(p) for p in list(params) + list(stats)]
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
    default), normal(0.01) for the head convs, he / glorot normal for the
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
