"""Checkpoints as torch files.

The port's counterpart of ``masklab_tpu/train/checkpoints.py`` (orbax
there). Each epoch saves its state under ``"{loss:.5f}-{epoch:02d}"``: a
directory holding ``state.pt`` with the parameters and BatchNorm statistics
(by the model's parameter and buffer names), the optimizer state, the box
loss's moving statistics and the step, all on the CPU. A save is written
under a ``tmp`` name and renamed into place, so ``best_checkpoint``, which
skips ``tmp`` names, never sees a half-written one. The best checkpoint is
picked by the PARSED loss (the original's lexical sort misorders across
powers of ten); nan losses rank after real ones, unparseable names last.
``config.json`` beside the checkpoints is the configuration the model must
be rebuilt from.

A checkpoint of the JAX package is not read here: restore it with that
package, and pass its numpy variables to ``weights.load_flax_variables``.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..config import ModelConfiguration

STATE_FILE = 'state.pt'


def _plain(tree: Any) -> Any:
    """Optimizer state -> plain containers of CPU tensors: named tuples as
    dicts of their fields, tuples as lists (``torch.load`` with
    ``weights_only`` reads these back)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, tuple) and hasattr(tree, '_fields'):
        return {f: _plain(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, (tuple, list)):
        return [_plain(v) for v in tree]
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


def _like(template: Any, stored: Any) -> Any:
    """``stored`` (``_plain``'s form) back onto the template's containers,
    tensors on the template's devices and dtypes."""
    if isinstance(template, torch.Tensor):
        return stored.to(template.device, template.dtype)
    if isinstance(template, tuple) and hasattr(template, '_fields'):
        return type(template)(**{f: _like(getattr(template, f), stored[f])
                                 for f in template._fields})
    if isinstance(template, (tuple, list)):
        if len(template) != len(stored):
            raise ValueError('checkpoint does not match the state template')
        return type(template)(_like(t, s) for t, s in zip(template, stored))
    if isinstance(template, dict):
        if set(template) != set(stored):
            raise ValueError('checkpoint does not match the state template')
        return {k: _like(template[k], stored[k]) for k in template}
    return type(template)(stored)


def load_variables(model: nn.Module, variables: Dict) -> nn.Module:
    """Copy ``restore_variables``' tensors into ``model`` in place; every
    parameter and BatchNorm statistic must be present, and nothing else."""
    tensors = {**variables['params'], **variables.get('batch_stats', {})}
    own = dict(model.named_parameters())
    own.update((k, v) for k, v in model.named_buffers()
               if k.endswith(('running_mean', 'running_var')))
    if set(own) != set(tensors):
        raise KeyError(f'checkpoint and model differ: missing '
                       f'{sorted(set(own) - set(tensors))[:5]}, unexpected '
                       f'{sorted(set(tensors) - set(own))[:5]}')
    with torch.no_grad():
        for k, t in own.items():
            t.copy_(tensors[k])
    return model


class CheckpointManager:
    def __init__(self, save_dir: str, config: ModelConfiguration = None):
        self.save_dir = os.path.abspath(save_dir)
        os.makedirs(self.save_dir, exist_ok=True)
        if config is not None:
            config.save_json(os.path.join(self.save_dir, 'config.json'))

    def save_epoch(self, state, loss: float, epoch: int) -> str:
        """Save ``"{loss:.5f}-{epoch:02d}"``, replacing one of that name."""
        name = f'{loss:.5f}-{epoch:02d}'
        path = os.path.join(self.save_dir, name)
        payload = {
            'params': _plain(state.params),
            'batch_stats': _plain(state.batch_stats),
            'opt_state': _plain(state.opt_state),
            'box_loss_state': _plain(state.box_loss_state._asdict()),
            'step': int(state.step),
        }
        tmp = tempfile.mkdtemp(prefix=f'{name}.tmp-', dir=self.save_dir)
        try:
            torch.save(payload, os.path.join(tmp, STATE_FILE))
            if os.path.isdir(path):
                shutil.rmtree(path)
            os.replace(tmp, path)
        finally:
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)
        return path

    def best_checkpoint(self) -> Optional[str]:
        """Lowest-loss checkpoint by PARSED loss value; nan losses after
        real ones, unparseable names last; ``tmp`` names (saves in
        progress) never."""
        names = [n for n in os.listdir(self.save_dir)
                 if os.path.isdir(os.path.join(self.save_dir, n))
                 and '-' in n and 'tmp' not in n]
        if not names:
            return None

        def key(name):
            try:
                loss = float(name.rsplit('-', 1)[0])
            except ValueError:
                return (2, 0.0, name)          # unparseable: last
            if np.isnan(loss):
                return (1, 0.0, name)          # nan loss: after real ones
            return (0, loss, name)
        return os.path.join(self.save_dir, min(names, key=key))

    def restore(self, path: Optional[str] = None) -> Dict:
        path = path or self.best_checkpoint()
        if path is None:
            raise FileNotFoundError(f'no checkpoints in {self.save_dir}')
        return torch.load(os.path.join(path, STATE_FILE), map_location='cpu',
                          weights_only=True)

    def restore_variables(self, path: Optional[str] = None) -> Dict:
        """Just what inference needs: {'params', 'batch_stats'} by name
        (``load_variables`` puts them into a model)."""
        payload = self.restore(path)
        out = {'params': payload['params']}
        if payload.get('batch_stats'):
            out['batch_stats'] = payload['batch_stats']
        return out

    def restore_state(self, state_template, path: Optional[str] = None):
        """Full training resume into ``state_template``, a ``TrainState``
        of the same model and optimizer: the model's parameters and
        statistics, the optimizer state, the box state and the step."""
        payload = self.restore(path)
        load_variables(state_template.model, payload)
        state_template.opt_state = _like(state_template.opt_state,
                                         payload['opt_state'])
        state_template.box_loss_state = _like(
            state_template.box_loss_state, payload['box_loss_state'])
        state_template.step = int(payload['step'])
        return state_template

    def load_config(self) -> Optional[ModelConfiguration]:
        """The config snapshot saved next to the weights: the model must be
        rebuilt from it, not from fresh CLI defaults."""
        path = os.path.join(self.save_dir, 'config.json')
        if os.path.exists(path):
            return ModelConfiguration.load_json(path)
        return None
