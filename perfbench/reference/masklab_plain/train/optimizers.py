"""Optimizers and learning-rate schedules, as functional updates.

Port of ``masklab_tpu/train/optimizers.py``: each optimizer is a
``Transform`` of ``init(params)`` and ``update(grads, state, params) ->
(updates, state)`` over dicts {name: tensor}, like the reference's optax
transformations, and ``apply_updates`` adds the updates to the parameters
in place. The arithmetic is the reference's:

  * the learning rate is read at the count *before* the step's increment;
  * ``rectified_adam``: RAdam with the ``N_sma > 5`` switch (step 6 is the
    first rectified one; steps 1-5 move by ``lr / (1 - b1^t) * m``), eps
    1e-7, optional decoupled weight decay ``weight_decay * lr * p``;
  * ``adamw``: decoupled weight decay scaled by ``eta_t = lr / init_lr``;
  * ``cyclic_lr``: the triangular / triangular2 / exp_range schedule;
  * ``masked_updates``: zeroes the final updates of frozen parameters, after
    the optimizer, so weight decay cannot move them either.

Scalars (schedule, bias corrections, the rectification) are float32, as
the reference computes them; the moments update with the foreach kernels.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Union

import numpy as np
import torch

Schedule = Union[float, Callable[[int], float]]
Tensors = Dict[str, torch.Tensor]
f32 = np.float32


class Transform(NamedTuple):
    init: Callable[[Tensors], Any]
    update: Callable[..., Any]      # (grads, state, params) -> (updates, state)


class AdamState(NamedTuple):
    count: int
    mu: Tensors
    nu: Tensors


def _lr_at(learning_rate: Schedule, count: int) -> np.float32:
    return f32(learning_rate(count) if callable(learning_rate)
               else learning_rate)


def _adam_init(params: Tensors) -> AdamState:
    return AdamState(0, {k: torch.zeros_like(p) for k, p in params.items()},
                     {k: torch.zeros_like(p) for k, p in params.items()})


def _moments(grads: Tensors, state: AdamState, b1: float, b2: float):
    """names, mu = b1 * m + (1 - b1) * g, nu = b2 * v + (1 - b2) * g^2."""
    names = list(grads)
    g = [grads[k] for k in names]
    mu = torch._foreach_mul([state.mu[k] for k in names], b1)
    torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
    nu = torch._foreach_mul([state.nu[k] for k in names], b2)
    torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g),
                                               1 - b2))
    return names, mu, nu


def _scaled_over_root(step: float, mu, nu, eps: float):
    """step * m / (sqrt(v) + eps) per tensor."""
    num = torch._foreach_mul(mu, float(step))
    den = torch._foreach_sqrt(nu)
    torch._foreach_add_(den, eps)
    torch._foreach_div_(num, den)
    return num


def _finish(names, delta, params: Tensors, decay: float):
    """-(delta + decay * p) per tensor, as {name: update}."""
    if decay:
        torch._foreach_add_(delta, torch._foreach_mul(
            [params[k] for k in names], float(decay)))
    torch._foreach_neg_(delta)
    return dict(zip(names, delta))


def adamw(learning_rate: Schedule, b1: float = 0.9, b2: float = 0.999,
          weight_decay: float = 1e-4, eps: float = 1e-8,
          init_lr: float = None) -> Transform:
    """AdamW with the reference's ``eta_t = lr / init_lr`` decay scaling."""

    def update(grads, state, params):
        count = state.count + 1
        t = f32(count)
        lr = _lr_at(learning_rate, state.count)
        lr0 = f32(init_lr) if init_lr is not None else _lr_at(learning_rate, 0)
        eta_t = lr / np.maximum(lr0, f32(1e-30))
        lr_t = lr * np.sqrt(f32(1.0) - f32(b2) ** t) / (f32(1.0) - f32(b1) ** t)
        names, mu, nu = _moments(grads, state, b1, b2)
        delta = _scaled_over_root(lr_t, mu, nu, eps)
        updates = _finish(names, delta, params, eta_t * f32(weight_decay))
        return updates, AdamState(count, dict(zip(names, mu)),
                                  dict(zip(names, nu)))

    return Transform(_adam_init, update)


def rectified_adam(learning_rate: Schedule, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-7,
                   weight_decay: float = 0.0) -> Transform:
    """RAdam as the reference's (engine/optimizers.py:142-199)."""

    def update(grads, state, params):
        count = state.count + 1
        t = f32(count)
        lr = _lr_at(learning_rate, state.count)
        beta2_t = f32(b2) ** t
        n_sma_max = f32(2.0 / (1.0 - b2) - 1.0)
        n_sma = n_sma_max - f32(2.0) * t * beta2_t / (f32(1.0) - beta2_t)
        names, mu, nu = _moments(grads, state, b1, b2)
        bias1 = f32(1.0) - f32(b1) ** t
        if n_sma > 5.0:
            rect = np.sqrt(np.maximum(
                (f32(1.0) - beta2_t) * (n_sma - f32(4.0))
                / (n_sma_max - f32(4.0)) * (n_sma - f32(2.0)) / n_sma
                * n_sma_max / (n_sma_max - f32(2.0)), f32(0.0)))
            delta = _scaled_over_root(lr * rect / bias1, mu, nu, eps)
        else:
            delta = torch._foreach_mul(mu, float(lr / bias1))
        updates = _finish(names, delta, params, f32(weight_decay) * lr)
        return updates, AdamState(count, dict(zip(names, mu)),
                                  dict(zip(names, nu)))

    return Transform(_adam_init, update)


def cyclic_lr(base_lr: float, max_lr: float, step_size: float,
              mode: str = 'triangular', gamma: float = 1.0) -> Callable:
    """Cyclical learning-rate schedule (callbacks.py:118-126), float32."""
    if mode not in ('triangular', 'triangular2', 'exp_range'):
        raise ValueError(f'unknown cyclic mode: {mode}')

    def schedule(step):
        it = f32(step)
        cycle = np.floor(f32(1.0) + it / f32(2.0 * step_size))
        x = np.abs(it / f32(step_size) - f32(2.0) * cycle + f32(1.0))
        amp = np.maximum(f32(0.0), f32(1.0) - x)
        if mode == 'triangular':
            scale = f32(1.0)
        elif mode == 'triangular2':
            scale = f32(1.0) / (f32(2.0) ** (cycle - f32(1.0)))
        else:
            scale = f32(gamma) ** it
        return f32(base_lr) + f32(max_lr - base_lr) * amp * scale

    return schedule


def masked_updates(mask: Dict[str, bool]) -> Transform:
    """Zero the final updates of frozen parameters (``mask[name]`` False):
    the counterpart of Keras ``layer.trainable = False``."""

    def update(updates, state, params=None):
        return ({k: u if mask[k] else torch.zeros_like(u)
                 for k, u in updates.items()}, state)

    return Transform(lambda params: (), update)


def chain(*transforms: Transform) -> Transform:
    """Apply the transforms in order, each to the previous one's updates."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return Transform(init, update)


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors) -> None:
    """p += u for every parameter, in place."""
    names = list(updates)
    torch._foreach_add_([params[k] for k in names],
                        [updates[k] for k in names])
