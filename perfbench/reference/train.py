"""The plain reference of a training cell's first steps: the
configuration's model in float32 (TF32 off) in train mode, the four task
losses as the program sums them (a copy of ``train.steps.losses_of``
without the metrics), one autograd backward, the phase's optimizer (RAdam
on the cyclic schedule; the 'all' phase freezes nothing) and the box
loss's moving statistics, run over the batches the program's first steps
were fed.

The loss-config NMS proposals that feed the mask targets follow the last
bits of nearly tied scores; each step takes the proposals the program's
step took (``proposals``), as the serving check replays the program's
NMS. ``control``: the precision control, every conv, transposed conv and
dense layer on float8 e4m3 weights (re-rounded from a float32 master copy
each step) and inputs, gradients passed straight through the rounding, and
its own proposals."""
from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from . import pipeline
from .masklab_plain.losses import (BoxLossState, box_loss, class_loss,
                                   mask_loss, seg_loss)
from .masklab_plain.models.detection import batched_assign_boxes
from .masklab_plain.models.instance import assign_masks
from .masklab_plain.models.masklab import MaskLab
from .masklab_plain.models.semantic import assign_seg
from .masklab_plain.train.optimizers import (apply_updates, cyclic_lr,
                                             rectified_adam)


def losses(model: MaskLab, out: Dict, batch: Dict, box_state: BoxLossState):
    cfg = model.config
    num_det = len(cfg.dataset.instance_labels)
    lc = cfg.loss
    cls_true, loc_true, assign_mask = batched_assign_boxes(
        batch['gt_boxes'], out['priors'], num_det)
    cls_l = class_loss(cls_true, out['cls_pred'], assign_mask,
                       batch['gt_boxes_exist'], weight=lc.cls_loss_weight,
                       alpha=lc.cls_loss_alpha, gamma=lc.cls_loss_gamma)
    box_l, new_box_state = box_loss(
        loc_true, out['loc_pred'], assign_mask, box_state,
        weight=lc.box_loss_weight, momentum=lc.box_loss_momentum,
        beta=lc.box_loss_beta, use_adjust=lc.box_loss_use_adjust)
    mask_targets = assign_masks(out['roi_boxes'], batch['gt_boxes'],
                                batch['gt_masks'],
                                out['roi_masks'].shape[2:4], num_det)
    mask_l = mask_loss(mask_targets, out['roi_masks'],
                       weight=lc.mask_loss_weight,
                       label_smoothing=lc.mask_loss_label_smoothing)
    seg_l = seg_loss(assign_seg(batch['gt_seg'], out['seg_pred']),
                     out['seg_pred'], batch['gt_seg_exist'],
                     weight=lc.seg_loss_weight,
                     label_smoothing=lc.seg_loss_label_smoothing)
    total = cls_l.mean() + box_l.mean() + mask_l.mean() + seg_l.mean()
    return total, new_box_state.detach()


class _Fp8Inputs:
    """Forward pre-hooks rounding each layer's input to float8, the
    gradient passed straight through."""

    def __init__(self, model: nn.Module):
        self.layers = [m for m in model.modules()
                       if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d,
                                         nn.Linear))]
        for m in self.layers:
            m.register_forward_pre_hook(self._round)

    @staticmethod
    def _round(module, args):
        x = args[0]
        return (x + (pipeline._fp8(x) - x).detach(),) + tuple(args[1:])

    def round_weights(self, master: Dict[str, torch.Tensor],
                      names: Dict[nn.Module, str]) -> None:
        with torch.no_grad():
            for m in self.layers:
                m.weight.copy_(pipeline._fp8(master[names[m]]))


def run_steps(model_dict: Dict, state0: Dict[str, torch.Tensor],
              batches: List[Dict[str, torch.Tensor]],
              proposals: Optional[List[torch.Tensor]], lr: Dict,
              device, control: bool = False) -> Dict:
    """len(batches) steps from ``state0`` (the model's state dict) ->
    ``losses`` (each step's total), ``grad1`` (each parameter's gradient at
    the first step), ``change`` (each parameter's change over the steps),
    ``stats`` (each BatchNorm running statistic's change over the steps),
    ``box`` (the box loss's moving mean and variance after them) and
    ``proposals`` (the loss-NMS proposals each step used)."""
    with pipeline.tf32_off():
        model = MaskLab(pipeline.config(model_dict))
        model.load_state_dict(state0)
        model = model.to(device).train()
        params = dict(model.named_parameters())
        start = {k: p.detach().clone() for k, p in params.items()}
        master = {k: p.detach().clone() for k, p in params.items()}
        fp8 = _Fp8Inputs(model) if control else None
        names = {m: n + '.weight' for n, m in model.named_modules()}
        tx = rectified_adam(cyclic_lr(lr['base'], lr['max'], lr['step_size']))
        opt = tx.init(master)
        box = BoxLossState.create(model.config.loss.box_loss_beta, device)
        out_losses, used, grad1 = [], [], None
        for i, batch in enumerate(batches):
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(master[k])
            if fp8 is not None:
                fp8.round_weights(master, names)
            out = model.trainer_outputs(
                batch['images'], batch['gt_boxes'], with_metrics=False,
                proposals=None if proposals is None else proposals[i])
            used.append(out['roi_boxes'][:, batch['gt_boxes'].shape[1]:]
                        .detach())
            total, box = losses(model, out, batch, box)
            grads = torch.autograd.grad(total, list(params.values()),
                                        allow_unused=True)
            grads = {k: torch.zeros_like(p) if g is None else g.detach()
                     for (k, p), g in zip(params.items(), grads)}
            if grad1 is None:
                grad1 = {k: float(g.double().norm()) for k, g in grads.items()}
            updates, opt = tx.update(grads, opt, master)
            apply_updates(master, updates)
            out_losses.append(float(total.detach()))
            del out, total, grads
        change = {k: float((master[k] - start[k]).double().norm())
                  for k in master}
        stats = stat_changes(state0, dict(model.named_buffers()))
    return dict(losses=out_losses, grad1=grad1, change=change, stats=stats,
                box=(box.moving_mean, box.moving_var), proposals=used)


def stat_changes(state0: Dict[str, torch.Tensor],
                 buffers: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each BatchNorm running statistic's change from ``state0``, by
    norm."""
    return {k: float((v.to(state0[k].device) - state0[k]).double().norm())
            for k, v in buffers.items()
            if k.endswith(('running_mean', 'running_var'))}


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              counted=None) -> Dict[str, float]:
    """Each leaf's gap between two norms, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    keys = [k for k in want if counted is None or k in counted]
    floor = median(want[k] for k in keys)
    return {k: abs(got[k] - want[k]) / max(want[k], floor, 1e-30)
            for k in keys}


def median(values) -> float:
    ordered = sorted(values)
    return ordered[len(ordered) // 2] if ordered else 0.0


def group_of(name: str) -> str:
    """A leaf's module group: the model's child it lies in (backbone,
    fpn, each head)."""
    return name.split('.', 1)[0]


def group_gap(got: Dict[str, float], want: Dict[str, float],
              counted=None) -> float:
    """The worst module group's median ``leaf_gaps``, each group's leaves
    measured against that group's own median leaf: a fault confined to
    one head (its loss left out, its update not applied) moves that head's
    median leaf, whatever its scale beside the others."""
    groups: Dict[str, List[str]] = {}
    for k in want:
        if counted is None or k in counted:
            groups.setdefault(group_of(k), []).append(k)
    return max((median(leaf_gaps(got, want, set(keys)).values())
                for keys in groups.values()), default=0.0)


def worst_leaves(gaps: Dict[str, float], n: int = 3) -> str:
    return ', '.join(f'{k} {v:.4g}' for k, v in
                     sorted(gaps.items(), key=lambda kv: -kv[1])[:n])


def counted_leaves(grad1: Dict[str, float], share: float = 1e-3):
    """Leaves whose first gradient in the reference is above ``share`` of
    the median leaf's: the others move under Adam by round-off alone."""
    floor = share * median(grad1.values())
    return {k for k, v in grad1.items() if v >= floor}


def data_gaps(batches: List[Dict[str, torch.Tensor]], written: List[Dict],
              labels) -> Dict[str, float]:
    """The data stage checked by itself: each row of the batches the
    program's steps were fed is one of the written frames, decoded and
    resized to the batch's size as the generator's contract says (cv2's
    bilinear ``resize``), exactly (``data_rows_off``: the rows that are
    none); and its gt boxes are that frame's drawn road objects of at
    least ``min_area``... scaled alike (``data_boxes_gap``: the largest
    distance, in pixels, from a program box to the nearest written box of
    its class)."""
    import cv2
    from ..harness import frames as frame_io
    decoded = [frame_io.decode(w['jpeg']) for w in written]
    off, gap = 0, 0.0
    for batch in batches:
        images = batch['images'].cpu().numpy()
        boxes = batch['gt_boxes'].cpu().numpy()
        h, w = images.shape[1:3]
        resized = [cv2.resize(d, (w, h)).astype(np.float32) for d in decoded]
        for img, rows in zip(images, boxes):
            match = [i for i, r in enumerate(resized)
                     if np.array_equal(r, img)]
            if not match:
                off += 1
                continue
            src = written[match[0]]
            sy = h / decoded[match[0]].shape[0]
            sx = w / decoded[match[0]].shape[1]
            drawn = []
            for label, poly in src['shapes']:
                if label in labels:
                    xs, ys = poly[::2], poly[1::2]
                    drawn.append((labels.index(label),
                                  (max(xs) + min(xs)) / 2 * sx,
                                  (max(ys) + min(ys)) / 2 * sy,
                                  (max(xs) - min(xs)) * sx,
                                  (max(ys) - min(ys)) * sy))
            for row in rows:
                if row[5] <= 0:
                    continue
                same = [d for d in drawn if d[0] == int(row[4])]
                gap = max(gap, min((max(abs(row[j] - d[j + 1])
                                        for j in range(4)) for d in same),
                                   default=float('inf')))
    return dict(data_rows_off=off, data_boxes_gap=gap)


def box_gap(got, want, beta: float) -> float:
    """The box loss's moving mean and variance: the larger of the two
    distances between the program's change from the initial state (mean
    ``beta``, variance 0) and the reference's, over the reference's."""
    out = 0.0
    for g, w, init in zip(got, want, (beta, 0.0)):
        g, w = g.double().cpu() - init, w.double().cpu() - init
        out = max(out, float((g - w).norm() / w.norm().clamp(min=1e-30)))
    return out


def step_gaps(got: Dict, ref: Dict, beta: float) -> Dict[str, float]:
    """A run's readings (``losses``, ``grad1``, ``change``, ``stats``,
    ``box``) against the reference's: ``grad_gap`` / ``change_gap`` (the
    median leaf's gap of the first gradient / of the counted leaves' change
    over the steps), ``grad_group_gap`` / ``change_group_gap`` (the worst
    module group's median leaf), ``stats_gap`` (the worst group's median
    BatchNorm running statistic's change), ``box_gap``; and, not compared,
    ``loss_gap`` (the worst step's relative gap of the total loss) and the
    worst single leaves (``grad_worst``, ``change_worst``)."""
    counted = counted_leaves(ref['grad1'])
    grad = leaf_gaps(got['grad1'], ref['grad1'])
    change = leaf_gaps(got['change'], ref['change'], counted)
    print('worst leaves (not compared): grad ' + worst_leaves(grad)
          + '; change ' + worst_leaves(change), file=sys.stderr)
    return dict(
        loss_gap=max(abs(p - r) / max(abs(r), 1e-30)
                     for p, r in zip(got['losses'], ref['losses'])),
        grad_gap=median(grad.values()),
        change_gap=median(change.values()),
        grad_group_gap=group_gap(got['grad1'], ref['grad1']),
        change_group_gap=group_gap(got['change'], ref['change'], counted),
        stats_gap=group_gap(got['stats'], ref['stats']),
        box_gap=box_gap(got['box'], ref['box'], beta),
        grad_worst=max(grad.values()),
        change_worst=max(change.values()))


# step_gaps' numbers that are printed and not compared (PERF.md)
NOT_COMPARED = ('loss_gap', 'grad_worst', 'change_worst')


def compared(gaps: Dict[str, float]) -> Dict[str, float]:
    """The compared numbers of ``gaps``; the others printed, as a JSON
    object on one line of standard error."""
    print('readings (not compared): ' + json.dumps(
        {k: gaps[k] for k in NOT_COMPARED}), file=sys.stderr)
    return {k: v for k, v in gaps.items() if k not in NOT_COMPARED}


def judge_steps(model_dict: Dict, entry: Dict, device,
                labels) -> Dict[str, float]:
    """The numbers of a training cell's checked steps: ``step_gaps`` of
    the program's steps (its first gradient as its optimizer got it, read
    off the first moment after one step: RAdam's b1 0.9), ``start_gap``
    (the program's parameters when its first checked step began against
    the benchmark's weights: exact) and ``data_gaps``."""
    ref = run_steps(model_dict, entry['state0'], entry['batches'],
                    entry['proposals'], entry['lr'], device)
    b1 = 0.9
    got = dict(losses=entry['losses'],
               grad1={k: float((v / (1 - b1)).double().norm())
                      for k, v in entry['mu'].items()},
               change={k: float((entry['after'][k] - entry['start'][k])
                                .double().norm()) for k in entry['start']},
               stats=stat_changes(entry['state0'], entry['stats']),
               box=entry['box'])
    start_gap = max(float((entry['start'][k] - entry['state0'][k])
                          .abs().max()) for k in entry['start'])
    gaps = step_gaps(got, ref, model_dict['loss']['box_loss_beta'])
    return dict(compared(gaps), start_gap=start_gap,
                **data_gaps(entry['batches'], entry['written'], labels))


def control_steps(model_dict: Dict, state0: Dict[str, torch.Tensor],
                  batches: List[Dict[str, torch.Tensor]], lr: Dict,
                  device) -> Dict[str, float]:
    """The float8 control in the program's place: its own steps (its own
    proposals), judged against the float32 reference run on its
    proposals."""
    ctrl = run_steps(model_dict, state0, batches, None, lr, device,
                     control=True)
    ref = run_steps(model_dict, state0, batches, ctrl['proposals'], lr,
                    device)
    return step_gaps(ctrl, ref, model_dict['loss']['box_loss_beta'])
