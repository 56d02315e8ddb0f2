"""Train and eval steps.

Port of ``masklab_tpu/train/steps.py``: the trainer forward, the four task
losses as one objective (each ``mean``-ed), one backward, the optimizer
update, the BatchNorm statistics (updated by the train-mode forward) and
the box loss's moving statistics, and the metrics when asked for. The
reference's step is a pure jitted function; this one updates the state in
place and returns it. Its four phases are spans (``utils.profiling``:
``stage:forward``, ``stage:losses``, ``stage:backward``,
``stage:optimizer``; a data-parallel step's ``stage:all_reduce`` before the
last).

Given a data-parallel group (``ranks``, ``nn.sync.Ranks``), each rank runs
the step on its rows of the global batch (``parallel.shard_batch``) and the
step is the one-process step on the global batch: train-mode BatchNorm, the
box loss's moving statistics and the drop-connect draws take the global
batch (``nn.sync``); the total is a mean of per-image terms, so each rank
backpropagates its own rows' total and the global batch's gradient is the
mean of the ranks' gradients once the statistics' gradients have crossed
the ranks; the reported loss and metrics are their means over the ranks.
Every rank then applies the same update.

Given a rank's groups on a (data, model) mesh (``spatial``,
``nn.spatial.SpatialRanks``), each rank holds its data row's images and a
block of their rows (``parallel.spatial_shard_batch``), the step runs
inside ``nn.spatial.spatially_sharded``, and every rank computes its data
row's whole loss (the heads' rows gathered, the segmentation's pixel sums
over the row's ranks): each collective's gradient is its adjoint, so the
mean of the mesh's gradients is the one-process step's.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..losses import BoxLossState, box_loss, class_loss, mask_loss, seg_loss
from ..metrics import class_binary_iou, detection_iou_metric
from ..models.detection import batched_assign_boxes
from ..models.instance import assign_masks
from ..models.masklab import MaskLab
from ..models.semantic import assign_seg
from ..nn.spatial import SpatialRanks, spatially_sharded
from ..nn.sync import Ranks, all_reduce_, synchronized
from ..utils.profiling import count, span
from .state import TrainState


def as_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (``make_random_batch``'s keys) as tensors on
    ``device``. Where that is not the host, the counters ``upload.bytes``
    and ``upload.pageable_bytes`` (those not in pinned memory) take the
    bytes copied."""
    host = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    if torch.device(device).type != 'cpu':
        sizes = [(t.nbytes, t.is_pinned()) for t in host.values()]
        count('upload.bytes', sum(n for n, _ in sizes))
        count('upload.pageable_bytes',
              sum(n for n, pinned in sizes if not pinned))
    return {k: t.to(device) for k, t in host.items()}


def losses_of(model: MaskLab, out: Dict, batch: Dict, box_state: BoxLossState,
              with_metrics: bool = True, ranks: Optional[Ranks] = None
              ) -> Tuple:
    """The losses (and metrics) of ``trainer_outputs``' ``out`` ->
    (total, next box state, metrics), of this rank's rows where ``ranks``
    is given (the box loss's statistics of the global batch)."""
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
        beta=lc.box_loss_beta, use_adjust=lc.box_loss_use_adjust,
        sync=ranks)
    mask_targets = assign_masks(out['roi_boxes'], batch['gt_boxes'],
                                batch['gt_masks'],
                                out['roi_masks'].shape[2:4], num_det)
    mask_l = mask_loss(mask_targets, out['roi_masks'],
                       weight=lc.mask_loss_weight,
                       label_smoothing=lc.mask_loss_label_smoothing)
    seg_assigned = assign_seg(batch['gt_seg'], out['seg_pred'])
    seg_l = seg_loss(seg_assigned, out['seg_pred'], batch['gt_seg_exist'],
                     weight=lc.seg_loss_weight,
                     label_smoothing=lc.seg_loss_label_smoothing)
    terms = {'class_loss': cls_l.mean(), 'box_loss': box_l.mean(),
             'mask_loss': mask_l.mean(), 'seg_loss': seg_l.mean()}
    total = (terms['class_loss'] + terms['box_loss'] + terms['mask_loss']
             + terms['seg_loss'])
    metrics = {'loss': total.detach(),
               **{k: v.detach() for k, v in terms.items()}}
    if with_metrics:
        with torch.no_grad():
            p, r, f = detection_iou_metric(out['metric_proposals'],
                                           batch['gt_boxes'])
            iou = class_binary_iou(seg_assigned, out['seg_pred'])
        metrics.update(detection_precision=p.mean(), detection_recall=r.mean(),
                       detection_fmeasure=f.mean())
        for idx, name in enumerate(cfg.dataset.semantic_labels):
            metrics[f'{name}_iou'] = iou[:, idx].mean()
    return total, new_box_state.detach(), metrics


def compute_losses(model: MaskLab, batch: Dict, box_state: BoxLossState,
                   train: bool = True, with_metrics: bool = True,
                   ranks: Optional[Ranks] = None) -> Tuple:
    """The trainer forward and its losses -> (total, next box state,
    metrics). ``train`` sets the model's mode: batch statistics (updated in
    place) or the running ones. ``batch`` holds tensors keyed like the
    reference generator's feed: images, gt_seg, gt_seg_exist, gt_boxes,
    gt_boxes_exist, gt_masks. ``ranks``: as ``losses_of``."""
    model.train(train)
    out = model.trainer_outputs(batch['images'], batch['gt_boxes'],
                                with_metrics=with_metrics)
    return losses_of(model, out, batch, box_state, with_metrics, ranks)


def gradients(total: torch.Tensor, params: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
    """{name: d total / d param}, zeros for a parameter the loss does not
    reach (as the reference's grad gives)."""
    grads = torch.autograd.grad(total, list(params.values()),
                                allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), grads)}


def mean_over_ranks(tensors: Dict[str, torch.Tensor], ranks: Ranks
                    ) -> Dict[str, torch.Tensor]:
    """{name: the mean over the ranks}: one sum over the ranks of the
    tensors of each dtype, flattened together, the dtypes in their first
    appearance's order (the same on every rank)."""
    out = {}
    for dtype in dict.fromkeys(t.dtype for t in tensors.values()):
        names = [k for k, t in tensors.items() if t.dtype == dtype]
        flat = all_reduce_(torch.cat([tensors[k].reshape(-1)
                                      for k in names]), ranks.group)
        flat /= ranks.world
        for k, part in zip(names, flat.split(
                [tensors[k].numel() for k in names])):
            out[k] = part.view_as(tensors[k])
    return {k: out[k] for k in tensors}


def _sync_block(model: MaskLab, ranks: Optional[Ranks],
                spatial: Optional[SpatialRanks]):
    if spatial is not None:
        return spatially_sharded(model, *spatial)
    if ranks is not None:
        return synchronized(model, ranks)
    return contextlib.nullcontext()


def make_train_step(model: MaskLab, with_metrics: bool = True,
                    seed: int = 42, ranks: Optional[Ranks] = None,
                    spatial: Optional[SpatialRanks] = None) -> Callable:
    """The train step: (state, batch) -> (state, metrics). ``state`` is a
    ``TrainState`` of ``model``, updated in place; ``batch`` holds tensors
    on the model's device (``as_batch``): this rank's rows of the global
    batch where ``ranks`` names a data-parallel group. ``seed`` is the
    run's base seed (``train.seed``): each step's drop-connect
    (efficientnet) draws from a CPU generator seeded from it and the step,
    as the reference folds ``PRNGKey(seed)`` with the step (its bits differ
    from the reference's draws; their distribution is the same).
    ``spatial``: the dp x sp step on this rank's block of its data row
    (``ranks`` is then ignored: the gradients' mean is over the mesh)."""
    box_ranks = spatial.dp if spatial is not None else ranks
    mesh = spatial.world if spatial is not None else ranks

    def train_step(state: TrainState, batch: Dict):
        if state.model is not model:
            raise ValueError('the state holds another model')
        model.train()
        # the CPU generator keeps the seed's low 32 bits
        generator = torch.Generator().manual_seed(
            (seed * 1_000_003 + state.step) % (1 << 32))
        with _sync_block(model, ranks, spatial):
            with span('stage:forward'):
                out = model.trainer_outputs(
                    batch['images'], batch['gt_boxes'],
                    with_metrics=with_metrics, generator=generator)
            with span('stage:losses'):
                total, new_box_state, metrics = losses_of(
                    model, out, batch, state.box_loss_state, with_metrics,
                    box_ranks)
            with span('stage:backward'):
                grads = gradients(total, state.params)
        if mesh is not None:
            with span('stage:all_reduce'):
                grads = mean_over_ranks(grads, mesh)
                metrics = mean_over_ranks(metrics, mesh)
        with span('stage:optimizer'):
            state.apply_gradients(grads)
        state.box_loss_state = new_box_state
        return state, metrics

    return train_step


def make_eval_step(model: MaskLab, with_metrics: bool = True,
                   ranks: Optional[Ranks] = None,
                   spatial: Optional[SpatialRanks] = None) -> Callable:
    """(state, batch) -> metrics, with the running BatchNorm statistics and
    no gradient; with ``ranks``, of this rank's rows (the box loss's
    statistics of the global batch), the metrics averaged over the
    ranks; with ``spatial``, of this rank's block (as ``make_train_step``),
    averaged over the mesh."""
    box_ranks = spatial.dp if spatial is not None else ranks
    mesh = spatial.world if spatial is not None else ranks

    def eval_step(state: TrainState, batch: Dict):
        with torch.no_grad(), _sync_block(model, None, spatial):
            _, _, metrics = compute_losses(model, batch,
                                           state.box_loss_state, train=False,
                                           with_metrics=with_metrics,
                                           ranks=box_ranks)
            if mesh is not None:
                metrics = mean_over_ranks(metrics, mesh)
        return metrics

    return eval_step
