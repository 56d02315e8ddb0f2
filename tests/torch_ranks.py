"""Rank-side work of tests/test_torch_parallel.py.

The ranks are spawned processes of a gloo group on the CPU; they import
this module by name, so it imports nothing of JAX (the test file does).
``SpawnedRanks`` runs a list of jobs, each a function of this module
with its keyword arguments, on every rank in turn and returns each rank's
results.
The same functions run in the test process, outside any group, as the
one-process references.
"""
import contextlib
import multiprocessing as mp
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

import masklab_tpu_torch as mt
from masklab_tpu_torch import parallel, train
from masklab_tpu_torch.weights import to_flax_tree

# torch's intra-op threads a rank: the tier-1 run's workers share the host
RANK_THREADS = 1


class SpawnedRanks:
    """``world`` spawned gloo ranks running ``jobs`` ([(name, function
    name, kwargs)]), started at construction, so the test process can work
    meanwhile; ``results()`` -> [{name: result}] in rank order."""

    def __init__(self, jobs, world=2):
        ctx = mp.get_context('spawn')
        port = parallel.free_port()
        self.queue = ctx.Queue()
        self.procs = [ctx.Process(target=_rank,
                                  args=(r, world, port, jobs, self.queue))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def results(self, timeout=600.0):
        try:
            # drain before joining: a rank blocks on a full pipe otherwise
            got = dict(_take(self.queue, timeout) for _ in self.procs)
        finally:
            for p in self.procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.terminate()
        return [got[r] for r in range(len(self.procs))]


def _take(queue, timeout):
    r, out, error = queue.get(timeout=timeout)
    if error is not None:
        raise RuntimeError(f'rank {r} failed:\n{error}')
    return r, out


def _rank(r, world, port, jobs, queue):
    torch.set_num_threads(RANK_THREADS)
    try:
        parallel.initialize(f'localhost:{port}', world, r, device='cpu')
        try:
            out = {name: globals()[fn](**kwargs)
                   for name, fn, kwargs in jobs}
        finally:
            dist.destroy_process_group()
        queue.put((r, out, None))
    except BaseException:  # noqa: BLE001 - reported to the test process
        queue.put((r, None, traceback.format_exc()))


def _model(cfg_dict, variables, float64):
    cfg = mt.ModelConfiguration().from_dict(cfg_dict)
    model = mt.MaskLab(cfg)
    if variables is None:
        mt.init_weights(model, seed=0)
    else:
        mt.load_flax_variables(model, variables)
    if float64:
        model.double()
        for m in model.modules():
            if hasattr(m, 'compute_dtype'):
                m.compute_dtype = torch.float64
            if isinstance(getattr(m, 'dtype', None), torch.dtype):
                m.dtype = torch.float64
    return model


def train_steps(cfg_dict, batch, steps=1, variables=None, with_metrics=True,
                seed=42):
    """``steps`` train steps of the configuration's model (from
    ``variables``, flax numpy trees, or seeded weights) on the global
    ``batch``: this rank's rows inside a group, all of them outside ->
    per step {metrics, mu, params, batch_stats, box} as numpy (flax
    trees)."""
    model = _model(cfg_dict, variables, False)
    state = train.TrainState(model, train.rectified_adam(
        train.cyclic_lr(1e-4, 1e-3, 700)))
    if dist.is_initialized():
        parallel.replicate_state(state)
        batch = parallel.shard_batch(batch)
        step = parallel.make_parallel_train_step(model, None, with_metrics,
                                                 seed)
    else:
        step = train.make_train_step(model, with_metrics, seed)
    tbatch = train.as_batch(batch, 'cpu')
    out = []
    for _ in range(steps):
        start = to_flax_tree(model)
        state, metrics = step(state, tbatch)
        out.append(dict(
            start=start,
            metrics={k: float(v) for k, v in metrics.items()},
            mu=to_flax_tree(model, state.opt_state.mu)['params'],
            box=[t.numpy().copy() for t in state.box_loss_state],
            **to_flax_tree(model)))
    return out


def feature_step(cfg_dict, batch, through_heads=True, seed=42):
    """One float64 train-mode forward of the configuration's seeded model
    and the objective: the mean over images of a fixed random projection
    of each image's maps, on this rank's rows inside a group -> {objective,
    grads (flax tree; the mean over the ranks), batch_stats}. The maps are
    ``raw_heads``' FPN features (drop-connect drawn from a generator seeded
    by ``seed``; the backbone checkpointed where the configuration says),
    or with ``through_heads`` False the body's endpoints on the
    preprocessed images in float64 (preprocessing casts the images to
    float32, and seresnet34's input BatchNorm then reduces in float32)."""
    from masklab_tpu_torch.nn.backbone.preprocess import preprocess_for
    from masklab_tpu_torch.nn.sync import synchronized
    from masklab_tpu_torch.train.steps import gradients, mean_over_ranks
    model = _model(cfg_dict, None, True).train()
    sync = contextlib.nullcontext()
    if dist.is_initialized():
        batch = parallel.shard_batch(batch)
        sync = synchronized(model, parallel.data_ranks())
    images = torch.from_numpy(batch['images']).double()
    params = dict(model.named_parameters())
    generator = torch.Generator().manual_seed(seed)
    with sync:
        if through_heads:
            maps = model.raw_heads(images, generator)['features']
        else:
            bb = model.backbone
            x = preprocess_for(bb.backbone_type, images).double()
            maps = list(getattr(bb, bb.body_name)(
                x.permute(0, 3, 1, 2).contiguous(
                    memory_format=torch.channels_last), generator).values())
        weights = torch.Generator().manual_seed(0)
        objective = sum(
            (f * torch.randn(f.shape[1:], generator=weights,
                             dtype=f.dtype)).flatten(1).sum(1)
            for f in maps).mean()
        grads = gradients(objective, params)
    values = dict(grads, objective=objective.detach())
    if dist.is_initialized():
        values = mean_over_ranks(values, parallel.data_ranks())
    return dict(objective=float(values.pop('objective')),
                grads=to_flax_tree(model, values)['params'],
                batch_stats=to_flax_tree(model)['batch_stats'])


def box_loss_step(b=4, n=60, seed=3):
    """The box loss in float64 on a random [b, n] batch (the moving
    statistics from their initial state), this rank's rows inside a group
    -> {loss per image, the gradient of the batch-mean loss per image row
    (of the global mean), the next state}."""
    from masklab_tpu_torch.losses import BoxLossState, box_loss
    rng = np.random.RandomState(seed)
    loc_true = rng.randn(b, n, 4)
    loc_pred = rng.randn(b, n, 4)
    mask = rng.randint(-1, 2, (b, n, 1)).astype(np.float64)
    ranks, world = None, 1
    if dist.is_initialized():
        ranks = parallel.data_ranks()
        world = ranks.world
        loc_true, loc_pred, mask = (parallel.shard_batch({'x': a}, ranks)['x']
                                    for a in (loc_true, loc_pred, mask))
    pred = torch.from_numpy(loc_pred).requires_grad_()
    state = BoxLossState(torch.full((4,), 0.11, dtype=torch.float64),
                         torch.zeros(4, dtype=torch.float64))
    loss, new = box_loss(torch.from_numpy(loc_true), pred,
                         torch.from_numpy(mask), state, sync=ranks)
    loss.mean().backward()
    return dict(loss=loss.detach().numpy(), grad=pred.grad.numpy() / world,
                state=[t.detach().numpy() for t in new])


def eval_step(cfg_dict, batch, variables=None):
    """The eval step's metrics of the global ``batch`` (this rank's rows
    inside a group)."""
    model = _model(cfg_dict, variables, False)
    state = train.TrainState(model, train.rectified_adam(1e-3))
    if dist.is_initialized():
        batch = parallel.shard_batch(batch)
        fn = parallel.make_parallel_eval_step(model)
    else:
        fn = train.make_eval_step(model)
    return {k: float(v) for k, v in fn(state, train.as_batch(batch, 'cpu')
                                       ).items()}


def trainer(cfg_dict, save_dir, steps_per_epoch):
    """``train_masklab_model`` on the CPU into ``save_dir`` (a directory of
    this rank's own under ``<save_dir>/rank<r>`` inside a group) -> the
    final parameters and statistics, the step losses, the files this rank's
    directory holds and, after every rank restores rank 0's best checkpoint,
    the restored state."""
    from masklab_tpu_torch.train import trainer as tr
    from masklab_tpu_torch.train.checkpoints import CheckpointManager
    cfg = mt.ModelConfiguration().from_dict(cfg_dict)
    r = parallel.rank()
    if dist.is_initialized():
        cfg.train.save_dir = os.path.join(save_dir, f'rank{r}')
    else:
        cfg.train.save_dir = save_dir
    losses = []
    orig = tr.make_train_step

    def recording(model, *args, **kwargs):
        step = orig(model, *args, **kwargs)

        def run(state, batch):
            state, metrics = step(state, batch)
            losses.append(float(metrics['loss']))
            return state, metrics
        return run
    tr.make_train_step = recording
    try:
        t = tr.train_masklab_model(cfg, max_gt_boxes=6,
                                   steps_per_epoch=steps_per_epoch,
                                   device='cpu')
    finally:
        tr.make_train_step = orig
    files = sorted(os.listdir(cfg.train.save_dir))
    final = {k: v.numpy().copy() for k, v in t.model.state_dict().items()}
    rank0 = os.path.join(save_dir, 'rank0') if dist.is_initialized() \
        else save_dir
    best = CheckpointManager(rank0, None).best_checkpoint()
    restored = CheckpointManager(rank0, None).restore_state(
        train.TrainState(t.model, t.state.tx), best)
    return dict(losses=losses, files=files,
                state=final,
                restored={k: v.numpy().copy()
                          for k, v in t.model.state_dict().items()},
                restored_step=restored.step,
                restored_box=[b.numpy().copy()
                              for b in restored.box_loss_state])


def drop_connect_draws(world, rank, rows=3, rate=0.4, seed=5):
    """Kept-or-dropped masks of efficientnet's ``drop_connect`` for
    ``rows`` samples of rank ``rank`` of ``world`` (no process group
    needed: the draw is local) -> [rows] bools."""
    from masklab_tpu_torch.nn.backbone.efficientnet import drop_connect
    from masklab_tpu_torch.nn.sync import Ranks
    x = torch.ones(rows, 1, 1, 1)
    g = torch.Generator().manual_seed(seed)
    sync = None if world == 1 else Ranks(None, rank, world)
    return (drop_connect(x, rate, g, sync)[:, 0, 0, 0] != 0).numpy()

