"""Rank-side work of tests/test_torch_parallel.py and
tests/test_torch_spatial.py.

The ranks are spawned processes of a gloo group on the CPU; they import
this module by name, so it imports nothing of JAX (the test file does).
``SpawnedRanks`` runs a list of jobs, each a function of this module
with its keyword arguments, on every rank in turn and returns each rank's
results.
The same functions run in the test process, outside any group, as the
one-process references.
"""
import contextlib
import contextvars
import multiprocessing as mp
import os
import traceback
import zlib

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

import masklab_tpu_torch as mt
from masklab_tpu_torch import parallel, train
from masklab_tpu_torch.weights import to_flax_tree

# torch's intra-op threads a rank: the tier-1 run's workers share the host
RANK_THREADS = 1


class SpawnedRanks:
    """``world`` spawned gloo ranks running ``jobs`` ([(name, function
    name, kwargs)]) on ``device`` (each rank the same one), started at
    construction, so the test process can work meanwhile; ``results()`` ->
    [{name: result}] in rank order."""

    def __init__(self, jobs, world=2, device='cpu'):
        ctx = mp.get_context('spawn')
        port = parallel.free_port()
        self.queue = ctx.Queue()
        self.procs = [ctx.Process(target=_rank,
                                  args=(r, world, port, jobs, self.queue,
                                        device))
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


def _rank(r, world, port, jobs, queue, device='cpu'):
    torch.set_num_threads(RANK_THREADS)
    try:
        parallel.initialize(f'localhost:{port}', world, r, device=device)
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
    return _float64(model) if float64 else model


def _float64(model):
    """``model`` computing in float64 (GroupNorm's statistics follow its
    input)."""
    model.double()
    for m in model.modules():
        if hasattr(m, 'compute_dtype'):
            m.compute_dtype = torch.float64
        if isinstance(getattr(m, 'dtype', None), torch.dtype):
            m.dtype = torch.float64
    return model


def _spatial_mesh(mesh_shape):
    """The (data, model) mesh of CPU ranks, or None outside a group."""
    if not dist.is_initialized():
        return None
    return parallel.make_mesh(*mesh_shape,
                              devices=['cpu'] * dist.get_world_size())


def train_steps(cfg_dict, batch, steps=1, variables=None, with_metrics=True,
                seed=42, mesh_shape=None):
    """``steps`` train steps of the configuration's model (from
    ``variables``, flax numpy trees, or seeded weights) on the global
    ``batch``: this rank's rows inside a group (with ``mesh_shape`` (data,
    model), its piece of the dp x sp layout), all of them outside -> per
    step {metrics, mu, params, batch_stats, box} as numpy (flax trees)."""
    model = _model(cfg_dict, variables, False)
    state = train.TrainState(model, train.rectified_adam(
        train.cyclic_lr(1e-4, 1e-3, 700)))
    mesh = _spatial_mesh(mesh_shape) if mesh_shape else None
    if mesh is not None:
        parallel.replicate_state(state, mesh)
        layout = parallel.spatial_batch_sharding(batch, mesh)
        batch = parallel.spatial_shard_batch(batch, mesh)
        step = parallel.make_parallel_train_step(
            model, mesh, with_metrics, seed, batch_shardings=layout)
    elif dist.is_initialized():
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


def eval_step(cfg_dict, batch, variables=None, mesh_shape=None):
    """The eval step's metrics of the global ``batch`` (this rank's rows
    inside a group; with ``mesh_shape``, its piece of the dp x sp
    layout)."""
    model = _model(cfg_dict, variables, False)
    state = train.TrainState(model, train.rectified_adam(1e-3))
    mesh = _spatial_mesh(mesh_shape) if mesh_shape else None
    if mesh is not None:
        layout = parallel.spatial_batch_sharding(batch, mesh)
        batch = parallel.spatial_shard_batch(batch, mesh)
        fn = parallel.make_parallel_eval_step(model, mesh,
                                              batch_shardings=layout)
    elif dist.is_initialized():
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



# ---- the dp x sp spatial sharding (tests/test_torch_spatial.py) ----

def spatial_heads(cfg_dict, images, mesh_shape=(1, 2), variables=None,
                  float64=False):
    """``raw_heads`` of the configuration's model (eval mode; ``float64``:
    computing in float64) on the global ``images``: this rank's piece
    inside a group (``parallel.sharded``), all of them outside ->
    {cls_pred, loc_pred (whole), seg_pred (this rank's rows), priors} as
    numpy, and image_hw."""
    model = _model(cfg_dict, variables, float64).eval()
    x = torch.from_numpy(images)
    block = contextlib.nullcontext()
    mesh = _spatial_mesh(mesh_shape)
    if mesh is not None:
        x = parallel.spatial_shard_batch({'images': x}, mesh)['images']
        block = parallel.sharded(model, mesh)
    with torch.no_grad(), block:
        out = model.raw_heads(x)
    heads = {k: out[k].double().numpy()
             for k in ('cls_pred', 'loc_pred', 'seg_pred', 'priors')}
    return dict(heads, image_hw=tuple(out['image_hw']))


def _projection(shape, key, dtype=torch.float64):
    """A fixed random weight of ``shape`` (the global map's), the same on
    every rank and in one process."""
    g = torch.Generator().manual_seed(zlib.crc32(repr(key).encode()))
    return torch.randn(shape, generator=g, dtype=dtype)


def _own_rows(w, rows, dim):
    """This rank's block of a global weight's rows (all outside a
    sharding)."""
    from masklab_tpu_torch.nn import spatial
    sp = spatial.active()
    if sp is None:
        return w
    a, b = sp.block(rows)
    return w.narrow(dim, a, b - a)


def spatial_objective(cfg_dict, batch, mesh_shape=(1, 2), seed=42):
    """One float64 train-mode ``raw_heads`` and backward of the
    configuration's seeded model (GroupNorm statistics in float64 too; the
    backbone checkpointed where the configuration says, its drop-connect
    drawn from a generator seeded by ``seed``) on the global ``batch``
    (this rank's piece of the dp x sp layout inside a group), through every
    collective of the sharding: the objective is the mean over images of
    fixed random projections of the FPN features (a pixel sum over the
    ranks), of each level's class-head block (its GroupNorms, the level
    gathered whole), of 7x7 RoI crops of the first level at the gt boxes
    (the crops' shares summed over the ranks) and of the segmentation
    head's map (ASPP, the decoder's resize) -> {objective, grads,
    batch_stats (float64 numpy by parameter / buffer name; the gradients
    the mean over the mesh)}."""
    from masklab_tpu_torch.nn import spatial
    from masklab_tpu_torch.ops.boxes import cxcywh_to_yxyx
    from masklab_tpu_torch.ops.roi_align import batched_crop_and_resize
    from masklab_tpu_torch.train.steps import gradients, mean_over_ranks
    model = _model(cfg_dict, None, True).train()
    block = contextlib.nullcontext()
    mesh = _spatial_mesh(mesh_shape)
    if mesh is not None:
        batch = parallel.spatial_shard_batch(batch, mesh)
        ranks = parallel.spatial_ranks(mesh)
        block = parallel.sharded(model, mesh)
    images = torch.from_numpy(batch['images']).double()
    boxes = torch.from_numpy(batch['gt_boxes']).double()
    params = dict(model.named_parameters())
    taken = {}

    def take(name):
        return lambda module, inputs, output: taken.__setitem__(name, output)
    hooks = [model.seg_subnet.register_forward_hook(take('seg'))]
    hooks += [getattr(model.cls_subnet, f'block_{i}').register_forward_hook(
        take(i)) for i in range(model.cls_subnet.num_blocks)]
    with block:
        out = model.raw_heads(images, torch.Generator().manual_seed(seed))
        for h in hooks:
            h.remove()
        feats, seg = out['features'], taken['seg']
        frame = out['image_hw'][0]
        terms = []
        for i, f in enumerate(feats + [seg]):
            rows = (spatial.active().rows(('objective', i), f.shape[2])
                    if spatial.active() else f.shape[2])
            w = _own_rows(_projection((f.shape[1], rows, f.shape[3]),
                                      ('map', i)), rows, 1)
            terms.append(spatial.sum_hw(f * w, (2, 3)).sum(1))
        for i in range(len(feats)):
            whole = spatial.gather(taken[i], ('objective head', i))
            w = _projection(whole.shape[1:], ('head', i))
            terms.append((whole * w).flatten(1).sum(1))
        norm = cxcywh_to_yxyx(boxes[..., :4], (frame, images.shape[2]))
        crops = spatial.reduce_crops(batched_crop_and_resize(
            feats[0].permute(0, 2, 3, 1), norm, (7, 7),
            spatial.crop_rows(('objective', 'crops'), feats[0].shape[2])))
        w = _projection(crops.shape[2:], 'crops')
        terms.append((crops * w * (boxes[..., :1, None, None] != -1.0))
                     .flatten(1).sum(1))
        objective = sum(terms).mean()
        # the backward in an empty context, as a card's runs in the autograd
        # engine's threads: it needs no sharding in force (a checkpointed
        # backbone re-enters its forward's)
        grads = contextvars.Context().run(gradients, objective, params)
    values = dict(grads, objective=objective.detach())
    if mesh is not None:
        values = mean_over_ranks(values, ranks.world)
    return dict(objective=float(values.pop('objective')),
                grads={k: v.numpy() for k, v in values.items()},
                batch_stats={k: v.numpy() for k, v in model.named_buffers()})


def spatial_backbone(backbone, images, mesh_shape=(1, 2), seed=42):
    """The float64 train-mode endpoints C1-C5, P6 and P7 of ``backbone``
    (``BackboneNetwork``, extras 16 wide, torch's initialization from seed
    0, drop-connect drawn from a generator seeded by ``seed``) on the
    global ``images``, preprocessed and then cast to float64 (the
    preprocessing computes in float32, and seresnet34's input BatchNorm
    would then reduce in float32): this rank's rows inside a group ->
    {endpoint: rows, batch_stats}."""
    from masklab_tpu_torch.nn import backbone as bb
    torch.manual_seed(0)
    model = _float64(bb.BackboneNetwork(
        backbone, ('C1', 'C2', 'C3', 'C4', 'C5', 'P6', 'P7'), 16)).train()
    x = torch.from_numpy(images).double()
    block = contextlib.nullcontext()
    mesh = _spatial_mesh(mesh_shape)
    if mesh is not None:
        x = parallel.spatial_shard_batch({'images': x}, mesh)['images']
        block = parallel.sharded(model, mesh)
    preprocess = bb.preprocess_for
    bb.preprocess_for = lambda name, t: preprocess(name, t).double()
    try:
        with torch.no_grad(), block:
            out = model(x, torch.Generator().manual_seed(seed))
    finally:
        bb.preprocess_for = preprocess
    res = {k: v.numpy() for k, v in out.items()}
    res['batch_stats'] = {k: v.numpy() for k, v in model.named_buffers()}
    return res


def spatial_rows_seen(cfg_dict, images, mesh_shape=(1, 2)):
    """The rows of every ``F.conv2d`` and ``F.max_pool2d`` input of one
    ``raw_heads`` (eval mode) on the global ``images``, in call order, with
    the kernel's rows, dilation and stride: on this rank's piece inside a
    group, on the whole frame outside -> [(op, rows, kernel, dilation,
    stride)]."""
    seen = []
    conv, pool = F.conv2d, F.max_pool2d

    def conv_hook(x, w, *args, **kwargs):
        stride = kwargs.get('stride', args[1] if len(args) > 1 else 1)
        dilation = kwargs.get('dilation', args[3] if len(args) > 3 else 1)
        seen.append(('conv', x.shape[-2], w.shape[-2],
                     _first(dilation), _first(stride)))
        return conv(x, w, *args, **kwargs)

    def pool_hook(x, kernel, *args, **kwargs):
        stride = kwargs.get('stride', args[0] if args else kernel)
        seen.append(('pool', x.shape[-2], _first(kernel), 1, _first(stride)))
        return pool(x, kernel, *args, **kwargs)
    F.conv2d, F.max_pool2d = conv_hook, pool_hook
    try:
        spatial_heads(cfg_dict, images, mesh_shape)
    finally:
        F.conv2d, F.max_pool2d = conv, pool
    return seen


def _first(v):
    return v[0] if isinstance(v, (tuple, list)) else v


def cuda_exchanges(rows=11, seed=0):
    """On this rank's card, of two gloo ranks: the row exchange (halo
    windows reaching one and three rows past the blocks, the blocks'
    partition of ``rows``) and the row gather of a seeded [2, 5, rows, 7]
    map, forward and backward against the same collectives on CPU copies;
    then a ragged GroupNorm map (rows x 7 pixels, 16 groups) sharded, which
    the rank gathers to K1, against K1's plain version on the whole map,
    with K1's launches -> {name: max |card - reference|}, launches."""
    from masklab_tpu_torch.nn import spatial
    from masklab_tpu_torch.nn.layers import GroupNorm
    from masklab_tpu_torch.nn.sync import (Ranks, exchange_rows,
                                           gather_rows, ranks_of)
    from masklab_tpu_torch.ops import cuda as kc
    ranks = ranks_of(None)
    parts = spatial.blocks(rows, ranks.world)
    a, b = parts[ranks.rank]
    g = torch.Generator().manual_seed(seed)
    whole = torch.randn(2, 5, rows, 7, generator=g, dtype=torch.float64)
    grad_out = torch.randn(2, 5, rows, 7, generator=g, dtype=torch.float64)
    out = {}
    for name, reach in (('exchange_1', 1), ('exchange_3', 3),
                        ('gather', None)):
        results = []
        for device in ('cuda', 'cpu'):
            x = whole[:, :, a:b].to(device).requires_grad_()
            if reach is None:
                y = gather_rows(x, ranks, parts)
                lo, hi = 0, rows
            else:
                wins = [(max(p - reach, 0), min(q + reach, rows))
                        for p, q in parts]
                y = exchange_rows(x, ranks, parts, wins)
                lo, hi = wins[ranks.rank]
            y.backward(grad_out[:, :, lo:hi].to(device))
            results.append((y.detach().cpu(), x.grad.cpu()))
            if device == 'cpu' and not torch.equal(y.detach(),
                                                   whole[:, :, lo:hi]):
                raise AssertionError(f'{name}: the rows on the CPU')
        (yc, gc), (yp, gp) = results
        out[name] = max((yc - yp).abs().max().item(),
                        (gc - gp).abs().max().item())
    norm = GroupNorm(32, 16).cuda()
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5)
        norm.bias.uniform_(-0.5, 0.5)
    fmap = torch.randn(2, 32, rows, 7, generator=g).cuda().contiguous(
        memory_format=torch.channels_last)
    before = kc.launch_counts()
    sp = spatial.SpatialRanks(ranks, Ranks(None, 0, 1), ranks, ranks.group)
    with spatial.spatially_sharded(norm, *sp):
        x = fmap[:, :, a:b].clone().requires_grad_()
        y = norm(x, fuse_relu=True)
        y.backward(torch.ones_like(y))
    after = kc.launch_counts()
    nhwc = fmap.permute(0, 2, 3, 1).reshape(2, rows * 7, 32).contiguous()
    want = kc.band_groupnorm_plain(nhwc, norm.weight.detach(),
                                   norm.bias.detach(), 16, fuse_relu=True)
    want = want.reshape(2, rows, 7, 32).permute(0, 3, 1, 2)[:, :, a:b]
    out['k1_gathered'] = (y.detach() - want).abs().max().item()
    out['launches'] = {k: after[k] - before[k] for k in after}
    return out
