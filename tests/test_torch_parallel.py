"""Data parallelism over torch.distributed against the JAX package's mesh.

Spawned gloo ranks on the CPU (``torch_ranks``, one torch thread each, a
free localhost port) run the port's parallel steps, its multi-process
worker and its trainer; the JAX package runs ``make_parallel_train_step`` /
``make_parallel_eval_step`` and the mesh predictor on two of the virtual
CPU devices. Every check states its tolerance:

  * the 2-rank train step against JAX's 2-device step from the same flax
    variables, at tests/test_torch_train.py's tolerances for one step
    (narrow mobilenet; narrow seresnet34 with squeeze-excite heads);
  * float64 semantics: the 2-rank train-mode forward and backward against
    the port's one-process ones on the global batch, within 1e-9
    (seresnet34; efficientnet with drop-connect and a checkpointed
    backbone), and the box loss's statistics of the global batch;
  * the eval step against JAX's mesh eval step, rtol 1e-4;
  * the drop-connect draws of the ranks are rows of the one-process draw;
  * the multi-process worker: two subprocesses, bit-identical losses;
  * the trainer: 2 ranks against the one-process trainer on the same
    global batches;
  * the mesh predictor (two replicas on the CPU) against the unsharded
    predictor and JAX's mesh predictor.
"""
import csv
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from masklab_tpu import ModelConfiguration as JaxConfig
from masklab_tpu.models import build_masklab as jax_build
from masklab_tpu.parallel import (make_mesh as jax_make_mesh,
                                  make_parallel_eval_step as jax_eval_step,
                                  make_parallel_train_step as jax_train_step,
                                  replicate_sharding,
                                  shard_batch as jax_shard_batch)
from masklab_tpu.serving import MaskLabPredictor as JaxPredictor
from masklab_tpu.train import TrainState as JaxTrainState
from masklab_tpu.train import cyclic_lr as jax_cyclic_lr
from masklab_tpu.train import rectified_adam as jax_radam
import masklab_tpu_torch as mt
from masklab_tpu_torch import parallel
from masklab_tpu_torch.data import (MaskLabDataset, MaskLabGenerator,
                                    make_random_batch, make_synthetic_dataset,
                                    process_dataset)
from masklab_tpu_torch.data import generator as tgen
from masklab_tpu_torch.serving.batching import CheckpointWatcher
from masklab_tpu_torch.weights import to_flax_tree

import torch_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (128, 128)
GLOBAL_BATCH = 4


@pytest.fixture(scope='module', autouse=True)
def torch_threads():
    """Two intra-op threads for the test process's torch work."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def narrow(cfg, backbone):
    """Width 32, depth 1, small NMS pools; ``backbone`` 'mobilenet', the
    road preset's 'seresnet34' (C3-P6, squeeze-excite heads) or
    'efficientnetb2' (C3-C5, drop-connect, the backbone checkpointed)."""
    if backbone == 'seresnet34':
        cfg.backbone.backbone_outputs = ('C3', 'C4', 'C5', 'P6')
        cfg.detection.feature_pyramid_inputs = ('C3', 'C4', 'C5')
        for g in (cfg.detection, cfg.instance, cfg.semantic):
            g.use_squeeze_excite = True
    elif backbone == 'efficientnetb2':
        cfg.backbone.backbone_outputs = ('C3', 'C4', 'C5')
        cfg.detection.feature_pyramid_inputs = ('C3', 'C4', 'C5')
        cfg.compute.remat_backbone = True
    cfg.backbone.backbone_type = backbone
    cfg.backbone.num_features = 32
    for g in (cfg.detection, cfg.instance, cfg.semantic):
        g.num_features = 32
        g.num_depth = 1
    cfg.semantic.num_aspp_features = 32
    cfg.detection.nms_max_output_size = 20
    cfg.compute.nms_candidates_per_class = 64
    return cfg


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, 'items'):
            out.update(flat(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


JAX_MODELS = ('mobilenet', 'seresnet34')
# the float64 checks' models, each with whether its objective reads
# raw_heads' features (else the body's endpoints on float64 images)
FLOAT64_MODELS = {'seresnet34': False, 'efficientnetb2': True}


@pytest.fixture(scope='module')
def batch():
    return make_random_batch(GLOBAL_BATCH, HW, 4, seed=0)


@pytest.fixture(scope='module')
def jax_models():
    """{backbone: (JAX model, its initial variables as numpy)}."""
    out = {}
    for name in JAX_MODELS:
        jmodel = jax_build(narrow(JaxConfig(), name))
        out[name] = (jmodel, numpy_tree(jax.jit(jmodel.init)(
            jax.random.PRNGKey(0), jnp.zeros((1,) + HW + (3,)))))
    return out


@pytest.fixture(scope='module')
def trainer_data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('parallel_trainer_data'))
    make_synthetic_dataset(d, num_images=10, image_hw=(128, 160), seed=1)
    process_dataset(d, num_workers=1)
    return d


def trainer_config(data_dir):
    """tests/test_torch_trainer.py's small run, 3 phases of one epoch, a
    global batch of 2 and a valid set of 2 (so validation rides the
    group)."""
    cfg = narrow(mt.ModelConfiguration(), 'mobilenet')
    cfg.backbone.backbone_outputs = ('C3', 'C4', 'C5')
    cfg.detection.feature_pyramid_inputs = ('C3', 'C4', 'C5')
    cfg.backbone.num_features = 16
    for g in (cfg.detection, cfg.instance, cfg.semantic):
        g.num_features = 16
    cfg.semantic.num_aspp_features = 16
    cfg.instance.crop_size = (7, 7)
    cfg.detection.nms_max_output_size = 4
    cfg.loss.nms_max_output_size = 4
    cfg.compute.nms_candidates_per_class = 8
    cfg.compute.scale_buckets = (0.5,)
    cfg.train.scale_ratio = (0.5, 0.5)
    cfg.train.batch_size = 2
    cfg.train.train_head_tune_epoch = 1
    cfg.train.train_waist_tune_epoch = 1
    cfg.train.train_all_epoch = 1
    cfg.dataset.data_dir = data_dir
    cfg.dataset.min_area = 50.0
    cases = MaskLabDataset(data_dir=data_dir, min_area=50.0).cases
    cfg.dataset.train_cases = list(cases[:8])
    cfg.dataset.valid_cases = list(cases[8:])
    cfg.postprocess.resolution = (128, 160)
    return cfg


TRAINER_STEPS = 2


@pytest.fixture(scope='module')
def ranks(batch, jax_models, trainer_data, tmp_path_factory):
    """One spawn of 2 gloo ranks for every rank-side job of this file; the
    JAX package's mesh steps run meanwhile."""
    def cfg(name):
        return narrow(mt.ModelConfiguration(), name).to_dict()
    jobs = [(f'jax_{name}', 'train_steps',
             dict(cfg_dict=cfg(name), batch=batch,
                  variables=jax_models[name][1])) for name in JAX_MODELS]
    jobs += [(f'f64_{name}', 'feature_step',
              dict(cfg_dict=cfg(name), batch=batch,
                   through_heads=FLOAT64_MODELS[name]))
             for name in FLOAT64_MODELS]
    jobs.append(('box_loss', 'box_loss_step', {}))
    jobs.append(('eval', 'eval_step', dict(
        cfg_dict=cfg('mobilenet'), batch=batch,
        variables=jax_models['mobilenet'][1])))
    root = str(tmp_path_factory.mktemp('parallel_trainer'))
    jobs.append(('trainer', 'trainer', dict(
        cfg_dict=trainer_config(trainer_data).to_dict(),
        save_dir=os.path.join(root, 'ranks'),
        steps_per_epoch=TRAINER_STEPS)))
    spawned = torch_ranks.SpawnedRanks(jobs)
    jax_steps = {name: jax_parallel_step(name, jax_models, batch)
                 for name in JAX_MODELS}
    jax_eval = jax_parallel_eval(jax_models, batch)
    return dict(results=spawned.results(), root=root, jax_steps=jax_steps,
                jax_eval=jax_eval)


# ---- the train step ----

def jax_parallel_step(name, jax_models, batch):
    """JAX's ``make_parallel_train_step`` on a 2-device mesh, one step."""
    jmodel, variables = jax_models[name]
    mesh = jax_make_mesh(data=2, devices=jax.devices()[:2])
    state = JaxTrainState.create(variables, jax_radam(
        jax_cyclic_lr(1e-4, 1e-3, 700)))
    with mesh:
        state = jax.device_put(state, replicate_sharding(mesh))
        step = jax_train_step(jmodel, mesh, with_metrics=True)
        state, metrics = step(state, jax_shard_batch(
            {k: jnp.asarray(v) for k, v in batch.items()}, mesh))
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                mu=numpy_tree(state.opt_state.mu),
                params=numpy_tree(state.params),
                batch_stats=numpy_tree(state.batch_stats),
                box=[np.asarray(t) for t in state.box_loss_state])


def close_at_scale(got, want, rel, what, scale=None, floor=0.0):
    """Every leaf within ``rel`` x ``scale`` (default: its own largest
    |value|) plus ``floor``."""
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want), what
    for path, w in want.items():
        tol = rel * (np.abs(w).max() if scale is None else scale) + floor
        err = np.abs(got[path] - w).max() if w.size else 0.0
        assert err <= tol, f'{what} {"/".join(path)}: {err} > {tol}'


@pytest.mark.parametrize('name', JAX_MODELS)
def test_two_rank_step_matches_jax_mesh(ranks, name):
    """Both ranks against JAX's 2-device step from the same variables, at
    tests/test_torch_train.py's one-step tolerances: loss terms within
    1e-5 relative and the counted metrics exact; head gradients within
    2e-3 of each tensor's largest entry, backbone gradients within 5e-2
    of the largest backbone gradient (train-mode BatchNorm over small
    maps in float32: that test's docstring), each head tensor also within
    1e-7 of the largest head gradient (float32 rounding at the heads'
    scale: a mask level's GroupNorm bias gradient of ~1e-8, summed in
    another order, moved 4.4e-11 on this run); batch_stats within 1e-3 of
    each tensor's largest value; the box state's moving mean within 1e-5
    relative and its variance within 1e-5 of the mean."""
    want = ranks['jax_steps'][name]
    for r, res in enumerate(ranks['results']):
        got = res[f'jax_{name}'][0]
        assert sorted(got['metrics']) == sorted(want['metrics'])
        for k, v in want['metrics'].items():
            if k.endswith('loss'):
                assert got['metrics'][k] == pytest.approx(v, rel=1e-5), k
            else:
                assert got['metrics'][k] == v, k
        heads = {k: v for k, v in want['mu'].items() if k != 'backbone'}
        close_at_scale({k: v for k, v in got['mu'].items()
                        if k != 'backbone'}, heads, 2e-3, f'rank {r} heads',
                       floor=1e-7 * max(np.abs(v).max()
                                        for v in flat(heads).values()))
        backbone = flat(want['mu']['backbone'])
        close_at_scale(got['mu']['backbone'], want['mu']['backbone'], 5e-2,
                       f'rank {r} backbone',
                       scale=max(np.abs(v).max() for v in backbone.values()))
        close_at_scale(got['batch_stats'], want['batch_stats'], 1e-3,
                       f'rank {r} batch_stats')
        np.testing.assert_allclose(got['box'][0], want['box'][0], rtol=1e-5)
        np.testing.assert_allclose(got['box'][1], want['box'][1],
                                   atol=1e-5 * np.abs(want['box'][0]).max())


def test_ranks_apply_bit_identical_updates(ranks):
    """After each step both ranks hold the same parameters, BatchNorm
    statistics, first moments, box state and metrics, bit for bit; so do
    the float64 feature steps' reduced gradients and statistics."""
    a, b = ranks['results']
    for job in [f'jax_{n}' for n in JAX_MODELS]:
        for sa, sb in zip(a[job], b[job]):
            assert sa['metrics'] == sb['metrics']
            for part in ('params', 'batch_stats', 'mu'):
                fa, fb = flat(sa[part]), flat(sb[part])
                for path in fa:
                    assert np.array_equal(fa[path], fb[path]), (job, path)
            assert all(np.array_equal(x, y)
                       for x, y in zip(sa['box'], sb['box']))
    for job in [f'f64_{n}' for n in FLOAT64_MODELS]:
        for part in ('grads', 'batch_stats'):
            fa, fb = flat(a[job][part]), flat(b[job][part])
            for path in fa:
                assert np.array_equal(fa[path], fb[path]), (job, path)


@pytest.mark.parametrize('name', FLOAT64_MODELS)
def test_two_rank_step_is_the_one_process_step_float64(ranks, batch, name):
    """In float64 the 2-rank train-mode forward and backward equal the
    one-process ones on the global batch within 1e-9 of each tensor's
    scale: the objective (a fixed projection of seresnet34's body endpoints
    on float64 images, of efficientnet's FPN features; a mean over
    images), every parameter gradient (the mean over the ranks; plus 1e-9
    of the largest gradient, for the tensors whose exact gradient is 0: a
    bias ahead of a train-mode BatchNorm, ~1e-13 of cancellation noise)
    and the updated BatchNorm statistics (plus 1e-9 of the largest
    statistic: a mean of ~1e-18 where the exact one is 0). BatchNorm's
    statistics and their gradients cross the ranks; efficientnet also draws drop-connect for
    the global batch and recomputes its checkpointed backbone (the
    recomputation reduces too). The heads' float32 outputs are left out:
    the model computes them in float32 whatever its dtype."""
    want = torch_ranks.feature_step(
        narrow(mt.ModelConfiguration(), name).to_dict(), batch,
        through_heads=FLOAT64_MODELS[name])
    for res in ranks['results']:
        got = res[f'f64_{name}']
        assert got['objective'] == pytest.approx(want['objective'],
                                                 rel=1e-9)
        scale = max(np.abs(v).max() for v in flat(want['grads']).values())
        close_at_scale(got['grads'], want['grads'], 1e-9, 'grads',
                       floor=1e-9 * scale)
        stats = max(np.abs(v).max()
                    for v in flat(want['batch_stats']).values())
        close_at_scale(got['batch_stats'], want['batch_stats'], 1e-9,
                       'batch_stats', floor=1e-9 * stats)


def test_box_loss_statistics_of_the_global_batch_float64(ranks):
    """The box loss over 2 ranks in float64: each rank's per-image losses,
    its rows' share of the global mean's gradient (through the moving
    statistics of the global batch) and the next state within 1e-12 of
    the one-process box loss on the global batch."""
    want = torch_ranks.box_loss_step()
    for r, res in enumerate(ranks['results']):
        got = res['box_loss']
        rows = slice(2 * r, 2 * r + 2)
        np.testing.assert_allclose(got['loss'], want['loss'][rows],
                                   rtol=1e-12)
        np.testing.assert_allclose(got['grad'], want['grad'][rows],
                                   rtol=1e-12, atol=1e-15)
        for x, y in zip(got['state'], want['state']):
            np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-15)


def jax_parallel_eval(jax_models, batch):
    """JAX's ``make_parallel_eval_step`` on a 2-device mesh."""
    jmodel, variables = jax_models['mobilenet']
    mesh = jax_make_mesh(data=2, devices=jax.devices()[:2])
    state = JaxTrainState.create(variables, jax_radam(1e-3))
    with mesh:
        state = jax.device_put(state, replicate_sharding(mesh))
        metrics = jax_eval_step(jmodel, mesh)(state, jax_shard_batch(
            {k: jnp.asarray(v) for k, v in batch.items()}, mesh))
    return {k: float(v) for k, v in metrics.items()}


def test_eval_step_matches_jax_mesh(ranks):
    """Each rank's eval metrics against JAX's mesh eval step on the same
    variables, rtol 1e-4 (tests/test_train_parallel.py's bound between
    its sharded and one-device eval)."""
    want = ranks['jax_eval']
    for res in ranks['results']:
        got = res['eval']
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], float(v), rtol=1e-4,
                                       err_msg=k)


def test_drop_connect_draws_are_rows_of_the_global_draw():
    """Each rank's keep mask is its rows of the one-process draw for the
    global batch, from the same generator state."""
    whole = torch_ranks.drop_connect_draws(1, 0, rows=6)
    parts = [torch_ranks.drop_connect_draws(2, r, rows=3) for r in (0, 1)]
    assert np.array_equal(np.concatenate(parts), whole)
    assert whole.any() and not whole.all()


def test_shard_batch_and_mesh_arguments():
    """``shard_batch`` gives a rank its rows and refuses an indivisible
    batch; ``make_mesh`` takes the first ``data`` devices, and with a
    model axis the first ``data * model`` (tests/test_torch_spatial.py
    holds the dp x sp layout)."""
    from masklab_tpu_torch.nn.sync import Ranks
    rows = {'a': np.arange(6), 'b': np.arange(12).reshape(6, 2)}
    got = parallel.shard_batch(rows, Ranks(None, 1, 3))
    assert got['a'].tolist() == [2, 3] and got['b'].shape == (2, 2)
    with pytest.raises(ValueError, match='does not divide'):
        parallel.shard_batch(rows, Ranks(None, 0, 4))
    mesh = parallel.make_mesh(data=2, devices=['cpu', 'cpu', 'cpu'])
    assert mesh.shape == {'data': 2, 'model': 1} and mesh.size == 2
    mesh = parallel.make_mesh(model=2, devices=['cpu', 'cpu', 'cpu'])
    assert mesh.shape == {'data': 1, 'model': 2} and mesh.size == 2
    with pytest.raises(ValueError):
        parallel.make_mesh(data=3, devices=['cpu', 'cpu'])


# ---- the multi-process worker ----

def test_multihost_worker_two_processes():
    """Two worker processes (``python -m
    masklab_tpu_torch.parallel.multihost --device=cpu``) join over gloo,
    hold the NMS pool exact without a fallback and print ``MULTIHOST_OK``
    with the same loss bits (tests/test_multihost.py's check)."""
    port = parallel.free_port()
    env = dict(os.environ, OMP_NUM_THREADS='1')
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'masklab_tpu_torch.parallel.multihost',
         f'--coordinator=localhost:{port}', '--num_processes=2',
         f'--process_id={r}', '--shape=small', '--device=cpu'],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=env) for r in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
        assert 'backend gloo' in out and 'NMS_POOL_OK' in out, out[-4000:]
        assert 'MULTIHOST_OK' in out and 'devices=2' in out, out[-4000:]
    losses = [o.rsplit('loss=', 1)[1].split()[0] for o in outs]
    assert losses[0] == losses[1]
    assert np.isfinite(float(losses[0]))


# ---- the trainer ----

def read_metrics(d):
    with open(os.path.join(d, 'metrics.csv')) as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope='module')
def one_process_trainer(ranks, trainer_data):
    save = os.path.join(ranks['root'], 'one')
    return save, torch_ranks.trainer(trainer_config(trainer_data).to_dict(),
                                     save, TRAINER_STEPS)


def test_trainer_two_ranks_match_one_process(ranks, one_process_trainer):
    """Two ranks each call ``train_masklab_model`` (smoke + 2 steps in each
    of 3 phases, validation over the group) against the one-process
    trainer on the same global batches: every step's loss within 1e-5
    relative; metrics.csv's step and lr columns exact, every other value
    within 1e-5 relative, the last phase's within 1e-4 (float32 sums in
    another order: with every layer trainable, train-mode BatchNorm over a
    rank's image moves the epoch's loss terms further; measured 1.32e-5,
    its box_loss; the earlier epochs 2.1e-6 at most)."""
    save, one = one_process_trainer
    rank0 = os.path.join(ranks['root'], 'ranks', 'rank0')
    got = ranks['results']
    assert len(one['losses']) == 1 + 3 * TRAINER_STEPS
    for res in got:
        np.testing.assert_allclose(res['trainer']['losses'], one['losses'],
                                   rtol=1e-5)
    want_rows, got_rows = read_metrics(save), read_metrics(rank0)
    assert len(got_rows) == len(want_rows) == 3
    for i, (g, w) in enumerate(zip(got_rows, want_rows)):
        assert sorted(g) == sorted(w)
        assert g['step'] == w['step'] and g['lr'] == w['lr']
        for k in w:
            np.testing.assert_allclose(float(g[k]), float(w[k]),
                                       rtol=1e-4 if i == 2 else 1e-5,
                                       atol=1e-7, err_msg=k)
    assert 'val_loss' in want_rows[0]


def test_trainer_rank_zero_alone_writes(ranks, one_process_trainer):
    """Rank 0 writes what the one-process trainer writes (config.json,
    metrics.csv, history.json, tb/, the checkpoints); rank 1, given a
    directory of its own, writes nothing there."""
    def kinds(files):
        """The names, each checkpoint's ("{loss:.5f}-{epoch:02d}") as
        'checkpoint': the losses' last digits may differ."""
        return sorted('checkpoint' if f[0].isdigit() else f for f in files)
    _, one = one_process_trainer
    r0, r1 = (res['trainer'] for res in ranks['results'])
    assert kinds(r0['files']) == kinds(one['files'])
    assert {'config.json', 'metrics.csv', 'history.json',
            'checkpoint'} <= set(kinds(r0['files']))
    assert r1['files'] == []


def test_trainer_ranks_end_and_resume_bit_identical(ranks):
    """The ranks' final parameters and statistics are equal bit for bit,
    and every rank restores rank 0's best checkpoint to the same state."""
    r0, r1 = (res['trainer'] for res in ranks['results'])
    for k, v in r0['state'].items():
        assert np.array_equal(v, r1['state'][k]), k
    for k, v in r0['restored'].items():
        assert np.array_equal(v, r1['restored'][k]), k
    assert r0['restored_step'] == r1['restored_step'] > 0
    assert all(np.array_equal(x, y) for x, y in zip(r0['restored_box'],
                                                     r1['restored_box']))


def test_trainer_spawns_its_ranks(ranks, trainer_data, tmp_path,
                                  monkeypatch):
    """The route ``train_masklab_model`` takes with N cards asked for and
    present (``_train_on_devices``: this process rank 0, the others
    spawned), here over two CPU ranks of one torch thread each: it returns
    rank 0's trainer, which ends in the state the two gloo ranks above
    reached, bit for bit."""
    from masklab_tpu_torch.train import trainer as tr
    cfg = trainer_config(trainer_data)
    cfg.train.save_dir = str(tmp_path)
    monkeypatch.setenv('OMP_NUM_THREADS', str(torch_ranks.RANK_THREADS))
    before = torch.get_num_threads()
    torch.set_num_threads(torch_ranks.RANK_THREADS)
    try:
        t = tr._train_on_devices(cfg, ['cpu', 'cpu'], dict(
            max_gt_boxes=6, steps_per_epoch=TRAINER_STEPS, smoke_steps=1))
    finally:
        torch.set_num_threads(before)
    assert not torch.distributed.is_initialized()
    assert t.ranks.rank == 0 and t.ranks.world == 2 and t.writes
    want = ranks['results'][0]['trainer']['state']
    for k, v in t.model.state_dict().items():
        assert np.array_equal(v.numpy(), want[k]), k
    assert os.path.exists(os.path.join(str(tmp_path), 'metrics.csv'))


@pytest.mark.parametrize('rank', [0, 1])
def test_generator_and_loader_build_a_rank_s_rows(trainer_data, rank):
    """A sharded generator's batch is its rows of the whole batch, with the
    same scale draw; the worker loader's (``_loader_get``, in process) the
    same; a batch that does not divide raises."""
    ds = MaskLabDataset(data_dir=trainer_data, min_area=50.0).get_config()
    kw = dict(batch_size=4, scale_buckets=(0.4, 0.5, 0.6),
              scale_ratio=(0.4, 0.6), seed=3)
    whole = MaskLabGenerator(ds, **kw)
    mine = MaskLabGenerator(ds, shard=(rank, 2), **kw)
    for i in range(len(whole)):
        w, g = whole[i], mine[i]
        for k in ('images', 'gt_seg', 'gt_boxes_exist', 'gt_seg_exist'):
            np.testing.assert_array_equal(g[k], w[k][2 * rank:2 * rank + 2])
    args = dict(dataset=ds, batch_size=4, scale_ratio=(0.4, 0.6),
                scale_buckets=(0.4, 0.5, 0.6), shuffle=False)
    tgen._loader_init(args)
    want = tgen._loader_get((11, 5, 1))
    tgen._loader_init(dict(args, shard=(rank, 2)))
    got = tgen._loader_get((11, 5, 1))
    np.testing.assert_array_equal(got['images'],
                                  want['images'][2 * rank:2 * rank + 2])
    with pytest.raises(ValueError, match='does not divide'):
        MaskLabGenerator(ds, shard=(rank, 3), **kw)


# ---- the predictor's mesh ----

def serving_config(cfg):
    """tests/test_serving_mesh.py's tiny configuration."""
    cfg.backbone.backbone_type = 'mobilenet'
    cfg.backbone.backbone_outputs = ('C3', 'C4', 'C5')
    cfg.detection.feature_pyramid_inputs = ('C3', 'C4', 'C5')
    cfg.backbone.num_features = 16
    for g in (cfg.detection, cfg.instance, cfg.semantic):
        g.num_features = 16
        g.num_depth = 1
    cfg.instance.crop_size = (7, 7)
    cfg.semantic.num_aspp_features = 16
    cfg.detection.nms_max_output_size = 4
    cfg.compute.nms_candidates_per_class = 8
    cfg.postprocess.resolution = (96, 128)
    return cfg


@pytest.fixture(scope='module')
def serving():
    jcfg = serving_config(JaxConfig())
    jmodel = jax_build(jcfg)
    variables = numpy_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 64, 64, 3))))
    tcfg = serving_config(mt.ModelConfiguration())
    tmodel = mt.load_flax_variables(mt.MaskLab(tcfg), variables)
    images = np.uint8(np.random.RandomState(1).rand(4, 96, 128, 3) * 255)
    mesh = parallel.make_mesh(data=2, devices=['cpu', 'cpu'])
    jmesh = jax_make_mesh(data=2, devices=jax.devices()[:2])
    return dict(jcfg=jcfg, jmodel=jmodel, variables=variables, tcfg=tcfg,
                tmodel=tmodel, images=images, mesh=mesh, jmesh=jmesh,
                sharded=mt.MaskLabPredictor(tmodel, tcfg, mesh=mesh),
                base=mt.MaskLabPredictor(tmodel, tcfg, device='cpu'),
                jax=JaxPredictor(jmodel, variables, jcfg, mesh=jmesh))


def assert_close_to_jax(got, want):
    """tests/test_torch_serving.py's end-to-end bounds: boxes within 1 px /
    1 confidence point, classes exact; at most 1e-3 of frame pixels
    changed; analytics within 1 on the box columns, rtol 1e-3 on the
    mask-derived ones; the full-frame masks at most 1e-3 of pixels
    apart; semantics within 1 count."""
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
    assert np.abs(got['det_boxes'].astype(np.int64)
                  - want['det_boxes']).max() <= 1
    np.testing.assert_array_equal(got['det_boxes'][..., 4],
                                  want['det_boxes'][..., 4])
    if 'visualize' in want:
        assert (got['visualize'] != want['visualize']).any(-1).mean() <= 1e-3
    if 'summarize' in want:
        g, w = got['summarize'], want['summarize']
        np.testing.assert_array_equal(g[..., [0, 10]], w[..., [0, 10]])
        assert np.abs(g[..., 1:6] - w[..., 1:6]).max() <= 1
        np.testing.assert_allclose(g[..., 6:9], w[..., 6:9], rtol=1e-3,
                                   atol=1e-2)
        np.testing.assert_allclose(g[..., 9], w[..., 9], rtol=1e-3, atol=0.5)
    if 'padded_masks' in want:
        assert (got['padded_masks'] != want['padded_masks']).mean() <= 1e-3
        assert np.abs(got['semantic'].astype(int)
                      - want['semantic']).max() <= 1


@pytest.mark.parametrize('mode', ['raw', 'summarize', 'visualize'])
def test_mesh_predictor_matches_single_device(serving, mode):
    """Two replicas on the CPU: exactly the unsharded predictor's answers on
    the same 2-row shards, within 1e-4 (uint8 within 1) of its answer on
    the whole batch (tests/test_serving_mesh.py's bound), and within
    tests/test_torch_serving.py's bounds of JAX's mesh predictor."""
    images = serving['images']
    out = serving['sharded'].predict(images, mode)
    shards = [serving['base'].predict(images[i:i + 2], mode) for i in (0, 2)]
    whole = serving['base'].predict(images, mode)
    for k in whole:
        np.testing.assert_array_equal(
            out[k], np.concatenate([s[k] for s in shards]), err_msg=k)
        atol = 1.001 if whole[k].dtype == np.uint8 else 1e-4
        np.testing.assert_allclose(out[k].astype(np.float32),
                                   whole[k].astype(np.float32), atol=atol,
                                   rtol=1e-4, err_msg=k)
    assert_close_to_jax(out, serving['jax'].predict(images, mode))


def test_mesh_predictor_pads_indivisible_batch(serving):
    """A batch of 3 runs as 2 + (1 + a zero pad row), the pad dropped: the
    unsharded predictor's answers on those rows exactly, JAX's mesh
    predictor's within bounds; a single image too."""
    images = serving['images'][:3]
    out = serving['sharded'].predict(images, 'summarize')
    want = [serving['base'].predict(images[:2], 'summarize'),
            serving['base'].predict(np.concatenate(
                [images[2:], np.zeros_like(images[:1])]), 'summarize')]
    for k in out:
        assert out[k].shape[0] == 3
        np.testing.assert_array_equal(out[k][:2], want[0][k])
        np.testing.assert_array_equal(out[k][2:], want[1][k][:1])
    assert_close_to_jax(out, serving['jax'].predict(images, 'summarize'))
    one = serving['sharded'].predict(serving['images'][0], 'summarize')
    ref = serving['base'].predict(serving['images'][0], 'summarize')
    for k in ref:
        assert one[k].shape == ref[k].shape
        np.testing.assert_array_equal(one[k], ref[k])


def test_mesh_predictor_hot_reload_keeps_the_replicas(serving, tmp_path):
    """``place_variables`` (the watcher's swap) builds one replica a mesh
    device; after a ``CheckpointWatcher`` swap every replica serves the new
    checkpoint: the answers of an unsharded predictor built on it, shard
    by shard, and within tests/test_torch_serving.py's bounds of JAX's
    mesh predictor after its own ``place_variables`` of the same
    variables (tests/test_serving_mesh.py's reload)."""
    from masklab_tpu_torch import train
    from masklab_tpu_torch.train.checkpoints import CheckpointManager
    cfg = serving['tcfg']
    pred = mt.MaskLabPredictor(serving['tmodel'], cfg, mesh=serving['mesh'])
    new = mt.build_masklab(cfg, device='cpu', seed=7)
    CheckpointManager(str(tmp_path), cfg).save_epoch(
        train.TrainState(new, train.rectified_adam(1e-3)), 0.5, 0)
    before = pred.model
    assert CheckpointWatcher(pred, str(tmp_path)).check_once()
    assert isinstance(pred.model, tuple) and len(pred.model) == 2
    assert all(a is not b for a, b in zip(pred.model, before))
    assert pred.model[0] is not pred.model[1]
    for m in pred.model:
        for (k, v), w in zip(m.state_dict().items(),
                             new.state_dict().values()):
            assert torch.equal(v.float(), w.float()), k
    images = serving['images']
    base = mt.MaskLabPredictor(new, cfg, device='cpu')
    want = [base.predict(images[i:i + 2], 'raw') for i in (0, 2)]
    got = pred.predict(images, 'raw')
    for k in got:
        np.testing.assert_array_equal(
            got[k], np.concatenate([w[k] for w in want]), err_msg=k)
    jpred = JaxPredictor(serving['jmodel'], serving['variables'],
                         serving['jcfg'], mesh=serving['jmesh'])
    jpred.variables = jpred.place_variables(to_flax_tree(new))
    assert_close_to_jax(got, jpred.predict(images, 'raw'))
