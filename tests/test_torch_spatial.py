"""The dp x sp spatial sharding against the JAX package and one process.

A frame's rows split over the ranks of a mesh's model axis
(``masklab_tpu_torch.nn.spatial``, ``parallel.spatial_*``), each rank a
spawned gloo process on the CPU running the rank-side jobs of
``torch_ranks`` (one torch thread each); one spawn of 2 ranks serves every
1 x 2 check and one of 4 every 2 x 2 check, while the test process runs
the JAX package and the one-process references. Every check states its
tolerance:

  * JAX's two spatial tests (``tests/test_spatial_sharding.py``) on the
    port: the 1 x 2 ``raw_heads`` within 1e-4 of JAX's, and the 2 x 2
    train step's loss within 1e-4 of JAX's one-device step;
  * float64: the sharded forward against one process within 1e-7 of scale
    (the heads' float32 outputs), and a train-mode forward and backward
    through every collective on 1 x 2 and 2 x 2 meshes against one process
    within 1e-9 (the adjoints and the gradients' mean over the mesh);
  * every body of the backbone registry sharded at an uneven height in
    float64 within 1e-9 of one process;
  * no conv or pool on a rank sees more rows than its block and its halo;
  * the eval step with ``batch_shardings=``, the layout and the mesh.

The JAX imports live inside the CPU tests, so that the ``gpu`` tests also
run on a card's machine that has no JAX: ``python -m pytest --noconftest
tests/test_torch_spatial.py -m gpu``.
"""
import math
import threading

import numpy as np
import pytest
import torch

import masklab_tpu_torch as mt
from masklab_tpu_torch import parallel
from masklab_tpu_torch.data import make_random_batch
from masklab_tpu_torch.nn import spatial
from masklab_tpu_torch.nn.backbone import PORTED_BACKBONES
from masklab_tpu_torch.nn.sync import Ranks

import torch_ranks

HW = (128, 128)


@pytest.fixture(scope='module', autouse=True)
def torch_threads():
    """Two intra-op threads for the test process's torch work."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def jax_test_config(cfg):
    """tests/test_spatial_sharding.py's model: mobilenet, widths 16, depth
    1, C3-C5."""
    cfg.backbone.backbone_type = 'mobilenet'
    cfg.backbone.backbone_outputs = ('C3', 'C4', 'C5')
    cfg.detection.feature_pyramid_inputs = ('C3', 'C4', 'C5')
    cfg.backbone.num_features = 16
    for g in (cfg.detection, cfg.instance, cfg.semantic):
        g.num_features = 16
        g.num_depth = 1
    cfg.semantic.num_aspp_features = 16
    return cfg


def step_config(cfg):
    """tests/test_spatial_sharding.py's train-step model."""
    cfg = jax_test_config(cfg)
    cfg.detection.nms_max_output_size = 8
    cfg.loss.nms_max_output_size = 8
    cfg.compute.nms_candidates_per_class = 16
    return cfg


def narrow(cfg):
    """Widths 16, depth 1 of any configuration."""
    cfg.backbone.num_features = 16
    for g in (cfg.detection, cfg.instance, cfg.semantic):
        g.num_features = 16
        g.num_depth = 1
    cfg.semantic.num_aspp_features = 16
    cfg.semantic.num_skip_features = 16
    return cfg


# the structural check's models and frames: JAX's test model at an uneven
# height (C3 15 rows, C5 3), the road preset (seresnet34, C3-P6,
# squeeze-excite heads) with a 7-row C3 and a 1-row P6, and the default
# configuration (resnet50, C3-P7) with a 1-row P7
ROWS_CASES = {
    'jax_test': (lambda: jax_test_config(mt.ModelConfiguration()),
                 (120, 128)),
    'road': (lambda: narrow(mt.road_project_config()), (56, 96)),
    'default': (lambda: narrow(mt.ModelConfiguration()), (72, 128)),
}


def body_frames(name):
    """Uneven frames with a 1-row P7 (mobilenet's VALID stride-2 convs
    floor: 136 x 128, C3 17 rows; the others 72 x 64, C3 9 rows)."""
    hw = (136, 128) if name == 'mobilenet' else (72, 64)
    return (np.random.RandomState(3).rand(2, *hw, 3) * 255).astype(
        np.float32)


def frames(n, hw, seed=0):
    return (np.random.RandomState(seed).rand(n, *hw, 3) * 255).astype(
        np.float32)


@pytest.fixture(scope='module')
def batch():
    return make_random_batch(2, HW, 3)


@pytest.fixture(scope='module')
def objective_batch():
    """An uneven frame (C3 15 rows, 15 x 15 pixels: a ragged GroupNorm
    map) for the float64 objective."""
    return make_random_batch(2, (120, 120), 3, seed=5)


def remat_config(cfg):
    """efficientnetb2 (drop-connect) with its backbone checkpointed, C3-C5,
    widths 16: the recomputation's exchanges and draws in the backward."""
    cfg = jax_test_config(cfg)
    cfg.backbone.backbone_type = 'efficientnetb2'
    cfg.compute.remat_backbone = True
    return cfg


# the float64 objective's cases: (model, mesh)
OBJECTIVES = {'mobilenet 1x2': (jax_test_config, (1, 2)),
              'mobilenet 2x2': (jax_test_config, (2, 2)),
              'efficientnetb2 remat 2x2': (remat_config, (2, 2))}


@pytest.fixture(scope='module')
def jax_model():
    """JAX's test model and its initial variables (numpy), JAX's init."""
    import jax
    import jax.numpy as jnp
    from masklab_tpu import ModelConfiguration as JaxConfig
    from masklab_tpu.models import build_masklab as jax_build
    jmodel = jax_build(step_config(JaxConfig()))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1,) + HW + (3,)))
    return jmodel, jax.tree_util.tree_map(np.asarray, dict(variables))


@pytest.fixture(scope='module')
def pair(jax_model, batch, objective_batch):
    """One spawn of 2 ranks (a 1 x 2 mesh) for every 1 x 2 job; the JAX
    package's forward and the one-process references run meanwhile."""
    jcfg = jax_test_config(mt.ModelConfiguration()).to_dict()
    images = frames(1, HW)
    jobs = [('heads', 'spatial_heads',
             dict(cfg_dict=jcfg, images=images, variables=jax_model[1])),
            ('heads_f64', 'spatial_heads',
             dict(cfg_dict=jcfg, images=frames(2, (120, 136)),
                  float64=True)),
            ('eval', 'eval_step',
             dict(cfg_dict=step_config(mt.ModelConfiguration()).to_dict(),
                  batch=batch, variables=jax_model[1], mesh_shape=(1, 2)))]
    jobs += [(f'objective {name}', 'spatial_objective',
              dict(cfg_dict=make(mt.ModelConfiguration()).to_dict(),
                   batch=objective_batch, mesh_shape=shape))
             for name, (make, shape) in OBJECTIVES.items() if shape == (1, 2)]
    jobs += [(f'body_{name}', 'spatial_backbone',
              dict(backbone=name, images=body_frames(name)))
             for name in PORTED_BACKBONES]
    jobs += [(f'rows_{name}', 'spatial_rows_seen',
              dict(cfg_dict=make().to_dict(), images=frames(1, hw)))
             for name, (make, hw) in ROWS_CASES.items()]
    spawned = torch_ranks.SpawnedRanks(jobs, world=2)
    jax_heads = jax_raw_heads(jax_model, images)
    return dict(results=spawned.results(), jax_heads=jax_heads,
                images=images)


@pytest.fixture(scope='module')
def quad(jax_model, batch, objective_batch):
    """One spawn of 4 ranks (a 2 x 2 mesh) for every 2 x 2 job; the JAX
    package's one-device step and the one-process step run meanwhile."""
    scfg = step_config(mt.ModelConfiguration()).to_dict()
    jobs = [('step', 'train_steps',
             dict(cfg_dict=scfg, batch=batch, variables=jax_model[1],
                  with_metrics=False, mesh_shape=(2, 2))),
            ('eval', 'eval_step',
             dict(cfg_dict=scfg, batch=batch, variables=jax_model[1],
                  mesh_shape=(2, 2)))]
    jobs += [(f'objective {name}', 'spatial_objective',
              dict(cfg_dict=make(mt.ModelConfiguration()).to_dict(),
                   batch=objective_batch, mesh_shape=shape))
             for name, (make, shape) in OBJECTIVES.items() if shape == (2, 2)]
    spawned = torch_ranks.SpawnedRanks(jobs, world=4)
    jax_loss = jax_one_device_loss(jax_model, batch)
    one = torch_ranks.train_steps(scfg, batch, variables=jax_model[1],
                                  with_metrics=False)[0]
    return dict(results=spawned.results(), jax_loss=jax_loss, one=one)


def jax_raw_heads(jax_model, images):
    import jax
    import jax.numpy as jnp
    from masklab_tpu import ModelConfiguration as JaxConfig
    from masklab_tpu.models import build_masklab as jax_build
    jmodel = jax_build(jax_test_config(JaxConfig()))
    out = jax.jit(lambda v, x: jmodel.apply(v, x, method='raw_heads'))(
        jax_model[1], jnp.asarray(images))
    return {k: np.asarray(out[k]) for k in ('cls_pred', 'loc_pred',
                                             'seg_pred')}


def jax_one_device_loss(jax_model, batch):
    """tests/test_spatial_sharding.py's reference: the JAX step on a 1 x 1
    mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from masklab_tpu.parallel import (make_parallel_train_step,
                                      replicate_sharding, shard_batch)
    from masklab_tpu.train import TrainState, cyclic_lr, rectified_adam
    jmodel, variables = jax_model
    state = TrainState.create(variables,
                              rectified_adam(cyclic_lr(1e-4, 1e-3, 700)))
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ('data', 'model'))
    with mesh:
        state = jax.device_put(state, replicate_sharding(mesh))
        step = make_parallel_train_step(jmodel, mesh, with_metrics=False)
        _, metrics = step(state, shard_batch(
            {k: jnp.asarray(v) for k, v in batch.items()}, mesh))
    return float(metrics['loss'])


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, 'items'):
            out.update(flat(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def close_at_scale(got, want, rel, what, scale=None, floor=0.0):
    """Every leaf within ``rel`` x ``scale`` (default: its own largest
    |value|) plus ``floor``."""
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want), what
    for path, w in want.items():
        tol = rel * (np.abs(w).max() if scale is None else scale) + floor
        err = np.abs(got[path] - w).max() if w.size else 0.0
        assert err <= tol, f'{what} {"/".join(path)}: {err} > {tol}'


def change_of(step):
    """A step's parameter changes, as a flat dict by path, and the two
    float32 ulps of each parameter's largest entry the subtraction
    leaves."""
    start = flat(step['start']['params'])
    return ({k: v - start[k] for k, v in flat(step['params']).items()},
            {k: 2 * float(np.spacing(np.abs(v).max()))
             for k, v in start.items()})


def rows_of(results, job, key, axis):
    """The ranks' blocks of a map, in rank order, as the whole map."""
    return np.concatenate([r[job][key] for r in results], axis)


def assert_ranks_equal(results, job, parts):
    for r, res in enumerate(results[1:], 1):
        for part in parts:
            a, b = flat(results[0][job][part]), flat(res[job][part])
            for path in a:
                assert np.array_equal(a[path], b[path]), (job, r, path)


# ---- the layout ----

def test_mesh_layout_and_pieces():
    """``make_mesh(model=2)`` gives a 2-axis mesh; ``spatial_batch_sharding``
    is JAX's leaf-to-axes map; ``spatial_shard_batch``'s pieces put
    together are the batch (rows by data, height blocks by model, boxes by
    data only); the partition is contiguous and balanced, empty blocks
    included; a model axis without the layout, a layout no step runs, and
    the predictor over a model axis are refused."""
    import jax
    from masklab_tpu.parallel import make_mesh as jax_make_mesh
    from masklab_tpu.parallel import (spatial_batch_sharding as
                                      jax_spatial_batch_sharding)
    mesh = parallel.make_mesh(data=2, model=2, devices=['cpu'] * 5)
    assert mesh.shape == {'data': 2, 'model': 2} and mesh.size == 4
    assert parallel.make_mesh(model=2, devices=['cpu'] * 4).shape == {
        'data': 2, 'model': 2}
    with pytest.raises(ValueError):
        parallel.make_mesh(data=3, model=2, devices=['cpu'] * 4)
    batch = make_random_batch(4, (9, 6), 3)
    jmesh = jax_make_mesh(data=2, model=2, devices=jax.devices()[:4])
    want = jax_spatial_batch_sharding(batch, jmesh)
    got = parallel.spatial_batch_sharding(batch, mesh)
    assert got == {k: tuple(v.spec) for k, v in want.items()}
    pieces = [parallel.spatial_shard_batch(batch, mesh, rank=r)
              for r in range(4)]
    for k, axes in got.items():
        rows = [np.concatenate([pieces[d * 2 + m][k] for m in range(2)],
                               axes.index('model'))
                if 'model' in axes else pieces[d * 2][k] for d in range(2)]
        assert np.array_equal(np.concatenate(rows), batch[k]), k
    assert pieces[1]['images'].shape == (2, 5, 6, 3)
    assert spatial.blocks(9, 2) == [(0, 4), (4, 9)]
    assert spatial.blocks(1, 2) == [(0, 0), (0, 1)]
    model = mt.MaskLab(jax_test_config(mt.ModelConfiguration()))
    with pytest.raises(ValueError, match='batch_shardings'):
        parallel.make_parallel_train_step(model, mesh)
    with pytest.raises(ValueError, match='gt_seg'):
        parallel.make_parallel_eval_step(model, mesh, batch_shardings=dict(
            got, gt_seg=('data', 'model', None)))
    with pytest.raises(ValueError, match='model axis'):
        mt.MaskLabPredictor(model, mesh=mesh)


def test_sharding_is_the_threads_and_a_site_takes_one_height():
    """The sharding in force is the entering thread's: another thread (as
    the predictor's shards run) sees none, ``replicated`` suspends it, and
    the block restores what was before; a site that gets a second height
    of map at one frame raises, naming itself (a 1-rank group: no
    collective)."""
    model = mt.MaskLab(jax_test_config(mt.ModelConfiguration()))
    one = Ranks(None, 0, 1)
    seen = []
    with spatial.spatially_sharded(model, one, one, world=one) as sp:
        t = threading.Thread(target=lambda: seen.append(spatial.active()))
        t.start()
        t.join()
        assert spatial.active() is sp and seen == [None]
        with spatial.replicated():
            assert spatial.active() is None
        assert spatial.active() is sp
        assert sp.start(64) == 64
        assert sp.rows(model.seg_subnet, 8) == 8
        assert sp.rows(model.seg_subnet, 8) == 8
        with pytest.raises(ValueError, match='seg_subnet: a map of 4 rows'):
            sp.rows(model.seg_subnet, 4)
    assert spatial.active() is None


# ---- the forward ----

def test_height_sharded_forward_matches_jax(pair):
    """tests/test_spatial_sharding.py::test_height_sharded_forward_matches
    on the port: JAX's test model at 128 px (JAX's init) over a 1 x 2 mesh
    of gloo ranks; each rank's cls_pred and loc_pred (gathered) and the
    ranks' seg_pred rows put together within JAX's tolerance (atol and
    rtol 1e-4) of JAX's unsharded ``raw_heads``."""
    want = pair['jax_heads']
    res = pair['results']
    for r in res:
        for k in ('cls_pred', 'loc_pred'):
            np.testing.assert_allclose(r['heads'][k], want[k], atol=1e-4,
                                       rtol=1e-4, err_msg=k)
        assert r['heads']['image_hw'] == HW
    seg = rows_of(res, 'heads', 'seg_pred', 1)
    np.testing.assert_allclose(seg, want['seg_pred'], atol=1e-4, rtol=1e-4)


def test_height_sharded_forward_is_one_process_float64(pair):
    """JAX's test model in float64 at an uneven 120 x 136 (C3 15 rows, C5
    3): the 1 x 2 ``raw_heads`` against one process within 1e-7 of each
    output's largest value (the heads' outputs are float32: the float64
    maps agree far below their rounding); the anchors' priors exact."""
    want = torch_ranks.spatial_heads(
        jax_test_config(mt.ModelConfiguration()).to_dict(),
        frames(2, (120, 136)), float64=True)
    res = pair['results']
    got = dict(res[0]['heads_f64'],
               seg_pred=rows_of(res, 'heads_f64', 'seg_pred', 1))
    for k in ('cls_pred', 'loc_pred', 'seg_pred'):
        err = np.abs(got[k] - want[k]).max()
        assert err <= 1e-7 * np.abs(want[k]).max(), (k, err)
    assert np.array_equal(got['priors'], want['priors'])
    assert np.array_equal(res[1]['heads_f64']['cls_pred'], got['cls_pred'])


# ---- the train step ----

def test_dpsp_train_step_matches_jax(quad):
    """tests/test_spatial_sharding.py::test_dpsp_train_step_loss_parity on
    the port: one train step over a 2 x 2 mesh of gloo ranks (images,
    gt_seg and gt_masks split by batch and height), from JAX's initial
    variables. The loss within 1e-4 (x max(1, |loss|)) of JAX's
    one-device step; against the port's one-process step at
    tests/test_torch_parallel.py's one-step tolerances: loss terms within
    1e-5 relative, head gradients (first moments) and parameter changes
    within 2e-3 of each tensor's largest (plus 1e-7 of the heads'
    largest), backbone ones within 5e-2 of the backbone's largest (the
    changes also within the two float32 ulps of the parameter's largest
    entry that the subtraction leaves), batch_stats within 1e-3 of each
    tensor's largest, the box state's mean within 1e-5 relative and its
    variance within 1e-5 of the mean; the four ranks' parameters, statistics, first moments, box state and metrics
    equal bit for bit."""
    res, one = quad['results'], quad['one']
    for r in res:
        got = r['step'][0]
        loss = got['metrics']['loss']
        assert abs(loss - quad['jax_loss']) <= 1e-4 * max(
            1.0, abs(quad['jax_loss'])), (loss, quad['jax_loss'])
        for k, v in one['metrics'].items():
            assert got['metrics'][k] == pytest.approx(v, rel=1e-5), k
        changes, slack = change_of(got)
        want_changes, _ = change_of(one)
        for what, g, w in (('mu', flat(got['mu']), flat(one['mu'])),
                           ('change', changes, want_changes)):
            heads = {k: v for k, v in w.items() if k[0] != 'backbone'}
            body = {k: v for k, v in w.items() if k[0] == 'backbone'}
            floor = 1e-7 * max(np.abs(v).max() for v in heads.values())
            scale = max(np.abs(v).max() for v in body.values())
            for k, v in w.items():
                tol = (5e-2 * scale if k[0] == 'backbone'
                       else 2e-3 * np.abs(v).max() + floor)
                if what == 'change':
                    tol += slack[k]
                assert np.abs(g[k] - v).max() <= tol, (what, k)
        close_at_scale(got['batch_stats'], one['batch_stats'], 1e-3,
                       'batch_stats')
        np.testing.assert_allclose(got['box'][0], one['box'][0], rtol=1e-5)
        np.testing.assert_allclose(got['box'][1], one['box'][1],
                                   atol=1e-5 * np.abs(one['box'][0]).max())
    first = res[0]['step'][0]
    for r in res[1:]:
        got = r['step'][0]
        assert got['metrics'] == first['metrics']
        for part in ('params', 'batch_stats', 'mu'):
            a, b = flat(first[part]), flat(got[part])
            for path in a:
                assert np.array_equal(a[path], b[path]), (part, path)
        assert all(np.array_equal(x, y)
                   for x, y in zip(first['box'], got['box']))


@pytest.mark.parametrize('case', OBJECTIVES)
def test_spatial_step_is_one_process_float64(pair, quad, objective_batch,
                                             case):
    """In float64 (GroupNorm statistics too) a train-mode forward and
    backward through every collective of the sharding (conv and pool
    halos, stride-2 pads, the FPN and decoder resizes, BatchNorm over the
    mesh, GroupNorm bands over the ranks and a ragged map gathered whole
    to K1's plain version, the gathered head levels, the RoI crops'
    shares) at an uneven 120 x 120 against one process on the global
    batch: JAX's test model on a 1 x 2 and a 2 x 2 mesh, and efficientnetb2
    with its checkpointed backbone (exchanges recomputed in the backward)
    and drop-connect (each data row its draws) on a 2 x 2. The objective
    within 1e-9 relative, every parameter gradient (the mean over the
    mesh) within 1e-9 of the largest gradient, the BatchNorm statistics
    within 1e-9 of each tensor's largest plus 1e-9 of the largest
    statistic; the ranks' gradients and statistics equal bit for bit."""
    make, shape = OBJECTIVES[case]
    want = torch_ranks.spatial_objective(
        make(mt.ModelConfiguration()).to_dict(), objective_batch)
    res = (pair if shape == (1, 2) else quad)['results']
    job = f'objective {case}'
    scale = max(np.abs(v).max() for v in want['grads'].values())
    stats = max(np.abs(v).max() for v in want['batch_stats'].values())
    for r in res:
        got = r[job]
        assert got['objective'] == pytest.approx(want['objective'],
                                                 rel=1e-9)
        close_at_scale(got['grads'], want['grads'], 1e-9, 'grads',
                       scale=scale)
        close_at_scale(got['batch_stats'], want['batch_stats'], 1e-9,
                       'batch_stats', floor=1e-9 * stats)
    assert_ranks_equal(res, job, ('grads', 'batch_stats'))


def test_eval_step_with_batch_shardings(pair, quad, batch, jax_model):
    """The eval step with ``batch_shardings=spatial_batch_sharding`` on a 1
    x 2 and a 2 x 2 mesh: every metric within rtol 1e-4 of the port's
    one-process eval step (tests/test_train_parallel.py's bound between a
    sharded and a one-device eval), the same on every rank."""
    want = torch_ranks.eval_step(
        step_config(mt.ModelConfiguration()).to_dict(), batch,
        variables=jax_model[1])
    for group in (pair, quad):
        res = group['results']
        for r in res:
            got = r['eval']
            assert set(got) == set(want)
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)
            assert got == res[0]['eval']


# ---- every body, and the rows each rank touches ----

@pytest.mark.parametrize('name', PORTED_BACKBONES)
def test_backbone_body_sharded_float64(pair, name):
    """Each body of the registry (with the P6 / P7 extras, 16 wide) in
    float64 train mode over a 1 x 2 mesh at an uneven height (a 1-row P7:
    one rank's block empty) against one process: every endpoint's rows
    put together within 1e-9 of its largest value, the BatchNorm
    statistics within 1e-9 of each tensor's largest plus 1e-9 of the
    largest statistic, equal on both ranks."""
    res = pair['results']
    job = f'body_{name}'
    want = torch_ranks.spatial_backbone(name, body_frames(name))
    wstats = want.pop('batch_stats')
    assert want['P7'].shape[2] == 1
    for k, w in want.items():
        got = rows_of(res, job, k, 2)
        assert got.shape == w.shape, k
        assert np.abs(got - w).max() <= 1e-9 * np.abs(w).max(), k
    stats = max((np.abs(v).max() for v in wstats.values()), default=0.0)
    close_at_scale(res[0][job]['batch_stats'], wstats, 1e-9, 'batch_stats',
                   floor=1e-9 * stats)
    assert_ranks_equal(res, job, ('batch_stats',))


@pytest.mark.parametrize('case', ROWS_CASES)
def test_no_rank_sees_more_than_its_rows(pair, case):
    """Under a hook on ``F.conv2d`` and ``F.max_pool2d``, one ``raw_heads``
    on each rank of a 1 x 2 mesh makes the same calls as one process
    (kernel, dilation, stride), and no input on a rank holds more rows
    than the largest block of the one-process input, ceil(rows / 2), plus
    the halo a k x k kernel of dilation d and stride s reads, (k - 1) d +
    s (a conv's window, its zero rows at the frame's edges included; the
    ASPP's dilated convs read their window, not the map). The GroupNorm
    maps K1 takes whole are gathered without a conv."""
    make, hw = ROWS_CASES[case]
    want = torch_ranks.spatial_rows_seen(make().to_dict(), frames(1, hw))
    for r in pair['results']:
        got = r[f'rows_{case}']
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert (g[0],) + tuple(g[2:]) == (w[0],) + tuple(w[2:]), i
            op, rows, k, d, s = w
            bound = math.ceil(rows / 2) + (k - 1) * d + s
            assert g[1] <= bound, (i, g, w, bound)


# ---- on the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


@pytest.mark.gpu
def test_row_exchange_and_gathered_k1_on_cuda(cuda):
    """Two gloo ranks sharing the card: the row exchange (halos of 1 and 3
    rows) and the row gather of CUDA tensors, staged through the host,
    equal the same collectives on the CPU forward and backward (exact:
    float64 copies); a ragged GroupNorm map (11 x 7 pixels, 16 groups)
    sharded over the pair goes whole to K1 (launched forward and backward
    on each rank) and each rank's rows lie within K1's f32 tolerance, 2e-5,
    of the plain version on the whole map."""
    res = torch_ranks.SpawnedRanks([('x', 'cuda_exchanges', {})], world=2,
                                   device='cuda').results()
    for r in res:
        got = r['x']
        for name in ('exchange_1', 'exchange_3', 'gather'):
            assert got[name] == 0.0, name
        assert got['k1_gathered'] <= 2e-5
        assert got['launches']['band_groupnorm'] == 1
        assert got['launches']['band_groupnorm_backward'] == 1
