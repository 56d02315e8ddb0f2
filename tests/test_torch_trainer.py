"""The port's trainer, checkpoints, eval and CLI against the JAX package's.

Both trainers run ``train_masklab_model`` on one processed dataset (10
synthetic 128x160 frames: 9 train, 1 valid) with the same configuration
(tests/test_e2e_train.py's: mobilenet, widths 16, depth 1, batch 2, the
0.5 bucket, one step an epoch; head 5 epochs, so that the 4-batch train set
runs out and the prefetcher rotates, then all 1) on the CPU, the port from
the JAX trainer's initial variables through the weight bridge. Each check
states its tolerance and why.
"""
import csv
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from masklab_tpu import ModelConfiguration as JaxConfig
from masklab_tpu import cli as jcli
from masklab_tpu.eval import evaluate_dataset as jax_evaluate
from masklab_tpu.models import build_masklab as jax_build
from masklab_tpu.serving import MaskLabPredictor as JaxPredictor
from masklab_tpu.train import checkpoints as jckpt
from masklab_tpu.train import trainer as jtrainer
import masklab_tpu_torch as mt
from masklab_tpu_torch import cli as tcli
from masklab_tpu_torch import train as ttrain
from masklab_tpu_torch.data import (MaskLabDataset, MaskLabGenerator,
                                    make_synthetic_dataset, process_dataset)
from masklab_tpu_torch.eval import evaluate_dataset
from masklab_tpu_torch.train import checkpoints as tckpt
from masklab_tpu_torch.train import trainer as ttrainer

FRAMES = 10
# later epoch means, the val_* columns and the checkpoints' losses within
# this share of each value: the two float32 trainers drift apart step by
# step (measured on this run: at most 3.3e-5, the seg_loss of the third
# epoch; ROADMAP.md, Queue 3)
LATER_RTOL = 1e-4


@pytest.fixture(scope='module', autouse=True)
def torch_threads():
    """Two intra-op threads, as tests/test_torch_train.py holds them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def small(cfg, data_dir, save_dir):
    """tests/test_e2e_train.py's configuration, 3-phase schedule below."""
    cfg.backbone.backbone_type = 'mobilenet'
    cfg.backbone.num_features = 16
    cfg.backbone.backbone_outputs = ('C3', 'C4', 'C5')
    cfg.detection.feature_pyramid_inputs = ('C3', 'C4', 'C5')
    for g in (cfg.detection, cfg.instance, cfg.semantic):
        g.num_features = 16
        g.num_depth = 1
    cfg.instance.crop_size = (7, 7)
    cfg.semantic.num_aspp_features = 16
    cfg.detection.nms_max_output_size = 4
    cfg.loss.nms_max_output_size = 4
    cfg.compute.nms_candidates_per_class = 8
    cfg.compute.scale_buckets = (0.5,)
    cfg.train.scale_ratio = (0.5, 0.5)
    cfg.train.batch_size = 2
    cfg.train.train_head_tune_epoch = 5
    cfg.train.train_waist_tune = False
    cfg.train.train_waist_tune_epoch = 0
    cfg.train.train_all_epoch = 1
    cfg.dataset.data_dir = data_dir
    cfg.dataset.min_area = 50.0
    cfg.train.save_dir = save_dir
    cfg.postprocess.resolution = (128, 160)
    return cfg


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def jax_init(cfg, images):
    """The JAX trainer's initial variables (``MaskLabTrainer.init_state``)
    for a configuration given as the port's."""
    jmodel = jax_build(JaxConfig().from_dict(cfg.to_dict()))
    return numpy_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                           jnp.asarray(images[:1])))


def record_losses(monkeypatch, module, losses):
    """Wrap ``module.make_train_step``: each step's loss into ``losses``."""
    orig = module.make_train_step

    def make(model, *args, **kwargs):
        step = orig(model, *args, **kwargs)

        def run(state, batch):
            state, metrics = step(state, batch)
            losses.append(float(metrics['loss']))
            return state, metrics
        return run
    monkeypatch.setattr(module, 'make_train_step', make)


@pytest.fixture(scope='module')
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('trainer_data'))
    make_synthetic_dataset(d, num_images=FRAMES, image_hw=(128, 160), seed=1)
    process_dataset(d, num_workers=1)
    return d


@pytest.fixture(scope='module')
def runs(data_dir, tmp_path_factory):
    """Both trainers, one after the other in the same save_dir (each then
    moved aside), so that their config.json name the same paths."""
    root = str(tmp_path_factory.mktemp('trainer_runs'))
    run = os.path.join(root, 'run')
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        jlosses, tlosses = [], []
        record_losses(mp, jtrainer, jlosses)
        record_losses(mp, ttrainer, tlosses)
        init = ttrainer.MaskLabTrainer.init_state

        def init_from_jax(self, sample_batch):
            init(self, sample_batch)
            out['init'] = jax_init(self.config, sample_batch['images'])
            mt.load_flax_variables(self.model, out['init'])
        mp.setattr(ttrainer.MaskLabTrainer, 'init_state', init_from_jax)
        jtrainer.train_masklab_model(small(JaxConfig(), data_dir, run),
                                     max_gt_boxes=6, steps_per_epoch=1)
        shutil.move(run, os.path.join(root, 'jax'))
        trainer = ttrainer.train_masklab_model(
            small(mt.ModelConfiguration(), data_dir, run), max_gt_boxes=6,
            steps_per_epoch=1, device='cpu')
        shutil.move(run, os.path.join(root, 'port'))
    out.update(jax=os.path.join(root, 'jax'), port=os.path.join(root, 'port'),
               jax_losses=jlosses, port_losses=tlosses, trainer=trainer)
    return out


def read_metrics(d):
    with open(os.path.join(d, 'metrics.csv')) as f:
        return list(csv.DictReader(f))


def checkpoint_names(d):
    return sorted(n for n in os.listdir(d)
                  if os.path.isdir(os.path.join(d, n)) and '-' in n)


def test_smoke_and_first_step_losses(runs):
    """The smoke check's loss and the head phase's first step within 1e-5
    relative (test_torch_train.py::test_train_step_loss_terms's), and each
    run took the smoke step and 6 phase steps."""
    j, t = runs['jax_losses'], runs['port_losses']
    assert len(j) == len(t) == 7
    np.testing.assert_allclose(t[:2], j[:2], rtol=1e-5)


def test_metrics_csv(runs):
    """Same columns and rows (one an epoch: 5 head + 1 all); the lr column
    within 1e-7 relative (both float32 cyclic_lr); the first row's epoch
    means within 1e-5 as the step; later rows and every val_* column
    within LATER_RTOL."""
    want, got = read_metrics(runs['jax']), read_metrics(runs['port'])
    assert list(got[0]) == list(want[0])
    assert len(got) == len(want) == 6
    for i, (g, w) in enumerate(zip(got, want)):
        for k in w:
            gv, wv = float(g[k]), float(w[k])
            assert np.isfinite(gv), (i, k)
            if k == 'step':
                assert gv == wv
            elif k == 'lr':
                np.testing.assert_allclose(gv, wv, rtol=1e-7)
            else:
                rtol = 1e-5 if i == 0 and not k.startswith('val_') \
                    else LATER_RTOL
                np.testing.assert_allclose(gv, wv, rtol=rtol, atol=1e-6,
                                           err_msg=f'row {i} {k}')


def test_history_config_and_checkpoint_names(runs):
    """history.json has the same keys (its values are the metrics' losses);
    config.json is byte for byte the reference's; the checkpoints carry
    the same epoch suffixes and losses within LATER_RTOL."""
    with open(os.path.join(runs['jax'], 'history.json')) as f:
        want = json.load(f)
    with open(os.path.join(runs['port'], 'history.json')) as f:
        got = json.load(f)
    assert sorted(got) == sorted(want) == ['all_loss', 'head_loss']
    with open(os.path.join(runs['jax'], 'config.json'), 'rb') as f:
        want_cfg = f.read()
    with open(os.path.join(runs['port'], 'config.json'), 'rb') as f:
        assert f.read() == want_cfg

    def parse(names):
        return sorted((n.rsplit('-', 1)[1], float(n.rsplit('-', 1)[0]))
                      for n in names)
    want, got = (parse(checkpoint_names(runs[k])) for k in ('jax', 'port'))
    assert [s for s, _ in got] == [s for s, _ in want]
    assert len(got) == 6
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=LATER_RTOL)


def test_checkpoint_round_trip(runs):
    """The trainer's last save restores every tensor exactly: variables by
    name, and a whole state (parameters, statistics, moments, box state,
    step) into a new model."""
    trainer = runs['trainer']
    manager = tckpt.CheckpointManager(runs['port'])
    state = trainer.state
    last = float(read_metrics(runs['port'])[-1]['val_loss'])
    path = os.path.join(runs['port'], f'{last:.5f}-00')
    variables = manager.restore_variables(path)
    for k, v in state.params.items():
        assert torch.equal(variables['params'][k], v), k
    for k, v in state.batch_stats.items():
        assert torch.equal(variables['batch_stats'][k], v), k
    model = mt.build_masklab(trainer.config, device='cpu', seed=3)
    restored = manager.restore_state(ttrain.TrainState(model, state.tx), path)
    assert restored.step == state.step == 1
    for a, b in ((restored.opt_state[0].mu, state.opt_state[0].mu),
                 (restored.opt_state[0].nu, state.opt_state[0].nu)):
        assert sorted(a) == sorted(b)
        assert all(torch.equal(a[k], b[k]) for k in b)
    assert all(torch.equal(a, b) for a, b in zip(restored.box_loss_state,
                                                 state.box_loss_state))
    for k, v in state.params.items():
        assert torch.equal(restored.params[k], v), k


def _resume_setup(data_dir, save_dir):
    cfg = small(mt.ModelConfiguration(), data_dir, save_dir)
    trainer = ttrainer.MaskLabTrainer(cfg, max_gt_boxes=6, device='cpu')
    trainer.init_state(None)
    tx, _ = trainer._phase_tx(1e-4, 1e-3, 4, 'C5')
    trainer._rebuild_state_for_phase(tx)
    return trainer


def test_resume_is_bit_identical(data_dir, tmp_path):
    """A trainer restored from a checkpoint takes the next step exactly as
    the one that never stopped: parameters, statistics, moments and box
    state equal bit for bit."""
    gen = MaskLabGenerator(MaskLabDataset(data_dir=data_dir, min_area=50.0)
                           .get_config(), batch_size=2,
                           scale_buckets=(0.5,), scale_ratio=(0.5, 0.5))
    a = _resume_setup(data_dir, str(tmp_path / 'a'))
    batches = [a._prepare(gen[i]) for i in range(3)]
    step = ttrain.make_train_step(a.model)
    for b in batches[:2]:
        a.state, _ = step(a.state, b)
    path = a.ckpt.save_epoch(a.state, 1.5, 0)
    b_trainer = _resume_setup(data_dir, str(tmp_path / 'b'))
    b_trainer.ckpt.restore_state(b_trainer.state, path)
    a.state, _ = step(a.state, batches[2])
    b_trainer.state, _ = ttrain.make_train_step(b_trainer.model)(
        b_trainer.state, batches[2])
    sa, sb = a.state, b_trainer.state
    assert sa.step == sb.step == 3
    for k, v in sa.params.items():
        assert torch.equal(sb.params[k], v), k
    for k, v in sa.batch_stats.items():
        assert torch.equal(sb.batch_stats[k], v), k
    for k in sa.opt_state[0].mu:
        assert torch.equal(sa.opt_state[0].mu[k], sb.opt_state[0].mu[k])
        assert torch.equal(sa.opt_state[0].nu[k], sb.opt_state[0].nu[k])
    assert all(torch.equal(x, y) for x, y in zip(sa.box_loss_state,
                                                 sb.box_loss_state))


@pytest.mark.parametrize('names,tmp_files', [
    (['12.31442-00', '3.40781-03'], False),       # lexical vs parsed
    (['nan-01', '5.00000-00', '7.25000-02'], False),
    (['abc-00', '7.00000-01', 'nan-02'], False),  # unparseable, then nan
    (['1.00000-00.orbax-checkpoint-tmp-5', '0.50000-00.tmp-x1',
      '2.00000-01'], False),
    (['0.50000-00.tmp-x1'], False),                 # only a save in progress
    (['3.00000-00', '1.00000-01'], True)])           # files are not saves
def test_best_checkpoint_matches_reference(tmp_path, names, tmp_files):
    for n in names:
        os.makedirs(tmp_path / n)
    if tmp_files:
        (tmp_path / '0.10000-05').write_text('')
    want = jckpt.CheckpointManager(str(tmp_path)).best_checkpoint()
    got = tckpt.CheckpointManager(str(tmp_path)).best_checkpoint()
    assert got == want


@pytest.fixture(scope='module')
def bridged(runs, data_dir):
    """The JAX run's best checkpoint: its predictor, and the port's
    predictor on the same variables through the weight bridge."""
    cfg = small(JaxConfig(), data_dir, runs['jax'])
    variables = jckpt.CheckpointManager(runs['jax']).restore_variables()
    jpred = JaxPredictor(jax_build(cfg), variables, cfg)
    tcfg = small(mt.ModelConfiguration(), data_dir, runs['jax'])
    model = mt.MaskLab(tcfg)
    mt.load_flax_variables(model, numpy_tree(variables))
    return jpred, mt.MaskLabPredictor(model, tcfg, device='cpu'), tcfg


def test_jax_checkpoint_in_the_port_predictor(bridged, data_dir):
    """A JAX checkpoint's variables in the port's predictor: raw outputs
    within tests/test_torch_slice.py::test_predictor_raw_mode's
    tolerances (boxes within 1 px / 1 confidence point, classes exact,
    thresholded masks and semantics on at most 0.1% of pixels)."""
    jpred, tpred, _ = bridged
    frames = MaskLabDataset(data_dir=data_dir, min_area=50.0)[0:2]['images']
    want = jpred.predict(frames, mode='raw')
    got = tpred.predict(frames)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
    assert np.abs(got['det_boxes'].astype(np.int64)
                  - want['det_boxes']).max() <= 1
    np.testing.assert_array_equal(got['det_boxes'][..., 4],
                                  want['det_boxes'][..., 4])
    for k in ('instance_masks', 'semantic', 'padded_masks'):
        assert (got[k] != want[k]).mean() <= 1e-3, k


def test_evaluate_dataset_matches_reference(bridged, data_dir):
    """``evaluate_dataset`` over 4 frames on both predictors (bridged
    weights): every metric within 1e-6."""
    jpred, tpred, cfg = bridged
    labels = (cfg.dataset.instance_labels, cfg.dataset.semantic_labels)
    from masklab_tpu.data import MaskLabDataset as JaxDataset
    want = jax_evaluate(jpred, JaxDataset(data_dir=data_dir, min_area=50.0),
                        *labels, max_images=4)
    got = evaluate_dataset(tpred, MaskLabDataset(data_dir=data_dir,
                                                 min_area=50.0),
                           *labels, max_images=4)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)


def test_remat_backbone_changes_nothing():
    """``compute.remat_backbone`` recomputes the backbone in the backward
    pass: gradients equal bit for bit, and the BatchNorm statistics are
    updated once, as without it (the recomputation leaves them alone)."""
    grads, stats = [], []
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.rand(2, 64, 64, 3).astype(np.float32) * 255)
    for remat in (False, True):
        cfg = mt.ModelConfiguration()
        cfg.backbone.backbone_type = 'mobilenet'
        cfg.backbone.num_features = 16
        cfg.backbone.backbone_outputs = ('C3', 'C4', 'C5')
        for g in (cfg.detection, cfg.instance, cfg.semantic):
            g.num_features = 16
            g.num_depth = 1
        cfg.semantic.num_aspp_features = 16
        cfg.compute.remat_backbone = remat
        model = mt.build_masklab(cfg, device='cpu', seed=1).train()
        out = model.raw_heads(images)
        loss = (out['cls_pred'].square().sum() + out['loc_pred'].sum()
                + out['seg_pred'].square().sum())
        loss.backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
        stats.append({k: v.clone() for k, v in model.named_buffers()
                      if k.endswith(('running_mean', 'running_var'))})
    for k, g in grads[0].items():     # the mask head's stay None
        assert (g is None and grads[1][k] is None) or torch.equal(
            g, grads[1][k]), k
    assert all(g is not None for k, g in grads[1].items()
               if k.startswith('backbone.'))
    for k in stats[0]:
        assert torch.equal(stats[0][k], stats[1][k]), k
    fresh = mt.build_masklab(cfg, device='cpu', seed=1)
    moved = [k for k, v in fresh.named_buffers()
             if k in stats[1] and not torch.equal(v, stats[1][k])]
    assert moved


@pytest.mark.parametrize('args', [
    ['--preset=road'],
    ['--preset=road', '-detection.use_squeeze_excite', 'False'],
    ['-train.batch_size', '8', '-compute.scale_buckets', '0.4', '0.6'],
    ['--preset=default', '-backbone.backbone_type', 'resnet50']])
def test_load_config_matches_reference(args):
    """``_load_config``: the same configuration from the same arguments,
    a preset's value re-asserted back to the default included."""
    assert tcli._load_config(args).to_dict() == \
        jcli._load_config(args).to_dict()


def test_load_config_unknown_preset():
    for load in (tcli._load_config, jcli._load_config):
        with pytest.raises(SystemExit, match='unknown preset'):
            load(['--preset=nope'])


def test_cli_etl_train_eval(tmp_path):
    """``etl``, ``train`` (3 phases, then its own eval) and ``eval`` through
    ``cli.main`` on the CPU: checkpoints, metrics.csv, history.json,
    config.json and eval.json."""
    d, logs = str(tmp_path / 'data'), str(tmp_path / 'logs')
    make_synthetic_dataset(d, num_images=FRAMES, image_hw=(128, 160), seed=2)
    tcli.main(['etl', f'-dataset.data_dir={d}'])
    args = ['-backbone.backbone_type', 'mobilenet', '-backbone.num_features',
            '16', '-backbone.backbone_outputs', 'C3', 'C4', 'C5',
            '-detection.num_features', '16', '-detection.num_depth', '1',
            '-instance.num_features', '16', '-instance.num_depth', '1',
            '-instance.crop_size', '7', '7', '-semantic.num_features', '16',
            '-semantic.num_aspp_features', '16', '-semantic.num_depth', '1',
            '-compute.scale_buckets', '0.5', '-train.scale_ratio', '0.5',
            '0.5', '-train.batch_size', '2',
            '-train.train_head_tune_epoch', '1',
            '-train.train_waist_tune_epoch', '1', '-train.train_all_epoch',
            '1', '-train.head_step_size', '2', '-train.waist_step_size', '2',
            '-train.all_step_size', '2', '-dataset.data_dir', d,
            '-dataset.min_area', '50', '-postprocess.resolution', '128',
            '160', '--device=cpu']
    tcli.main(['train', *args, '-train.save_dir', logs])
    (run,) = os.listdir(logs)
    run = os.path.join(logs, run)
    for f in ('metrics.csv', 'history.json', 'config.json', 'eval.json'):
        assert os.path.isfile(os.path.join(run, f)), f
    assert len(checkpoint_names(run)) == 3
    assert len(read_metrics(run)) == 3
    os.remove(os.path.join(run, 'eval.json'))
    tcli.main(['eval', *args, '-train.save_dir', run])
    with open(os.path.join(run, 'eval.json')) as f:
        metrics = json.load(f)
    assert np.isfinite(metrics['semantic_miou'])
    assert np.isfinite(metrics['mask_miou'])


@pytest.mark.parametrize('command', ['serve', 'process', 'export'])
def test_unported_commands_exit(command, tmp_path):
    """serve, process and export are ported (tests/test_torch_deploy.py):
    each parses its arguments as the reference's does and exits non-zero
    on a flag it does not know, before it builds a model or binds a
    port."""
    args = {'serve': ['--port=0', '--bogus'],
            'process': [str(tmp_path), str(tmp_path / 'out'), '--bogus'],
            'export': [str(tmp_path), '--bogus']}[command]
    with pytest.raises(SystemExit) as exc:
        tcli.main([command, *args, '--device=cpu'])
    assert exc.value.code not in (0, None)
    with pytest.raises(SystemExit) as ref:
        jcli.main([command, *args])
    assert ref.value.code == exc.value.code


def test_trainer_and_cli_need_a_card_or_the_cpu(monkeypatch, data_dir,
                                                tmp_path):
    """Without a card and without a device, the trainer and the CLI raise;
    they never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfg = small(mt.ModelConfiguration(), data_dir, str(tmp_path / 'a'))
    with pytest.raises(RuntimeError, match='CUDA'):
        ttrainer.MaskLabTrainer(cfg)
    with pytest.raises(RuntimeError, match='CUDA'):
        ttrainer.train_masklab_model(cfg)
    for command in ('train', 'eval'):
        with pytest.raises(RuntimeError, match='CUDA'):
            tcli.main([command, '-dataset.data_dir', data_dir,
                       '-train.save_dir', str(tmp_path / 'b'),
                       '-backbone.backbone_type', 'mobilenet'])


@pytest.mark.parametrize('cards,mesh_data,want', [
    (1, 2, 1),          # the road preset's 2 on one card: clamped
    (1, 0, 1),
    (2, 2, 2),          # two cards asked for and present: two ranks
    (2, 0, 2),          # 0 asks for every card
    (2, 1, 1)])
def test_data_parallel_size(monkeypatch, cards, mesh_data, want):
    """``compute.mesh_data`` clamped to the cards present, as the reference
    clamps it to its devices (the trainer then runs one rank a card); one
    on the CPU."""
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: cards)
    cfg = mt.road_project_config()
    cfg.compute.mesh_data = mesh_data
    assert ttrainer.data_parallel_size(cfg, torch.device('cuda')) == want
    assert ttrainer.data_parallel_size(cfg, torch.device('cpu')) == 1
