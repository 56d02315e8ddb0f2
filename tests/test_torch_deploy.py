"""The port's deployment loop on the CPU: checkpoint hot-reload
(``CheckpointWatcher``), the HTTP server's ``/healthz`` and ``/reload``,
and the CLI's ``export``, ``serve`` and ``process``, against the JAX
package where it defines the result (the exported JSON, the processed
folder).

Models are tiny (mobilenet, widths 16, depth 1, 96x128 frames); the CLI's
own default, resnet50, is built where ``train`` is called without a preset.
Tolerances: a swapped-in model's outputs equal those of a predictor built
directly on its checkpoint (exact: the same CPU arithmetic); the processed
folder against the JAX package's ``process_folder`` as
``tests/test_torch_serving.py`` holds the predictors (classes and the flag
exact, boxes and confidences within 1, mask-derived columns rtol 1e-3,
at most 1e-3 of a frame's pixels changed).
"""
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from masklab_tpu import ModelConfiguration as JaxConfig
from masklab_tpu import cli as jcli
from masklab_tpu.models import build_masklab as jax_build
from masklab_tpu.serving.predictor import MaskLabPredictor as JaxPredictor
from masklab_tpu.serving.server import process_folder as jax_process_folder
import masklab_tpu_torch as mt
from masklab_tpu_torch import cli as tcli
from masklab_tpu_torch import load_flax_variables
from masklab_tpu_torch.serving import MaskLabServer
from masklab_tpu_torch.serving.batching import CheckpointWatcher
from masklab_tpu_torch.train import TrainState, rectified_adam
from masklab_tpu_torch.train import trainer as ttrainer
from masklab_tpu_torch.train.checkpoints import CheckpointManager

LABELS = ('car', 'bump', 'manhole', 'steel', 'pothole')
RESOLUTION = ('-postprocess.resolution', '96', '128')


@pytest.fixture(scope='module', autouse=True)
def torch_threads():
    """Two intra-op threads for this file's torch work, as
    tests/test_torch_train.py does: the tier-1 run puts it beside JAX tests
    whose 8-device CPU collectives abort when their threads are starved."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def tiny(cfg):
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
    cfg.loss.nms_max_output_size = 4
    cfg.compute.nms_candidates_per_class = 8
    cfg.postprocess.resolution = (96, 128)
    return cfg


def save_checkpoint(save_dir, cfg, seed, loss, epoch=0):
    """A checkpoint of the tiny model with seeded, forced-dense weights;
    returns its path."""
    model = mt.force_dense(mt.build_masklab(cfg, device='cpu', seed=seed))
    state = TrainState(model, rectified_adam(1e-3))
    return CheckpointManager(save_dir, cfg).save_epoch(state, loss, epoch)


def frames(n=2, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, 96, 128, 3)
                                               ).astype(np.uint8)


def predictor_on(cfg, path):
    """A predictor built directly on one checkpoint."""
    model = mt.MaskLab(cfg)
    from masklab_tpu_torch.train.checkpoints import load_variables
    load_variables(model, CheckpointManager(
        os.path.dirname(path), None).restore_variables(path))
    return mt.MaskLabPredictor(model, cfg, visualization=True, device='cpu')


def assert_same_outputs(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---- CheckpointWatcher ----

class _FakePredictor:
    """Builds a 'model' that is just the restored value."""

    def __init__(self):
        self.model = -1.0

    def place_variables(self, variables):
        return variables['params']


def _loss_of(path):
    return {'params': float(os.path.basename(path).split('-')[0])}


def test_checkpoint_watcher_swaps_best(tmp_path):
    pred = _FakePredictor()
    w = CheckpointWatcher(pred, str(tmp_path), restore=_loss_of)
    assert not w.check_once()                      # empty dir
    os.makedirs(tmp_path / '1.50000-00')
    assert w.check_once()
    assert pred.model == 1.5
    assert not w.check_once()                      # unchanged
    os.makedirs(tmp_path / '0.70000-01')           # a better loss appears
    assert w.check_once()
    assert pred.model == pytest.approx(0.7)
    assert w.current.endswith('0.70000-01')
    os.makedirs(tmp_path / '2.00000-02')           # a worse one does not
    assert not w.check_once()
    assert pred.model == pytest.approx(0.7)
    assert not CheckpointWatcher(pred, str(tmp_path / 'absent'),
                                 restore=_loss_of).check_once()


def test_checkpoint_watcher_skips_saves_in_progress(tmp_path):
    """A save is written under a ``tmp`` name and renamed into place: the
    watcher never restores a name still being written, however good its
    loss."""
    pred = _FakePredictor()
    restored = []

    def restore(path):
        restored.append(os.path.basename(path))
        return _loss_of(path)
    w = CheckpointWatcher(pred, str(tmp_path), restore=restore)
    os.makedirs(tmp_path / '0.10000-03.tmp-abc123')
    assert not w.check_once()
    os.makedirs(tmp_path / '1.00000-00')
    assert w.check_once()
    assert restored == ['1.00000-00'] and pred.model == 1.0


def test_checkpoint_watcher_keeps_the_old_version_when_a_restore_fails(
        tmp_path):
    """A restore that raises leaves the served model and version alone:
    ``check_once`` raises, the poll thread swallows it and swaps to the
    next good checkpoint later."""
    pred = _FakePredictor()

    def restore(path):
        if '0.50000' in path:
            raise OSError('truncated checkpoint')
        return _loss_of(path)
    w = CheckpointWatcher(pred, str(tmp_path), poll_s=0.05, restore=restore)
    os.makedirs(tmp_path / '0.90000-00')
    assert w.check_once()
    os.makedirs(tmp_path / '0.50000-01')
    with pytest.raises(OSError):
        w.check_once()
    assert pred.model == pytest.approx(0.9)
    assert w.current.endswith('0.90000-00')
    w.start()
    try:
        time.sleep(0.3)                   # several failing polls
        assert pred.model == pytest.approx(0.9)
        os.makedirs(tmp_path / '0.30000-02')
        deadline = time.time() + 5.0
        while time.time() < deadline and pred.model != pytest.approx(0.3):
            time.sleep(0.05)
        assert pred.model == pytest.approx(0.3)
    finally:
        w.stop()


def test_checkpoint_watcher_thread_polls(tmp_path):
    pred = _FakePredictor()
    w = CheckpointWatcher(pred, str(tmp_path), poll_s=0.05,
                          restore=_loss_of)
    w.start()
    try:
        os.makedirs(tmp_path / '0.90000-00')
        deadline = time.time() + 5.0
        while time.time() < deadline:
            if pred.model == pytest.approx(0.9):
                break
            time.sleep(0.05)
        assert pred.model == pytest.approx(0.9)
    finally:
        w.stop()


def test_checkpoint_watcher_needs_a_predictor_that_builds_models(tmp_path):
    class NoPlace:
        model = None
    with pytest.raises(TypeError, match='place_variables'):
        CheckpointWatcher(NoPlace(), str(tmp_path))


def test_watcher_swaps_real_checkpoints(tmp_path):
    """Torch checkpoints A then B (a better loss): each swap serves exactly
    what a predictor built directly on that checkpoint serves; the swapped
    out model object is left as it was (a request in flight on it finishes
    on A's weights)."""
    cfg = tiny(mt.ModelConfiguration())
    run = str(tmp_path / 'run')
    a = save_checkpoint(run, cfg, seed=1, loss=0.5)
    pred = tcli._build_predictor(cfg, run, device='cpu')
    images = frames()
    w = CheckpointWatcher(pred, run)
    assert w.check_once() and w.current == a
    on_a = predictor_on(cfg, a).predict(images, 'summarize')
    assert_same_outputs(pred.predict(images, 'summarize'), on_a)
    old = pred.model
    old_params = {k: v.clone() for k, v in old.state_dict().items()}
    b = save_checkpoint(run, cfg, seed=2, loss=0.4, epoch=1)
    assert w.check_once() and w.current == b
    assert pred.model is not old
    got = pred.predict(images, 'summarize')
    assert_same_outputs(got, predictor_on(cfg, b).predict(images,
                                                          'summarize'))
    assert not np.array_equal(got['summarize'], on_a['summarize'])
    for k, v in old.state_dict().items():
        assert torch.equal(v, old_params[k]), k


# ---- the server's hot-reload surface ----

def _get(port, path):
    with urllib.request.urlopen(f'http://localhost:{port}{path}',
                                timeout=30) as r:
        return json.loads(r.read())


def _post(port, path, body=b''):
    req = urllib.request.Request(f'http://localhost:{port}{path}',
                                 data=body, method='POST')
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_server_healthz_and_reload(tmp_path):
    """With a watched directory: /healthz names the served checkpoint
    (null before the first swap), POST /reload polls it now and answers
    {"reloaded", "model_version"}. Without one: /reload is a 400 with
    {"error": "no watch dir configured"} and /healthz has no version."""
    cfg = tiny(mt.ModelConfiguration())
    run = str(tmp_path / 'run')
    a = save_checkpoint(run, cfg, seed=1, loss=0.5)
    pred = tcli._build_predictor(cfg, run, device='cpu')
    server = MaskLabServer(pred, port=0, instance_labels=LABELS,
                           watch_dir=run, watch_poll_s=3600.0)
    server.start()
    try:
        assert _get(server.port, '/healthz') == {'status': 'ok',
                                                 'model_version': None}
        assert _post(server.port, '/reload') == (
            200, {'reloaded': True, 'model_version': a})
        assert _post(server.port, '/reload') == (
            200, {'reloaded': False, 'model_version': a})
        b = save_checkpoint(run, cfg, seed=2, loss=0.4, epoch=1)
        assert _post(server.port, '/reload') == (
            200, {'reloaded': True, 'model_version': b})
        assert _get(server.port, '/healthz')['model_version'] == b
    finally:
        server.stop()
    plain = MaskLabServer(pred, port=0, max_batch=1)
    plain.start()
    try:
        assert _get(plain.port, '/healthz') == {'status': 'ok'}
        with pytest.raises(urllib.error.HTTPError) as info:
            _post(plain.port, '/reload')
        assert info.value.code == 400
        assert json.loads(info.value.read()) == {
            'error': 'no watch dir configured'}
    finally:
        plain.stop()


# ---- export ----

EXPORT_FLAGS = ['-postprocess.instance_alpha', '0.5',
                '-postprocess.smoothing_kernel_sizes', '5', '5', '0']


def test_export_serving_config_matches_reference(tmp_path):
    """``export <save_dir> [flags]``: the saved config with the flags
    applied (flags not given keep the saved values), the same JSON as the
    JAX package writes from the same config.json and flags."""
    cfg = tiny(mt.ModelConfiguration())
    cfg.postprocess.semantic_alpha = 0.6           # a saved, tuned value
    dirs = {}
    for name, main in (('torch', tcli.main), ('jax', jcli.main)):
        d = tmp_path / name
        d.mkdir()
        cfg.save_json(str(d / 'config.json'))
        main(['export', str(d), *EXPORT_FLAGS])
        with open(d / 'serving_config.json') as f:
            dirs[name] = json.load(f)
    assert dirs['torch'] == dirs['jax']
    assert dirs['torch']['postprocess']['instance_alpha'] == 0.5
    assert dirs['torch']['postprocess']['semantic_alpha'] == 0.6
    assert dirs['torch']['postprocess']['smoothing_kernel_sizes'] == [5, 5,
                                                                      0]
    assert dirs['torch']['backbone']['backbone_type'] == 'mobilenet'
    with pytest.raises(SystemExit, match='usage'):
        tcli.main(['export'])


def test_export_bundle_versions_and_serves(tmp_path, capsys):
    """``export --dest``: versioned bundles 1, 2, ... each with the best
    checkpoint, config.json and serving_config.json; the bundle serves by
    path alone, the exported postprocess winning. ``--h5`` warns as the
    reference does where its h5 export fails, and the bundle stands."""
    cfg = tiny(mt.ModelConfiguration())
    run = str(tmp_path / 'run')
    save_checkpoint(run, cfg, seed=1, loss=0.7)
    best = save_checkpoint(run, cfg, seed=2, loss=0.5, epoch=1)
    dest = str(tmp_path / 'bundles')
    tcli.main(['export', run, f'--dest={dest}',
               '-postprocess.instance_alpha', '0.7'])
    tcli.main(['export', run, f'--dest={dest}'])
    capsys.readouterr()
    tcli.main(['export', run, f'--dest={dest}', '--h5'])
    err = capsys.readouterr().err
    assert err.startswith('WARNING: --h5 export skipped (')
    assert sorted(os.listdir(dest)) == ['1', '2', '3']
    bundle = os.path.join(dest, '1')
    assert sorted(os.listdir(bundle)) == sorted(
        ['0.50000-01', 'config.json', 'serving_config.json'])
    pred = tcli._build_predictor(mt.ModelConfiguration(), bundle,
                                 device='cpu')
    assert pred.config.postprocess.instance_alpha == 0.7
    assert pred.config.backbone.backbone_type == 'mobilenet'
    images = frames()
    assert_same_outputs(pred.predict(images, 'summarize'),
                        predictor_on(cfg, best).predict(images,
                                                        'summarize'))
    for v in ('2', '3'):
        with open(os.path.join(dest, v, 'serving_config.json')) as f:
            assert json.load(f)['postprocess']['instance_alpha'] == \
                cfg.postprocess.instance_alpha
    with pytest.raises(SystemExit, match='no checkpoints'):
        tcli.main(['export', str(tmp_path / 'empty'), f'--dest={dest}'])


# ---- _build_predictor ----

def test_build_predictor_precedence(tmp_path, capsys, monkeypatch):
    """serving_config.json wins over config.json and the command line;
    without it, config.json keeps the command line's postprocess; without
    a checkpoint directory, smoke mode: a warning and init_weights(seed=0).
    --mesh-data above the cards present warns and serves on one; with as
    many cards as asked for (more than one) the predictor serves over a
    mesh of them, one replica of the checkpoint a card."""
    cfg = tiny(mt.ModelConfiguration())
    run = str(tmp_path / 'run')
    save_checkpoint(run, cfg, seed=1, loss=0.5)
    cli_cfg = mt.ModelConfiguration()
    cli_cfg.postprocess.instance_alpha = 0.9
    pred = tcli._build_predictor(cli_cfg, run, device='cpu')
    assert pred.config.backbone.backbone_type == 'mobilenet'
    assert pred.config.postprocess.instance_alpha == 0.9
    exported = tiny(mt.ModelConfiguration())
    exported.postprocess.instance_alpha = 0.2
    exported.save_json(os.path.join(run, 'serving_config.json'))
    pred = tcli._build_predictor(cli_cfg, run, device='cpu')
    assert pred.config.postprocess.instance_alpha == 0.2

    capsys.readouterr()
    smoke = tcli._build_predictor(cfg, str(tmp_path / 'absent'), mesh_data=2,
                                  device='cpu')
    out = capsys.readouterr().out
    assert 'WARNING: --mesh-data=2 but only 1 device(s)' in out
    assert 'WARNING: no checkpoint dir' in out
    seeded = mt.build_masklab(cfg, device='cpu', seed=0)
    for (k, v), w in zip(smoke.model.state_dict().items(),
                         seeded.state_dict().values()):
        assert torch.equal(v, w), k

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
    from masklab_tpu_torch import parallel
    from masklab_tpu_torch.train.checkpoints import load_variables
    make_mesh, asked = parallel.make_mesh, []

    def cpu_mesh(data=None, **_):
        # the two "cards" as CPU devices: this host has none
        asked.append(data)
        return make_mesh(data, devices=['cpu'] * data)
    monkeypatch.setattr(parallel, 'make_mesh', cpu_mesh)
    meshed = tcli._build_predictor(cfg, run, mesh_data=2, device='cuda')
    assert asked == [2] and meshed.mesh.size == 2
    assert len(meshed.model) == 2
    want = load_variables(mt.MaskLab(cfg), CheckpointManager(
        run, None).restore_variables()).state_dict()
    for replica in meshed.model:
        for (k, v), w in zip(replica.state_dict().items(), want.values()):
            assert torch.equal(v, w), k


# ---- serve and process: arguments ----

def test_serve_arguments(tmp_path, monkeypatch, capsys):
    """--port (0: a free one), --max-batch, --no-watch, --warmup and
    --warmup-sizes=HxW,... (every client size x batch bucket x mode),
    --device, then -group.attr overrides; the watcher is on for an
    existing -train.save_dir unless --no-watch."""
    cfg = tiny(mt.ModelConfiguration())
    run = str(tmp_path / 'run')
    save_checkpoint(run, cfg, seed=1, loss=0.5)
    warmed = []
    monkeypatch.setattr(mt.MaskLabPredictor, 'warmup',
                        lambda self, sizes: warmed.extend(sizes))
    server = tcli.build_server(['--port=0', '--max-batch=4',
                                '--warmup-sizes=64x80,48x64',
                                '-train.save_dir', run, '--device=cpu'])
    try:
        assert server.port != 0
        assert server.batcher.max_batch == 4
        assert server.watcher is not None and server.watcher.save_dir == run
        assert warmed == [(h, w, b, m) for h, w in ((64, 80), (48, 64))
                          for b in (1, 2, 4)
                          for m in ('visualize', 'summarize')]
        assert f'serving on :{server.port}' in capsys.readouterr().out
    finally:
        server.stop()
    warmed.clear()
    server = tcli.build_server(['--port=0', '--max-batch=1', '--no-watch',
                                '--warmup', '-train.save_dir', run,
                                *RESOLUTION, '--device=cpu'])
    try:
        assert server.batcher is None and server.watcher is None
        assert warmed == [(96, 128, 1, 'visualize'),
                          (96, 128, 1, 'summarize')]
    finally:
        server.stop()


def test_process_arguments(tmp_path):
    with pytest.raises(SystemExit, match='usage: process'):
        tcli.main(['process', str(tmp_path)])
    with pytest.raises(SystemExit):           # argparse: unknown flag
        tcli.main(['process', str(tmp_path), str(tmp_path / 'out'),
                   '--bogus', '--device=cpu'])


def test_process_matches_reference(tmp_path):
    """``process <src> <dst> --batch=2`` over a 4-image folder from a
    checkpoint of the same weights the JAX package's process_folder runs
    with (forced dense): the same files, the records and the annotated
    frames within the predictors' tolerances. As in the reference, only
    the arguments that start with '-' reach the config, so values go in
    the ``-group.attr=value`` form."""
    import cv2
    jcfg, tcfg = tiny(JaxConfig()), tiny(mt.ModelConfiguration())
    jmodel = jax_build(jcfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 96, 128, 3)))

    def dense(path, x):
        keys = jax.tree_util.keystr(path)
        if 'cls_subnet' in keys and 'output_' in keys and 'bias' in keys:
            return x * 0.0 + 2.0
        return x
    variables = jax.tree_util.tree_map_with_path(dense, variables)
    model = mt.MaskLab(tcfg)
    load_flax_variables(model, jax.tree_util.tree_map(np.asarray,
                                                      variables))
    run = str(tmp_path / 'run')
    CheckpointManager(run, tcfg).save_epoch(
        TrainState(model, rectified_adam(1e-3)), 0.5, 0)
    src = tmp_path / 'src'
    src.mkdir()
    for i, image in enumerate(frames(4, seed=3)):
        cv2.imwrite(str(src / f'frame_{i}.jpg'), image[..., ::-1])
    got_dir, want_dir = tmp_path / 'torch', tmp_path / 'jax'
    tcli.main(['export', run])            # the saved postprocess (96x128)
    tcli.main(['process', str(src), str(got_dir), '--batch=2',
               f'-train.save_dir={run}', '--device=cpu'])
    jax_process_folder(JaxPredictor(jmodel, variables, jcfg,
                                    visualization=True),
                       str(src), str(want_dir), LABELS, batch_size=2)
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir))
    with open(got_dir / 'results.json') as f:
        got = json.load(f)
    with open(want_dir / 'results.json') as f:
        want = json.load(f)
    assert sorted(got) == sorted(want) and len(got) == 4
    for name in want:
        g, w = got[name]['objs'], want[name]['objs']
        assert len(g) == len(w) and len(w) > 0
        for a, b in zip(g, w):
            assert (a['name'], a['includeMyRoad']) == (b['name'],
                                                       b['includeMyRoad'])
            for k in ('x', 'y', 'w', 'h', 'confidence'):
                assert abs(a[k] - b[k]) <= 1, (name, k)
            for k in ('pixelSize', 'estimatedSize',
                      'estimatedHorizontalLength',
                      'estimatedVerticalLength'):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-3, atol=0.5)
        mine = cv2.imread(str(got_dir / name))
        theirs = cv2.imread(str(want_dir / name))
        assert mine.shape == theirs.shape == (96, 128, 3)
        assert (mine != theirs).any(-1).mean() <= 1e-3, name


# ---- train: the CLI's default model ----

def test_cli_train_without_a_preset_builds_resnet50(tmp_path, monkeypatch):
    """``train`` with no preset takes ``ModelConfiguration()``'s resnet50
    (here with narrow heads): the trainer builds it, where the port raised
    before it had the backbone."""
    built = {}

    def train_model(cfg, device=None):
        built['trainer'] = ttrainer.MaskLabTrainer(cfg, device=device)
        return built['trainer']
    monkeypatch.setattr(ttrainer, 'train_masklab_model', train_model)
    monkeypatch.setattr(tcli, 'cmd_eval',
                        lambda args, save_dir=None: built.setdefault(
                            'eval', save_dir))
    tcli.main(['train', '-detection.num_features', '16',
               '-detection.num_depth', '1', '-instance.num_features', '16',
               '-instance.num_depth', '1', '-semantic.num_features', '16',
               '-semantic.num_aspp_features', '16', '-semantic.num_depth',
               '1', '-train.save_dir', str(tmp_path), '--device=cpu'])
    model = built['trainer'].model
    assert model.config.backbone.backbone_type == 'resnet50'
    body = model.backbone.ResNet_0
    assert body.stem.bias is not None                  # biased v1 convs
    assert body.stage3.BottleneckBlock_0.Conv_0.stride == (2, 2)
    assert built['eval'].startswith(str(tmp_path))
