"""The PyTorch port stands alone: no JAX, no masklab_tpu, no silent CPU."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import masklab_tpu_torch as mt
from masklab_tpu_torch.ops import cuda as kc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMPORT_LINE = re.compile(r'^\s*(?:import|from)\s+(\S+)')
FORBIDDEN = re.compile(r'^(?:jax|flax)\b|\bmasklab_tpu\b(?!_torch)')


def _port_sources():
    paths = [os.path.join(ROOT, 'chip_smoke.py')]
    for top in ('masklab_tpu_torch', os.path.join('examples', 'torch')):
        for base, _, files in os.walk(os.path.join(ROOT, top)):
            paths += [os.path.join(base, f) for f in files
                      if f.endswith('.py')]
    return sorted(paths)


def test_import_leaves_jax_unloaded():
    # a subprocess: this test process already imported jax (conftest)
    code = ("import masklab_tpu_torch, masklab_tpu_torch.serving, "
            "masklab_tpu_torch.presets, masklab_tpu_torch.train, "
            "masklab_tpu_torch.losses, masklab_tpu_torch.metrics, "
            "masklab_tpu_torch.data, sys; "
            "assert 'jax' not in sys.modules and 'flax' not in sys.modules, "
            "sorted(m for m in sys.modules if m.startswith(('jax', 'flax')))")
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True,
                   timeout=120)


# the training slice's modules; the data modules read and write the ETL's
# tables without pandas, which the chip machine is not known to have
TRAINING_MODULES = ['data.dataset', 'data.generator', 'data.imglab',
                    'data.process', 'data.synthetic', 'data.tables', 'native',
                    'train.trainer', 'train.checkpoints', 'utils.loggers',
                    'eval.miou', 'cli']
# the deployment slice's modules: the backbone zoo, hot-reload, the servers
DEPLOY_MODULES = ['nn.backbone.efficientnet', 'nn.backbone.mobilenetv2',
                  'nn.backbone.vgg', 'serving.batching', 'serving.server']
# the data-parallel slice's modules, and the dp x sp sharding's
PARALLEL_MODULES = ['parallel.mesh', 'parallel.multihost', 'nn.spatial']
# the fused head and the utilities; TensorFlow is imported only inside the
# reference's functions of keras_export / ref_shim
UTILITY_MODULES = ['models.fused_mask_head', 'utils.keras_import',
                   'utils.keras_export', 'utils.ref_shim', 'utils.profiling',
                   'utils.visualize']


@pytest.mark.parametrize('module', TRAINING_MODULES + DEPLOY_MODULES
                         + PARALLEL_MODULES + UTILITY_MODULES)
def test_training_module_imports_no_jax_reference_or_pandas(module):
    """Imported alone in a fresh interpreter: no jax, flax or masklab_tpu
    module is loaded, nor pandas by a data module, nor TensorFlow by a
    utility."""
    banned = "('jax', 'flax', 'masklab_tpu.')"
    if module.startswith('data.'):
        banned = "('jax', 'flax', 'masklab_tpu.', 'pandas')"
    elif module in UTILITY_MODULES:
        banned = "('jax', 'flax', 'masklab_tpu.', 'tensorflow', 'keras')"
    code = (f"import sys, masklab_tpu_torch.{module}; "
            f"bad = sorted(m for m in sys.modules if m.startswith({banned}) "
            "or m == 'masklab_tpu'); assert not bad, bad")
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True,
                   timeout=120)


def test_sources_import_nothing_of_jax_or_the_reference():
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            for n, line in enumerate(f, 1):
                m = IMPORT_LINE.match(line)
                if m and FORBIDDEN.search(m.group(1)):
                    offenders.append(f'{os.path.relpath(path, ROOT)}:{n}: '
                                     f'{line.strip()}')
    walked = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for module in ('train/steps.py', 'train/optimizers.py', 'train/state.py',
                   'losses.py', 'metrics.py', 'data/synthetic.py',
                   *(m.replace('.', '/') + '.py' for m in
                     TRAINING_MODULES + DEPLOY_MODULES + UTILITY_MODULES
                     if m != 'native'),
                   'native/__init__.py', 'nn/backbone/resnet.py'):
        assert os.path.join('masklab_tpu_torch', module) in walked, module
    assert os.path.join('examples', 'torch', '06_overfit_acceptance.py') \
        in walked
    assert not offenders, offenders


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


def test_build_masklab_raises_without_card(monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match='CUDA'):
        mt.build_masklab(mt.ModelConfiguration())
    with pytest.raises(RuntimeError, match='CUDA'):
        mt.build_masklab(mt.ModelConfiguration(), device='cuda')


def test_predictor_raises_without_card(monkeypatch):
    cfg = mt.ModelConfiguration()
    cfg.backbone.backbone_type = 'mobilenet'
    model = mt.build_masklab(cfg, device='cpu')
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match='CUDA'):
        mt.MaskLabPredictor(model)


def test_predictor_refuses_unported_modes():
    """Every output mode is served, and serving over several devices
    (``mesh=``) builds one replica of the model on each mesh device
    (tests/test_torch_parallel.py holds its answers)."""
    from masklab_tpu_torch.parallel import make_mesh
    cfg = mt.ModelConfiguration()
    cfg.backbone.backbone_type = 'mobilenet'
    model = mt.build_masklab(cfg, device='cpu')
    pred = mt.MaskLabPredictor(model, mesh=make_mesh(devices=['cpu', 'cpu']))
    assert isinstance(pred.model, tuple) and len(pred.model) == 2
    assert pred.model[0] is not pred.model[1]
    for replica in pred.model:
        for (k, v), w in zip(replica.state_dict().items(),
                             model.state_dict().values()):
            assert torch.equal(v, w), k


@pytest.mark.parametrize('group', ['detection', 'instance', 'semantic'])
def test_separable_heads_raise(group):
    """Separable heads are ported: they build wherever the reference's
    build, and raise only where the reference fails too. The road preset's
    segmentation head adds its 160-channel input (128 ASPP + 32 skip
    features) to its 128-channel output, which the reference's add rejects
    as the port's construction does."""
    cfg = mt.road_project_config()
    getattr(cfg, group).use_separable_conv = True
    if group == 'semantic':
        with pytest.raises(ValueError, match='widths must match'):
            mt.MaskLab(cfg)
        cfg.semantic.num_aspp_features = 96
    model = mt.MaskLab(cfg)
    head = {'detection': model.cls_subnet.block_0,
            'instance': model.mask_subnet.level_0.block,
            'semantic': model.seg_subnet.HeadBlock_0}[group]
    assert hasattr(head, 'MobileSeparableConv_0')


@pytest.mark.parametrize('preset', ['mobilenet', 'road'])
def test_fused_mask_head_condition(preset):
    """``compute.fused_mask_head`` builds ``FusedMaskSubNet`` where the
    reference does (the flag set, instance heads neither separable nor
    squeeze-excite). The road preset's squeeze-excite instance heads make
    the reference ignore the flag, so the port builds the per-level
    ``MaskSubNet`` there."""
    if preset == 'road':
        cfg = mt.road_project_config()
    else:
        cfg = mt.ModelConfiguration()
        cfg.backbone.backbone_type = 'mobilenet'
    cfg.compute.fused_mask_head = True
    want = 'MaskSubNet' if preset == 'road' else 'FusedMaskSubNet'
    assert type(mt.MaskLab(cfg).mask_subnet).__name__ == want


def test_server_refuses_watch_dir(tmp_path):
    """Checkpoint hot-reload swaps in a model the predictor builds
    (``place_variables``): a server asked to watch a directory for a
    predictor that cannot raises before it binds a port."""
    from masklab_tpu_torch.serving import MaskLabServer

    class NoPredictor:
        def predict(self, images, mode=None):
            raise AssertionError('not called')
    with pytest.raises(TypeError, match='place_variables'):
        MaskLabServer(NoPredictor(), port=0, watch_dir=str(tmp_path))


def test_unported_backbone_raises():
    """The registry is the reference's: a name it lacks raises (resnet101
    is defined there but not registered), the default resnet50 builds."""
    from masklab_tpu.nn.backbone import BACKBONE_REGISTRY
    from masklab_tpu_torch.nn.backbone import PORTED_BACKBONES
    assert set(PORTED_BACKBONES) == set(BACKBONE_REGISTRY)
    cfg = mt.ModelConfiguration()
    for name in ('resnet101', 'nope'):
        cfg.backbone.backbone_type = name
        with pytest.raises(NotImplementedError, match='must be one of'):
            mt.MaskLab(cfg)
    assert type(mt.MaskLab(mt.ModelConfiguration()).backbone.ResNet_0
                ).__name__ == 'ResNet'


@pytest.mark.parametrize('call', ['band_groupnorm', 'segment_topk',
                                  'segment_topk_rows', 'nms_keep_mask',
                                  'paste_reduce', 'batch_norm_act'])
def test_wrappers_refuse_other_devices(call):
    """A wrapper takes the plain version only for a CPU tensor; any other
    device launches the kernel or raises, never falls back."""
    meta = dict(device='meta')
    args = {
        'band_groupnorm': lambda: kc.band_groupnorm(
            torch.empty(2, 196, 32, **meta), torch.empty(32, **meta),
            torch.empty(32, **meta), 16),
        'segment_topk': lambda: kc.segment_topk(
            torch.empty(2, 128, 8, **meta), 16),
        'segment_topk_rows': lambda: kc.segment_topk_rows(
            torch.empty(2, 5, 1000, **meta).transpose(1, 2), 16),
        'nms_keep_mask': lambda: kc.nms_keep_mask(
            torch.empty(2, 8, 4, **meta),
            torch.empty(2, 8, dtype=torch.bool, **meta), 0.5, 4),
        'paste_reduce': lambda: kc.paste_reduce(
            *[torch.empty(2, 8, **meta)] * 5,
            torch.empty(2, 8, 28, 28, **meta),
            torch.empty(2, 64, 96, dtype=torch.bool, **meta)),
        'batch_norm_act': lambda: kc.batch_norm_act.batch_norm_act(
            torch.empty(2, 8, 4, 4, **meta), *[torch.empty(8, **meta)] * 3,
            act='relu'),
    }
    before = kc.launch_counts()
    with pytest.raises(ValueError, match='unsupported device'):
        args[call]()
    assert kc.launch_counts() == before


def test_cpu_wrappers_take_plain_and_count_nothing():
    rng = np.random.RandomState(0)
    kc.reset_launch_counts()
    x = torch.from_numpy(rng.randn(2, 49, 32).astype(np.float32))
    s, b = torch.ones(32), torch.zeros(32)
    assert torch.equal(kc.band_groupnorm(x, s, b, 16),
                       kc.band_groupnorm_plain(x, s, b, 16))
    assert kc.launch_counts() == {'band_groupnorm': 0,
                                  'band_groupnorm_backward': 0,
                                  'segment_topk': 0, 'nms_keep': 0,
                                  'paste_stats': 0, 'batch_norm_act': 0}
