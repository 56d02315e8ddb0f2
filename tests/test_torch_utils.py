"""The port's utilities against the JAX package's: host drawing, profiling,
the reference's Keras h5 weights in and out, and the examples.

The h5 path is held on a narrow synthetic reference h5 of the mobilenet
configuration of tests/test_capstone_parity.py, written from a JAX
variable tree through the JAX package's ``invert_converter`` (the reference
checkout that would write a real one is not needed): both packages load it
and their forwards agree, and the port's ``invert_converter`` gives the
file's arrays back bitwise. CPU only; seeded numpy inputs; each tolerance
stated.
"""
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from masklab_tpu import ModelConfiguration as JaxConfig
from masklab_tpu.models import build_masklab as jax_build
from masklab_tpu.utils import keras_export as jke
from masklab_tpu.utils import keras_import as jki
from masklab_tpu.utils import visualize as jvis
import masklab_tpu_torch as mt
from masklab_tpu_torch import cli as tcli
from masklab_tpu_torch.nn.backbone import BackboneNetwork, body_module_name
from masklab_tpu_torch.ops.cuda import _build
from masklab_tpu_torch.utils import (StageTimer, device_trace,
                                     enable_compilation_cache, keras_export,
                                     keras_import, ref_shim, timed_blocked,
                                     visualize)
from masklab_tpu_torch.weights import to_flax_tree

h5py = pytest.importorskip('h5py')

EXAMPLES = os.path.join(os.path.dirname(__file__), '..', 'examples', 'torch')


@pytest.fixture(scope='module', autouse=True)
def torch_threads():
    """Two intra-op threads, as tests/test_torch_train.py."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ---- drawing and profiling ----

def test_color_map_equals_jax():
    for seed in (40, 3):
        got = visualize.color_map(seed)
        np.testing.assert_array_equal(got, jvis.color_map(seed))
    assert got.shape == (255, 3) and got.dtype == np.uint8


@pytest.mark.parametrize('scale', [1.0, 255.0])
def test_drawings_equal_jax(scale):
    """Both drawings, on float images in [0, 1] and in [0, 255], equal the
    JAX package's arrays exactly."""
    rng = np.random.RandomState(0)
    img = (rng.rand(48, 64, 3) * scale).astype(np.float32)
    segs = (rng.rand(48, 64, 3) > 0.6).astype(np.float32)
    np.testing.assert_array_equal(visualize.draw_semantics(img, segs),
                                  jvis.draw_semantics(img, segs))
    boxes = np.asarray([[20, 16, 10, 12, 1, 0.9], [40, 30, 16, 8, 3, 0.5],
                        [-1, -1, -1, -1, -1, -1]], np.float32)
    masks = (rng.rand(3, 48, 64) > 0.5).astype(np.float32)
    labels = ('car', 'bump', 'manhole', 'steel')
    np.testing.assert_array_equal(
        visualize.draw_instances(img, boxes, masks, labels),
        jvis.draw_instances(img, boxes, masks, labels))
    np.testing.assert_array_equal(visualize.draw_instances(img, boxes[:, :5]),
                                  jvis.draw_instances(img, boxes[:, :5]))


def test_stage_timer():
    logged = []
    timer = StageTimer(log_fn=logged.append)
    for _ in range(2):
        with timer.stage('a'):
            pass
    assert list(timer.stages) == ['a'] and timer.stages['a'] >= 0.0
    assert len(logged) == 2 and logged[0].startswith('[a] ')
    assert '"a"' in timer.summary()


def test_device_trace_writes_a_trace(tmp_path):
    log_dir = str(tmp_path / 'trace')
    with device_trace(log_dir):
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    files = [f for _, _, fs in os.walk(log_dir) for f in fs]
    assert any(f.endswith('.pt.trace.json') for f in files), files


def test_timed_blocked_is_positive():
    x = torch.ones(128, 128)
    assert timed_blocked(torch.matmul, x, x, iters=3, warmup=1) > 0


def test_enable_compilation_cache_moves_the_build_dir(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(_build, 'BUILD_DIR', _build.BUILD_DIR)
    enable_compilation_cache(str(tmp_path))
    assert _build.BUILD_DIR == str(tmp_path)


# ---- h5: the JAX package's keras_import cases, on the port's copy ----

@pytest.fixture
def h5_file(tmp_path):
    path = str(tmp_path / 'weights.h5')
    with h5py.File(path, 'w') as f:
        root = f.create_group('model_weights')
        root.attrs['layer_names'] = [b'conv1', b'dw1']
        g = root.create_group('conv1')
        g.attrs['weight_names'] = [b'conv1/kernel:0', b'conv1/bias:0']
        g.create_dataset('conv1/kernel:0',
                         data=np.ones((3, 3, 3, 8), np.float32))
        g.create_dataset('conv1/bias:0', data=np.full((8,), 0.5, np.float32))
        g2 = root.create_group('dw1')
        g2.attrs['weight_names'] = [b'dw1/depthwise_kernel:0']
        g2.create_dataset('dw1/depthwise_kernel:0',
                          data=np.ones((3, 3, 8, 1), np.float32) * 2)
    return path


def test_read_h5_groups(h5_file):
    groups = keras_import.read_h5_groups(h5_file)
    assert list(groups) == ['conv1', 'dw1']
    assert groups['conv1'][0][0] == 'conv1/kernel:0'
    assert groups['conv1'][0][1].shape == (3, 3, 3, 8)
    assert len(keras_import.read_h5_weights(h5_file)) == 3


def test_cursor_conv_and_depthwise(h5_file):
    ki = keras_import
    groups = ki.read_h5_groups(h5_file)
    cur = ki.WeightCursor(groups['conv1'], 'conv1')
    conv = ki.take_conv(cur)
    cur.finish()
    np.testing.assert_allclose(conv['kernel'], 1.0)
    np.testing.assert_allclose(conv['bias'], 0.5)
    cur = ki.WeightCursor(groups['dw1'], 'dw1')
    assert ki.take_depthwise(cur)['kernel'].shape == (3, 3, 1, 8)
    cur.finish()


def test_cursor_rejects_wrong_kind_and_shape(h5_file):
    ki = keras_import
    groups = ki.read_h5_groups(h5_file)
    cur = ki.WeightCursor(groups['conv1'], 'conv1')
    with pytest.raises(ki.ImportMismatch):
        ki.take_gn(cur)                 # kernel where gamma expected
    cur = ki.WeightCursor(groups['conv1'], 'conv1')
    with pytest.raises(ki.ImportMismatch):
        cur.take('kernel', shape=(1, 1, 3, 8))
    cur = ki.WeightCursor(groups['dw1'], 'dw1')
    ki.take_depthwise(cur)
    with pytest.raises(ki.ImportMismatch):
        cur.take('kernel')              # exhausted
    cur = ki.WeightCursor(groups['conv1'], 'conv1')
    cur.take('kernel')
    with pytest.raises(ki.ImportMismatch):
        cur.finish()                    # unconsumed


def test_take_bn_and_conv_transpose():
    ki = keras_import
    bn_w = [('bn/gamma:0', np.full(4, 2.0, np.float32)),
            ('bn/beta:0', np.full(4, 1.0, np.float32)),
            ('bn/moving_mean:0', np.zeros(4, np.float32)),
            ('bn/moving_variance:0', np.ones(4, np.float32))]
    params, stats = ki.take_bn(ki.WeightCursor(bn_w, 'bn'))
    assert set(params) == {'scale', 'bias'} and set(stats) == {'mean', 'var'}
    k = np.arange(2 * 2 * 3 * 5, dtype=np.float32).reshape(2, 2, 3, 5)
    ct_w = [('up/kernel:0', k), ('up/bias:0', np.zeros(3, np.float32))]
    out = ki.take_conv_transpose(ki.WeightCursor(ct_w, 'up'))
    assert out['kernel'].shape == (2, 2, 5, 3)
    np.testing.assert_allclose(out['kernel'][0, 0, 0, 0], k[1, 1, 0, 0])


def test_find_group():
    names = ['mobilenet', 'feature_pyramid', 'classification_sub_net']
    assert keras_import.find_group(names, r'^feature_pyramid') == \
        'feature_pyramid'
    with pytest.raises(keras_import.ImportMismatch):
        keras_import.find_group(names, r'^resnet')


def test_backbone_body_names_cover_every_converter():
    """Every backbone the converters cover lands under the port's own body
    child (the registry's name, as the JAX package's literal map names its
    flax module)."""
    src = open(jki.__file__.replace('.pyc', '.py')).read()
    body_map = eval('{' + re.search(r"body_name = \{(.*?)\}\[bt\]", src,  # noqa: S307
                                    re.S).group(1) + '}')
    assert set(keras_import._BACKBONE_CONVERTERS) == set(body_map)
    for bt, name in sorted(body_map.items()):
        assert body_module_name(bt) == name
        net = BackboneNetwork(bt, ('C3', 'C4', 'C5'), 8)
        assert isinstance(getattr(net, name), torch.nn.Module), bt


# ---- h5: a synthetic reference h5, both packages ----

CAPSTONE = [
    ('backbone', 'backbone_type', 'mobilenet'),
    ('backbone', 'backbone_outputs', ('C3', 'C4', 'C5', 'P6', 'P7')),
    ('backbone', 'num_features', 64),
    ('detection', 'feature_pyramid_inputs', ('C3', 'C4', 'C5')),
    ('detection', 'num_features', 32), ('detection', 'num_depth', 1),
    ('detection', 'groups', 16),
    ('instance', 'num_features', 32), ('instance', 'num_depth', 1),
    ('instance', 'groups', 16),
    ('semantic', 'num_aspp_features', 32), ('semantic', 'num_features', 32),
    ('semantic', 'num_skip_features', 32), ('semantic', 'num_depth', 1),
    ('semantic', 'atrous_rate', (2, 4)), ('semantic', 'atrous_groups', 16),
    ('semantic', 'groups', 16),
]


def capstone(cfg):
    """tests/test_capstone_parity.py's mobilenet configuration."""
    for group, key, value in CAPSTONE:
        setattr(getattr(cfg, group), key, value)
    cfg.detection.nms_max_output_size = 20
    cfg.compute.nms_candidates_per_class = 64
    return cfg


# Keras weight specs (name, shape) in the converters' creation order
def _conv(p, d):
    out = [(f'{p}/kernel:0', d['kernel'].shape)]
    return out + ([(f'{p}/bias:0', d['bias'].shape)] if 'bias' in d else [])


def _gn(p, d):
    return [(f'{p}/gamma:0', d['scale'].shape),
            (f'{p}/beta:0', d['bias'].shape)]


def _bn(p, d):
    shape = d['bias'].shape
    return ([(f'{p}/gamma:0', shape)] if 'scale' in d else []) + [
        (f'{p}/{k}:0', shape) for k in ('beta', 'moving_mean',
                                        'moving_variance')]


def _depthwise(p, d):
    kh, kw, _, c = d['kernel'].shape
    return [(f'{p}/depthwise_kernel:0', (kh, kw, c, 1))]


def _conv_transpose(p, d):
    kh, kw, cin, cout = d['kernel'].shape
    return [(f'{p}/kernel:0', (kh, kw, cout, cin)),
            (f'{p}/bias:0', d['bias'].shape)]


def _head_block(p, d, depth):
    return [w for i in range(depth)
            for w in _conv(f'{p}/conv_{i}', d[f'Conv_{i}'])
            + _gn(f'{p}/gn_{i}', d[f'GroupNorm_{i}'])]


def reference_specs(params, cfg):
    """[(layer group, [(weight name, shape)], converter, flax subtree)]:
    the mobilenet body's layers and the P6 / P7 extras as top-level groups
    (construct_inference_network flattens the backbone so), then the six
    subnets under the names load_reference_h5's regexes find."""
    bb = params['backbone']
    body = bb['MobileNetV1_0']
    layers = [('conv1', _conv('conv1', body['stem']['Conv_0'])),
              ('conv1_bn', _bn('conv1_bn', body['stem']['BatchNorm_0']))]
    for i in range(1, 14):
        for kind, take in (('dw', _depthwise), ('pw', _conv)):
            name = f'conv_{kind}_{i}'
            layers += [(name, take(name, body[f'{kind}{i}']['Conv_0'])),
                       (f'{name}_bn', _bn(f'{name}_bn',
                                          body[f'{kind}{i}']['BatchNorm_0']))]
    for extra in ('P6_conv', 'P6_norm', 'P7_conv'):
        if f'extras_{extra}' in bb:
            take = _gn if extra.endswith('norm') else _conv
            layers.append((extra, take(extra, bb[f'extras_{extra}'])))
    det, ins, sem = cfg.detection, cfg.instance, cfg.semantic
    fpn = [w for i in range(3) for w in
           _conv(f'fp/lateral_{i}', params['fpn'][f'lateral_{i}'])
           + _conv(f'fp/output_{i}', params['fpn'][f'output_{i}'])]

    def head(tree):
        return [w for i in range(5) for w in
                _head_block(f'h/block_{i}', tree[f'block_{i}'], det.num_depth)
                + _conv(f'h/output_{i}', tree[f'output_{i}'])]
    mask = [w for i in range(ins.max_k + 1) for w in
            _head_block(f'm/level_{i}', params['mask_subnet'][f'level_{i}']
                        ['block'], ins.num_depth)
            + _conv_transpose(f'm/up_{i}', params['mask_subnet'][
                f'level_{i}']['upsample'])
            + _conv(f'm/out_{i}', params['mask_subnet'][f'level_{i}']
                    ['output'])]
    a = params['aspp']
    aspp = _conv('a/1x1', a['aspp_1x1']) + _gn('a/gn0', a['GroupNorm_0'])
    for r in sem.atrous_rate:
        s = a[f'aspp_{r}']
        aspp += (_depthwise(f'a/{r}/dw', s['Conv_0'])
                 + _conv(f'a/{r}/pw', s['Conv_1'])
                 + _gn(f'a/{r}/gn0', s['GroupNorm_0'])
                 + _gn(f'a/{r}/gn1', s['GroupNorm_1']))
    aspp += (_conv('a/pool', a['aspp_pool'])
             + _conv('a/proj', a['concat_projection'])
             + _gn('a/gn1', a['GroupNorm_1']))
    s = params['seg_subnet']
    seg = (_conv('s/skip', s['skip_projection']) + _gn('s/gn', s['GroupNorm_0'])
           + _head_block('s/hb', s['HeadBlock_0'], sem.num_depth)
           + _conv('s/out', s['seg_output']))
    return layers, [
        ('feature_pyramid', fpn, lambda w: jki.convert_fpn(w, 3),
         params['fpn']),
        ('classification_sub_net', head, lambda w: jki.convert_head_subnet(
            w, 5, det.num_depth, name='classification_sub_net'),
         params['cls_subnet']),
        ('box_regression_sub_net', head, lambda w: jki.convert_head_subnet(
            w, 5, det.num_depth, name='box_regression_sub_net'),
         params['loc_subnet']),
        ('mask_sub_net', mask, lambda w: jki.convert_mask_subnet(
            w, ins.max_k + 1, ins.num_depth), params['mask_subnet']),
        ('aspp', aspp, lambda w: jki.convert_aspp(w, tuple(sem.atrous_rate)),
         params['aspp']),
        ('segmentation_sub_net', seg, lambda w: jki.convert_seg_subnet(
            w, sem.num_depth), params['seg_subnet'])]


def write_reference_h5(path, variables, cfg):
    """A reference inference-model h5 (Keras legacy ``model_weights``
    layout) holding ``variables``, through the JAX package's
    ``invert_converter``."""
    params, stats = variables['params'], variables['batch_stats']
    layers, subnets = reference_specs(params, cfg)
    groups = []
    flat = [(n, np.zeros(s, np.float32)) for _, ws in layers for n, s in ws]
    values = iter(jke.invert_converter(
        lambda w: jki.convert_backbone(w, 'mobilenet'), flat,
        (params['backbone'], stats['backbone'])))
    for name, ws in layers:
        groups.append((name, [(n, next(values)) for n, _ in ws]))
    for name, specs, convert, tree in subnets:
        if callable(specs):
            specs = specs(tree)
        named = [(f'{name}/{n}', np.zeros(s, np.float32)) for n, s in specs]
        groups.append((name, list(zip([n for n, _ in named],
                                      jke.invert_converter(convert, named,
                                                           tree)))))
    with h5py.File(path, 'w') as f:
        root = f.create_group('model_weights')
        root.attrs['layer_names'] = [n.encode() for n, _ in groups]
        for name, ws in groups:
            g = root.create_group(name)
            g.attrs['weight_names'] = [n.encode() for n, _ in ws]
            for n, v in ws:
                g.create_dataset(n, data=v)
    return groups


@pytest.fixture(scope='module')
def reference_h5(tmp_path_factory):
    """The synthetic h5 of a JAX-initialised capstone model, forced dense
    (every class-output bias 2.0) with norms off the identity."""
    jcfg = capstone(JaxConfig())
    jmodel = jax_build(jcfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 128, 128, 3)))
    rng = np.random.RandomState(0)

    def leaf(path, x):
        keys = jax.tree_util.keystr(path)
        if 'cls_subnet' in keys and 'output_' in keys and 'bias' in keys:
            return np.full(x.shape, 2.0, np.float32)
        if 'Norm' in keys or 'norm' in keys:
            lo, hi = ((0.5, 1.5) if keys.endswith(("['scale']", "['var']"))
                      else (-0.3, 0.3))
            return rng.uniform(lo, hi, x.shape).astype(np.float32)
        return np.asarray(x, np.float32)
    variables = jax.tree_util.tree_map_with_path(leaf, dict(variables))
    path = str(tmp_path_factory.mktemp('h5') / 'reference.h5')
    groups = write_reference_h5(path, variables, jcfg)
    return dict(path=path, groups=groups, variables=variables, jcfg=jcfg,
                jmodel=jmodel)


def test_reference_h5_loads_into_both_packages(reference_h5):
    """JAX's ``load_reference_h5`` gives back the tree the file was written
    from, bit for bit; the port's ``load_reference_h5_into`` fills the port's
    model from it; at 128 px their forwards agree as the main path's
    (tests/test_torch_slice.py): heads and masks within 1e-4, boxes within
    1e-3 px."""
    path, jcfg, jmodel = (reference_h5[k] for k in ('path', 'jcfg',
                                                    'jmodel'))
    jvars = jki.load_reference_h5(path, jcfg)
    for got, want in zip(jax.tree_util.tree_leaves(jvars),
                         jax.tree_util.tree_leaves(reference_h5['variables'])):
        np.testing.assert_array_equal(got, want)
    tmodel = keras_import.load_reference_h5_into(
        mt.MaskLab(capstone(mt.ModelConfiguration())), path).eval()
    x = np.random.RandomState(1).randint(0, 256, (2, 128, 128, 3)).astype(
        np.float32)
    want = jax.tree_util.tree_map(np.asarray,
                                  jax.jit(jmodel.apply)(jvars, x))
    with torch.no_grad():
        got = {k: v.numpy() for k, v in tmodel(torch.from_numpy(x)).items()}
    for k in ('cls_pred', 'loc_pred', 'seg_pred'):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    assert (got['roi_boxes'][..., 4] >= 0).all()
    np.testing.assert_allclose(got['roi_boxes'], want['roi_boxes'],
                               atol=1e-3, rtol=1e-5)
    np.testing.assert_allclose(got['roi_masks'], want['roi_masks'],
                               atol=1e-4, rtol=1e-4)


def test_invert_converter_gives_the_file_back_bitwise(reference_h5):
    """The port's model loaded from the h5, read back through
    ``to_flax_tree`` and the port's ``invert_converter``: every array of
    the file, bit for bit."""
    ki, ke = keras_import, keras_export
    path, cfg = reference_h5['path'], capstone(mt.ModelConfiguration())
    tree = to_flax_tree(ki.load_reference_h5_into(mt.MaskLab(cfg), path))
    groups = ki.read_h5_groups(path)
    subnets = {'feature_pyramid': ('fpn', lambda w: ki.convert_fpn(w, 3)),
               'classification_sub_net': ('cls_subnet',
                                          lambda w: ki.convert_head_subnet(
                                              w, 5, 1)),
               'box_regression_sub_net': ('loc_subnet',
                                          lambda w: ki.convert_head_subnet(
                                              w, 5, 1)),
               'mask_sub_net': ('mask_subnet',
                                lambda w: ki.convert_mask_subnet(w, 3, 1)),
               'aspp': ('aspp', lambda w: ki.convert_aspp(w, (2, 4))),
               'segmentation_sub_net': ('seg_subnet',
                                        lambda w: ki.convert_seg_subnet(w,
                                                                        1))}
    backbone = [w for name, ws in groups.items() if name not in subnets
                for w in ws]
    got = ke.invert_converter(
        lambda w: ki.convert_backbone(w, 'mobilenet'), backbone,
        (tree['params']['backbone'], tree['batch_stats']['backbone']))
    for (_, want), g in zip(backbone, got):
        np.testing.assert_array_equal(g, want)
    for name, (key, convert) in subnets.items():
        got = ke.invert_converter(convert, groups[name], tree['params'][key])
        for (_, want), g in zip(groups[name], got):
            np.testing.assert_array_equal(g, want)


def test_export_h5_warns_without_the_reference(tmp_path, monkeypatch,
                                               capsys):
    """``export --dest --h5`` where no reference checkout is found: a
    warning on stderr, no model.h5, and the bundle stands."""
    monkeypatch.setattr(ref_shim, 'REFERENCE_DIR', str(tmp_path / 'none'))
    cfg = capstone(mt.ModelConfiguration())
    model = mt.build_masklab(cfg, device='cpu', seed=0)
    from masklab_tpu_torch.train import TrainState, rectified_adam
    from masklab_tpu_torch.train.checkpoints import CheckpointManager
    run = str(tmp_path / 'run')
    CheckpointManager(run, cfg).save_epoch(
        TrainState(model, rectified_adam(1e-3)), 0.5, 0)
    tcli.main(['export', run, f'--dest={tmp_path / "bundles"}', '--h5'])
    out = capsys.readouterr()
    assert out.err.startswith('WARNING: --h5 export skipped '
                              '(ModuleNotFoundError: no reference checkout')
    bundle = tmp_path / 'bundles' / '1'
    assert sorted(os.listdir(bundle)) == ['0.50000-00', 'config.json',
                                          'serving_config.json']
    assert 'bundle exported to' in out.out


# ---- examples ----

def example(name):
    spec = importlib.util.spec_from_file_location(
        name[:4], os.path.join(EXAMPLES, name))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_example_01_data_pipeline(tmp_path):
    out = example('01_data_pipeline.py').main(str(tmp_path / 'd'),
                                              num_images=4)
    assert out['images'] == 4
    assert out['batch']['images'][0][0] == 2


def test_example_05_serving_on_the_cpu():
    out = example('05_inference_and_serving.py').main(device='cpu')
    assert out['outputs']['visualize'] == (1, 256, 448, 3)
    assert 'objs' in out['response'] and 'latency_ms' in out['response']


def test_example_06_pipeline_smoke(tmp_path):
    """Example 06's pipeline cut to 2 steps at 64 px (128 px frames at the
    0.5 bucket): the gate itself runs on the card (chip_smoke.py)."""
    m = example('06_overfit_acceptance.py').main(
        str(tmp_path / 'd'), str(tmp_path / 's'), 'cpu', epochs=1,
        steps_per_epoch=2, image_hw=(128, 128), eval_hw=(64, 64),
        check=False)
    assert m['steps'] == 2 and m['images'] == 8
    assert 0.0 <= m['mask_miou'] <= 1.0 and 0.0 <= m['semantic_miou'] <= 1.0
