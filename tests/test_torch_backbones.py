"""The rest of the backbone zoo and the separable heads of the PyTorch port
against the JAX package.

Each of the ten registry names the port lacked before (mobilenetv2,
resnet50, resnet50v2, resnet101v2, seresnet50, seresnext50, vgg16,
efficientnet b2 / b3 / b4) runs through ``BackboneNetwork`` with every
endpoint (C1-C5, P6, P7) in both packages from the same flax variables,
carried into torch by the weight bridge (``load_flax_variables``, which
raises on any leaf left over): random kernels at lecun scale, random norm
parameters and statistics, so an identity norm cannot hide a layout error.
float32 on the CPU, batch 1 at 72x88 (odd maps at C3 and below, where
XLA's 'SAME' stride-2 padding differs from the even case) and, marked
``slow`` with the deepest variants (resnet101v2, efficientnet b3 / b4),
at 64x64.

Tolerances: every endpoint within 1e-5 of its map's largest magnitude in
eval mode (measured at most 4.4e-6, at P7 after its GroupNorm); train mode
in float64 on both sides, within 1e-9 (the statistics 2.4e-7, the
reference keeps them in float32). ``module_frozen`` is
held to the reference's ``trainable_mask`` exactly, and a narrow MaskLab
with separable heads in all three groups to the main path's tolerances
(``tests/test_torch_slice.py``: 1e-4; NMS exact on identical inputs).
"""
import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from masklab_tpu import ModelConfiguration as JaxConfig
from masklab_tpu.models import MaskLab as JaxMaskLab
from masklab_tpu.models import build_masklab as jax_build
from masklab_tpu.nn.backbone import BACKBONE_REGISTRY
from masklab_tpu.nn.backbone import BackboneNetwork as JaxBackbone
from masklab_tpu.nn.layers import MobileSeparableConv as JaxSeparable
from masklab_tpu.ops.boxes import decode_boxes as jax_decode
from masklab_tpu.ops.nms import batched_class_aware_nms as jax_nms
from masklab_tpu.train import trainable_mask as jax_trainable_mask
import masklab_tpu_torch as mt
from masklab_tpu_torch import load_flax_variables
from masklab_tpu_torch.nn.backbone import (BackboneNetwork, PORTED_BACKBONES,
                                           _BODIES)
from masklab_tpu_torch.nn.backbone.efficientnet import (EfficientNet,
                                                        drop_connect)
from masklab_tpu_torch.nn.layers import MobileSeparableConv
from masklab_tpu_torch.ops import nms as tnms
from masklab_tpu_torch.train import trainable_mask
from masklab_tpu_torch.weights import flax_names

NEW = ('mobilenetv2', 'resnet50', 'resnet50v2', 'resnet101v2', 'seresnet50',
       'seresnext50', 'vgg16', 'efficientnetb2', 'efficientnetb3',
       'efficientnetb4')
OUTPUTS = ('C1', 'C2', 'C3', 'C4', 'C5', 'P6', 'P7')
# endpoint channels, C1-C5
CHANNELS = {
    'mobilenetv2': (16, 24, 32, 96, 1280),
    'resnet50': (64, 256, 512, 1024, 2048),
    'resnet50v2': (64, 256, 512, 1024, 2048),
    'resnet101v2': (64, 64, 128, 256, 2048),
    'seresnet50': (64, 256, 512, 1024, 2048),
    'seresnext50': (64, 256, 512, 1024, 2048),
    'vgg16': (128, 256, 512, 512, 512),
    'efficientnetb2': (96, 144, 288, 720, 1408),
    'efficientnetb3': (144, 192, 288, 816, 1536),
    'efficientnetb4': (144, 192, 336, 960, 1792),
}
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope='module', autouse=True)
def torch_threads():
    """Two intra-op threads for this file's torch work, as
    tests/test_torch_train.py does: the tier-1 run puts it beside JAX tests
    whose 8-device CPU collectives abort when their threads are starved."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def random_variables(module, example, seed):
    """The module's flax variables (shapes from ``jax.eval_shape``, no
    compile) filled from a seeded numpy generator: kernels normal at
    1 / sqrt(fan in), biases and norm offsets uniform, norm scales and
    running variances in [0.5, 1.5], running means in [-0.2, 0.2]."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), example)

    def leaf(path, s):
        keys = jax.tree_util.keystr(path)
        shape = s.shape
        if keys.endswith("['kernel']"):
            fan_in = int(np.prod(shape[:-1]))
            return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
        if keys.endswith(("['scale']", "['var']")):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if keys.endswith("['mean']"):
            return rng.uniform(-0.2, 0.2, shape).astype(np.float32)
        return rng.uniform(-0.3, 0.3, shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, dict(shapes))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2))).contiguous(
            memory_format=torch.channels_last)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def scaled_err(got, want):
    """max |got - want| over the largest |want|."""
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_registry_equals_reference():
    assert set(PORTED_BACKBONES) == set(BACKBONE_REGISTRY)
    assert set(NEW) | {'mobilenet', 'seresnet34', 'resnext50'} == set(
        BACKBONE_REGISTRY)
    with pytest.raises(NotImplementedError):
        BackboneNetwork('resnet101')      # defined there, not registered


@pytest.fixture(scope='module')
def backbones():
    """name -> (JAX module, variables, bridged torch module), each built
    once, at its first use."""
    out = {}

    def get(name):
        if name not in out:
            jmod = JaxBackbone(backbone_type=name, backbone_outputs=OUTPUTS,
                               num_features=32)
            variables = random_variables(jmod, jnp.zeros((1, 64, 64, 3)),
                                         seed=len(name))
            tmod = BackboneNetwork(name, OUTPUTS, num_features=32)
            load_flax_variables(tmod, jax.tree_util.tree_map(np.asarray,
                                                             variables))
            out[name] = (jmod, variables, tmod)
        return out[name]
    return get


# the deepest variants run the code of efficientnetb2 and resnet50v2 at
# other widths and depths; their JAX compiles take 3-23 s each
FULL_DEPTH = ('resnet101v2', 'efficientnetb3', 'efficientnetb4')


def _slow_if(cond, *values):
    return pytest.param(*values, marks=[pytest.mark.slow] if cond else [])


# 72x88 (odd maps at C3 and below) in tier-1; the even 64 px case and the
# deepest variants are slow
SIZES = ((64, 64), (72, 88))


@pytest.mark.parametrize('name,hw', [
    _slow_if(n in FULL_DEPTH or hw == SIZES[0], n, hw)
    for n in NEW for hw in SIZES],
    ids=lambda v: v if isinstance(v, str) else f'hw{SIZES.index(v)}')
def test_backbone_matches_reference(backbones, name, hw):
    """Every endpoint in eval mode (the running statistics) against the
    reference's BackboneNetwork: channels, shapes, values."""
    jmod, variables, tmod = backbones(name)
    images = (np.random.RandomState(hw[1]).rand(1, *hw, 3)
              * 255).astype(np.float32)
    want = jax.jit(jmod.apply)(variables, images)
    with torch.no_grad():
        got = tmod.eval()(torch.from_numpy(images))
    assert sorted(got) == sorted(want) == sorted(OUTPUTS)
    for i, c in enumerate(CHANNELS[name]):
        assert got[f'C{i + 1}'].shape[1] == c, (name, i)
    for k in OUTPUTS:
        assert nhwc(got[k]).shape == want[k].shape, (name, hw, k)
        err = scaled_err(nhwc(got[k]), want[k])
        assert err <= 1e-5, (name, hw, k, err)


@pytest.mark.parametrize('name', [_slow_if(n in FULL_DEPTH, n) for n in NEW])
def test_backbone_train_mode_float64(backbones, name):
    """BatchNorm's train mode (batch statistics, batch 2, 64 px: C5 is
    2x2) of the body in float64 on both sides, as
    ``tests/test_torch_train.py`` holds mobilenet's and resnext50's:
    float32 would measure the cancellation of E[x^2] - E[x]^2 over 8
    values, not the port. Every endpoint within 1e-9 of its scale; the
    updated running statistics (float32 in the reference) within 2.4e-7
    of each tensor's largest value. vgg16 has no BatchNorm: its train mode
    is its eval mode."""
    _, variables, _ = backbones(name)
    body_name = _BODIES[name][2]
    variables = {coll: tree[body_name] for coll, tree in variables.items()
                 if body_name in tree}
    rng = np.random.RandomState(len(name) + 100)
    x = rng.randn(2, 64, 64, 3)
    jbody = BACKBONE_REGISTRY[name](jnp.float64)
    tbody = _BODIES[name][0](torch.float64)
    load_flax_variables(tbody, jax.tree_util.tree_map(np.asarray,
                                                      variables))
    tbody = tbody.double().train()
    with jax.enable_x64():
        want, mutated = jax.jit(lambda v, x: jbody.apply(
            v, x, train=True, mutable=['batch_stats']))(
                variables, jnp.asarray(x))
        want = jax.tree_util.tree_map(np.asarray, want)
        mutated = jax.tree_util.tree_map(np.asarray, dict(mutated))
    with torch.no_grad():
        got = tbody(torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 3, 1, 2))))
    for k in ('C1', 'C2', 'C3', 'C4', 'C5'):
        err = scaled_err(nhwc(got[k]), want[k])
        assert err <= 1e-9, (name, k, err)
    names = flax_names(tbody)
    stats = {names[k][1]: v.numpy() for k, v in tbody.state_dict().items()
             if k in names and names[k][0] == 'batch_stats'}
    flat = {tuple(getattr(p, 'key', str(p)) for p in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(
                mutated.get('batch_stats', {}))[0]}
    assert set(stats) == set(flat)
    assert bool(flat) == (name != 'vgg16')
    for path, v in flat.items():
        np.testing.assert_allclose(stats[path], v, rtol=0,
                                   atol=2.4e-7 * np.abs(v).max(),
                                   err_msg=str(path))


@pytest.mark.parametrize('name', NEW)
def test_module_frozen_matches_reference(name):
    """The trainable mask at every unfreeze depth equals the reference's,
    path by path, over the backbone's parameters: the freeze rules key on
    the flax module names, so a body named otherwise freezes the wrong
    layers."""
    jmod = JaxBackbone(backbone_type=name, backbone_outputs=OUTPUTS,
                       num_features=32)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    holder = nn.Module()
    holder.backbone = BackboneNetwork(name, OUTPUTS, num_features=32)
    names = flax_names(holder)
    seen = set()
    for depth in ('C0', 'C1', 'C2', 'C3', 'C4', 'C5'):
        want = jax_trainable_mask({'backbone': shapes['params']}, name,
                                  depth)
        want = {tuple(getattr(p, 'key', str(p)) for p in path): bool(v)
                for path, v in jax.tree_util.tree_flatten_with_path(want)[0]}
        got = {names[k][1]: v for k, v in
               trainable_mask(holder, name, depth).items()}
        assert got == want, depth
        seen.add(tuple(sorted(got.values())))
    assert len(seen) > 1             # some depth freezes something


def test_drop_connect_form():
    """Per-sample keep with probability 1 - rate from the caller's
    generator, the kept samples scaled by 1 / (1 - rate), the others zero;
    the same generator state gives the same draw."""
    rate = 0.3
    x = torch.randn(4000, 3, 2, 2, generator=torch.Generator().manual_seed(1))
    got = drop_connect(x, rate, torch.Generator().manual_seed(7))
    u = torch.rand(4000, generator=torch.Generator().manual_seed(7))
    keep = u < 1 - rate
    want = torch.where(keep[:, None, None, None], x / (1 - rate),
                       torch.zeros_like(x))
    assert torch.equal(got, want)
    kept = (got != 0).flatten(1).any(1)
    assert torch.equal(kept, keep)
    # 4000 draws: the kept share within 4 standard deviations of 0.7
    assert abs(kept.float().mean().item() - 0.7) < 4 * np.sqrt(
        0.21 / 4000)


def test_efficientnet_drop_connect_only_with_a_generator():
    """Train mode without a generator is deterministic (the reference
    without a 'dropout' rng, held above); with one, the residual blocks
    drop samples, the same seed giving the same output; eval mode ignores
    the generator."""
    torch.manual_seed(0)
    body = EfficientNet(1.1, 1.2)
    x = torch.randn(4, 3, 64, 64)
    with torch.no_grad():
        body.eval()
        plain = body(x)['C5']
        assert torch.equal(body(x, torch.Generator().manual_seed(3))['C5'],
                           plain)
        body.train()
        frozen = {k: v.clone() for k, v in body.state_dict().items()}
        det = body(x)['C5']
        body.load_state_dict(frozen)
        assert torch.equal(body(x)['C5'], det)
        body.load_state_dict(frozen)
        a = body(x, torch.Generator().manual_seed(3))['C5']
        body.load_state_dict(frozen)
        b = body(x, torch.Generator().manual_seed(3))['C5']
    assert torch.equal(a, b)
    assert not torch.equal(a, det)


@pytest.mark.parametrize('c,expand,hw', [(32, 4.0, (14, 14)),
                                         (48, 1.0, (7, 9))])
def test_mobile_separable_conv(c, expand, hw):
    """The inverted-residual separable conv against the reference's; its
    GroupNorms take the flat-band path (ragged at 14x14 with 16 groups)."""
    x = np.random.RandomState(c).randn(2, *hw, c).astype(np.float32)
    jmod = JaxSeparable(c, expand_ratio=expand, groups=16)
    variables = random_variables(jmod, jnp.zeros((1,) + x.shape[1:]), c)
    want = jmod.apply(variables, x)
    tmod = MobileSeparableConv(c, c, 3, expand, 16)
    load_flax_variables(tmod, jax.tree_util.tree_map(np.asarray, variables))
    with torch.no_grad():
        got = tmod(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    with pytest.raises(ValueError, match='widths must match'):
        MobileSeparableConv(c, c + 16)


# ---- a narrow MaskLab with separable heads ----

def separable(cfg):
    """The CLI's default deployment (resnet50) at width 32, depth 1, with
    separable heads in detection, instance and semantic. The separable
    segmentation head adds its input (the upsampled ASPP output beside the
    skip projection) to its output, so num_aspp_features +
    num_skip_features must equal its num_features, in both packages."""
    cfg.backbone.num_features = 32
    for group in (cfg.detection, cfg.instance, cfg.semantic):
        group.num_features = 32
        group.num_depth = 1
        group.use_separable_conv = True
    cfg.semantic.num_aspp_features = 16
    cfg.semantic.num_skip_features = 16
    cfg.detection.nms_max_output_size = 20
    cfg.compute.nms_candidates_per_class = 64
    return cfg


@pytest.fixture(scope='module')
def separable_models():
    jcfg, tcfg = separable(JaxConfig()), separable(mt.ModelConfiguration())
    assert tcfg.backbone.backbone_type == 'resnet50'
    jmodel = jax_build(jcfg)
    variables = random_variables(jmodel, jnp.zeros((1, 128, 128, 3)), 11)

    def dense(path, x):
        keys = jax.tree_util.keystr(path)
        if 'cls_subnet' in keys and 'output_' in keys and 'bias' in keys:
            return x * 0.0 + 2.0                    # forced dense
        return x
    variables = jax.tree_util.tree_map_with_path(dense, variables)
    tmodel = mt.MaskLab(tcfg)
    load_flax_variables(tmodel, jax.tree_util.tree_map(np.asarray,
                                                       variables))
    return jcfg, jmodel, variables, tmodel.eval()


def test_separable_masklab_structure(separable_models):
    """Separable blocks where the reference has them, with its quirks: the
    box head's squeeze-excite follows use_separable_conv, and the mask and
    segmentation heads expand by float(use_separable_conv) = 1."""
    _, _, variables, tmodel = separable_models
    params = variables['params']
    assert 'MobileSeparableConv_0' in params['cls_subnet']['block_0']
    assert 'SqueezeExcite_0' in params['loc_subnet']['block_0']
    assert 'SqueezeExcite_0' not in params['cls_subnet']['block_0']
    sep = tmodel.mask_subnet.level_0.block.MobileSeparableConv_0
    assert sep.Conv_0.out_channels == 32                  # expand 1
    det = tmodel.cls_subnet.block_0.MobileSeparableConv_0
    assert det.Conv_0.out_channels == 128                 # expand 4
    assert hasattr(tmodel.loc_subnet.block_0, 'SqueezeExcite_0')
    assert hasattr(tmodel.seg_subnet.HeadBlock_0, 'MobileSeparableConv_0')


def test_separable_masklab_matches_reference(separable_models):
    """The raw heads (backbone, FPN, separable cls / box / segmentation
    heads) within 1e-4; NMS fed the reference's scores and boxes gives its
    proposals exactly (every slot filled: forced dense); the separable mask
    heads fed its features and proposals give its masks within 1e-4."""
    jcfg, jmodel, variables, tmodel = separable_models
    x = np.random.RandomState(4).randint(0, 256, (2, 128, 128, 3)).astype(
        np.float32)
    raw = jax.jit(lambda v, i: jmodel.apply(
        v, i, method=JaxMaskLab.raw_heads))(variables, x)
    with torch.no_grad():
        got = tmodel.raw_heads(torch.from_numpy(x))
    for k in ('cls_pred', 'loc_pred', 'seg_pred', 'priors'):
        assert tuple(got[k].shape) == raw[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(raw[k]),
                                   err_msg=k, **TOL)
    det = jcfg.detection
    kw = dict(min_confidence=det.min_confidence,
              nms_iou_threshold=det.nms_iou_threshold,
              post_iou_threshold=det.post_iou_threshold,
              max_outputs=det.nms_max_output_size,
              candidates_per_class=jcfg.compute.nms_candidates_per_class)
    cls = np.array(raw['cls_pred'])
    boxes = np.array(jax_decode(raw['loc_pred'], raw['priors']))
    props = np.array(jax_nms(jnp.asarray(cls), jnp.asarray(boxes), **kw))
    assert (props[..., 4] >= 0).all()                       # forced dense
    np.testing.assert_array_equal(
        tnms.batched_class_aware_nms(torch.from_numpy(cls),
                                     torch.from_numpy(boxes), **kw).numpy(),
        props)
    want_masks = np.asarray(jax.jit(lambda v, f, b: jmodel.apply(
        v, f, b, (128, 128), method=JaxMaskLab.mask_branch))(
        variables, raw['features'], jnp.asarray(props)))
    with torch.no_grad():
        got_masks = tmodel.mask_branch([nchw(f) for f in raw['features']],
                                       torch.from_numpy(props),
                                       (128, 128)).numpy()
    assert np.abs(got_masks).max() > 0
    np.testing.assert_allclose(got_masks, want_masks, **TOL)


def test_separable_segmentation_width_mismatch_raises():
    """num_aspp_features + num_skip_features != num_features: the
    reference fails at its residual add, the port when it builds."""
    jcfg, tcfg = separable(JaxConfig()), separable(mt.ModelConfiguration())
    for cfg in (jcfg, tcfg):
        cfg.semantic.num_skip_features = 32
    with pytest.raises(TypeError):
        jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 128, 128, 3)))
    with pytest.raises(ValueError, match='widths must match'):
        mt.MaskLab(tcfg)


def test_default_configuration_builds_resnet50():
    """``ModelConfiguration()`` as it stands (resnet50) builds, and its
    prior at the predictor's 540x960 is the [163275, 4] grid the
    deployment's candidate pool takes through K2."""
    cfg = mt.ModelConfiguration()
    assert cfg.backbone.backbone_type == 'resnet50'
    model = mt.MaskLab(cfg)
    assert type(model.backbone.ResNet_0).__name__ == 'ResNet'
    priors = mt.generate_priors(540, 960, mt.priors_from_config(cfg))
    assert priors.shape == (163275, 4)


@pytest.mark.parametrize('backbone', ['efficientnetb2', 'mobilenet'])
def test_train_step_draws_drop_connect(backbone):
    """The train step draws efficientnet's drop-connect from a generator
    seeded from ``seed`` and the step, as the reference's step folds its
    'dropout' rng: other seeds give other gradients, the same seed the
    same ones, with the backbone recomputed (``remat_backbone``) too, since
    the recomputation draws the same masks. A body without random layers
    does not depend on the seed."""
    from masklab_tpu_torch import train
    from masklab_tpu_torch.data import make_random_batch
    cfg = mt.ModelConfiguration()
    cfg.backbone.backbone_type = backbone
    cfg.backbone.backbone_outputs = ('C3', 'C4', 'C5')
    cfg.backbone.num_features = 16
    for group in (cfg.detection, cfg.instance, cfg.semantic):
        group.num_features = 16
        group.num_depth = 1
    cfg.semantic.num_aspp_features = 16
    cfg.compute.nms_candidates_per_class = 16
    batch = train.as_batch(make_random_batch(2, (64, 64), 4, seed=3), 'cpu')

    def first_moments(seed, remat=False):
        cfg.compute.remat_backbone = remat
        model = mt.build_masklab(cfg, device='cpu', seed=0)
        state = train.TrainState(model, train.rectified_adam(1e-3))
        state, _ = train.make_train_step(model, with_metrics=False,
                                         seed=seed)(state, batch)
        return {k: v for k, v in state.opt_state.mu.items()
                if k.startswith('backbone')}
    a, b, again = first_moments(1), first_moments(2), first_moments(1, True)
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    assert bool(differ) == (backbone == 'efficientnetb2')
    for k in a:
        torch.testing.assert_close(again[k], a[k], rtol=1e-5, atol=1e-9)
