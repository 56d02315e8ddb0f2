"""The road preset (seresnet34 backbone, squeeze-excite heads) of the
PyTorch port against the JAX package.

Same flax variables through the weight bridge, same seeded numpy inputs,
float32 on the CPU. Tolerances: atol/rtol 1e-4 where convolutions sum in
another order (measured maxima, road model at 128 px: cls_pred 3.7e-6,
loc_pred 3.3e-5, seg_pred 8.8e-6, roi_masks 6.0e-7), the backbone's
endpoints 1e-4 of each map's scale (measured 5.7e-5), decoded boxes 5e-3
px (measured 2.9e-3); exact for the NMS fed identical inputs and for the
candidate pool.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from masklab_tpu.models import MaskLab as JaxMaskLab
from masklab_tpu.models import build_masklab as jax_build
from masklab_tpu.nn.backbone import BackboneNetwork as JaxBackbone
from masklab_tpu.nn.backbone.resnet import CMBasicBlock as JaxBlock
from masklab_tpu.nn.backbone.resnet import _SE as JaxChannelSE
from masklab_tpu.nn.layers import SqueezeExcite as JaxSqueezeExcite
from masklab_tpu.ops.boxes import decode_boxes as jax_decode
from masklab_tpu.ops.nms import batched_class_aware_nms as jax_nms
from masklab_tpu.ops.nms import candidate_pool as jax_candidate_pool
from masklab_tpu.presets import road_project_config as jax_road_config
import masklab_tpu_torch as mt
from masklab_tpu_torch import load_flax_variables
from masklab_tpu_torch.nn.backbone import BackboneNetwork
from masklab_tpu_torch.nn.backbone.resnet import CMBasicBlock, _SE
from masklab_tpu_torch.nn.layers import SqueezeExcite, pad_same_s2
from masklab_tpu_torch.ops import nms as tnms

TOL = dict(atol=1e-4, rtol=1e-4)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def perturb(variables, seed=0):
    """Random norm parameters and statistics, and squeeze-excite kernels of
    unit scale, so identity norms and near-1/2 gates cannot hide a layout
    error. ``bn_data`` gets statistics of raw 0-255 pixels, as a trained
    one has: with unit variance there, the random body's maps grow to the
    thousands, where float32 itself (either package's, against float64)
    drifts by 1e-3 of the map's scale at C5."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        keys = jax.tree_util.keystr(path)
        if 'bn_data' in keys and keys.endswith(("['mean']", "['var']")):
            lo, hi = ((100, 140) if keys.endswith("['mean']")
                      else (3000, 5000))
            return jnp.asarray(rng.uniform(lo, hi, x.shape), x.dtype)
        if 'Norm' in keys or 'norm' in keys or "['bn" in keys:
            if keys.endswith("['scale']") or keys.endswith("['var']"):
                return jnp.asarray(rng.uniform(0.5, 1.5, x.shape), x.dtype)
            return jnp.asarray(rng.uniform(-0.3, 0.3, x.shape), x.dtype)
        if 'Dense' in keys or "['fc" in keys:
            return jnp.asarray(rng.randn(*x.shape), x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(leaf, variables)


def bridged(module, variables):
    load_flax_variables(module, numpy_tree(variables))
    return module.eval()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2))).contiguous(
            memory_format=torch.channels_last)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


# ---- layers ----

@pytest.mark.parametrize('c,ratio', [(32, 16.0), (48, 16), (20, 3.0)])
def test_squeeze_excite(c, ratio):
    x = np.random.RandomState(c).randn(3, 7, 5, c).astype(np.float32)
    jmod = JaxSqueezeExcite(ratio)
    variables = perturb(jmod.init(jax.random.PRNGKey(0), x))
    want = jmod.apply(variables, x)
    tmod = bridged(SqueezeExcite(c, ratio), variables)
    assert tmod.Dense_0.out_features == int(c // ratio)
    with torch.no_grad():
        got = tmod(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize('c', [64, 8])
def test_channel_se(c):
    """fc1 / fc2 with biases; c // 16 floored at 1."""
    x = np.random.RandomState(c).randn(2, 6, 6, c).astype(np.float32)
    jmod = JaxChannelSE()
    variables = perturb(jmod.init(jax.random.PRNGKey(1), x))
    want = jmod.apply(variables, x)
    tmod = bridged(_SE(c), variables)
    with torch.no_grad():
        got = tmod(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize('c_in,filters,stride,cut,hw', [
    (64, 64, 1, 'post', 16),      # stage 1's first unit
    (64, 128, 2, 'post', 16),     # a later stage's first unit
    (64, 128, 2, 'post', 15),     # odd map under the explicit (1, 1) pad
    (128, 128, 1, 'pre', 8),
])
def test_cm_basic_block(c_in, filters, stride, cut, hw):
    x = np.random.RandomState(hw).randn(2, hw, hw, c_in).astype(np.float32)
    jmod = JaxBlock(filters, stride, cut, use_se=True)
    variables = perturb(jmod.init(jax.random.PRNGKey(2), x))
    want_y, want_pre = jmod.apply(variables, x)
    tmod = bridged(CMBasicBlock(c_in, filters, stride, cut), variables)
    with torch.no_grad():
        got_y, got_pre = tmod(nchw(x))
    np.testing.assert_allclose(nhwc(got_pre), np.asarray(want_pre), **TOL)
    np.testing.assert_allclose(nhwc(got_y), np.asarray(want_y), **TOL)


@pytest.mark.parametrize('hw', [(8, 8), (7, 9), (1, 2), (3, 5)])
def test_pad_same_s2_matches_xla_same(hw):
    """A stride-2 3x3 conv after pad_same_s2 equals XLA's 'SAME' conv:
    (0, 1) on even axes, (1, 1) on odd ones."""
    rng = np.random.RandomState(sum(hw))
    x = rng.randn(1, *hw, 4).astype(np.float32)
    k = rng.randn(3, 3, 4, 5).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        x, k, (2, 2), 'SAME', dimension_numbers=('NHWC', 'HWIO', 'NHWC'))
    weight = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    got = torch.nn.functional.conv2d(pad_same_s2(nchw(x)), weight, stride=2)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)


# ---- backbone ----

@pytest.fixture(scope='module')
def backbone_pair():
    outputs = ('C1', 'C2', 'C3', 'C4', 'C5', 'P6', 'P7')
    jmod = JaxBackbone(backbone_type='seresnet34', backbone_outputs=outputs,
                       num_features=32)
    variables = perturb(jax.jit(jmod.init)(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 128, 128, 3))))
    tmod = bridged(BackboneNetwork('seresnet34', outputs, num_features=32),
                   variables)
    return jmod, variables, tmod


@pytest.mark.parametrize('hw,c5', [((128, 128), (4, 4)),
                                   ((96, 160), (3, 5))])
def test_seresnet34_backbone(backbone_pair, hw, c5):
    """Every endpoint at 128 px and at 96x160, whose C5 is 3x5: odd maps,
    where the P6 / P7 'SAME' padding is (1, 1), not pad_valid_s2's
    (0, 1). Channels: C1 64, C2 64, C3 128, C4 256, C5 512."""
    jmod, variables, tmod = backbone_pair
    images = (np.random.RandomState(hw[1]).rand(2, *hw, 3)
              * 255).astype(np.float32)
    want = jax.jit(jmod.apply)(variables, images)
    with torch.no_grad():
        got = tmod(torch.from_numpy(images))
    assert sorted(got) == sorted(want)
    assert tuple(got['C5'].shape[-2:]) == c5
    channels = {'C1': 64, 'C2': 64, 'C3': 128, 'C4': 256, 'C5': 512,
                'P6': 32, 'P7': 32}
    for name in got:
        assert got[name].shape[1] == channels[name], name
        # absolute error in units of the map's largest magnitude; measured
        # at most 8.3e-6 at C1-C5 and 5.7e-5 at P7 (after a GroupNorm),
        # where the float32 evaluations of both packages sit 6.8e-5 and
        # 1.2e-4 from float64
        scale = float(np.abs(want[name]).max())
        err = np.abs(nhwc(got[name]) - np.asarray(want[name])).max()
        assert err <= 1e-4 * scale, (name, err, scale)


# ---- the road-preset model ----

def narrow(cfg):
    cfg.backbone.num_features = 32
    for group in (cfg.detection, cfg.instance, cfg.semantic):
        group.num_features = 32
        group.num_depth = 1
    cfg.semantic.num_aspp_features = 32
    cfg.detection.nms_max_output_size = 20
    cfg.compute.nms_candidates_per_class = 64
    cfg.postprocess.resolution = (128, 160)
    return cfg


@pytest.fixture(scope='module')
def road_models():
    """The road preset at width 32, depth 1, forced dense (every class
    output bias 2.0, as bench.py bumps them), with random norms."""
    jcfg, tcfg = narrow(jax_road_config()), narrow(mt.road_project_config())
    jmodel = jax_build(jcfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 128, 128, 3)))

    def dense(path, x):
        keys = jax.tree_util.keystr(path)
        if 'cls_subnet' in keys and 'output_' in keys and 'bias' in keys:
            return x * 0.0 + 2.0
        return x
    variables = jax.tree_util.tree_map_with_path(dense, perturb(variables))
    tmodel = mt.MaskLab(tcfg)
    load_flax_variables(tmodel, numpy_tree(variables))
    return jcfg, jmodel, variables, tcfg, tmodel.eval()


def test_road_preset_copy_matches_reference():
    assert mt.road_project_config().to_dict() == jax_road_config().to_dict()


def test_road_model_has_se_where_the_reference_has_it(road_models):
    """Squeeze-excite in the class, mask and segmentation heads; none in
    the box head (the reference wires its flag from use_separable_conv)."""
    _, _, variables, _, tmodel = road_models
    params = variables['params']
    assert 'SqueezeExcite_0' in params['cls_subnet']['block_0']
    assert 'SqueezeExcite_0' not in params['loc_subnet']['block_0']
    assert 'SqueezeExcite_0' in params['mask_subnet']['level_0']['block']
    assert 'SqueezeExcite_0' in params['seg_subnet']['HeadBlock_0']
    assert hasattr(tmodel.cls_subnet.block_0, 'SqueezeExcite_0')
    assert not hasattr(tmodel.loc_subnet.block_0, 'SqueezeExcite_0')


def test_road_force_dense_and_init(road_models):
    """The port's force_dense sets the class-output biases bench.py bumps;
    seeded init builds the preset on the CPU with finite weights."""
    _, _, variables, tcfg, tmodel = road_models
    model = mt.force_dense(mt.build_masklab(tcfg, device='cpu', seed=3))
    for i in range(4):
        bias = getattr(model.cls_subnet, f'output_{i}').bias
        assert torch.equal(bias, torch.full_like(bias, 2.0))
        np.testing.assert_array_equal(
            getattr(tmodel.cls_subnet, f'output_{i}').bias.detach().numpy(),
            np.asarray(variables['params']['cls_subnet'][f'output_{i}']
                       ['bias']))
    assert all(torch.isfinite(p).all() for p in model.parameters())
    assert model.backbone.CMResNet_0.bn_data.BatchNorm_0.weight is None


def test_road_model_end_to_end(road_models):
    jcfg, jmodel, variables, _, tmodel = road_models
    x = np.random.RandomState(1).randint(0, 256, (2, 128, 128, 3)).astype(
        np.float32)
    want = jax.tree_util.tree_map(np.asarray,
                                  jax.jit(jmodel.apply)(variables, x))
    with torch.no_grad():
        got = {k: v.numpy() for k, v in tmodel(torch.from_numpy(x)).items()}
    # 16^2 + 8^2 + 4^2 + 2^2 positions ('same' grid) x 15 anchors
    assert got['cls_pred'].shape == (2, 340 * 15, 5)
    for k in ('cls_pred', 'loc_pred', 'seg_pred', 'priors'):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    max_out = jcfg.detection.nms_max_output_size
    assert (got['roi_boxes'][..., 4] >= 0).all()           # forced dense
    # decoded coordinates: loc_pred's differences (the deeper body's
    # float32 drift) pass through exp and the box scales; measured
    # 2.9e-3 px on 128 px boxes
    np.testing.assert_array_equal(got['roi_boxes'][..., 4],
                                  want['roi_boxes'][..., 4])
    np.testing.assert_allclose(got['roi_boxes'], want['roi_boxes'],
                               atol=5e-3, rtol=1e-5)
    assert got['roi_masks'].shape == (2, max_out, 28, 28, 5)
    np.testing.assert_allclose(got['roi_masks'], want['roi_masks'], **TOL)


def test_road_model_staged_nms_and_masks(road_models):
    """NMS fed the reference's scores and boxes gives its proposals
    exactly; the SE mask heads fed its features and proposals give its
    masks within 1e-4."""
    jcfg, jmodel, variables, _, tmodel = road_models
    x = np.random.RandomState(2).randint(0, 256, (2, 128, 128, 3)).astype(
        np.float32)
    raw = jax.jit(lambda v, i: jmodel.apply(
        v, i, method=JaxMaskLab.raw_heads))(variables, x)
    det = jcfg.detection
    kw = dict(min_confidence=det.min_confidence,
              nms_iou_threshold=det.nms_iou_threshold,
              post_iou_threshold=det.post_iou_threshold,
              max_outputs=det.nms_max_output_size,
              candidates_per_class=jcfg.compute.nms_candidates_per_class)
    cls = np.array(raw['cls_pred'])
    boxes = np.array(jax_decode(raw['loc_pred'], raw['priors']))
    want = np.array(jax_nms(jnp.asarray(cls), jnp.asarray(boxes), **kw))
    got = tnms.batched_class_aware_nms(torch.from_numpy(cls),
                                       torch.from_numpy(boxes), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    want_masks = np.asarray(jax.jit(lambda v, f, b: jmodel.apply(
        v, f, b, (128, 128), method=JaxMaskLab.mask_branch))(
        variables, raw['features'], jnp.asarray(want)))
    feats = [nchw(f) for f in raw['features']]
    with torch.no_grad():
        got_masks = tmodel.mask_branch(feats, torch.from_numpy(want),
                                       (128, 128)).numpy()
    assert np.abs(got_masks).max() > 0
    np.testing.assert_allclose(got_masks, want_masks, **TOL)


def test_candidate_pool_road_shape():
    """The road preset's pool at 512 px: [8, 5, 81600] masked scores (the
    transpose of cls_pred), k = 128, forced-dense-like bf16 ties; exact
    against the JAX pool, and through the certificate without a fallback.
    A second row set whose top 40 sit in one segment (which keeps 16)
    takes the fallback, exact too."""
    rng = np.random.RandomState(5)
    b, n, c, k, floor = 8, 81600, 5, 128, 0.05
    cls = 1 / (1 + np.exp(-(2.0 + 0.05 * rng.randn(b, n, c))))
    cls = torch.from_numpy(cls.astype(np.float32)).bfloat16().float()
    cls[torch.from_numpy(rng.rand(b, n, c) < 0.05)] = 0.01
    scores_t = cls.transpose(1, 2)
    masked = torch.where(scores_t >= floor, scores_t,
                         torch.full_like(scores_t, -1.0))
    before = tnms.pool_fallbacks
    got_v, got_i = tnms.candidate_pool(masked, k, floor=floor)
    assert tnms.pool_fallbacks == before
    want_v, want_i = jax_candidate_pool(jnp.asarray(masked.numpy()), k,
                                        floor=floor)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))

    crowded = masked[:1].clone()
    s = -(-n // 128)
    crowded[0, 3, 7 + s * np.arange(40)] = torch.linspace(0.999, 0.99, 40)
    got_v, got_i = tnms.candidate_pool(crowded, k, floor=floor)
    assert tnms.pool_fallbacks == before + 1
    want_v, want_i = jax_candidate_pool(jnp.asarray(crowded.numpy()), k,
                                        floor=floor)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
