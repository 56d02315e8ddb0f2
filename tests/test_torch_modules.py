"""Module-by-module parity of the PyTorch port against the JAX package.

Every module is loaded with the same flax variables through the weight
bridge and fed the same seeded numpy inputs, in float32 on the CPU.
Tolerances: atol 1e-4 / rtol 1e-4 where convolutions sum in another order;
exact where both sides run the same float operations (NMS, top-k, masks of
integers).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from masklab_tpu.models.detection import (
    BoxRegressionSubNet as JaxBoxNet, ClassificationSubNet as JaxClsNet,
    FeaturePyramid as JaxFPN)
from masklab_tpu.models.instance import (
    MaskSubNet as JaxMaskSubNet, mask_distribute as jax_mask_distribute,
    trim_instances as jax_trim_instances)
from masklab_tpu.models.semantic import (
    ASPPNetwork as JaxASPP, SegmentationSubNet as JaxSegNet)
from masklab_tpu.nn.backbone import BackboneNetwork as JaxBackbone
from masklab_tpu.nn.layers import GroupNorm as JaxGroupNorm
from masklab_tpu.ops import boxes as jboxes
from masklab_tpu.ops import morphology as jmorph
from masklab_tpu.ops import resize as jresize
from masklab_tpu.ops.nms import batched_class_aware_nms as jax_nms
from masklab_tpu.ops.nms import candidate_pool as jax_candidate_pool
from masklab_tpu.ops.roi_align import (
    batched_crop_and_resize as jax_crop_and_resize)
from masklab_tpu.ops.roi_align import crop_and_resize as jax_crop_and_resize_one
from masklab_tpu.serving import postprocess as jpost
from masklab_tpu_torch import load_flax_variables
from masklab_tpu_torch.models.detection import (
    BoxRegressionSubNet, ClassificationSubNet, FeaturePyramid)
from masklab_tpu_torch.models.instance import (
    MaskSubNet, mask_distribute, trim_instances)
from masklab_tpu_torch.models.semantic import ASPPNetwork, SegmentationSubNet
from masklab_tpu_torch.nn.backbone import BackboneNetwork
from masklab_tpu_torch.nn.layers import GroupNorm
from masklab_tpu_torch.ops import boxes as tboxes
from masklab_tpu_torch.ops import morphology as tmorph
from masklab_tpu_torch.ops import nms as tnms
from masklab_tpu_torch.ops import resize as tresize
from masklab_tpu_torch.ops.roi_align import (batched_crop_and_resize,
                                             crop_and_resize)
from masklab_tpu_torch.serving import postprocess as tpost

TOL = dict(atol=1e-4, rtol=1e-4)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def perturb_norms(variables, seed=0):
    """Random GroupNorm/BatchNorm parameters and statistics, so identity
    norms cannot hide a layout or affine error."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        keys = jax.tree_util.keystr(path)
        if 'Norm' in keys or 'norm' in keys:
            if keys.endswith("['scale']") or keys.endswith("['var']"):
                return jnp.asarray(rng.uniform(0.5, 1.5, x.shape), x.dtype)
            return jnp.asarray(rng.uniform(-0.3, 0.3, x.shape), x.dtype)
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


# ---- the port's own copies of the JAX-free modules ----

def test_config_copy_matches_reference():
    from masklab_tpu.config import ModelConfiguration as JaxConfig
    from masklab_tpu_torch.config import ModelConfiguration as TorchConfig
    want = JaxConfig().to_dict()
    assert TorchConfig().to_dict() == want
    assert TorchConfig().from_dict(want).to_dict() == want


@pytest.mark.parametrize('backbone,hw', [('mobilenet', (128, 160)),
                                         ('resnet50', (96, 96))])
def test_prior_copy_matches_reference(backbone, hw):
    from masklab_tpu.config import ModelConfiguration as JaxConfig
    from masklab_tpu.prior import generate_priors as jax_priors
    from masklab_tpu.prior import priors_from_config as jax_table
    from masklab_tpu_torch.prior import generate_priors, priors_from_config
    cfg = JaxConfig()
    cfg.backbone.backbone_type = backbone
    pad = 'valid' if backbone == 'mobilenet' else 'same'
    np.testing.assert_array_equal(
        generate_priors(*hw, priors_from_config(cfg), padding=pad),
        jax_priors(*hw, jax_table(cfg), padding=pad))


# ---- layers ----

@pytest.mark.parametrize('hw,c,g,fuse_relu', [
    (8, 32, 16, False),      # strip view: G | H*W
    (4, 1024, 16, True),
    (7, 32, 16, False),      # ragged: band edges split pixels
    (14, 64, 16, True),
    (2, 32, 32, False),      # ragged with more groups than pixels
])
def test_groupnorm_both_branches(hw, c, g, fuse_relu):
    rng = np.random.RandomState(hw * c)
    x = rng.randn(2, hw, hw, c).astype(np.float32) * 2 + 0.5
    jmod = JaxGroupNorm(g, jnp.float32)
    variables = perturb_norms(jmod.init(jax.random.PRNGKey(0), x))
    want = jmod.apply(variables, np.maximum(x, 0) if fuse_relu else x)
    tmod = bridged(GroupNorm(c, g), variables)
    with torch.no_grad():
        got = tmod(nchw(x), fuse_relu=fuse_relu)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=2e-5)


def test_mobilenet_backbone():
    rng = np.random.RandomState(0)
    images = (rng.rand(2, 128, 128, 3) * 255).astype(np.float32)
    jmod = JaxBackbone(backbone_type='mobilenet', num_features=32)
    variables = perturb_norms(jax.jit(jmod.init)(jax.random.PRNGKey(0),
                                                 images))
    want = jax.jit(jmod.apply)(variables, images)
    tmod = bridged(BackboneNetwork('mobilenet', num_features=32), variables)
    with torch.no_grad():
        got = tmod(torch.from_numpy(images))
    assert sorted(got) == ['C3', 'C4', 'C5', 'P6', 'P7']
    for name in got:
        np.testing.assert_allclose(nhwc(got[name]), np.asarray(want[name]),
                                   err_msg=name, **TOL)


def test_fpn_and_detection_heads():
    """FPN over C3-C5, then the cls/loc heads over FPN outputs + P6/P7 (the
    1x1 P7 and 2x2 P6 maps take the ragged GroupNorm)."""
    rng = np.random.RandomState(1)
    shapes = [(2, 16, 16, 256), (2, 8, 8, 512), (2, 4, 4, 1024)]
    c_maps = [rng.randn(*s).astype(np.float32) for s in shapes]
    extras = [rng.randn(2, 2, 2, 32).astype(np.float32),
              rng.randn(2, 1, 1, 32).astype(np.float32)]
    key = jax.random.PRNGKey(1)
    jfpn = JaxFPN(num_features=32)
    vfpn = jfpn.init(key, c_maps)
    feats = [np.asarray(f) for f in jfpn.apply(vfpn, c_maps)] + extras
    tfpn = bridged(FeaturePyramid([256, 512, 1024], 32), vfpn)
    with torch.no_grad():
        got = tfpn([nchw(x) for x in c_maps])
    for g, w in zip(got, feats):
        np.testing.assert_allclose(nhwc(g), w, **TOL)

    kw = dict(num_depth=1, num_features=32, num_priors=15)
    jcls = JaxClsNet(num_blocks=5, num_classes=5, **kw)
    vcls = perturb_norms(jcls.init(key, feats), 2)
    jloc = JaxBoxNet(num_blocks=5, **kw)
    vloc = perturb_norms(jloc.init(key, feats), 3)
    tcls = bridged(ClassificationSubNet([32] * 5, 5, **kw), vcls)
    tloc = bridged(BoxRegressionSubNet([32] * 5, **kw), vloc)
    with torch.no_grad():
        got_cls = tcls([nchw(f) for f in feats]).numpy()
        got_loc = tloc([nchw(f) for f in feats]).numpy()
    want_cls = np.asarray(jax.jit(jcls.apply)(vcls, feats))
    assert got_cls.shape == want_cls.shape == (2, 15 * (256 + 64 + 16 + 4 + 1),
                                               5)
    np.testing.assert_allclose(got_cls, want_cls, **TOL)
    np.testing.assert_allclose(got_loc,
                               np.asarray(jax.jit(jloc.apply)(vloc, feats)),
                               **TOL)


def test_aspp_and_decoder():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 4, 4, 64).astype(np.float32)
    skip = rng.randn(2, 16, 16, 48).astype(np.float32)
    key = jax.random.PRNGKey(2)
    jaspp = JaxASPP(num_features=32)
    vaspp = perturb_norms(jaspp.init(key, x), 4)
    aspp_out = np.asarray(jaspp.apply(vaspp, x))
    jseg = JaxSegNet(num_classes=3, num_depth=1, num_features=32,
                     num_skip_features=32)
    vseg = perturb_norms(jseg.init(key, aspp_out, skip), 5)
    want = np.asarray(jseg.apply(vseg, aspp_out, skip))
    taspp = bridged(ASPPNetwork(64, 32), vaspp)
    tseg = bridged(SegmentationSubNet(32, 48, 3, 1, 32, 32), vseg)
    with torch.no_grad():
        got_aspp = taspp(nchw(x))
        got = tseg(nchw(aspp_out), nchw(skip))
    np.testing.assert_allclose(nhwc(got_aspp), aspp_out, **TOL)
    np.testing.assert_allclose(nhwc(got), want, **TOL)


# ---- instance branch ----

def _boxes(rng, b, k, size=128):
    """(cx, cy, w, h, class, conf) rows spanning all three mask levels,
    partly outside the image, the last two rows -1 padding."""
    cxcy = rng.uniform(-10, size + 10, (b, k, 2))
    wh = np.exp(rng.uniform(np.log(8), np.log(400), (b, k, 2)))
    rows = np.concatenate([cxcy, wh, rng.randint(0, 5, (b, k, 1)),
                           rng.uniform(0.5, 1, (b, k, 1))], -1)
    rows[:, -2:] = -1.0
    return rows.astype(np.float32)


def test_crop_and_resize():
    rng = np.random.RandomState(3)
    fmap = rng.randn(2, 16, 12, 8).astype(np.float32)
    boxes = rng.uniform(-0.3, 1.2, (2, 9, 4)).astype(np.float32)
    want = np.asarray(jax_crop_and_resize(fmap, boxes, (14, 14)))
    got = batched_crop_and_resize(torch.from_numpy(fmap),
                                  torch.from_numpy(boxes), (14, 14)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    one = crop_and_resize(torch.from_numpy(fmap[1]),
                          torch.from_numpy(boxes[1]), (7, 5)).numpy()
    np.testing.assert_allclose(
        one, np.asarray(jax_crop_and_resize_one(fmap[1], boxes[1], (7, 5))),
        atol=1e-5)


def test_mask_subnet_compact():
    """Each level's head on its own boxes, masks written back by index,
    equals the reference's capacity-bucketed compact path."""
    rng = np.random.RandomState(4)
    feats = [rng.randn(2, s, s, 32).astype(np.float32) for s in (16, 8, 4)]
    boxes = _boxes(rng, 2, 12)
    levels = jax_mask_distribute(jnp.asarray(boxes), 2, 36)
    np.testing.assert_array_equal(
        mask_distribute(torch.from_numpy(boxes), 2, 36).numpy(),
        np.asarray(levels))
    assert set(np.asarray(levels).ravel()) == {-1, 0, 1, 2}
    jmod = JaxMaskSubNet(num_blocks=3, num_classes=5, num_depth=1,
                         num_features=32)
    args = (feats, boxes, levels, (128, 128), (14, 14))
    variables = perturb_norms(jmod.init(jax.random.PRNGKey(4), *args,
                                        method=JaxMaskSubNet.compact), 6)
    want = np.asarray(jax.jit(
        lambda v, f, b, lv: jmod.apply(v, f, b, lv, (128, 128), (14, 14),
                                       method=JaxMaskSubNet.compact))(
        variables, feats, boxes, levels))
    tmod = bridged(MaskSubNet([32] * 3, 5, 1, 32), variables)
    with torch.no_grad():
        got = tmod([nchw(f) for f in feats], torch.from_numpy(boxes),
                   torch.from_numpy(np.array(levels)).long(), (128, 128),
                   (14, 14)).numpy()
    assert got.shape == (2, 12, 28, 28, 5)
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[:, -2:].any()


def test_trim_instances():
    rng = np.random.RandomState(5)
    boxes = _boxes(rng, 2, 6)
    masks = rng.rand(2, 6, 28, 28, 5).astype(np.float32)
    _, want = jax_trim_instances(jnp.asarray(boxes), jnp.asarray(masks))
    _, got = trim_instances(torch.from_numpy(boxes), torch.from_numpy(masks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- NMS ----

def _scores(rng, b, c, n, floor=0.5):
    s = rng.rand(b, c, n).astype(np.float32)
    return np.where(s >= floor, s, -1.0).astype(np.float32)


def _pool_pair(scores, k, floor):
    want_v, want_i = jax_candidate_pool(jnp.asarray(scores), k, floor=floor,
                                        sort_below=0)
    got_v, got_i = tnms.candidate_pool(torch.from_numpy(scores), k,
                                       floor=floor, sort_below=0)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_candidate_pool_segment_path():
    """n of a few thousand with sort_below=0: the strided segment top-k and
    the certificate, which passes here. Exact, dead slots included."""
    rng = np.random.RandomState(6)
    scores = _scores(rng, 2, 3, 3000)
    # bf16-like quantization: thousands of exact ties
    scores = np.where(scores > 0, np.round(scores * 128) / 128, scores)
    before = tnms.pool_fallbacks
    _pool_pair(scores.astype(np.float32), 64, 0.5)
    assert tnms.pool_fallbacks == before


def test_candidate_pool_transposed_cls_pred_view():
    """The main path's call form: the masked scores are the [B, C, N]
    transpose of a contiguous [B, N, C] cls_pred (strides (N*C, 1, C)),
    which K2 reads in place; n is not a multiple of 128 and class 2 has
    fewer valid anchors than k. Exact, dead slots included."""
    rng = np.random.RandomState(9)
    b, n, c, k, floor = 2, 3000, 3, 64, 0.5
    cls = 1 / (1 + np.exp(-(1.5 + 0.3 * rng.randn(b, n, c))))
    cls[..., 2] *= np.where(rng.rand(b, n) < 0.01, 1.0, 0.3)
    cls = np.round(cls.astype(np.float32) * 256) / 256       # exact ties
    scores_t = torch.from_numpy(cls.astype(np.float32)).transpose(1, 2)
    masked = torch.where(scores_t >= floor, scores_t,
                         torch.full_like(scores_t, -1.0))
    assert masked.stride() == (n * c, 1, c)
    before = tnms.pool_fallbacks
    got_v, got_i = tnms.candidate_pool(masked, k, floor=floor, sort_below=0)
    assert tnms.pool_fallbacks == before
    want_v, want_i = jax_candidate_pool(jnp.asarray(masked.numpy()), k,
                                        floor=floor, sort_below=0)
    assert (got_v.numpy() == -1).any()
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_candidate_pool_certificate_failure_falls_back():
    """The top 40 scores of one row all sit in segment 5: the segment keeps
    16 of them, the certificate fails and the exact top-k answers."""
    rng = np.random.RandomState(7)
    scores = _scores(rng, 1, 2, 3000, floor=0.5) * 0.5
    s = -(-3000 // 128)
    scores[0, 1, 5 + s * np.arange(40)] = np.linspace(0.99, 0.9, 40)
    before = tnms.pool_fallbacks
    _pool_pair(scores.astype(np.float32), 32, 0.25)
    assert tnms.pool_fallbacks == before + 1


@pytest.mark.parametrize('n', [3000, 40000])
def test_class_aware_nms_exact(n):
    """Both NMS stages fed the same scores and boxes. n=40000 takes the
    segment pool (above sort_below), n=3000 the exact top-k."""
    rng = np.random.RandomState(n)
    b, c = 2, 3
    centers = rng.uniform(0, 512, (b, 30, 2))
    pick = rng.randint(0, 30, (b, n))
    cxcy = np.take_along_axis(centers, pick[..., None].repeat(2, -1), 1)
    boxes = np.concatenate([cxcy + rng.normal(0, 5, (b, n, 2)),
                            rng.uniform(20, 80, (b, n, 2))], -1)
    cls = 1 / (1 + np.exp(-(1.5 + 0.3 * rng.randn(b, n, c))))
    cls, boxes = cls.astype(np.float32), boxes.astype(np.float32)
    kw = dict(min_confidence=0.5, nms_iou_threshold=0.4,
              post_iou_threshold=0.6, max_outputs=100,
              candidates_per_class=256)
    want = np.asarray(jax_nms(jnp.asarray(cls), jnp.asarray(boxes), **kw))
    got = tnms.batched_class_aware_nms(torch.from_numpy(cls),
                                       torch.from_numpy(boxes), **kw).numpy()
    assert (want[..., 4] >= 0).sum() == b * 100
    np.testing.assert_array_equal(got, want)


# ---- small ops ----

@pytest.mark.parametrize('out_hw,align', [((23, 17), True), ((23, 17), False),
                                          ((5, 9), True), ((5, 9), False)])
def test_resize_bilinear(out_hw, align):
    x = np.random.RandomState(8).randn(2, 11, 13, 3).astype(np.float32)
    want = np.asarray(jresize.resize_bilinear(x, *out_hw, align_corners=align))
    got = tresize.resize_bilinear(torch.from_numpy(x), *out_hw,
                                  align_corners=align).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_box_ops():
    rng = np.random.RandomState(9)
    loc = rng.randn(2, 50, 4).astype(np.float32) * 0.3
    priors = np.abs(rng.randn(50, 4).astype(np.float32)) * 40 + 1
    want = np.array(jboxes.decode_boxes(loc, priors))
    got = tboxes.decode_boxes(torch.from_numpy(loc), torch.from_numpy(priors))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    for hw in (None, (96, 120)):
        np.testing.assert_array_equal(
            tboxes.cxcywh_to_yxyx(torch.from_numpy(want), hw).numpy(),
            np.asarray(jboxes.cxcywh_to_yxyx(want, hw)))
    yxyx = np.array(jboxes.cxcywh_to_yxyx(want))
    np.testing.assert_array_equal(
        tboxes.iou_yxyx(torch.from_numpy(yxyx), torch.from_numpy(yxyx)).numpy(),
        np.asarray(jboxes.iou_yxyx(yxyx, yxyx)))


@pytest.mark.parametrize('k,w', [(0, 1.0), (3, 0.8), (4, 1.0)])
def test_semantic_smoothing(k, w):
    x = np.random.RandomState(10).rand(2, 15, 12, 3).astype(np.float32)
    want = np.asarray(jpost.smooth_semantics(x, (k, 0, k), (w, 1.0, w)))
    got = tpost.smooth_semantics(torch.from_numpy(x), (k, 0, k), (w, 1.0, w))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tmorph.erode(torch.from_numpy(x), 3).numpy(),
        np.asarray(jmorph.erode(x, 3)))


def test_upsample_and_paste():
    """upsample_output exact on identical inputs; the full-frame paste
    within 1e-5 (its matmuls sum in another order)."""
    rng = np.random.RandomState(11)
    boxes = _boxes(rng, 2, 6, size=96)
    masks = (rng.rand(2, 6, 28, 28) > 0.5).astype(np.float32)
    sem = rng.rand(2, 96, 120, 3).astype(np.float32)
    want = [np.array(a) for a in jpost.upsample_output(
        boxes, masks, sem, (96, 120), (72, 90))]
    got = [a.numpy() for a in tpost.upsample_output(
        torch.from_numpy(boxes), torch.from_numpy(masks),
        torch.from_numpy(sem), (96, 120), (72, 90))]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[2] != want[2]).mean() < 1e-3      # threshold of resampled
    pasted = tpost.crop_and_pad_masks(torch.from_numpy(want[0]),
                                      torch.from_numpy(want[1]), (72, 90))
    np.testing.assert_allclose(
        pasted.numpy(),
        np.asarray(jpost.crop_and_pad_masks(want[0], want[1], (72, 90))),
        atol=1e-5)
