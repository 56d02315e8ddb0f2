"""The port's fused mask head against the JAX package's.

``FusedMaskSubNet`` and ``select_crops_by_level`` at narrow widths (16
features, depth 2, 3 levels, some boxes at level -1), then the narrow
mobilenet MaskLab with ``compute.fused_mask_head`` set: its forward, its
mask branch staged in float32 and in bf16, and one train step's gradients.
The same seeded numpy inputs and flax variables (through the weight bridge)
go to both sides, on the CPU. Each check states its tolerance.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as flax_nn

from masklab_tpu import ModelConfiguration as JaxConfig
from masklab_tpu.data.synthetic import make_random_batch as jax_random_batch
from masklab_tpu.models import MaskLab as JaxMaskLab
from masklab_tpu.models import build_masklab as jax_build
from masklab_tpu.models import fused_mask_head as jax_fused_module
from masklab_tpu.models.fused_mask_head import (
    FusedMaskSubNet as JaxFused, select_crops_by_level as jax_select)
from masklab_tpu.train import TrainState as JaxTrainState
from masklab_tpu.train import make_train_step as jax_train_step
from masklab_tpu.train import optimizers as jopt
import masklab_tpu_torch as mt
from masklab_tpu_torch import train as ttrain
from masklab_tpu_torch.data import make_random_batch
from masklab_tpu_torch.models.fused_mask_head import (FusedMaskSubNet,
                                                      select_crops_by_level)
from masklab_tpu_torch.weights import flax_names, to_flax_tree

LEVELS = np.array([[0, 2, 1, 0, -1], [1, 1, -1, 2, 0]], np.int32)
# bf16 outputs are sigmoids in (0, 1): half a bf16 ulp at 0.5-1 is 2e-3.
# The port at the reference's promotion sits ~3e-4 from it; computing every
# layer in bf16 instead would sit ~9e-3 away.
BF16_ATOL = 2e-3


@pytest.fixture(scope='module', autouse=True)
def torch_threads():
    """Two intra-op threads, as tests/test_torch_train.py: JAX's 8-device
    CPU tests beside this file starve otherwise."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


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


def assert_trees_close(got, want, rel, what=''):
    """Same paths; each leaf within ``rel`` x its own largest |value|."""
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want), what
    for path, w in want.items():
        err = np.abs(got[path] - w).max() if w.size else 0.0
        assert err <= rel * np.abs(w).max(), f'{what} {"/".join(path)}: {err}'


def on_crops(tm, crops, levels):
    """The port's head on the JAX head's inputs: crops [B, K, h, w, Cin]
    (each box's own level's crop), levels [B, K] -> [B, K, 2h, 2w, classes],
    each level's boxes through ``tm.head(level, .)``, zeros for level -1."""
    b, k, h, w, cin = crops.shape
    flat_crops = crops.reshape(b * k, h, w, cin)
    flat_levels = levels.reshape(-1)
    out = torch.zeros((b * k, 2 * h, 2 * w, tm.num_classes))
    for level in range(tm.num_levels):
        idx = torch.nonzero(flat_levels == level)[:, 0]
        out = out.index_put(
            (idx,), tm.head(level, flat_crops[idx].permute(0, 3, 1, 2))
            .permute(0, 2, 3, 1))
    return out.reshape(b, k, 2 * h, 2 * w, tm.num_classes)


def head_case(dtype, seed=0):
    """A JAX fused head (16 features, depth 2, 3 levels, 8 groups, 12 input
    channels, 4 classes) with random variables, its crops and levels, and
    the port's head holding the same variables."""
    rng = np.random.RandomState(seed)
    jm = JaxFused(num_levels=3, num_classes=4, num_depth=2, num_features=16,
                  groups=8, dtype=getattr(jnp, dtype))
    crops = rng.randn(2, 5, 7, 7, 12).astype(np.float32)
    variables = numpy_tree(jm.init(jax.random.PRNGKey(0), crops, LEVELS))
    variables = jax.tree_util.tree_map(
        lambda x: (x + 0.3 * rng.randn(*x.shape)).astype(np.float32),
        variables)
    tm = FusedMaskSubNet(3, 12, 4, 2, 16, 8, getattr(torch, dtype))
    mt.load_flax_variables(tm, variables)
    return jm, variables, crops, tm


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_fused_head_matches_jax(dtype):
    """float32 within 1e-5; bf16, where the port keeps the reference's
    promotion (the first conv in bf16, the rest in float32 with
    bf16-rounded weights), within BF16_ATOL. Level -1 boxes give zeros."""
    jm, variables, crops, tm = head_case(dtype)
    want = np.asarray(jm.apply(variables, crops, LEVELS))
    with torch.no_grad():
        got = on_crops(tm, torch.from_numpy(crops),
                       torch.from_numpy(LEVELS).long()).numpy()
    assert got.shape == want.shape == (2, 5, 14, 14, 4)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 if dtype == 'float32' else BF16_ATOL)
    assert not got[LEVELS < 0].any()


def test_fused_head_parameter_gradients_match_jax():
    """The gradients of a random projection of the masks w.r.t. every
    parameter (and the crops), float32, against ``jax.grad``: each within
    1e-5 of its own largest entry. Level -1 boxes' crops get none."""
    jm, variables, crops, tm = head_case('float32', seed=1)
    proj = np.random.RandomState(2).randn(2, 5, 14, 14, 4).astype(np.float32)

    def objective(params, x):
        return jnp.sum(jm.apply({'params': params}, x, LEVELS) * proj)
    jgrads, jgx = jax.grad(objective, argnums=(0, 1))(variables['params'],
                                                      crops)
    x = torch.from_numpy(crops).requires_grad_()
    (on_crops(tm, x, torch.from_numpy(LEVELS).long())
     * torch.from_numpy(proj)).sum().backward()
    grads = to_flax_tree(tm, {k: p.grad for k, p in tm.named_parameters()})
    assert_trees_close(grads['params'], numpy_tree(jgrads), 1e-5, 'grads')
    assert_trees_close({'x': x.grad.numpy()}, {'x': np.asarray(jgx)}, 1e-5,
                       'crop grads')
    assert not x.grad.numpy()[LEVELS < 0].any()


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_select_crops_by_level_exact(dtype):
    rng = np.random.RandomState(3)
    per_level = [rng.randn(2, 5, 4, 4, 3).astype(np.float32)
                 for _ in range(3)]
    want = np.asarray(jax_select([jnp.asarray(p, getattr(jnp, dtype))
                                  for p in per_level], LEVELS)
                      .astype(jnp.float32))
    got = select_crops_by_level(
        [torch.from_numpy(p).to(getattr(torch, dtype)) for p in per_level],
        torch.from_numpy(LEVELS).long()).float().numpy()
    np.testing.assert_array_equal(got, want)


def small(cfg, dtype='float32'):
    """tests/test_torch_slice.py's narrow mobilenet model, fused head."""
    cfg.backbone.backbone_type = 'mobilenet'
    cfg.backbone.num_features = 32
    cfg.detection.num_features = 32
    cfg.detection.num_depth = 1
    cfg.detection.nms_max_output_size = 20
    cfg.instance.num_features = 32
    cfg.instance.num_depth = 1
    cfg.semantic.num_aspp_features = 32
    cfg.semantic.num_features = 32
    cfg.semantic.num_depth = 1
    cfg.compute.nms_candidates_per_class = 64
    cfg.compute.fused_mask_head = True
    cfg.compute.compute_dtype = dtype
    return cfg


def randomized(variables, rng):
    """Forced dense (every class-output bias 2.0), norms away from the
    identity, the fused head's kernels 10x their init scale (so its masks
    are not all sigmoid(0))."""
    def leaf(path, x):
        keys = jax.tree_util.keystr(path)
        if 'cls_subnet' in keys and 'output_' in keys and 'bias' in keys:
            return x * 0.0 + 2.0
        if 'Norm' in keys or 'norm' in keys or "['gn" in keys:
            lo, hi = ((0.5, 1.5) if keys.endswith(("scale']", "['var']"))
                      else (-0.3, 0.3))
            return jnp.asarray(rng.uniform(lo, hi, x.shape), x.dtype)
        if 'mask_subnet' in keys and keys.endswith("_kernel']"):
            return x * 10.0
        return x
    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture(scope='module')
def models():
    jcfg, tcfg = small(JaxConfig()), small(mt.ModelConfiguration())
    jmodel = jax_build(jcfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 128, 128, 3)))
    variables = randomized(variables, np.random.RandomState(0))
    tmodel = mt.MaskLab(tcfg)
    mt.load_flax_variables(tmodel, numpy_tree(variables))
    return jcfg, jmodel, variables, tcfg, tmodel.eval()


def test_fused_head_bridge_names_and_init():
    """The fused head's parameters are named as flax names them
    (``mask_subnet/conv0_kernel`` ...) and initialised as flax does:
    kernels normal(0.01), biases zero, GroupNorm scales one."""
    model = mt.MaskLab(small(mt.ModelConfiguration()))
    assert isinstance(model.mask_subnet, FusedMaskSubNet)
    names = flax_names(model)
    assert names['mask_subnet.conv0_kernel'] == (
        'params', ('mask_subnet', 'conv0_kernel'))
    assert model.mask_subnet.conv0_kernel.shape == (3, 3, 3, 32, 32)
    mt.init_weights(model, 0)
    head = model.mask_subnet
    assert head.gn0_scale.eq(1).all() and not head.conv0_bias.any()
    assert 0.009 < head.deconv_kernel.std() < 0.011


def test_fused_masklab_end_to_end(models):
    """``MaskLab.__call__`` of the narrow fused model, float32, 128 px:
    heads and masks within 1e-4, boxes within 1e-3 px (as
    tests/test_torch_slice.py holds the per-level model)."""
    jcfg, jmodel, variables, _, tmodel = models
    x = np.random.RandomState(1).randint(0, 256, (2, 128, 128, 3)).astype(
        np.float32)
    want = numpy_tree(jax.jit(jmodel.apply)(variables, x))
    with torch.no_grad():
        got = {k: v.numpy() for k, v in tmodel(torch.from_numpy(x)).items()}
    for k in ('cls_pred', 'loc_pred', 'seg_pred'):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    assert (got['roi_boxes'][..., 4] >= 0).all()
    np.testing.assert_allclose(got['roi_boxes'], want['roi_boxes'],
                               atol=1e-3, rtol=1e-5)
    assert got['roi_masks'].shape == (2, 20, 28, 28, 5)
    assert got['roi_masks'].std() > 0.01
    np.testing.assert_allclose(got['roi_masks'], want['roi_masks'],
                               atol=1e-4, rtol=1e-4)


def mask_branch_inputs(seed):
    """Feature maps at the P3-P5 shapes of a 128 px input and boxes on
    every level, then -1 rows."""
    rng = np.random.RandomState(seed)
    feats = [rng.randn(2, 128 // s, 128 // s, 32).astype(np.float32)
             for s in (8, 16, 32)]
    boxes = np.full((2, 10, 6), -1.0, np.float32)
    for i, size in enumerate((20.0, 50.0, 110.0, 30.0, 180.0, 15.0, 80.0)):
        boxes[:, i] = [64.0 + i, 60.0 - i, size, size * 0.8, i % 5, 0.5]
    return feats, boxes


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_fused_mask_branch_staged(models, dtype):
    """The mask branch fed the same features and boxes: float32 within
    1e-4; the bf16 model (features in bf16, the reference's promotion)
    within BF16_ATOL. Dead rows are zero."""
    _, _, variables, _, _ = models
    jcfg = small(JaxConfig(), dtype)
    jmodel = jax_build(jcfg)
    tmodel = mt.MaskLab(small(mt.ModelConfiguration(), dtype))
    mt.load_flax_variables(tmodel, numpy_tree(variables))
    feats, boxes = mask_branch_inputs(4)
    jdt = getattr(jnp, dtype)
    want = np.asarray(jax.jit(lambda v, f, b: jmodel.apply(
        v, f, b, (128, 128), method=JaxMaskLab.mask_branch))(
        variables, [jnp.asarray(f, jdt) for f in feats], jnp.asarray(boxes)))
    tfeats = [torch.from_numpy(f.transpose(0, 3, 1, 2)).to(
        getattr(torch, dtype)).contiguous(memory_format=torch.channels_last)
        for f in feats]
    with torch.no_grad():
        got = tmodel.eval().mask_branch(tfeats, torch.from_numpy(boxes),
                                        (128, 128)).numpy()
    atol = 1e-4 if dtype == 'float32' else BF16_ATOL
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    assert not got[boxes[..., 0] == -1.0].any()


def test_fused_trainer_mask_branch_staged(models):
    """The trainer's mask branch of the fused model fed the same feature
    maps and boxes (gts, proposals on every level, -1 rows): the gradient of
    a random projection of the masks w.r.t. every fused-head parameter and
    every feature map within 1e-5 of its own largest entry."""
    jcfg, jmodel, variables, _, tmodel = models
    feats, boxes = mask_branch_inputs(5)
    proj = np.random.RandomState(6).randn(2, 10, 28, 28, 5).astype(
        np.float32)

    def objective(params, features):
        return jnp.sum(jmodel.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            features, jnp.asarray(boxes), (128, 128),
            method=JaxMaskLab.mask_branch) * proj)
    jgrads, jfeat = jax.jit(jax.grad(objective, argnums=(0, 1)))(
        variables['params'], [jnp.asarray(f) for f in feats])
    model = copy.deepcopy(tmodel)
    tfeats = [torch.from_numpy(f.transpose(0, 3, 1, 2)).contiguous(
        memory_format=torch.channels_last).requires_grad_() for f in feats]
    (model.mask_branch(tfeats, torch.from_numpy(boxes), (128, 128))
     * torch.from_numpy(proj)).sum().backward()
    grads = to_flax_tree(model, {k: p.grad for k, p in
                                 model.mask_subnet.named_parameters(
                                     prefix='mask_subnet')})
    assert_trees_close(grads['params']['mask_subnet'],
                       numpy_tree(jgrads['mask_subnet']), 1e-5, 'head grads')
    for t, w in zip(tfeats, jfeat):
        assert_trees_close({'g': t.grad.permute(0, 2, 3, 1).numpy()},
                           {'g': np.asarray(w)}, 1e-5, 'feature grads')


def record_jax_relu_gates(monkeypatch):
    """Within the block, the JAX fused head records the sign of every ReLU
    input (``x > 0``, [B*K, h, w, F] numpy, in call order) into the list
    returned, from inside a jitted step too."""
    gates = []

    class Recording:
        def __getattr__(self, name):
            return getattr(flax_nn, name)

        @staticmethod
        def relu(x):
            jax.debug.callback(lambda g: gates.append(np.asarray(g)),
                               x > 0, ordered=True)
            return flax_nn.relu(x)
    monkeypatch.setattr(jax_fused_module, 'nn', Recording())
    return gates


def replay_relu_gates(monkeypatch, gates):
    """The port's fused head, within the block, gates each ReLU input by the
    JAX head's recorded sign (``record_jax_relu_gates``) instead of its
    own, taking the rows of the boxes each level's call runs."""
    forward, head, relu = (FusedMaskSubNet.forward, FusedMaskSubNet.head,
                           torch.relu)
    levels = []

    def recorded_forward(self, features, boxes, lv, *args):
        levels.append(lv.reshape(-1).numpy())
        return forward(self, features, boxes, lv, *args)

    def replayed_head(self, level, x):
        rows = np.nonzero(levels[-1] == level)[0]
        own = iter([torch.from_numpy(g[rows]).permute(0, 3, 1, 2)
                    for g in gates])
        monkeypatch.setattr(torch, 'relu', lambda t: torch.where(
            next(own), t, torch.zeros_like(t)))
        try:
            out = head(self, level, x)
        finally:
            monkeypatch.setattr(torch, 'relu', relu)
        assert next(own, None) is None, 'fewer ReLUs than the JAX head'
        return out
    monkeypatch.setattr(FusedMaskSubNet, 'forward', recorded_forward)
    monkeypatch.setattr(FusedMaskSubNet, 'head', replayed_head)
    return levels


def test_fused_train_step_gradients(models, monkeypatch):
    """One train step of the narrow fused model at 128 px from the same
    flax init and ``make_random_batch`` batch in each package: the loss
    terms within 1e-5 relative, and each gradient (read as the step's first
    moment, (1 - b1) * g on both sides) within tests/test_torch_train.py's
    first-step tolerances: 2e-3 of its own largest entry for the heads, the
    fused head's included, 5e-2 of the largest backbone gradient for the
    backbone. The fused head's ReLUs take the JAX step's decisions
    (``replay_relu_gates``): a ReLU input within float error of 0 is
    decided either way by float32 sums of another order, and at this init
    one deconv ReLU input, 4.4e-7 from 0 in a float64 run, is decided the
    other way by the port's float32 step; that single flip moves
    deconv_kernel's gradient by 8.4e-3 of its largest entry (the port's
    float32 step with the float64 run's gates sits within 7.4e-5 of it).
    The proposals, mask targets and masks are the same on both sides
    without any replay. The BatchNorms stay at their init: moved off the
    identity, train-mode BatchNorm over the 4x4 C5 maps of two images
    carries f32 cancellation into the ASPP's gradients beyond 2e-3."""
    jcfg, jmodel, _, tcfg, _ = models
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 128, 128, 3)))
    batch = make_random_batch(2, (128, 128), 4, seed=0)
    jbatch = {k: jnp.asarray(v) for k, v in
              jax_random_batch(2, (128, 128), 4, seed=0).items()}
    jstate = JaxTrainState.create(variables, jopt.rectified_adam(
        jopt.cyclic_lr(1e-4, 1e-3, 700)))
    gates = record_jax_relu_gates(monkeypatch)
    jstate, jm = jax_train_step(jmodel, with_metrics=False)(jstate, jbatch)
    jax.effects_barrier()
    assert len(gates) == tcfg.instance.num_depth + 1
    tmodel = mt.MaskLab(tcfg)
    mt.load_flax_variables(tmodel, numpy_tree(variables))
    tstate = ttrain.TrainState(tmodel, ttrain.rectified_adam(
        ttrain.cyclic_lr(1e-4, 1e-3, 700)))
    tstep = ttrain.make_train_step(tmodel, with_metrics=False)
    levels = replay_relu_gates(monkeypatch, gates)
    tstate, tm = tstep(tstate, ttrain.as_batch(batch, 'cpu'))
    assert len(levels) == 1 and (levels[0] >= 0).sum() > 0
    for k, v in jm.items():
        assert float(tm[k]) == pytest.approx(float(v), rel=1e-5), k
    tmu = to_flax_tree(tmodel, tstate.opt_state.mu)['params']
    jmu = numpy_tree(jstate.opt_state.mu)
    assert np.abs(tmu['mask_subnet']['conv0_kernel']).max() > 0
    heads = [k for k in jmu if k != 'backbone']
    assert_trees_close({k: tmu[k] for k in heads},
                       {k: jmu[k] for k in heads}, 2e-3, 'head grads')
    tb, jb = flat(tmu['backbone']), flat(jmu['backbone'])
    scale = max(np.abs(w).max() for w in jb.values())
    for path, w in jb.items():
        assert np.abs(tb[path] - w).max() <= 5e-2 * scale, path
