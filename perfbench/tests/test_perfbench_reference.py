"""The plain reference against the program, at a small size on the CPU,
for each configuration and for resnet50's with the efficientnetb4 body at
its own widths: with both in float32 the forward (raw heads, proposals,
masks) and the analytics rows agree to rounding, and so do the training
cell's steps."""
import copy

import numpy as np
import pytest
import torch

from perfbench.harness import frames
from perfbench.harness.main import Context
from perfbench.reference import pipeline
from perfbench.tests import small


@pytest.mark.parametrize('name', ['road-seresnet34-bf16', 'resnet50-bf16',
                                  'resnet50-bf16:efficientnetb4'])
def test_reference_equals_program_in_float32(name):
    """``<configuration>:<body>`` swaps the configuration's body."""
    from masklab_tpu_torch.config import ModelConfiguration
    from masklab_tpu_torch.models.masklab import MaskLab
    from masklab_tpu_torch.serving.predictor import MaskLabPredictor
    name, _, body = name.partition(':')
    config = small.small_config(name)
    if body:
        config['model']['backbone']['backbone_type'] = body
    model_dict = copy.deepcopy(config['model'])
    model_dict['compute']['compute_dtype'] = 'float32'
    ctx = Context({}, config, {}, 2 ** 31 + 7, 1.0, False, 'cpu')
    state = ctx.weights()
    ctx.close()
    port = MaskLab(ModelConfiguration().from_dict(copy.deepcopy(model_dict)))
    port.load_state_dict(state)
    predictor = MaskLabPredictor(port, port.config, device='cpu')
    ref = pipeline.build(model_dict, state, 'cpu')
    cfg = pipeline.config(model_dict)
    rng = np.random.default_rng(3)
    batch = np.stack([frames.road_frame(rng, small.FRAME_HW, 3.0)
                      for _ in range(2)])
    kept = {}
    hook = predictor.model.register_forward_hook(
        lambda m, a, o: kept.update(o, down=a[0]))
    got = predictor.predict(batch, 'summarize')
    hook.remove()
    with torch.no_grad():
        images = torch.from_numpy(batch)
        down, _, _ = pipeline.downsample(images, cfg)
        out = ref(down)
        post = pipeline.postprocess(out, images, down, cfg)
    torch.testing.assert_close(kept['down'], down, rtol=0, atol=0)
    for k in ('cls_pred', 'loc_pred', 'seg_pred', 'roi_masks'):
        torch.testing.assert_close(kept[k], out[k], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(kept['roi_boxes'], out['roi_boxes'],
                               rtol=1e-5, atol=1e-4)
    assert (out['roi_boxes'][..., 4] >= 0).sum() > 0
    np.testing.assert_allclose(got['summarize'], post['summarize'].numpy(),
                               rtol=1e-4, atol=1e-3)


def test_reference_train_step_equals_program_in_float32():
    """Two of the program's train steps (the 'all' phase's optimizer) and
    the reference's on the same batches, both in float32, the program's
    loss-NMS proposals replayed: the losses, the first gradient and the
    change agree to rounding."""
    from masklab_tpu_torch.config import ModelConfiguration
    from masklab_tpu_torch.data.synthetic import make_random_batch
    from masklab_tpu_torch.models import masklab as masklab_module
    from masklab_tpu_torch.models.masklab import MaskLab
    from masklab_tpu_torch.train import TrainState, rectified_adam
    from masklab_tpu_torch.train.optimizers import cyclic_lr
    from masklab_tpu_torch.train.steps import as_batch, make_train_step
    from perfbench.reference import train
    config = small.small_train_config()
    model_dict = copy.deepcopy(config['model'])
    model_dict['compute']['compute_dtype'] = 'float32'
    ctx = Context({}, config, {}, 2 ** 31 + 8, 1.0, False, 'cpu')
    state0 = ctx.weights()
    ctx.close()
    model = MaskLab(ModelConfiguration().from_dict(copy.deepcopy(model_dict)))
    model.load_state_dict(state0)
    lr = dict(base=1e-5, max=1e-4, step_size=700)
    state = TrainState(model, rectified_adam(cyclic_lr(
        lr['base'], lr['max'], lr['step_size'])))
    step = make_train_step(model, with_metrics=False)
    batches = [as_batch(make_random_batch(2, (128, 192), seed=s), 'cpu')
               for s in (1, 2)]
    proposals, losses = [], []
    nms = masklab_module.batched_class_aware_nms

    def kept(*args, **kwargs):
        out = nms(*args, **kwargs)
        proposals.append(out.clone())
        return out
    masklab_module.batched_class_aware_nms = kept
    try:
        start = {k: p.detach().clone() for k, p in state.params.items()}
        for i, batch in enumerate(batches):
            state, metrics = step(state, batch)
            losses.append(float(metrics['loss']))
            if i == 0:
                grad1 = {k: float((v / 0.1).double().norm())
                         for k, v in state.opt_state.mu.items()}
    finally:
        masklab_module.batched_class_aware_nms = nms
    change = {k: float((p.detach() - start[k]).double().norm())
              for k, p in state.params.items()}
    ref = train.run_steps(model_dict, state0, batches, proposals, lr, 'cpu')
    np.testing.assert_allclose(losses, ref['losses'], rtol=1e-4)
    stats = train.stat_changes(state0, dict(model.named_buffers()))
    gaps = train.step_gaps(dict(losses=losses, grad1=grad1, change=change,
                                stats=stats, box=state.box_loss_state),
                           ref, model_dict['loss']['box_loss_beta'])
    for name in ('grad_gap', 'change_gap', 'grad_group_gap',
                 'change_group_gap', 'stats_gap', 'box_gap'):
        assert gaps[name] < 1e-3, gaps
