"""The port's serving runtime against the JAX package: drawing, analytics,
the fused paste, the predictor's three modes, micro-batching, the HTTP and
gRPC servers and process_folder. CPU, float32, small shapes.

Tolerances, each stated where it is used: drawing exact; the analytics
columns that do not depend on the my_road edge fit exact or within float32
summation order; the columns scaled by the edge fit (size, horizontal,
vertical) rtol 5e-4. The fit solves 2x2 normal equations in float32 whose
determinant cancels, and XLA evaluates those expressions in another order
than PyTorch: metres per pixel measured 6.5e-5 (96x128) and 2.6e-4
(512x512) apart relatively on the my_road trapezoid.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from masklab_tpu.ops.resize import resize_bilinear as jax_resize
from masklab_tpu.serving import postprocess as jpost
from masklab_tpu.serving import summary as jsum
from masklab_tpu.serving import visualize as jvis
from masklab_tpu.serving.predictor import MaskLabPredictor as JaxPredictor
import masklab_tpu_torch as mt
from masklab_tpu_torch.serving import (MaskLabGrpcServer, MaskLabServer,
                                       process_folder, send_image_to_grpc,
                                       send_image_to_server)
from masklab_tpu_torch.serving import postprocess as tpost
from masklab_tpu_torch.serving import summary as tsum
from masklab_tpu_torch.serving import visualize as tvis
from masklab_tpu_torch.serving.batching import (MicroBatcher, _next_bucket,
                                                default_buckets)
from masklab_tpu_torch.serving.predictor import (decode_image_bytes,
                                                 summary_to_records)
from test_torch_slice import models  # noqa: F401 - the shared fixture

C = 6                      # instance classes of the analytics fixtures
FIT_RTOL = 5e-4            # columns scaled by the my_road edge fit
SUM_ATOL = 1e-3


def road_scene(b, h, w, k, mask_size, seed, *, noisy=False):
    """Detection rows, RoI masks and binarized semantics: the my_road
    trapezoid and crack patch of tests/test_fused_paste.py:17-42, with
    integer boxes, two padded rows per image and mixed confidences."""
    rng = np.random.RandomState(seed)
    det = np.stack([rng.rand(b, k) * w, rng.rand(b, k) * h,
                    rng.rand(b, k) * 40 + 4, rng.rand(b, k) * 40 + 4,
                    rng.randint(0, C, (b, k)), rng.rand(b, k) * 100], -1)
    det[:, -2:, 4:] = -1
    det = np.round(det).astype(np.float32)
    masks = (rng.rand(b, k, mask_size, mask_size) > 0.5).astype(np.int32)
    seg = np.zeros((b, h, w, 3), np.int32)
    for y in range(h // 3, h):
        seg[:, y, int(w * 0.5 - (y / h) * w * 0.4):
            int(w * 0.5 + (y / h) * w * 0.4), 1] = 1
    if noisy:
        flip = rng.rand(b, h, w) > 0.97
        seg[..., 1] = np.where(flip, 1 - seg[..., 1], seg[..., 1])
    seg[:, h // 2:h // 2 + 5, w // 2:w // 2 + 9, 2] = 1
    seg[..., 0] = rng.rand(b, h, w) > 0.8
    return det, masks, seg


SCENES = {
    'fixture 96x128': (2, 96, 128, 12, 8, 7, False),
    'random 64x80': (3, 64, 80, 9, 14, 3, True),
    'headline 512x512': (1, 512, 512, 100, 28, 5, False),
}


def t(x):
    return torch.from_numpy(np.array(x))


def assert_summary_close(got, want):
    """Class, box and confidence columns and the flag exact; pixel count
    within float32 summation order; the fit-scaled columns FIT_RTOL."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., [0, 1, 2, 3, 4, 5, 10]],
                                  want[..., [0, 1, 2, 3, 4, 5, 10]])
    np.testing.assert_allclose(got[..., 6], want[..., 6], rtol=1e-6,
                               atol=SUM_ATOL)
    np.testing.assert_allclose(got[..., 7:10], want[..., 7:10],
                               rtol=FIT_RTOL, atol=SUM_ATOL)


# ---- drawing: exact ----

def test_draw_segmentation_and_instance_exact():
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (2, 24, 32, 3)).astype(np.float32)
    seg = (rng.rand(2, 24, 32, 3) > 0.5).astype(np.int32)
    colors = [[64, 0, 128], [128, 96, 0], [128, 192, 0]]
    for alpha in (0.3, 0.55):
        want = jvis.draw_segmentation(images, seg, colors, alpha)
        got = tvis.draw_segmentation(t(images), t(seg), colors, alpha)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    det = np.round(rng.rand(2, 5, 6) * 20).astype(np.float32)
    det[..., 4] = [[0, 1, 2, -1, 4], [3, 3, 0, 1, -1]]
    padded = rng.rand(2, 5, 24, 32).astype(np.float32)
    icolors = [[20 * i, 10, 255 - i] for i in range(5)]
    want = jvis.draw_instance(images, det, padded, icolors)
    got = tvis.draw_instance(t(images), t(det), t(padded), icolors)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_draw_boxes_exact():
    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (2, 40, 56, 3)).astype(np.uint8)
    det = np.round(np.stack([rng.rand(2, 8) * 56, rng.rand(2, 8) * 40,
                             rng.rand(2, 8) * 30, rng.rand(2, 8) * 30,
                             rng.randint(-1, 5, (2, 8)),
                             rng.rand(2, 8) * 100], -1)).astype(np.int32)
    det[0, 0, :4] = [10, 10, 7, 5]         # odd sizes: half-pixel edges
    det[1, 1, 2] = 0                       # zero width: not drawn
    want = jvis.draw_boxes(images.astype(np.float32), det)
    got = tvis.draw_boxes(t(images), t(det))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- checks of the existing postprocess (ROADMAP.md, Queue 3) ----

def test_paste_on_integer_box_edges():
    """Boxes whose edges fall exactly on integers (even sizes) or on
    halves (odd sizes), at the frame border and past it, in the same frame
    as boxes floored at 1: the clipped edges and the pasted masks equal the
    JAX package's exactly."""
    rng = np.random.RandomState(2)
    h, w = 48, 64
    det = np.array([[[20, 10, 8, 6, 0, 90], [0, 0, 4, 4, 1, 80],
                     [64, 48, 10, 12, 2, 70], [31, 17, 7, 5, 3, 60],
                     [1, 1, 1, 1, 4, 55], [70, -5, 20, 30, 0, 52]],
                    [[32, 24, 64, 48, 0, 40], [10, 40, 2, 2, 1, 30],
                     [-1, -1, -1, -1, -1, -1], [5, 5, 3, 3, 2, 20],
                     [63, 47, 2, 2, 3, 10], [0, 24, 16, 9, 4, 5]]],
                   np.float32)
    masks = (rng.rand(2, 6, 7, 7) > 0.4).astype(np.int32)
    want_edges = jpost._paste_edges(det, (h, w), 50.0)
    got_edges = tpost._paste_edges(t(det), (h, w), 50.0)
    for g, wnt in zip(got_edges, want_edges):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    np.testing.assert_array_equal(
        tpost.crop_and_pad_masks(t(det), t(masks), (h, w)).numpy(),
        np.asarray(jpost.crop_and_pad_masks(det, masks, (h, w))))


def test_upsample_output_truncates_toward_zero():
    """Negative and fractional coordinates: both packages' int cast
    truncates toward zero (-3.7 -> -3, 2.9 -> 2), confidences x100
    likewise."""
    boxes = np.array([[[-3.7, 2.9, -0.4, 5.5, 1.0, 0.999],
                       [10.25, -7.5, 3.3, -2.6, -1.0, -1.0]]], np.float32)
    masks = np.full((1, 2, 4, 4), 0.6, np.float32)
    sem = np.full((1, 4, 4, 3), 0.4, np.float32)
    for src, dst in (((4, 4), (8, 8)), ((4, 4), (6, 10))):
        want = jpost.upsample_output(boxes, masks, sem, src, dst)
        got = tpost.upsample_output(t(boxes), t(masks), t(sem), src, dst)
        for g, wnt in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    got = tpost.upsample_output(t(boxes), t(masks), t(sem), (4, 4),
                                (4, 4))[0]
    assert got[0, 0].tolist() == [-3, 2, 0, 5, 1, 99]


# ---- analytics ----

@pytest.mark.parametrize('scene', ['fixture 96x128', 'random 64x80'])
def test_crack_and_my_road_and_sizes(scene):
    b, h, w, k, ms, seed, noisy = SCENES[scene]
    det, masks, seg = road_scene(b, h, w, k, ms, seed, noisy=noisy)
    padded = np.asarray(jax.jit(jpost.crop_and_pad_masks, static_argnums=2)(
        det, masks, (h, w)))
    want_det, want_mask = jax.jit(jsum.crack_to_instance)(seg[..., 2])
    got_det, got_mask = tsum.crack_to_instance(t(seg[..., 2]))
    np.testing.assert_array_equal(got_det.numpy(), np.asarray(want_det))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(
        tsum.include_my_road(t(seg), t(padded)).numpy(),
        np.asarray(jax.jit(jsum.include_my_road)(seg, padded)))
    np.testing.assert_allclose(
        tsum.calculate_instance_size(t(seg), t(padded)).numpy(),
        np.asarray(jax.jit(jsum.calculate_instance_size)(seg, padded)),
        rtol=FIT_RTOL, atol=SUM_ATOL)
    assert_summary_close(tsum.summary_output(t(det), t(seg), t(padded)),
                         jax.jit(jsum.summary_output)(det, seg, padded))


def test_crack_conf_is_a_predicate_on_the_int32_area():
    crack = np.zeros((2, 5000, 5000), np.float32)
    crack[0, 0, 0] = crack[0, 4999, 4999] = 1.0   # 4999 x 4999 bbox
    crack[1, 7, 3:9] = 1.0                          # one row: no area
    got, _ = tsum.crack_to_instance(t(crack))
    assert got[:, 0, 5].tolist() == [100.0, 0.0]
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jsum.crack_to_instance(jnp.asarray(crack))[0]))


@pytest.mark.parametrize('hw', [(96, 128), (512, 512)])
def test_road_width_fit(hw):
    """The my_road edge fit in float32, the same formulas as the JAX
    package: metres per pixel within FIT_RTOL (measured 6.5e-5 at 96x128,
    2.6e-4 at 512x512 on the clean trapezoid, 8e-7 with noisy edges)."""
    h, w = hw
    _, _, seg = road_scene(2, h, w, 4, 8, 7)
    _, _, noisy = road_scene(2, h, w, 4, 8, 7, noisy=True)
    for s in (seg, noisy):
        my_road = s[..., 1].astype(np.float32)
        want = np.stack([np.asarray(jax.jit(
            jsum._road_width_per_row, static_argnums=1)(m, 3.25))
            for m in my_road])
        got = tsum.road_width_per_row(t(my_road), 3.25).numpy()
        np.testing.assert_allclose(got, want, rtol=FIT_RTOL)


@pytest.mark.parametrize('scene', list(SCENES))
def test_fused_summary_union(scene):
    """fused_summary_union and paste_stats_and_union against the JAX
    package, and against the port's own unfused path (crop_and_pad_masks
    -> summary_output / draw_instance). The pasted masks and their 0.5
    threshold agree exactly with the JAX paste here (0 flipped pixels);
    the union must flip none."""
    b, h, w, k, ms, seed, noisy = SCENES[scene]
    det, masks, seg = road_scene(b, h, w, k, ms, seed, noisy=noisy)
    want_sum, want_union = jax.jit(lambda d, s, m: jsum.fused_summary_union(
        d, s, m, (h, w), C))(det, seg, masks)
    got_sum, got_union = tsum.fused_summary_union(t(det), t(seg), t(masks),
                                                  (h, w), C)
    assert_summary_close(got_sum, want_sum)
    np.testing.assert_array_equal(got_union.numpy(), np.asarray(want_union))

    padded = tpost.crop_and_pad_masks(t(det), t(masks), (h, w))
    want_padded = np.asarray(jax.jit(jpost.crop_and_pad_masks,
                                     static_argnums=2)(det, masks, (h, w)))
    assert ((padded.numpy() > 0.5) != (want_padded > 0.5)).sum() == 0
    assert_summary_close(got_sum, tsum.summary_output(t(det), t(seg), padded))
    colors = [[20 * i, 10, 5] for i in range(C)]
    base = torch.zeros((b, h, w, 3))
    np.testing.assert_array_equal(
        tvis.draw_segmentation(base, got_union, colors).numpy(),
        tvis.draw_instance(base, t(det), padded, colors).numpy())

    unit = tsum.road_width_per_row(t(seg[..., 1]).float(), 3.25)
    stats = tpost.paste_stats_and_union(t(det), t(masks), (h, w), unit,
                                        t(seg[..., 1] > 0), C)
    want_stats = jax.jit(jpost.paste_stats_and_union, static_argnums=(2, 5))(
        det, masks, (h, w), unit.numpy(), seg[..., 1] > 0, C)
    for key in ('pixel', 'inter', 'area', 'union'):
        np.testing.assert_allclose(stats[key].numpy(),
                                   np.asarray(want_stats[key]),
                                   rtol=1e-6, atol=SUM_ATOL, err_msg=key)
    for key in ('size', 'horiz', 'vert'):
        np.testing.assert_allclose(stats[key].numpy(),
                                   np.asarray(want_stats[key]),
                                   rtol=1e-5, atol=SUM_ATOL, err_msg=key)


@pytest.mark.parametrize('scene', list(SCENES))
def test_fused_summary_union_without_union(scene):
    """``with_union=False`` (summarize mode) gives the same table bit for
    bit and no union."""
    b, h, w, k, ms, seed, noisy = SCENES[scene]
    det, masks, seg = road_scene(b, h, w, k, ms, seed, noisy=noisy)
    args = (t(det), t(seg), t(masks), (h, w), C)
    with_sum, union = tsum.fused_summary_union(*args)
    got_sum, none = tsum.fused_summary_union(*args, with_union=False)
    assert none is None and union.shape == (b, h, w, C)
    assert torch.equal(got_sum, with_sum)


def test_summary_to_records():
    row = np.zeros((3, 11), np.float32)
    row[0, :6] = [1, 10, 20, 5, 6, 90]
    row[0, 10] = 1.0
    row[1, 0] = -1                                  # padded slot
    row[2, :6] = [5, 3, 4, 1, 1, 0]                 # absent crack
    recs = summary_to_records(row, ('car', 'bump', 'manhole', 'steel',
                                    'pothole'))
    assert [r['name'] for r in recs] == ['bump']
    assert recs[0]['includeMyRoad'] and recs[0]['confidence'] == 90.0


# ---- the predictor ----

class _Fixed(nn.Module):
    """A model that answers fixed outputs, so the port's postprocess runs
    on exactly the JAX model's outputs."""

    def __init__(self, config, outputs):
        super().__init__()
        self.config = config
        self.outputs = outputs

    def forward(self, images):
        return dict(self.outputs)


class _JaxFixed:
    def __init__(self, config, outputs):
        self.config = config
        self.outputs = outputs

    def apply(self, variables, images):
        return self.outputs


@pytest.fixture(scope='module')
def staged(models):
    """The JAX model's outputs on two 96x120 frames (upsampled to 128x160
    for the model), and both predictors' postprocess on them."""
    jcfg, jmodel, variables, tcfg, tmodel = models
    frames = np.random.RandomState(3).randint(0, 256, (2, 96, 120, 3)
                                              ).astype(np.uint8)
    down = jax_resize(jnp.asarray(frames, jnp.float32), 128, 160,
                      align_corners=True)
    out = jax.tree_util.tree_map(np.asarray,
                                 jax.jit(jmodel.apply)(variables, down))
    jax_pred = JaxPredictor(_JaxFixed(jcfg, out), {}, jcfg)
    port_pred = mt.MaskLabPredictor(
        _Fixed(tcfg, {k: t(v) for k, v in out.items()}), tcfg, device='cpu')
    raw = jax_pred.predict(frames, 'raw')
    full = np.asarray(jpost.crop_and_pad_masks(
        raw['det_boxes'], raw['instance_masks'], frames.shape[1:3]))
    ties = np.abs(full - 0.5) <= 1e-5                # [B, K, H, W]
    return frames, jax_pred, port_pred, ties


@pytest.mark.parametrize('mode', ['visualize', 'summarize', 'raw'])
def test_predictor_postprocess_on_identical_outputs(staged, mode):
    """The same model outputs through each package's postprocess: exact,
    but for the fit-scaled analytics columns (FIT_RTOL) and the 0.5
    threshold of the full-frame paste. Bilinear weights put many pasted
    pixels at exactly 0.5, where XLA's and PyTorch's einsum orders round
    to either side: a flipped mask pixel must be such a tie (within 1e-5
    of 0.5 in the JAX paste), a changed frame pixel must lie on one, and
    each stays below 1e-3 of its pixels (measured: 31 of 460,800 mask
    pixels, 31 of 23,040 frame pixels)."""
    frames, jax_pred, port_pred, ties = staged
    want = jax_pred.predict(frames, mode)
    got = port_pred.predict(frames, mode)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
        if k == 'summarize':
            assert_summary_close(got[k], want[k])
        elif k == 'padded_masks':
            flips = got[k] != want[k]
            assert flips.mean() <= 1e-3 and not (flips & ~ties).any()
        elif k == 'visualize':
            changed = (got[k] != want[k]).any(-1)
            assert changed.mean() <= 1e-3
            assert not (changed & ~ties.any(1)).any()
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_predictor_summarize_answer_is_visualize_table(staged):
    """Summarize mode, which computes no instance union, answers the
    analytics table of visualize mode, which does, bit for bit."""
    frames, _, port_pred, _ = staged
    summarize = port_pred.predict(frames, 'summarize')
    visualize = port_pred.predict(frames, 'visualize')
    assert sorted(summarize) == ['det_boxes', 'summarize']
    for key in summarize:
        np.testing.assert_array_equal(summarize[key], visualize[key])


@pytest.mark.parametrize('mode', ['visualize', 'summarize'])
def test_predictor_modes_end_to_end(models, mode):
    """The port's predictor against masklab_tpu's on the same flax
    variables (forced dense), 96x120 frames, the model's outputs ~1e-7
    apart: boxes within 1 px / 1 confidence point (int casts of values a
    last ulp apart), classes exact; at most 1e-3 of the frame's pixels
    changed; analytics rows within 1 on the box columns,
    rtol 1e-3 on the mask-derived ones (vertical extent, a thresholded
    sum of units, atol 0.5), the flag exact. Measured: boxes and frames
    identical, analytics 4.9e-4 apart at most (pixel counts). Raw mode on
    the same model: tests/test_torch_slice.py::test_predictor_raw_mode."""
    jcfg, jmodel, variables, tcfg, tmodel = models
    frames = np.random.RandomState(4).randint(0, 256, (2, 96, 120, 3)
                                              ).astype(np.uint8)
    want = JaxPredictor(jmodel, variables, jcfg).predict(frames, mode)
    got = mt.MaskLabPredictor(tmodel, tcfg, device='cpu').predict(frames,
                                                                   mode)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
    assert np.abs(got['det_boxes'].astype(np.int64)
                  - want['det_boxes']).max() <= 1
    np.testing.assert_array_equal(got['det_boxes'][..., 4],
                                  want['det_boxes'][..., 4])
    assert (got['det_boxes'][..., 4] >= 0).all()
    if 'visualize' in want:
        assert (got['visualize'] != want['visualize']).any(-1).mean() <= 1e-3
    if 'summarize' in want:
        g, w = got['summarize'], want['summarize']
        np.testing.assert_array_equal(g[..., [0, 10]], w[..., [0, 10]])
        assert np.abs(g[..., 1:6] - w[..., 1:6]).max() <= 1
        np.testing.assert_allclose(g[..., 6:9], w[..., 6:9], rtol=1e-3,
                                   atol=1e-2)
        np.testing.assert_allclose(g[..., 9], w[..., 9], rtol=1e-3, atol=0.5)


def test_predictor_default_mode_warmup_and_bytes(models):
    """``visualization`` selects the default mode; any other mode name
    answers the raw outputs, as the JAX predictor's pipeline does; warmup
    runs each entry; predict_bytes decodes a JPEG on the host."""
    import cv2
    _, _, _, tcfg, tmodel = models
    pred = mt.MaskLabPredictor(tmodel, tcfg, visualization=True,
                               device='cpu')
    frame = np.random.RandomState(5).randint(0, 256, (64, 80, 3)
                                             ).astype(np.uint8)
    assert sorted(pred.predict(frame)) == ['det_boxes', 'summarize',
                                           'visualize']
    assert 'padded_masks' in pred.predict(frame, 'masks please')
    calls = []
    pred.predict = lambda images, mode=None: calls.append(
        (images.shape, mode))
    pred.warmup([(64, 80), (32, 48, 2, 'summarize')])
    assert calls == [((1, 64, 80, 3), None), ((2, 32, 48, 3), 'summarize')]
    del pred.predict
    ok, jpeg = cv2.imencode('.jpg', frame[..., ::-1])
    out = pred.predict_bytes(jpeg.tobytes(), 'summarize')
    assert out['summarize'].shape == (1, tcfg.detection.nms_max_output_size
                                      + 1, 11)
    np.testing.assert_array_equal(decode_image_bytes(jpeg.tobytes()),
                                  cv2.imdecode(jpeg, 1)[..., ::-1])
    with pytest.raises(ValueError, match='decode'):
        decode_image_bytes(b'not an image')
    assert mt.MaskLabPredictor.encode_jpeg(frame)[:2] == b'\xff\xd8'


# ---- micro-batching (fake predict) ----

def _marked_image(i, hw=(8, 8)):
    img = np.zeros(hw + (3,), np.uint8)
    img[0, 0, 0] = i
    return img


def _fake_predict(calls):
    def predict(images, mode=None):
        calls.append((images.shape[0], mode))
        return {'marker': images[:, 0, 0, 0].astype(np.int32),
                'shape_h': np.full(images.shape[0], images.shape[1])}
    return predict


def _wave(mb, items, mode=None):
    """Submit ``items`` ({key: image}) from one thread each, released
    together -> ({key: result}, {key: error})."""
    results, errors = {}, {}
    barrier = threading.Barrier(len(items))

    def worker(key, image):
        barrier.wait()
        try:
            results[key] = mb.submit(image, mode)
        except BaseException as exc:  # noqa: BLE001 - checked by the test
            errors[key] = exc
    threads = [threading.Thread(target=worker, args=kv)
               for kv in items.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    assert not any(th.is_alive() for th in threads)
    return results, errors


@pytest.mark.parametrize('n,buckets', [(1, (1,)), (3, (1, 2, 4)),
                                       (8, (1, 2, 4, 8)),
                                       (11, (1, 2, 4, 8))])
def test_buckets(n, buckets):
    assert default_buckets(max(buckets)) == buckets
    want = next((b for b in buckets if n <= b), buckets[-1])
    assert _next_bucket(n, buckets) == want


@pytest.mark.parametrize('count,max_batch', [(8, 8), (3, 8), (5, 4)])
def test_microbatcher_coalesces_pads_and_routes(count, max_batch):
    """Concurrent submits share device calls, pad to a bucket, and each
    caller gets its own row back; the mode reaches predict."""
    calls = []
    mb = MicroBatcher(_fake_predict(calls), max_batch=max_batch,
                      window_ms=30.0)
    try:
        results, errors = _wave(mb, {i: _marked_image(i)
                                     for i in range(count)}, 'summarize')
        assert not errors and len(results) == count
        for i, out in results.items():
            assert out['marker'].shape == (1,)
            assert int(out['marker'][0]) == i
        assert len(calls) < count or count == 1
        assert all(mode == 'summarize' for _, mode in calls)
        assert all(b in default_buckets(max_batch) for b in mb.batch_sizes)
        assert sum(b for b, _ in calls) >= count
    finally:
        mb.close()


def test_microbatcher_mixed_resolutions_never_share_a_batch():
    calls = []
    mb = MicroBatcher(_fake_predict(calls), max_batch=8, window_ms=30.0)
    try:
        results, _ = _wave(mb, {i: _marked_image(
            i, (8, 8) if i % 2 == 0 else (16, 16)) for i in range(6)})
        assert len(results) == 6
        for i, out in results.items():
            assert int(out['shape_h'][0]) == (8 if i % 2 == 0 else 16)
            assert int(out['marker'][0]) == i
    finally:
        mb.close()


@pytest.mark.parametrize('exc', [RuntimeError('device on fire'),
                                 SystemExit(3)])
def test_microbatcher_fans_errors_out_and_survives(exc):
    """A failure at bucket 1 reaches each caller; the dispatcher lives on."""
    def boom(images, mode=None):
        raise exc

    mb = MicroBatcher(boom, max_batch=4, window_ms=1.0)
    try:
        for i in (1, 2):
            with pytest.raises(type(exc)):
                mb.submit(_marked_image(i))
        assert mb._thread.is_alive()
    finally:
        mb.close()


def test_microbatcher_suspends_a_failing_bucket_and_degrades():
    """A bucket whose first run fails is suspended and its group retried
    at strictly smaller buckets (never a larger one); every caller is
    answered."""
    calls = []

    def predict(images, mode=None):
        calls.append(images.shape[0])
        if images.shape[0] == 4:
            raise RuntimeError('first run of bucket 4 failed')
        return {'marker': images[:, 0, 0, 0].astype(np.int32)}

    mb = MicroBatcher(predict, max_batch=8, window_ms=30.0)
    try:
        results, errors = _wave(mb, {i: _marked_image(i) for i in range(3)})
        assert not errors and len(results) == 3
        for i, out in results.items():
            assert int(out['marker'][0]) == i
        assert 8 not in calls
        assert 4 in calls and max(calls[calls.index(4) + 1:]) <= 2
        assert 4 not in mb.eligible_buckets()
    finally:
        mb.close()


def test_microbatcher_reinstates_after_cooldown():
    state = {'fail': True}
    calls = []

    def predict(images, mode=None):
        calls.append(images.shape[0])
        if images.shape[0] >= 4 and state['fail']:
            raise RuntimeError('outage during the first batch-4 run')
        return {'marker': images[:, 0, 0, 0].astype(np.int32)}

    mb = MicroBatcher(predict, max_batch=4, window_ms=30.0,
                      evict_cooldown_s=0.3)
    try:
        first, _ = _wave(mb, {i: _marked_image(i) for i in range(4)})
        assert len(first) == 4
        assert all(b < 4 for b in mb.eligible_buckets())
        state['fail'] = False
        time.sleep(0.35)
        assert 4 in mb.eligible_buckets()
        second, _ = _wave(mb, {i: _marked_image(i + 10) for i in range(4)})
        assert {i: int(o['marker'][0]) for i, o in second.items()} == {
            i: i + 10 for i in range(4)}
        assert 4 in calls[calls.index(4) + 1:]
    finally:
        mb.close()


def test_microbatcher_warm_bucket_failure_propagates():
    """A bucket that has served passes a later failure to its callers and
    stays in service."""
    state = {'fail': False}

    def predict(images, mode=None):
        if state['fail']:
            raise RuntimeError('transient')
        return {'marker': images[:, 0, 0, 0].astype(np.int32)}

    mb = MicroBatcher(predict, max_batch=2, window_ms=20.0)
    try:
        ok, errors = _wave(mb, {i: _marked_image(i) for i in range(2)})
        assert len(ok) == 2 and not errors
        state['fail'] = True
        _, errors = _wave(mb, {i: _marked_image(i) for i in range(2)})
        assert len(errors) == 2
        assert 2 in mb.eligible_buckets()
    finally:
        mb.close()


def test_microbatcher_malformed_group_fails_its_callers():
    calls = []
    mb = MicroBatcher(_fake_predict(calls), max_batch=4, window_ms=30.0)
    try:
        _, errors = _wave(mb, {0: np.zeros((8, 8, 3), np.uint8),
                               1: np.zeros((8, 8, 4), np.uint8)})
        assert len(errors) == 2 and not calls
    finally:
        mb.close()
    with pytest.raises(RuntimeError, match='closed'):
        mb.submit(_marked_image(0))


# ---- servers and process_folder (tiny model) ----

def tiny_config():
    cfg = mt.ModelConfiguration()
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
    cfg.compute.nms_candidates_per_class = 8
    cfg.postprocess.resolution = (96, 128)
    return cfg


@pytest.fixture(scope='module')
def tiny_predictor():
    cfg = tiny_config()
    model = mt.force_dense(mt.build_masklab(cfg, device='cpu', seed=0))
    return mt.MaskLabPredictor(model, cfg, visualization=True, device='cpu')


@pytest.fixture()
def jpeg_path(tmp_path):
    import cv2
    image = np.uint8(np.random.RandomState(0).rand(96, 128, 3) * 255)
    path = str(tmp_path / 'frame.jpg')
    cv2.imwrite(path, image[..., ::-1])
    return path


def _post(port, query, body):
    req = urllib.request.Request(f'http://localhost:{port}/predict{query}',
                                 data=body, method='POST')
    return urllib.request.urlopen(req, timeout=60)


@pytest.mark.parametrize('max_batch', [1, 4])
def test_http_round_trip(tiny_predictor, jpeg_path, max_batch):
    """visualize (JSON with the base64 JPEG), summarize, raw and jpeg
    outputs, the health probe, /reload without a watcher (400), bad bodies
    (400) and unknown paths (404); with and without the micro-batcher."""
    import cv2
    server = MaskLabServer(tiny_predictor, port=0, max_batch=max_batch,
                           instance_labels=('car', 'bump', 'manhole',
                                            'steel', 'pothole'))
    server.start()
    try:
        port = server.port
        assert port != 0
        resp = send_image_to_server(jpeg_path, port=port)
        assert 'objs' in resp and 'visualize_jpeg_b64' in resp
        assert resp['latency_ms'] > 0 and len(resp['objs']) >= 1
        with open(jpeg_path, 'rb') as f:
            body = f.read()
        with _post(port, '?outputs=summarize', body) as r:
            lean = json.loads(r.read())
        assert 'objs' in lean and 'visualize_jpeg_b64' not in lean
        assert lean['objs'] == resp['objs']
        with _post(port, '?outputs=raw', body) as r:
            raw = json.loads(r.read())
        assert np.array(raw['det_boxes']).shape == (4, 6)
        assert raw['semantic_shape'] == [96, 128, 3]
        with _post(port, '?outputs=jpeg', body) as r:
            assert r.headers['Content-Type'] == 'image/jpeg'
            objs = json.loads(r.headers['X-Masklab-Summary'])
            jpeg = r.read()
        assert objs == resp['objs']
        assert cv2.imdecode(np.frombuffer(jpeg, np.uint8), 1).shape == (
            96, 128, 3)
        with urllib.request.urlopen(f'http://localhost:{port}/healthz',
                                    timeout=10) as r:
            assert json.loads(r.read()) == {'status': 'ok'}
        for path, body_, code in (('/predict', b'garbage', 400),
                                  ('/reload', b'', 400),
                                  ('/nowhere', b'', 404)):
            req = urllib.request.Request(f'http://localhost:{port}{path}',
                                         data=body_, method='POST')
            with pytest.raises(urllib.error.HTTPError) as info:
                urllib.request.urlopen(req, timeout=10)
            assert info.value.code == code, path
    finally:
        server.stop()


def test_grpc_round_trip(tiny_predictor, jpeg_path):
    pytest.importorskip('grpc')
    server = MaskLabGrpcServer(tiny_predictor, port=0, max_batch=4,
                               instance_labels=('car', 'bump', 'manhole',
                                                'steel', 'pothole'))
    server.start()
    try:
        resp = send_image_to_grpc(jpeg_path, port=server.port)
    finally:
        server.stop()
    assert 'objs' in resp and 'visualize_jpeg_b64' in resp
    with open(jpeg_path, 'rb') as f:
        out = tiny_predictor.predict_bytes(f.read())
    assert resp['objs'] == summary_to_records(
        out['summarize'][0], ('car', 'bump', 'manhole', 'steel', 'pothole'))


def test_process_folder_batch_matches_single(tiny_predictor, tmp_path):
    """batch_size 4: 5 same-size frames in two stacked calls (the last
    padded) and an odd-size frame in its own; the same records and files
    as one frame per call."""
    import cv2
    src = tmp_path / 'src'
    src.mkdir()
    rng = np.random.RandomState(7)
    for i in range(5):
        cv2.imwrite(str(src / f'im_{i}.jpg'),
                    np.uint8(rng.rand(96, 128, 3) * 255))
    cv2.imwrite(str(src / 'odd.png'), np.uint8(rng.rand(64, 96, 3) * 255))
    single = process_folder(tiny_predictor, str(src), str(tmp_path / 'one'))
    calls = []
    predict = tiny_predictor.predict

    def counting(images, mode=None):
        calls.append(images.shape)
        return predict(images, mode)
    tiny_predictor.predict = counting
    try:
        batched = process_folder(tiny_predictor, str(src),
                                 str(tmp_path / 'four'), batch_size=4)
    finally:
        del tiny_predictor.predict
    assert sorted(calls) == [(4, 64, 96, 3), (4, 96, 128, 3),
                             (4, 96, 128, 3)]
    assert set(batched) == set(single) and len(single) == 6
    for name in single:
        assert (tmp_path / 'four' / name).exists()
        assert len(batched[name]['objs']) == len(single[name]['objs'])
        for a, b in zip(single[name]['objs'], batched[name]['objs']):
            assert a['name'] == b['name']
            np.testing.assert_allclose(
                [a['x'], a['y'], a['w'], a['h'], a['confidence'],
                 a['pixelSize']],
                [b['x'], b['y'], b['w'], b['h'], b['confidence'],
                 b['pixelSize']], rtol=1e-5, atol=1e-4)
    with open(tmp_path / 'four' / 'results.json') as f:
        assert set(json.load(f)) == set(single)
