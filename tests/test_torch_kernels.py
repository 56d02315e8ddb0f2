"""The port's kernels against the reference's Pallas kernels.

On the CPU each kernel's plain PyTorch version is held against the JAX
Pallas kernel (interpret mode) and the XLA form the reference uses; the
``gpu`` twins hold the CUDA kernel against its plain version on the card.
Inputs come from seeded numpy.

The JAX imports live inside the CPU tests, so that the ``gpu`` tests also
run on a card's machine that has no JAX:
``python -m pytest --noconftest tests/test_torch_kernels.py -m gpu``.
"""
import numpy as np
import pytest
import torch

from masklab_tpu_torch.ops import cuda as kc


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


# ---- K1: flat-band GroupNorm ----

def _gn_inputs(seed, n, hw, c):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, hw, hw, c).astype(np.float32) * 2 + 1
    return x, rng.rand(c).astype(np.float32), rng.rand(c).astype(np.float32)


@pytest.mark.parametrize('fuse_relu', [False, True])
@pytest.mark.parametrize('hw,c', [(14, 256), (14, 64), (7, 32), (14, 128),
                                  (7, 48)])
def test_band_groupnorm_plain_matches_pallas(hw, c, fuse_relu):
    """f32, atol 2e-5 (f32 statistics summed in another order). (14, 128)
    is the mask heads' map; (7, 48) has cg = 3, which does not divide a
    16-byte vector."""
    import jax.numpy as jnp
    from masklab_tpu.nn.layers import GroupNorm as JaxGroupNorm
    from masklab_tpu.ops.pallas.groupnorm_kernel import band_groupnorm_pallas
    g = 16
    x, scale, bias = _gn_inputs(0, 5, hw, c)
    got = kc.band_groupnorm_plain(
        torch.from_numpy(x.reshape(5, hw * hw, c)), torch.from_numpy(scale),
        torch.from_numpy(bias), g, fuse_relu=fuse_relu).numpy()
    pallas = np.asarray(band_groupnorm_pallas(
        jnp.asarray(x.reshape(5, hw * hw, c)), jnp.asarray(scale),
        jnp.asarray(bias), g, fuse_relu=fuse_relu, interpret=True))
    x_in = np.maximum(x, 0) if fuse_relu else x
    module = np.asarray(JaxGroupNorm(g, jnp.float32).apply(
        {'params': {'scale': scale, 'bias': bias}}, jnp.asarray(x_in)))
    np.testing.assert_allclose(got, pallas, atol=2e-5)
    np.testing.assert_allclose(got.reshape(x.shape), module, atol=2e-5)


def _bf16_ulps(got, want, x, scale, bias, groups, relu):
    """Max |got - want| in bf16 ulps at operand scale: the plain version
    rounds m1, inv, scale, bias and four operations to bf16, so the gap is
    measured against the chain's largest operand,
    (|x| + |m1|) * inv * |scale| + |bias|."""
    n, q, c = x.shape
    xr = torch.relu(x.float()) if relu else x.float()
    xr = xr.reshape(n, groups, -1)
    m1 = xr.mean(-1, keepdim=True)
    inv = torch.rsqrt(torch.clamp(xr.square().mean(-1, keepdim=True)
                                  - m1 * m1, min=0.0) + 1e-5)
    reps = xr.shape[-1] // (c // groups)
    ts = scale.reshape(groups, c // groups).repeat(1, reps)
    tb = bias.reshape(groups, c // groups).repeat(1, reps)
    mag = ((xr.abs() + m1.abs()) * inv * ts.abs() + tb.abs()).reshape(n, q, c)
    mag = torch.maximum(mag, torch.maximum(got.abs(), want.abs()))
    _, e = torch.frexp(mag.clamp(min=2.0 ** -126))
    ulp = torch.ldexp(torch.ones_like(mag), e - 8).to(want.dtype)
    return ((got - want).abs() / ulp).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('n,q,c', [(64, 196, 128), (1, 196, 128),
                                   (7, 196, 128), (533, 196, 128),
                                   (1600, 196, 128), (7, 196, 256),
                                   (7, 49, 48), (7, 784, 256)])
def test_band_groupnorm_kernel_matches_plain(cuda, dtype, n, q, c):
    """f32 within 2e-5 of the plain version and of the plain version in
    f64. bf16, in ulps at operand scale: within 4 of the plain version,
    whose roundings put even the exactly rounded result up to 4 ulp away,
    and within 0.51 of the f64 result (the kernel rounds once). The maps
    cover the warp path (the mask heads' 196 x 128 at several batches, a
    longer band at C=256) and the block path (cg = 3; a band of 12544
    bf16, too long for registers)."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(n, q, c).astype(np.float32) * 2 + 1)
    x = x.to(cuda).to(getattr(torch, dtype))
    s = torch.from_numpy(rng.rand(c).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.rand(c).astype(np.float32)).to(cuda)
    before = kc.launch_counts()['band_groupnorm']
    for relu in (False, True):
        got = kc.band_groupnorm(x, s, b, 16, fuse_relu=relu).float()
        want = kc.band_groupnorm_plain(x, s, b, 16, fuse_relu=relu).float()
        exact = kc.band_groupnorm_plain(x.double(), s.double(), b.double(),
                                        16, fuse_relu=relu)
        if dtype == 'float32':
            torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
            torch.testing.assert_close(got.double(), exact, atol=2e-5, rtol=0)
        else:
            assert _bf16_ulps(got, want, x, s, b, 16, relu) <= 4.0
            assert _bf16_ulps(got.double(), exact, x, s, b, 16, relu) <= 0.51
    assert kc.launch_counts()['band_groupnorm'] == before + 2


def _k1b_inputs(cuda, n, q, c, dtype, seed=4):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(n, q, c).astype(np.float32) * 2 + 1)
    dy = torch.from_numpy(rng.randn(n, q, c).astype(np.float32))
    s = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    dt = getattr(torch, dtype)
    return x.to(cuda).to(dt), dy.to(cuda).to(dt), s.to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('n,q,c,g', [(432, 196, 128, 16), (4, 4, 128, 16),
                                     (4, 16, 128, 32), (1, 196, 128, 16),
                                     (3, 196, 128, 16), (2000, 196, 128, 16),
                                     (7, 196, 256, 16), (7, 49, 48, 16),
                                     (7, 784, 256, 16), (3, 5, 600, 2)])
def test_band_groupnorm_backward_kernel_matches_plain(cuda, dtype, n, q, c,
                                                      g):
    """K1's backward kernel against its plain version, relu off and on,
    within chip_smoke.py's K1B_* tolerances (f32 dx 5e-5; bf16 dx in ulps
    at operand scale 1.01; dscale / dbias 1e-4 of the sum of their terms'
    magnitudes), and two calls on the same inputs give the same bits in
    dx, dscale and dbias (no float atomics; the ticket is back at 0 after
    each call). The maps: the train path's mask heads, P7 heads (G > Q)
    and P6 norm (G = 32 > Q); fewer samples than one block's warps (1, 3)
    and many more bands than the persistent grid has warps (2000 x 16);
    the forward's edges (the vector path, cg = 3 on the scalar path) and
    cg = 300 (the scalar path with columns wider than a block)."""
    import chip_smoke
    x, dy, s = _k1b_inputs(cuda, n, q, c, dtype, seed=2)
    before = kc.launch_counts()['band_groupnorm_backward']
    for relu in (False, True):
        dx_err, param_err = chip_smoke.k1_backward_errors(kc, x, dy, s, g,
                                                          relu)
        assert dx_err <= (chip_smoke.K1B_F32_ATOL if dtype == 'float32'
                          else chip_smoke.K1B_BF16_ULPS)
        assert param_err <= chip_smoke.K1B_PARAM_RTOL
        first = kc.band_groupnorm_backward(x, dy, s, g, fuse_relu=relu)
        second = kc.band_groupnorm_backward(x, dy, s, g, fuse_relu=relu)
        for a, b in zip(first, second):
            assert torch.equal(a, b)
    assert kc.launch_counts()['band_groupnorm_backward'] == before + 6


def _k1b_train_maps():
    import chip_smoke
    return sorted({tuple(m) for m in chip_smoke.K1B_TRAIN_MAPS})


@pytest.mark.gpu
@pytest.mark.parametrize('index', range(4))
def test_band_groupnorm_backward_one_launch_per_call(cuda, index):
    """At every map a train step gives K1's backward
    (chip_smoke.K1B_TRAIN_MAPS, which chip_smoke.py holds against the maps
    its train step records), one call launches exactly one device kernel:
    the profiler's kernels per call over 20 calls, template instances of
    one kernel counted apart."""
    import chip_smoke
    n, q, c, g, dtype, relu = _k1b_train_maps()[index]
    x, dy, s = _k1b_inputs(cuda, n, q, c, dtype)
    timing = chip_smoke.backward_timing(
        lambda: kc.band_groupnorm_backward(x, dy, s, g, fuse_relu=relu), 20)
    assert timing['kernels_per_call'] == 1, timing


@pytest.mark.gpu
def test_band_groupnorm_fn_launches_both_kernels(cuda):
    """On a CUDA tensor, ``BandGroupNormFn`` launches K1's forward and
    backward kernels, and its gradients equal the backward kernel's."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(6, 196, 128).astype(np.float32)).to(cuda)
    dy = torch.from_numpy(rng.randn(6, 196, 128).astype(np.float32)).to(cuda)
    s = torch.ones(128, device=cuda, requires_grad=True)
    b = torch.zeros(128, device=cuda, requires_grad=True)
    xg = x.clone().requires_grad_()
    kc.reset_launch_counts()
    kc.BandGroupNormFn.apply(xg, s, b, 16, 1e-5, True).backward(dy)
    counts = kc.launch_counts()
    assert counts['band_groupnorm'] == 1
    assert counts['band_groupnorm_backward'] == 1
    want = kc.band_groupnorm_backward(x, dy, s.detach(), 16, fuse_relu=True)
    for got, w in zip((xg.grad, s.grad, b.grad), want):
        assert torch.equal(got, w)


# ---- K2: segment top-k ----

def _topk_pair(x, cap):
    import jax.numpy as jnp
    from masklab_tpu.ops.pallas.topk_kernel import segment_topk_pallas
    got_v, got_i = kc.segment_topk_plain(torch.from_numpy(x), cap)
    want_v, want_i = segment_topk_pallas(jnp.asarray(x), cap, interpret=True)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_segment_topk_plain_matches_pallas():
    rng = np.random.RandomState(0)
    _topk_pair(rng.rand(3, 16, 256).astype(np.float32), 4)


def test_segment_topk_plain_ties_to_lowest_row():
    x = np.zeros((1, 8, 128), np.float32)
    x[0, 2, 5] = 0.7
    x[0, 6, 5] = 0.7
    _topk_pair(x, 2)
    vals, idx = kc.segment_topk_plain(torch.from_numpy(x), 2)
    assert idx[0, 0, 5] == 2 * 128 + 5 and idx[0, 1, 5] == 6 * 128 + 5
    assert vals[0, 0, 5] == np.float32(0.7)


def test_segment_topk_plain_short_columns():
    """Columns with fewer finite values than cap (the -inf pad): the tail
    repeats (-inf, row 0), as the Pallas rounds do."""
    rng = np.random.RandomState(1)
    # bf16-quantized scores: many exact ties inside a column
    x = np.round(rng.rand(2, 16, 128) * 64).astype(np.float32) / 64
    x[:, 3:, :40] = -np.inf
    x[:, :, 40:50] = -np.inf
    _topk_pair(x, 8)


@pytest.mark.gpu
def test_segment_topk_kernel_matches_plain(cuda):
    """Exact, at the 512 px pool shape with bf16-quantized ties and pad."""
    rng = np.random.RandomState(2)
    scores = torch.sigmoid(torch.from_numpy(
        2 + 0.05 * rng.randn(80, 81840).astype(np.float32))).bfloat16().float()
    x = torch.cat([scores, torch.full((80, 80), float('-inf'))], 1)
    x = x.reshape(80, 128, 640).contiguous().to(cuda)
    for cap in (16, 4):
        vals, idx = kc.segment_topk(x, cap)
        pv, pi = kc.segment_topk_plain(x, cap)
        assert torch.equal(vals, pv) and torch.equal(idx, pi)


def _score_rows(rng, b, c, n, layout, bf16=True):
    """[B, C, n] forced-dense scores (sigmoid near 2 through bf16, so
    columns carry exact ties, 5% masked to -1): as a contiguous tensor, or
    as the [B, C, n] transpose of a contiguous [B, n, C] tensor, the main
    path's cls_pred layout. ``bf16=False`` keeps the f32 sigmoid."""
    x = torch.sigmoid(torch.from_numpy(
        2 + 0.05 * rng.randn(b, n, c).astype(np.float32)))
    if bf16:
        x = x.bfloat16().float()
    x[torch.from_numpy(rng.rand(b, n, c) < 0.05)] = -1.0
    x = x.transpose(1, 2)
    return x.contiguous() if layout == 'contiguous' else x


def _padded(scores, m=128):
    """The reference's own padding: -inf to m * ceil(n / m), [R, m, s]."""
    rows = scores.reshape(-1, scores.shape[-1]).numpy()
    s = -(-rows.shape[1] // m)
    pad = np.full((rows.shape[0], m * s - rows.shape[1]), -np.inf, np.float32)
    return np.concatenate([rows, pad], 1).reshape(-1, m, s)


@pytest.mark.parametrize('cap', [1, 16])
@pytest.mark.parametrize('n', [1, 129, 1000, 3000])
@pytest.mark.parametrize('layout', ['contiguous', 'transposed'])
def test_segment_topk_rows_plain_matches_pallas(layout, n, cap):
    """Score rows read where they lie (n not a multiple of 128, the
    transposed cls_pred view) equal the Pallas kernel (interpret mode) and
    the plain version on the reference's padded input. Exact."""
    import jax.numpy as jnp
    from masklab_tpu.ops.pallas.topk_kernel import segment_topk_pallas
    scores = _score_rows(np.random.RandomState(n), 2, 3, n, layout)
    got_v, got_i = kc.segment_topk_rows_plain(scores, cap)
    x = _padded(scores)
    want_v, want_i = segment_topk_pallas(jnp.asarray(x), cap, interpret=True)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    plain_v, plain_i = kc.segment_topk_plain(torch.from_numpy(x), cap)
    assert torch.equal(got_v, plain_v) and torch.equal(got_i, plain_i)


@pytest.mark.parametrize('layout,groups', [('contiguous', 1),
                                           ('transposed', 5)])
def test_segment_topk_rows_group_view_is_in_place(layout, groups):
    """The kernel's [R0, G, n] view shares the scores' storage (no copy):
    the transposed cls_pred view groups its C rows, whose elements lie C
    apart; contiguous rows take G = 1. Rows stay in order."""
    from masklab_tpu_torch.ops.cuda.topk import _group_view
    scores = _score_rows(np.random.RandomState(0), 4, 5, 300, layout)
    x3 = _group_view(scores)
    assert x3.data_ptr() == scores.data_ptr() and x3.shape[1] == groups
    assert torch.equal(x3.reshape(20, 300), scores.reshape(20, 300))


TOPK_EDGES = [f'n={n} {layout} cap={cap}'
              for n in (81840, 81920, 40000, 129, 1)
              for layout in ('contiguous', 'transposed')
              for cap in (1, 2, 15, 16)] + [
    'R=1', 'fewer finite than cap', 'all -1', 'all equal', 's=3',
    'f32 scores', 'one f32 score', 'signed zeros']


def _topk_edge(name):
    """K2's edge cases on the card as (scores, cap): every cap at several n
    (the main path's 81840, a multiple of 128, a short row, one element),
    contiguous rows and the transposed view, R = 1, columns with fewer
    finite values than cap, all-(-1) and all-equal columns, s = 3 (not a
    multiple of the launch tile); and scores that are not all bf16-exact,
    which take the kernel's (value, row) keys: f32 sigmoids, one f32 score
    among bf16 ones (that block alone), +0.0 and -0.0 mixed."""
    rng = np.random.RandomState(3)
    if name.startswith('n='):
        n, layout, cap = name.split()
        n, cap = int(n[2:]), int(cap[4:])
        return _score_rows(rng, 16 if n > 129 else 2, 5, n, layout), cap
    if name == 'R=1':
        return _score_rows(rng, 1, 1, 81840, 'contiguous'), 16
    if name == 'fewer finite than cap':
        scores = _score_rows(rng, 2, 5, 3000, 'transposed').clone()
        scores[..., 8 * 24:] = float('-inf')    # s = 24: 8 finite rows
        return scores, 16
    if name in ('all -1', 'all equal'):
        return torch.full((2, 5, 3000), -1.0 if name == 'all -1' else 0.5), 16
    if name == 's=3':
        return _score_rows(rng, 2, 5, 300, 'transposed'), 16
    if name == 'f32 scores':
        return _score_rows(rng, 16, 5, 81840, 'transposed', bf16=False), 16
    if name == 'one f32 score':
        scores = _score_rows(rng, 16, 5, 81840, 'transposed').clone()
        scores[3, 2, 40000] += 1e-4
        return scores, 16
    assert name == 'signed zeros'
    signs = torch.from_numpy(rng.rand(2, 5, 3000) < 0.5)
    return torch.where(signs, 0.0, -0.0), 16


@pytest.mark.gpu
@pytest.mark.parametrize('name', TOPK_EDGES)
def test_segment_topk_rows_kernel_matches_plain(cuda, name):
    """Exact, one launch, scores read in place; the main path's call form
    is 'n=81840 transposed cap=16' ([16, 5, 81840], the transpose of
    cls_pred)."""
    scores, cap = _topk_edge(name)
    scores = scores.to(cuda)
    before = kc.launch_counts()['segment_topk']
    vals, idx = kc.segment_topk_rows(scores, cap)
    assert kc.launch_counts()['segment_topk'] == before + 1
    pv, pi = kc.segment_topk_rows_plain(scores, cap)
    assert torch.equal(vals, pv) and torch.equal(idx, pi)


@pytest.mark.gpu
@pytest.mark.parametrize('exact', [True, False])
@pytest.mark.parametrize('m', [8, 40, 256])
def test_segment_topk_kernel_padded_any_m(cuda, m, exact):
    """The padded form at other segment lengths: m = 256 takes eight slices
    of 32 rows, m = 40 a slice of 10 rows, m = 8 one short chunk; with both
    kinds of key (values on a 1/16 grid, bf16-exact with many ties, and f32
    ones)."""
    rng = np.random.RandomState(m)
    v = rng.rand(6, m, 300).astype(np.float32)
    if exact:
        v = np.round(v * 16) / 16
    x = torch.from_numpy(v).to(cuda)
    vals, idx = kc.segment_topk(x, 16)
    pv, pi = kc.segment_topk_plain(x, 16)
    assert torch.equal(vals, pv) and torch.equal(idx, pi)


# ---- K3: NMS keep-mask ----

def _nms_case(seed, r=3, n=64):
    from masklab_tpu_torch.ops.boxes import cxcywh_to_yxyx
    rng = np.random.RandomState(seed)
    boxes = np.stack([rng.uniform(20, 120, (r, n)), rng.uniform(20, 120, (r, n)),
                      rng.uniform(10, 70, (r, n)), rng.uniform(10, 70, (r, n))],
                     -1).astype(np.float32)
    yxyx = cxcywh_to_yxyx(torch.from_numpy(boxes)).numpy()
    order = np.argsort(-rng.uniform(0, 1, (r, n)), axis=1, kind='stable')
    yxyx = np.take_along_axis(yxyx, order[..., None], 1)
    return np.ascontiguousarray(yxyx), rng.rand(r, n) > 0.15


def _nms_edge(name):
    """Edge cases of the keep-mask as (boxes [R, K, 4], valid [R, K], t,
    max_outputs): K around the 64-bit word edges and the cluster-distributed
    mask; no valid box; integer-grid boxes whose IoU equals t exactly
    ([0,0,10,10] against [0,0,10,5] at t=0.5); zero-area boxes."""
    rng = np.random.RandomState(7)
    if name.startswith('K='):
        k, cap = (int(v.split('=')[1]) for v in name.split())
        yxyx, valid = _nms_case(4, 3, k)
        return yxyx, valid, 0.5, cap
    if name == 'no valid box':
        yxyx, valid = _nms_case(5, 2, 100)
        return yxyx, np.zeros_like(valid), 0.5, 100
    if name == 'IoU == t':
        lo = rng.randint(0, 8, (3, 48, 2))
        grid = np.concatenate([lo, lo + rng.randint(1, 6, (3, 48, 2))], -1)
        grid[:, :3] = [[0, 0, 10, 10], [0, 0, 10, 5], [0, 0, 10, 6]]
        return grid.astype(np.float32), np.ones((3, 48), bool), 0.5, 48
    assert name == 'zero-area'
    yxyx, valid = _nms_case(6, 2, 64)
    flat = rng.rand(2, 64) < 0.3
    yxyx[..., 2] = np.where(flat, yxyx[..., 0], yxyx[..., 2])
    yxyx[:, 0, 2] = yxyx[:, 0, 0]
    yxyx[:, 1:4] = yxyx[:, :1]          # three copies of a zero-area box
    return yxyx, valid, 0.5, 100


def _assert_plain_matches_reference(yxyx, valid, thresh, cap):
    """The plain version equals the fixpoint, the sequential loop and the
    Pallas kernel (interpret mode) on every row."""
    import jax.numpy as jnp
    from masklab_tpu.ops.nms import nms_keep_mask, nms_keep_mask_sequential
    from masklab_tpu.ops.pallas import nms_keep_mask_pallas
    got = kc.nms_keep_mask_plain(torch.from_numpy(yxyx),
                                 torch.from_numpy(valid), thresh, cap).numpy()
    for row in range(yxyx.shape[0]):
        b, v = jnp.asarray(yxyx[row]), jnp.asarray(valid[row])
        np.testing.assert_array_equal(
            got[row], np.asarray(nms_keep_mask(b, v, thresh, cap)))
        np.testing.assert_array_equal(
            got[row], np.asarray(nms_keep_mask_sequential(b, v, thresh, cap)))
        np.testing.assert_array_equal(got[row], np.asarray(
            nms_keep_mask_pallas(b, v, thresh, cap, interpret=True)))


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('thresh,cap', [(0.4, 100), (0.6, 8), (0.5, 3)])
def test_nms_keep_plain_matches_reference(seed, thresh, cap):
    """Exact: the fixpoint, the sequential loop and the Pallas kernel."""
    _assert_plain_matches_reference(*_nms_case(seed), thresh, cap)


@pytest.mark.parametrize('name', ['K=1 cap=1', 'K=63 cap=100', 'K=65 cap=65',
                                  'no valid box', 'IoU == t', 'zero-area'])
def test_nms_keep_plain_matches_reference_edges(name):
    """Exact at the edge cases the CUDA kernel is held to on the card."""
    _assert_plain_matches_reference(*_nms_edge(name))


def test_nms_edge_iou_equals_threshold():
    """The integer-grid case really has IoU == t: [0,0,10,10] keeps
    [0,0,10,5] (IoU exactly 0.5, not > 0.5) and removes [0,0,10,6]."""
    yxyx, valid, thresh, cap = _nms_edge('IoU == t')
    keep = kc.nms_keep_mask_plain(torch.from_numpy(yxyx),
                                  torch.from_numpy(valid), thresh, cap)
    assert keep[:, :3].tolist() == [[True, True, False]] * 3


@pytest.mark.gpu
@pytest.mark.parametrize('r,k,thresh', [(80, 256, 0.4), (16, 500, 0.6),
                                        (4, 1000, 0.5)])
def test_nms_keep_kernel_matches_plain(cuda, r, k, thresh):
    yxyx, valid = _nms_case(3, r, k)
    boxes = torch.from_numpy(yxyx).to(cuda)
    v = torch.from_numpy(valid).to(cuda)
    got = kc.nms_keep_mask(boxes, v, thresh, 100)
    assert torch.equal(got, kc.nms_keep_mask_plain(boxes, v, thresh, 100))


@pytest.mark.gpu
@pytest.mark.parametrize('name', [
    f'K={k} cap={cap}' for k in (1, 63, 64, 65, 256, 500, 1536, 2048)
    for cap in sorted({1, 100, k})] + ['no valid box', 'IoU == t',
                                       'zero-area'])
def test_nms_keep_kernel_matches_plain_edges(cuda, name):
    """Exact, K up to MAX_K = 2048 (above ~1280 the rows stay spread over
    the cluster's shared memory)."""
    yxyx, valid, thresh, cap = _nms_edge(name)
    boxes = torch.from_numpy(yxyx).to(cuda)
    v = torch.from_numpy(valid).to(cuda)
    got = kc.nms_keep_mask(boxes, v, thresh, cap)
    assert torch.equal(got, kc.nms_keep_mask_plain(boxes, v, thresh, cap))
