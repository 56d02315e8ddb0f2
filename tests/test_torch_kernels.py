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


# ---- K4: the thresholded statistics of the mask paste ----

PASTE_CLASSES = 6


def _paste_scene(seed, b, k, hw, ms, kept=1.0, classes=PASTE_CLASSES):
    """Forced-dense detection rows as the predictor hands them over (int
    boxes in frame pixels, confidence x100), random 0/1 RoI masks and a
    noisy my_road trapezoid -> (det [B, K, 6] f32, masks [B, K, mh, mw]
    int32, my_road [B, H, W] bool). Box sides are log-uniform from one
    pixel to the frame; ``kept`` of the slots score 50 or more; classes
    are drawn from ``classes``; the last two rows of each image are
    padding (class -1, confidence -1, mask 0)."""
    h, w = hw
    mh, mw = (ms, ms) if isinstance(ms, int) else ms
    rng = np.random.RandomState(seed)

    def side(n):
        return np.exp(rng.uniform(0, np.log(n), (b, k)))

    conf = np.where(rng.rand(b, k) < kept, rng.uniform(50, 100, (b, k)),
                    rng.uniform(0, 50, (b, k)))
    det = np.stack([rng.rand(b, k) * w, rng.rand(b, k) * h, side(w), side(h),
                    rng.randint(0, classes, (b, k)), conf], -1)
    det = det.astype(np.int32).astype(np.float32)
    masks = (rng.rand(b, k, mh, mw) > 0.5).astype(np.int32)
    det[:, -2:, 4:] = -1
    masks[:, -2:] = 0
    ys, xs = np.arange(h)[:, None], np.arange(w)[None]
    road = (ys >= h // 3) & (np.abs(xs - w * 0.5) < ys / h * w * 0.4)
    return det, masks, road[None] ^ (rng.rand(b, h, w) > 0.97)


def _paste_edge_scene():
    """Boxes at every frame edge, past the frame, full-frame, spans of 1,
    2 (positions 0 and mh - 1 only), 28 (integer positions) and 55, one
    clipped to nothing; in image 0 one box under 50 (not kept) and two
    padding rows; in image 1 every score under 50, so every slot is kept,
    padding included. A full mask and a checkerboard among random ones."""
    h, w = 96, 128
    boxes = [(5, 5, 30, 30), (w - 3, h - 3, 40, 40), (1, h // 2, 6, 20),
             (w // 2, 1, 20, 6), (w - 1, h // 2, 6, 20),
             (w // 2, h - 1, 20, 6), (w // 2, h // 2, w, h),
             (w // 2, h // 2, 3 * w, 3 * h), (10, 20, 1, 1), (30, 40, 2, 2),
             (60, 50, 28, 28), (70, 45, 55, 55), (w + 10, h + 10, 4, 4),
             (40, 30, 50, 33), (0, 0, 0, 0), (0, 0, 0, 0)]
    k = len(boxes)
    rng = np.random.RandomState(21)
    det = np.zeros((2, k, 6), np.float32)
    det[:, :, :4] = boxes
    det[:, :, 4] = np.arange(k) % PASTE_CLASSES
    det[0, :, 5] = rng.uniform(60, 100, k)
    det[0, 13, 5] = 20
    det[1, :, 5] = rng.uniform(0, 50, k)
    det[:, -2:, 4:] = -1
    masks = (rng.rand(2, k, 28, 28) > 0.5).astype(np.int32)
    masks[:, 6] = 1
    masks[:, 7] = (np.arange(28)[:, None] + np.arange(28)) % 2
    masks[:, -2:] = 0
    ys, xs = np.arange(h)[:, None], np.arange(w)[None]
    road = np.broadcast_to((ys + xs) % 3 > 0, (2, h, w))
    return det, masks, road


def _paste_args(det, masks, road, device, classes=PASTE_CLASSES):
    """The wrapper's arguments for a scene, as paste_stats_and_union makes
    them: ((y1, y2, x1, x2, keep, masks, my_road), onehot [B, K, C])."""
    from masklab_tpu_torch.serving import postprocess as tpost
    from masklab_tpu_torch.serving.visualize import class_one_hot
    det_t = torch.from_numpy(det).to(device)
    road_t = torch.from_numpy(np.ascontiguousarray(road)).to(device)
    y1, y2, x1, x2, keep = tpost._paste_edges(det_t, road.shape[1:], 50.0)
    onehot = class_one_hot(det_t[..., 4].to(torch.int64),
                           classes) * keep[..., None]
    args = (y1, y2, x1, x2, keep, torch.from_numpy(masks).to(device).float(),
            road_t)
    return args, onehot


PASTE_CPU_SCENES = {'random 2 x 12 at 96x128': lambda: _paste_scene(
    11, 2, 12, (96, 128), 8, 0.8), 'edges': _paste_edge_scene}


@pytest.mark.parametrize('with_union', [False, True])
@pytest.mark.parametrize('scene', list(PASTE_CPU_SCENES))
def test_paste_reduce_cpu_takes_plain_path(scene, with_union):
    """On CPU tensors the wrapper is the plain version and launches
    nothing."""
    args, onehot = _paste_args(*PASTE_CPU_SCENES[scene](), 'cpu')
    onehot = onehot if with_union else None
    kc.reset_launch_counts()
    got = kc.paste_reduce(*args, onehot)
    want = kc.paste_reduce_plain(*args, onehot)
    assert kc.launch_counts()['paste_stats'] == 0
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)
    assert (got[3] is None) == (not with_union)


@pytest.mark.parametrize('scene', list(PASTE_CPU_SCENES))
def test_paste_reduce_plain_matches_full_paste(scene):
    """The plain version's four outputs are the reductions of
    crop_and_pad_masks' [B, K, H, W] paste thresholded at 0.5; its union
    is also what the kernel's class words give: each pixel ORs the class
    bit of every box over it (class_bits, union_from_bits)."""
    from masklab_tpu_torch.ops.cuda import paste_stats as ps
    from masklab_tpu_torch.serving import postprocess as tpost
    det, masks, road = PASTE_CPU_SCENES[scene]()
    args, onehot = _paste_args(det, masks, road, 'cpu')
    area, inter, rowany, union = kc.paste_reduce_plain(*args, onehot)
    th = tpost.crop_and_pad_masks(torch.from_numpy(det),
                                  torch.from_numpy(masks),
                                  road.shape[1:]) > 0.5
    road_t = args[-1]
    assert torch.equal(area, th.float().sum((2, 3)))
    assert torch.equal(inter, (road_t[:, None] & th).float().sum((2, 3)))
    assert torch.equal(rowany, th.any(-1))
    assert area.sum() > 0 and (inter < area).any()
    words = (th[..., None].to(torch.int32)
             * ps.class_bits(onehot)[:, :, None, None])   # [B, K, H, W, 1]
    ored = torch.zeros_like(words[:, 0])
    for i in range(words.shape[1]):
        ored |= words[:, i]
    assert torch.equal(union, ps.union_from_bits(ored, PASTE_CLASSES))
    assert torch.equal(
        tpost.crop_and_pad_masks(torch.from_numpy(det),
                                 torch.from_numpy(masks), road.shape[1:]),
        ps.paste(*args[:6], road.shape[1:]))


@pytest.mark.parametrize('mask_size', [1, 2, 28, 32])
def test_paste_weights_two_adjacent_taps(mask_size):
    """What the kernel's per-pixel arithmetic rests on: in each paste
    weight row of an inside pixel at most two taps are nonzero, floor(pos)
    and the one above it (none above the mask's last grid point), pos is
    in [0, mask_size - 1], and both weights are max(1 - |pos - g|, 0) as
    rounded in float32; outside pixels have none."""
    from masklab_tpu_torch.ops.cuda.paste_stats import (paste_span,
                                                        paste_weights)
    rng = np.random.RandomState(mask_size)
    size = 300
    lo = np.concatenate([rng.uniform(0, size, 400),
                         rng.randint(0, size, 200)]).astype(np.float32)
    hi = np.minimum(lo + np.concatenate(
        [rng.uniform(0, size, 300), rng.randint(0, 60, 300)]), size)
    lo, hi = torch.from_numpy(lo), torch.from_numpy(hi.astype(np.float32))
    wgt = paste_weights(lo, hi, size, mask_size)           # [N, size, ms]
    start, stop, den = (v[:, None] for v in paste_span(lo, hi))
    y = torch.arange(size, dtype=torch.float32)
    inside = (y >= start) & (y < stop)
    pos = (y - start) * (mask_size - 1) / den
    g0 = torch.floor(pos)
    assert ((pos[inside] >= 0) & (pos[inside] <= mask_size - 1)).all()
    grid = torch.arange(mask_size, dtype=torch.float32)
    at_tap = (grid == g0[..., None]) | (grid == g0[..., None] + 1)
    assert not (wgt[~at_tap] != 0).any()
    assert not (wgt[~inside] != 0).any()

    def tap(g):
        return torch.clamp(1.0 - torch.abs(pos - g), min=0.0)

    idx0 = g0.clamp(0, mask_size - 1).long()[..., None]
    idx1 = (g0 + 1).clamp(0, mask_size - 1).long()[..., None]
    w0 = wgt.gather(-1, idx0)[..., 0]
    w1 = torch.where(g0 + 1 < mask_size, wgt.gather(-1, idx1)[..., 0], 0.0)
    assert torch.equal(w0[inside], tap(g0)[inside])
    assert torch.equal(w1[inside], torch.where(
        g0 + 1 < mask_size, tap(g0 + 1), torch.zeros_like(pos))[inside])
    assert (tap(g0 + 1)[inside & (g0 + 1 >= mask_size)] == 0).all()


@pytest.mark.parametrize('classes', [1, 6, 31, 32, 33, 40, 70])
def test_class_words_round_trip(classes):
    """A union over any number of classes: class c is bit c % 32 of word
    c // 32 (bit 31 the sign bit), and ORing the words of several boxes
    gives each class present among them."""
    from masklab_tpu_torch.ops.cuda import paste_stats as ps
    rng = np.random.RandomState(classes)
    onehot = torch.from_numpy(
        (rng.rand(3, 9, classes) > 0.6).astype(np.float32))
    onehot[:, 0] = 0
    onehot[:, 1, -1] = 1
    bits = ps.class_bits(onehot)
    assert bits.dtype == torch.int32
    assert bits.shape == (3, 9, -(-classes // 32))
    back = ps.union_from_bits(bits[:, :, None], classes)[:, :, 0]
    assert torch.equal(back, onehot)
    ored = bits[:, 0] | bits[:, 1] | bits[:, 2]
    assert torch.equal(ps.union_from_bits(ored, classes),
                       onehot[:, :3].amax(1))


@pytest.mark.parametrize('mask_width,width,chunk', [
    (28, 1920, 1920), (28, 100, 128), (28, 5000, 4000), (1, 1, 32),
    (56, 8192, 3936), (1024, 2000, 1344), (1024, 64, 64)])
def test_paste_column_chunk(mask_width, width, chunk):
    """The columns a CTA stages at a time: whole warps, no more than the
    frame needs, and with the warps' mask-wide rows within the 48 KB of
    shared memory a launch gets without opting in."""
    from masklab_tpu_torch.ops.cuda import paste_stats as ps
    got = ps.column_chunk(mask_width, width)
    assert got == chunk and got % 32 == 0
    assert got * ps.TAP_BYTES + ps.WARPS * mask_width * 4 <= ps.SMEM_BYTES


@pytest.mark.parametrize('mask_width', [0, 1025, 4096])
def test_paste_column_chunk_refuses(mask_width):
    """Masks wider than the kernel takes raise: no plain version runs on
    the card in the kernel's place."""
    from masklab_tpu_torch.ops.cuda import paste_stats as ps
    with pytest.raises(ValueError, match='columns wide'):
        ps.column_chunk(mask_width, 1920)


def _full_width_rows(scene):
    """A scene with the first two rows of each image a box across the whole
    frame and one across nine tenths of it, both kept: boxes wider than the
    kernel's column chunk."""
    det, masks, road = scene
    h, w = road.shape[1:]
    det[:, 0, :4] = (w / 2, h / 2, w, h)
    det[:, 1, :4] = (w / 2 + 7, h / 2, int(w * 0.9), h - 3)
    det[:, :2, 5] = 90
    return det, masks, road


PASTE_GPU_SCENES = {
    'cell b16 x 100 at 1080x1920 seed 15': lambda: _paste_scene(
        15, 16, 100, (1080, 1920), 28, 1.0),
    'cell b16 x 100 at 1080x1920 seed 16': lambda: _paste_scene(
        16, 16, 100, (1080, 1920), 28, 1.0),
    'cell, a third under 50': lambda: _paste_scene(
        17, 16, 100, (1080, 1920), 28, 0.67),
    'small 2 x 12 at 96x128': lambda: _paste_scene(
        18, 2, 12, (96, 128), 8, 0.8),
    'masks 32 x 32 at 4096 wide': lambda: _paste_scene(
        19, 2, 20, (64, 4096), 32, 1.0),
    'masks 14 x 20 at 200x300': lambda: _paste_scene(
        20, 3, 30, (200, 300), (14, 20), 0.9),
    'masks 56 x 56 at 200x300': lambda: _paste_scene(
        23, 2, 16, (200, 300), 56, 0.9),
    'masks 28 at 5000 wide, two column chunks': lambda: _full_width_rows(
        _paste_scene(24, 2, 12, (48, 5000), 28, 1.0)),
    'masks 8 x 1024 at 2000 wide, two column chunks': lambda:
        _full_width_rows(_paste_scene(25, 2, 10, (40, 2000), (8, 1024))),
    'a union over 40 classes': lambda: _paste_scene(
        26, 2, 24, (96, 128), 28, 1.0, classes=40),
    'edges': _paste_edge_scene,
}
PASTE_GPU_CLASSES = {'a union over 40 classes': 40}


@pytest.mark.gpu
@pytest.mark.parametrize('with_union', [False, True])
@pytest.mark.parametrize('scene', list(PASTE_GPU_SCENES))
def test_paste_reduce_kernel_matches_plain(cuda, scene, with_union):
    """Exact: not one thresholded pixel flips (area, inter and the row
    map equal, the union equal), in one kernel launch a call."""
    args, onehot = _paste_args(*PASTE_GPU_SCENES[scene](), cuda,
                               PASTE_GPU_CLASSES.get(scene, PASTE_CLASSES))
    onehot = onehot if with_union else None
    before = kc.launch_counts()['paste_stats']
    got = kc.paste_reduce(*args, onehot)
    torch.cuda.synchronize()
    assert kc.launch_counts()['paste_stats'] == before + 1
    want = kc.paste_reduce_plain(*args, onehot)
    flips = {name: int((g != w).sum()) for name, g, w in zip(
        ('area', 'inter', 'rowany', 'union'), got, want) if w is not None}
    assert (got[3] is None) == (not with_union)
    assert not any(flips.values()), flips
    assert want[0].sum() > 0


@pytest.mark.gpu
def test_paste_reduce_refuses_wide_masks(cuda):
    """Masks wider than the kernel takes raise on the card, launching
    nothing (the plain version never runs there in its place)."""
    args, onehot = _paste_args(*_paste_scene(22, 2, 4, (32, 48), (4, 1025)),
                               cuda)
    before = kc.launch_counts()['paste_stats']
    with pytest.raises(ValueError, match='columns wide'):
        kc.paste_reduce(*args, onehot)
    assert kc.launch_counts()['paste_stats'] == before


# ---- K5: eval BatchNorm with its residual add and activation ----

def _bn_module(c, seed, use_scale=True, eps=1e-3):
    """A BatchNorm with seeded parameters and running statistics."""
    from masklab_tpu_torch.nn.layers import BatchNorm
    bn = BatchNorm(c, eps, use_scale)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        if bn.weight is not None:
            bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.uniform_(-0.3, 0.3, generator=g)
        bn.running_mean.uniform_(-0.5, 0.5, generator=g)
        bn.running_var.uniform_(0.2, 2.0, generator=g)
    return bn


def _chain_before_k5(bn, x):
    """``BatchNorm.forward`` as written before K5 (single device, no sync),
    with its running-statistics update in train mode."""
    shape = (1, -1, 1, 1)
    f = x.to(torch.promote_types(x.dtype, torch.float32))
    if bn.training:
        mean = f.mean((0, 2, 3))
        mean_sq = f.square().mean((0, 2, 3))
        var = torch.clamp(mean_sq - mean.square(), min=0.0)
        with torch.no_grad():
            m = bn.momentum
            bn.running_mean.copy_(m * bn.running_mean + (1 - m) * mean)
            bn.running_var.copy_(m * bn.running_var + (1 - m) * var)
    else:
        mean, var = bn.running_mean, bn.running_var
    mul = torch.rsqrt(var + bn.eps)
    if bn.weight is not None:
        mul = mul * bn.weight
    y = (f - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)
    return y.to(x.dtype)


def _site_before_k5(bn, x, act, residual):
    """The call sites' chains as written before K5: ``relu(bn(x))``,
    ``F.silu(bn(x))``, ``bn(x) + r``, ``relu(bn(x) + r)``."""
    import torch.nn.functional as F
    y = _chain_before_k5(bn, x)
    if residual is not None:
        y = y + residual
    if act == 'relu':
        y = torch.relu(y)
    elif act == 'silu':
        y = F.silu(y)
    return y


# site -> (act, with a residual)
K5_SITES = {'bn': (None, False), 'relu(bn)': ('relu', False),
            'silu(bn)': ('silu', False), 'bn + r': (None, True),
            'relu(bn + r)': ('relu', True)}


def _k5_inputs(seed, shape, dtype, layout, device='cpu', residual=True):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=device) * 3 + 0.5).to(dtype)
    r = (torch.randn(shape, generator=g, device=device) * 2).to(dtype)
    if layout == 'channels_last':
        x = x.contiguous(memory_format=torch.channels_last)
        r = r.contiguous(memory_format=torch.channels_last)
    return x, (r if residual else None)


@pytest.mark.parametrize('use_scale', [True, False])
@pytest.mark.parametrize('mode', ['eval', 'train'])
@pytest.mark.parametrize('layout', ['channels_last', 'contiguous'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('site', list(K5_SITES))
def test_batch_norm_act_plain_path_matches_chain(site, dtype, layout, mode,
                                                 use_scale):
    """``BatchNorm.forward(x, act=..., residual=...)`` on the CPU equals the
    call site's chain as written before K5 bit for bit, in its layout; in
    train mode also the running statistics and the gradients of x, the
    residual and the parameters."""
    act, with_res = K5_SITES[site]
    train = mode == 'train'
    x, r = _k5_inputs(1, (3, 24, 7, 9), getattr(torch, dtype), layout,
                      residual=with_res)
    got_bn, want_bn = (_bn_module(24, 0, use_scale).train(train)
                       for _ in range(2))
    leaves = []
    for bn in (got_bn, want_bn):
        xi = x.detach().clone().requires_grad_(train)
        ri = None if r is None else r.detach().clone().requires_grad_(train)
        leaves.append((xi, ri, bn))
    (gx, gr, _), (wx, wr, _) = leaves
    got = got_bn(gx, act=act, residual=gr)
    want = _site_before_k5(want_bn, wx, act, wr)
    assert got.dtype == want.dtype
    assert got.stride() == want.stride()
    assert torch.equal(got, want)
    assert torch.equal(got_bn.running_mean, want_bn.running_mean)
    assert torch.equal(got_bn.running_var, want_bn.running_var)
    if train:
        w = torch.linspace(-1, 1, got.numel()).reshape(got.shape)
        (got.float() * w).sum().backward()
        (want.float() * w).sum().backward()
        pairs = [(gx.grad, wx.grad), (got_bn.bias.grad, want_bn.bias.grad)]
        if use_scale:
            pairs.append((got_bn.weight.grad, want_bn.weight.grad))
        if gr is not None:
            pairs.append((gr.grad, wr.grad))
        for a, b in pairs:
            assert torch.equal(a, b)


@pytest.mark.parametrize('site', list(K5_SITES))
def test_batch_norm_act_cpu_wrapper_takes_plain(site):
    """On the CPU the wrapper is its plain version, launching and counting
    nothing; an unknown activation raises."""
    from masklab_tpu_torch.ops.cuda import batch_norm_act as bna
    act, with_res = K5_SITES[site]
    x, r = _k5_inputs(2, (2, 16, 5, 6), torch.bfloat16, 'channels_last',
                      residual=with_res)
    bn = _bn_module(16, 3).eval()
    kc.reset_launch_counts()
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    got = bna.batch_norm_act(x, bn.running_mean, mul, bn.bias, r, act)
    with torch.no_grad():
        assert torch.equal(got, bn(x, act=act, residual=r))
        assert torch.equal(got, _site_before_k5(bn, x, act, r))
    assert kc.launch_counts()['batch_norm_act'] == 0
    with pytest.raises(ValueError, match='act must be one of'):
        bn(x, act='gelu')


@pytest.mark.parametrize('use_scale', [True, False])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('site', list(K5_SITES))
def test_batch_norm_act_fn_gradients_are_plain_chains(monkeypatch, site,
                                                      dtype, use_scale):
    """``BatchNormActFn``'s backward (K5 under autograd) gives the plain
    chain's gradients of x, the residual, the weight and the bias bit for
    bit, and none for the running mean; its forward's launch is replaced
    by the plain version here, which has no card."""
    from masklab_tpu_torch.ops.cuda import batch_norm_act as bna
    monkeypatch.setattr(bna, '_launch', bna.batch_norm_act_plain)
    act, with_res = K5_SITES[site]
    x, r = _k5_inputs(12, (3, 24, 7, 9), getattr(torch, dtype),
                      'channels_last', residual=with_res)
    bn = _bn_module(24, 13, use_scale).eval()
    w = torch.linspace(-1, 1, x.numel()).reshape(x.shape)
    grads = []
    for fn in (bna.BatchNormActFn.apply, bna.batch_norm_act_plain):
        xi = x.detach().clone().requires_grad_(True)
        ri = None if r is None else r.detach().clone().requires_grad_(True)
        bn.zero_grad(set_to_none=True)
        y = fn(xi, bn.running_mean, bn._mul(bn.running_var), bn.bias, ri,
               act)
        (y.float() * w).sum().backward()
        grads.append([y.detach(), xi.grad, bn.bias.grad]
                     + ([] if ri is None else [ri.grad])
                     + ([bn.weight.grad] if use_scale else []))
    assert bn.running_mean.grad is None
    for got, want in zip(*grads):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)


def _k5_launch(x, bn, act, r):
    from masklab_tpu_torch.ops.cuda import batch_norm_act as bna
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    before = kc.launch_counts()['batch_norm_act']
    got = bna.batch_norm_act(x, bn.running_mean, mul, bn.bias, r, act)
    torch.cuda.synchronize()
    assert kc.launch_counts()['batch_norm_act'] == before + 1
    want = bna.batch_norm_act_plain(x, bn.running_mean, mul, bn.bias, r, act)
    return got, want


# name -> (C, H, W) at batch 16: the stem's and the B4 expand's channels, the
# widest B4 maps, and odd C (the scalar path); 17x30 holds no whole vector a
# plane in NCHW (the planar scalar path)
K5_MAPS = {'C=8 at 270x480': (8, 270, 480),
           'C=64 at 270x480 (the stem)': (64, 270, 480),
           'C=144 at 135x240': (144, 135, 240),
           'C=1792 at 17x30': (1792, 17, 30),
           'C=2688 at 17x30': (2688, 17, 30),
           'C=37 at 68x120 (odd C)': (37, 68, 120),
           'C=3 at 17x30': (3, 17, 30)}


@pytest.mark.gpu
@pytest.mark.parametrize('layout', ['channels_last', 'contiguous'])
@pytest.mark.parametrize('with_res', [False, True])
@pytest.mark.parametrize('act', [None, 'relu', 'silu'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16', 'float16'])
@pytest.mark.parametrize('name', list(K5_MAPS))
def test_batch_norm_act_kernel_matches_plain(cuda, name, dtype, act,
                                             with_res, layout):
    """``torch.equal`` to the plain chain on the card, in one launch, the
    output in the map's layout."""
    c, h, w = K5_MAPS[name]
    x, r = _k5_inputs(4, (16, c, h, w), getattr(torch, dtype), layout, cuda,
                      with_res)
    got, want = _k5_launch(x, _bn_module(c, 5).to(cuda), act, r)
    assert got.stride() == x.stride()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize('layout', ['channels_last', 'contiguous'])
@pytest.mark.parametrize('act', [None, 'relu', 'silu'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16', 'float16'])
def test_batch_norm_act_kernel_unaligned(cuda, dtype, act, layout):
    """A map one element past a 16-byte boundary (a view with a storage
    offset) takes the scalar path, with the same bits."""
    n, c, h, w = 2, 64, 9, 16
    dt = getattr(torch, dtype)
    base, r = _k5_inputs(6, (n * c * h * w + 1,), dt, 'contiguous', cuda)
    if layout == 'channels_last':
        x = base[1:].view(n, h, w, c).permute(0, 3, 1, 2)
        r = r[1:].view(n, h, w, c).permute(0, 3, 1, 2)
    else:
        x, r = base[1:].view(n, c, h, w), r[1:].view(n, c, h, w)
    fmt = (torch.channels_last if layout == 'channels_last'
           else torch.contiguous_format)
    assert x.is_contiguous(memory_format=fmt) and x.data_ptr() % 16
    got, want = _k5_launch(x, _bn_module(c, 7).to(cuda), act, r)
    assert torch.equal(got, want)


def _seeded_norms(model, seed):
    from masklab_tpu_torch.nn.layers import BatchNorm
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                if m.weight is not None:
                    m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.3, 0.3, generator=g)
                m.running_mean.uniform_(-0.3, 0.3, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return model


# body -> K5 launches a forward: one a BatchNorm
K5_BODIES = {'resnet50': 53, 'efficientnetb4': 96}


@pytest.mark.gpu
@pytest.mark.parametrize('body', list(K5_BODIES))
def test_batch_norm_act_body_forward(cuda, body, monkeypatch):
    """A bf16 body's eval forward launches K5 once a BatchNorm, under
    ``inference_mode`` and with autograd on alike; its endpoints equal the
    same forward with every BatchNorm's chain in plain PyTorch ops on the
    card (same layouts, so the same convolutions), which launches none."""
    from masklab_tpu_torch.nn.backbone.efficientnet import efficientnet
    from masklab_tpu_torch.nn.backbone.resnet import resnet50
    from masklab_tpu_torch.ops.cuda import batch_norm_act as bna
    make = {'resnet50': lambda: resnet50(torch.bfloat16),
            'efficientnetb4': lambda: efficientnet('efficientnetb4',
                                                   torch.bfloat16)}[body]
    model = _seeded_norms(make(), 8).to(cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(9)
    x = (torch.rand(2, 3, 96, 160, generator=g, device=cuda) * 2 - 1
         ).contiguous(memory_format=torch.channels_last)
    kc.reset_launch_counts()
    with torch.inference_mode():
        got = model(x)
    torch.cuda.synchronize()
    assert kc.launch_counts()['batch_norm_act'] == K5_BODIES[body]
    graphed = model(x)
    assert kc.launch_counts()['batch_norm_act'] == 2 * K5_BODIES[body]
    monkeypatch.setattr(bna, 'batch_norm_act', bna.batch_norm_act_plain)
    want = model(x)
    assert kc.launch_counts()['batch_norm_act'] == 2 * K5_BODIES[body]
    assert sorted(got) == sorted(want) == sorted(graphed)
    for k in got:
        assert torch.isfinite(got[k]).all(), k
        assert torch.equal(got[k], want[k].detach()), k
        assert torch.equal(graphed[k].detach(), want[k].detach()), k


@pytest.mark.gpu
@pytest.mark.parametrize('act', [None, 'relu', 'silu'])
def test_batch_norm_act_autograd_and_layouts(cuda, act):
    """Train mode launches nothing. An eval call with autograd on launches
    K5 once and gives the plain chain's output and gradients (x, residual,
    weight, bias) bit for bit; so do NCHW maps without autograd; a map in
    neither layout raises, launching nothing."""
    from masklab_tpu_torch.ops.cuda import batch_norm_act as bna
    bn = _bn_module(64, 10).to(cuda)
    x, r = _k5_inputs(11, (4, 64, 12, 20), torch.bfloat16, 'channels_last',
                      cuda)
    kc.reset_launch_counts()
    bn.train()
    bn(x, act=act, residual=r)
    assert kc.launch_counts()['batch_norm_act'] == 0
    bn.eval()
    w = torch.linspace(-1, 1, x.numel(), device=cuda).reshape(x.shape)
    outs = []
    for fn in (lambda xi, ri: bn(xi, act=act, residual=ri),
               lambda xi, ri: bna.batch_norm_act_plain(
                   xi, bn.running_mean, bn._mul(bn.running_var), bn.bias,
                   ri, act)):
        xi = x.detach().clone().requires_grad_(True)
        ri = r.detach().clone().requires_grad_(True)
        bn.zero_grad(set_to_none=True)
        y = fn(xi, ri)
        (y.float() * w).sum().backward()
        outs.append((y.detach(), xi.grad, ri.grad, bn.weight.grad,
                     bn.bias.grad))
    assert kc.launch_counts()['batch_norm_act'] == 1
    for got, want in zip(*outs):
        assert torch.equal(got, want)
    with torch.no_grad():
        nchw = bn(x.contiguous(), act=act, residual=r.contiguous())
    assert kc.launch_counts()['batch_norm_act'] == 2
    assert nchw.is_contiguous() and torch.equal(nchw, outs[0][0])
    with pytest.raises(ValueError, match='channels_last- or NCHW'):
        with torch.no_grad():
            bn(x[:, :, :, ::2])
    with pytest.raises(ValueError, match='layout'):
        with torch.no_grad():
            bn(x, residual=r.contiguous())
    assert kc.launch_counts()['batch_norm_act'] == 2
