#!/usr/bin/env python3
"""Smoke run of the PyTorch port (masklab_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--kernels-only | --serve-only | --trainer-only]

Phases, each of which fails the run (non-zero exit, no result line):

  1. card: prints ``nvidia-smi --query-gpu=name,power.limit``;
  2. build: compiles the CUDA kernels from ``masklab_tpu_torch/csrc``;
  3. kernels: holds each kernel against its plain PyTorch version at the
     main path's shapes and at edge cases (K2, K3 exact; K1 f32 within
     2e-5, bf16 within 4 bf16 ulp at operand scale of the plain version and
     0.51 ulp of its f64 evaluation; K1's backward within K1B_*) and times
     each kernel at the main path's shapes: ``device_ms`` (= ``ms``), its
     own mean duration on the device from ``torch.profiler``; ``call_ms``,
     CUDA events around back-to-back wrapper calls, host work included; the
     plain version and, where one exists, the one PyTorch call computing
     the same function (``library_ms``); K3's device time split into the
     bitmask build and the sweep; K2 timed with the L2 flushed before each
     launch (its ``ms``) and back to back, the whole candidate pool around
     it (``pool_ms``), and at the road preset's call form (exact, cold);
  4. reference: narrow float32 models (width 32, depth 1, 512 px) of the
     headline configuration and of the road preset on the card against the
     same models on the CPU, where every kernel's plain version runs; and
     one train step of a narrow float32 model on the resnext50 body (128
     px) on the card against a float64 step on the CPU, each tensor within
     TRAIN_REF_RATIO x the CPU float32 step's own error, with a TF32 step
     as the control that must fail (``check_train_reference``);
  5. serve: two deployments behind ``MaskLabPredictor``, forced dense, 512
     px: the headline (mobilenet, width 128, depth 4, bf16, batch 16) and
     the road preset (seresnet34, squeeze-excite heads, bf16, batch 8).
     Each answers 3 requests in each output mode (raw, visualize,
     summarize), each mode with its launch counts and certificate
     fallbacks counted from 0 just before it; each request's model outputs
     must be finite, every slot must fill, every kernel must launch on
     every forward, and each mode's outputs have their shapes and finite
     analytics. One more request per mode, traced with ``torch.profiler``,
     splits its host and device time by the predictor's stage spans
     (``analytics`` and ``draw`` inside ``postprocess``). On the headline
     predictor also: the visualize / summarize postprocess of the same
     model outputs on the card and on the CPU (frames exact, analytics to
     the CPU tests' tolerance); 16 concurrent clients through a
     ``MicroBatcher`` (each answered, a batch above 1); HTTP and gRPC
     round trips on localhost;
  6. train: bench.py's train step (resnext50, bf16, batch 4 at 256 px):
     TRAIN_WARMUP steps, then TRAIN_STEPS counted ones with their launches
     counted from 0 before each (every loss finite; K1, K1's backward and
     K3 launched in every step), the peak memory, one traced step split by
     its ``stage:`` spans and one step with metrics (``train_path``); K1's
     backward held against its plain version and timed at the maps that
     step gave it (``k1_backward_at``);
  7. trainer: the user's training path through the CLI (``trainer_path``):
     ``etl`` of 40 synthetic 1080x1920 road frames, ``train`` with the
     road preset at full width (bf16, batch 8, buckets 0.4-0.6: 416x768 to
     640x1152; smoke check, then head / waist / all of 2 steps each, each
     epoch validated and checkpointed) and its eval, then ``eval`` again.
     Every step's loss finite, K1, K1's backward, K2 and K3 launched in
     it; metrics.csv, the checkpoints (best by parsed loss, the last
     restored bit for bit into a new state) and eval.json checked; every
     generator batch equal to its host replay from the same seed. Then
     K1's backward at the maps a trainer step gave it and one traced step
     (data wait, upload and the step's spans). K2 (phase 3) is also held
     and timed at the trainer's row lengths (the road preset's anchors at
     the 0.4 and 0.6 buckets of a 1080p frame).

Then it prints the ``kernels`` JSON line (each kernel's ``launches`` from
the headline raw path, K1's backward's from the train path,
``launches_by_path`` for every path), the card line and, last, ``{"ok":
true, "device": {...}}``. It needs a CUDA card, the repo, and cv2 and grpc
for the servers.

``--kernels-only`` runs phases 1-3 at the main path's shapes alone (no
edge cases, no split of K3; K1's backward also at K1B_TRAIN_MAPS, the
maps a train step gave it): copied into another tree of the repo that
has ``segment_topk_rows``, it times that tree's kernels the same way, for
comparing two trees in one call. ``--serve-only`` runs phases 1, 2 and the
two deployments' serve paths (phase 5 without the headline's extras), for
comparing the serve paths of two trees the same way. ``--trainer-only``
runs phases 1, 2, K2's check (without its edge cases) and phase 7.
``--reference-draws N`` runs phases 1, 2 and phase 4's train reference at
N fresh batch seeds, reporting each verdict (a failing draw does not fail
the run).
"""
import argparse
import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12         # FP32 outside the tensor cores
# K3's greedy sweep: cycles each dependent step needs at least, an estimate
# at the order of Hopper's shared-memory and shuffle latencies: a shuffle of
# the removed word per box, one shared-memory load more per kept box
SWEEP_CYCLES_PER_BOX = 30
SWEEP_CYCLES_PER_KEEP = 30
BATCH, ROAD_BATCH, SIZE, REQUESTS = 16, 8, 512, 3
DEVICE = 'cuda'
MODES = ('raw', 'visualize', 'summarize')
# kernel launches per forward at 512 px, forced dense: K1 in the 4
# GroupNorms of each of the 3 mask-head levels (14x14 crops: 196 pixels,
# ragged for 16 groups), K2 once for the candidate pool, K3 in both stages
PER_FORWARD = {'band_groupnorm': 12, 'segment_topk': 1, 'nms_keep': 2}
K1_F32_ATOL = 2e-5             # f32 statistics summed in another order
# bf16, in ulps at operand scale. Against the plain version: it rounds m1,
# inv, scale, bias and four operations to bf16, and even the exactly rounded
# result lies up to 4 ulp from it. Against the f64 reference: the kernel
# rounds its f32 result once, so half an ulp plus the f32 statistics' error.
K1_BF16_ULPS = 4.0
K1_BF16_EXACT_ULPS = 0.51
# K1 maps besides the main one, (n, Q, C) at G=16: batch edges, a longer
# band (C=256), cg=3 (the block path) and a band too long for registers
K1_EDGES = [(1, 196, 128), (7, 196, 128), (533, 196, 128), (7, 196, 256),
            (7, 49, 48), (7, 784, 256)]
# K1's backward: dx f32 within the JAX package's own gradient tolerance
# (tests/test_pallas_kernels.py:118-138); bf16 dx in ulps at operand scale,
# where kernel and plain version each round one f32 result once (1 ulp, and
# 1% for f32 sums in another order); dscale / dbias (f32 sums of up to
# N*Q products per channel, in another order) relative to the sum of their
# terms' magnitudes.
K1B_F32_ATOL = 5e-5
K1B_BF16_ULPS = 1.01
K1B_PARAM_RTOL = 1e-4
# (n, Q, C, G): the train path's mask-head map (4 images x (8 gts + 100
# proposals) = 432 RoIs at most, 14 x 14, C=128), its P7 heads' 2x2 maps
# (G=16 > Q=4) and its P6 norm's 4x4 map at G=32, then K1_EDGES at G=16
K1B_MAIN = (432, 196, 128, 16)
K1B_SHAPES = ([K1B_MAIN, (4, 4, 128, 16), (4, 16, 128, 32)]
              + [(n, q, c, 16) for n, q, c in K1_EDGES])
# The maps one train step (train_path, seeded) gives K1's backward on the
# card, as k1_backward_shapes records them (two mask-head levels, the P7
# heads' 2x2 maps, the P6 norm), times their calls a step: --kernels-only
# and the gpu tests time these, and train_path holds them against what it
# records (check_train_maps)
K1B_TRAIN_MAPS = ([[144, 196, 128, 16, 'bfloat16', True]] * 4
                  + [[92, 196, 128, 16, 'bfloat16', True]] * 4
                  + [[4, 4, 128, 16, 'bfloat16', True]] * 8
                  + [[4, 16, 128, 32, 'bfloat16', False]])
# check_train_maps: a recorded map's sample count within this share of
# K1B_TRAIN_MAPS's (a mask-head level's RoIs follow the proposals over the
# loss NMS's floor, and the card's step is not bit-reproducible: gather's
# backward adds with float atomics)
K1B_TRAIN_N_RTOL = 0.1
TRAIN_BATCH, TRAIN_SIZE, TRAIN_WARMUP, TRAIN_STEPS = 4, 256, 3, 20
# check_train_reference: each tensor of the card's float32 step within
# TRAIN_REF_RATIO x the CPU float32 step's own distance from the float64
# step, plus TRAIN_REF_FLOOR of the tensor's scale
TRAIN_REF_RATIO = 8.0
TRAIN_REF_FLOOR = 1e-5
# traces of one measurement before a trace with no kernel record fails it
PROFILE_TRIES = 3


def card_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean time per call between CUDA events around ``iters`` back-to-back
    calls: a call's host work counts wherever it is longer than the device
    work it enqueues."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def traced(body, ok, what: str, host: bool = False):
    """``body()`` under ``torch.profiler`` (device kernels, and host
    operations with ``host``): ``(prof, body's result)``. The tracer on the
    card now and then delivers none of a window's kernel records, so a
    trace for which ``ok(prof)`` is false is made again, up to
    PROFILE_TRIES times in all, each retry noted on stderr; then it raises.
    The kernels' results are checked elsewhere: this only repeats a
    measurement that saw nothing."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if host else [])
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=activities) as prof:
            result = body()
        if DEVICE != 'cuda' or ok(prof):
            return prof, result
        print(f'profiler: trace {attempt} of {PROFILE_TRIES} saw no {what}',
              file=sys.stderr, flush=True)
    raise AssertionError(f'profiler saw no {what} in {PROFILE_TRIES} traces')


def warm_profiler(tries: int = 5) -> int:
    """Trace 100 small kernels until a trace holds a record of them (the
    tracer's first sessions in a process can deliver none, and a window of
    one launch then misses every try): -> the traces it took."""
    x = torch.zeros(1 << 20, device=DEVICE)
    cuda = torch.autograd.DeviceType.CUDA
    for attempt in range(1, tries + 1):
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(100):
                x.add_(1.0)
            torch.cuda.synchronize()
        if any(e.device_type == cuda for e in prof.key_averages()):
            return attempt
    raise AssertionError(f'profiler saw no kernel in {tries} warm-up traces')


def device_split(fn, iters: int, symbol=None, exclude=()) -> dict:
    """Each device kernel of ``fn`` whose symbol contains ``symbol`` (every
    kernel when None) and is not in ``exclude``, by its short name: its
    launches per call and its device ms per call, the mean duration in
    ``torch.profiler``'s ``key_averages`` over ``iters`` calls times its
    launches per call. Means, not totals over ``iters``, because the
    tracer may drop a kernel's record now and then. The symbols that share
    a short name (template instances of one kernel) add up under it."""
    cuda = torch.autograd.DeviceType.CUDA

    def hits(prof):
        return [e for e in prof.key_averages() if e.device_type == cuda
                and (symbol is None or symbol in e.key)
                and e.key not in exclude and e.count]

    def body():
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()

    fn()
    torch.cuda.synchronize()
    prof, _ = traced(body, lambda p: bool(hits(p)),
                     f'kernel matching {symbol!r}')
    split = {}
    for e in hits(prof):
        m = re.search(r'(\w+)(?:<|\(|$)', e.key)
        name = m.group(1) if m else e.key
        per_call = max(1, round(e.count / iters))
        k = split.setdefault(name, dict(launches_per_call=0, ms=0.0))
        k['launches_per_call'] += per_call
        k['ms'] += e.device_time_total / e.count * per_call / 1e3
    return split


def device_ms(fn, iters: int, symbol=None, exclude=()) -> float:
    """Mean device time per call of ``fn``: the sum of ``device_split``'s
    kernels."""
    return sum(k['ms'] for k in device_split(fn, iters, symbol,
                                             exclude).values())


def backward_timing(fn, iters: int) -> dict:
    """K1's backward timed by every device kernel its call launches:
    ``device_ms``, their sum; ``kernels_per_call``; ``by_kernel``, each
    kernel's own device ms per call."""
    split = device_split(fn, iters)
    return dict(device_ms=sum(k['ms'] for k in split.values()),
                kernels_per_call=sum(k['launches_per_call']
                                     for k in split.values()),
                by_kernel={n: k['ms'] for n, k in split.items()})


def max_sm_clock_hz() -> float:
    return 1e6 * float(subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.max.sm',
         '--format=csv,noheader,nounits'], check=True, capture_output=True,
        text=True).stdout.split()[0])


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """Spacing of bfloat16 values at magnitude |v| (8 significant bits)."""
    _, e = torch.frexp(v.abs().clamp(min=2.0 ** -126))
    return torch.ldexp(torch.ones_like(v), e - 8)


def k1_errors(kc, x, scale, bias, g: int, relu: bool):
    """K1 on ``x`` against its plain version and against the plain version
    evaluated in f64 (f32 statistics, as both use): max abs errors for f32;
    for bf16, max errors in bf16 ulps at operand scale."""
    got = kc.band_groupnorm(x, scale, bias, g, fuse_relu=relu).float()
    want = kc.band_groupnorm_plain(x, scale, bias, g, fuse_relu=relu).float()
    exact = kc.band_groupnorm_plain(x.double(), scale.double(), bias.double(),
                                    g, fuse_relu=relu)
    if x.dtype == torch.float32:
        return ((got - want).abs().max().item(),
                (got - exact).abs().max().item())
    # the scale of the chain's largest operand,
    # (|x| + |m1|) * inv * |scale| + |bias|
    n, q, c = x.shape
    xr = x.float()
    if relu:
        xr = torch.relu(xr)
    xr = xr.reshape(n, g, -1)
    m1 = xr.mean(-1, keepdim=True)
    inv = torch.rsqrt(torch.clamp(xr.square().mean(-1, keepdim=True)
                                  - m1 * m1, min=0.0) + 1e-5)
    reps = xr.shape[-1] // (c // g)
    ts = scale.reshape(g, c // g).repeat(1, reps)
    tb = bias.reshape(g, c // g).repeat(1, reps)
    mag = ((xr.abs() + m1.abs()) * inv * ts.abs() + tb.abs()).reshape(n, q, c)
    mag = torch.maximum(mag, torch.maximum(got.abs(), want.abs()))
    ulp = bf16_ulp(mag).double()
    return (((got - want).abs() / ulp).max().item(),
            ((got - exact).abs() / ulp).max().item())


def k1_cases(kc, rng, shapes, g=16):
    """K1 at each (n, Q, C), f32 and bf16, relu off and on; raises after
    trying them all if any is outside its tolerance."""
    cases, bad = [], []
    for n, q, c in shapes:
        x = torch.from_numpy(rng.randn(n, q, c).astype(np.float32) * 2
                             + 1).to(DEVICE)
        scale = torch.from_numpy(rng.rand(c).astype(np.float32)).to(DEVICE)
        bias = torch.from_numpy(rng.rand(c).astype(np.float32)).to(DEVICE)
        for dtype in (torch.float32, torch.bfloat16):
            for relu in (False, True):
                err, exact_err = k1_errors(kc, x.to(dtype), scale, bias, g,
                                           relu)
                case = dict(shape=[n, q, c], dtype=str(dtype)[6:],
                            relu=relu, err=err, exact_err=exact_err)
                cases.append(case)
                ok = (err <= K1_F32_ATOL and exact_err <= K1_F32_ATOL
                      if dtype == torch.float32 else
                      err <= K1_BF16_ULPS and exact_err <= K1_BF16_EXACT_ULPS)
                if not ok:
                    bad.append(case)
    if bad:
        raise AssertionError(f'band_groupnorm outside tolerance: {bad}')
    return cases


def check_k1(kc, rng, edges: bool):
    """K1 at the mask-head GroupNorm shape [B*K = 1600, 14*14, 128], G=16
    (and, with ``edges``, at K1_EDGES). Timed in bf16: with relu as on the
    main path, and without relu beside ``F.group_norm`` over the [N, Q*C]
    view, whose G groups of contiguous channels are the bands; its
    per-channel affine is the periodic table, cast to bf16 because
    group_norm takes weights of the input's type."""
    n, q, c, g = BATCH * 100, 196, 128, 16
    cases = k1_cases(kc, rng, [(n, q, c)] + (K1_EDGES if edges else []), g)
    err32 = max(k['err'] for k in cases if k['dtype'] == 'float32')
    ulps = max(k['err'] for k in cases if k['dtype'] == 'bfloat16')
    exact_ulps = max(k['exact_err'] for k in cases
                     if k['dtype'] == 'bfloat16')
    xb = torch.from_numpy(rng.randn(n, q, c).astype(np.float32) * 2
                          + 1).to(DEVICE).bfloat16()
    scale = torch.from_numpy(rng.rand(c).astype(np.float32)).to(DEVICE)
    bias = torch.from_numpy(rng.rand(c).astype(np.float32)).to(DEVICE)

    def kernel(relu=True):
        return kc.band_groupnorm(xb, scale, bias, g, fuse_relu=relu)

    length = q * c // g
    table_s = scale.reshape(g, c // g).repeat(1, length // (c // g))
    table_b = bias.reshape(g, c // g).repeat(1, length // (c // g))
    table_s, table_b = table_s.reshape(-1).bfloat16(), table_b.reshape(-1).bfloat16()

    def library():
        return torch.nn.functional.group_norm(
            xb.view(n, q * c), g, weight=table_s, bias=table_b, eps=1e-5)

    library_err = (library().float().view(n, q, c)
                   - kernel(False).float()).abs().max().item()
    nbytes = 2 * xb.numel() * xb.element_size() + 2 * 4 * c
    b_ms, b_by = bound_ms(nbytes, 8 * xb.numel())
    dev_ms = device_ms(kernel, 200, 'band_groupnorm')
    return dict(name='band_groupnorm', route='cuda',
                source='masklab_tpu_torch/csrc/band_groupnorm.cu',
                replaces='masklab_tpu/ops/pallas/groupnorm_kernel.py:141',
                shape=f'[{n}, {q}, {c}] bf16, G={g}, fuse_relu',
                max_abs_err=err32, bf16_max_ulp=ulps,
                bf16_max_ulp_vs_f64=exact_ulps, ms=dev_ms,
                device_ms=dev_ms, call_ms=time_ms(kernel, 200),
                device_ms_no_relu=device_ms(lambda: kernel(False), 200,
                                            'band_groupnorm'),
                plain_ms=time_ms(lambda: kc.band_groupnorm_plain(
                    xb, scale, bias, g, fuse_relu=True), 50),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=device_ms(library, 200),
                library_call_ms=time_ms(library, 200),
                library_max_abs_err=library_err, cases=len(cases))


def k1_backward_errors(kc, x, dy, scale, g: int, relu: bool):
    """K1's backward on (x, dy) against its plain version -> (dx error,
    largest dscale / dbias error relative to the sum of |terms|). dx: max
    abs error for f32; for bf16, max error in bf16 ulps at the operand scale
    of its formula inv * (|g| + |mean g| + |x^| * (|sum g f| + |m1 sum g|) /
    L), the terms the kernel sums and cancels."""
    got = kc.band_groupnorm_backward(x, dy, scale, g, fuse_relu=relu)
    want = kc.band_groupnorm_backward_plain(x, dy, scale, g, fuse_relu=relu)
    n, q, c = x.shape
    cg = c // g
    f = x.float().reshape(n, g, -1)
    if relu:
        f = torch.relu(f)
    length = f.shape[-1]
    m1 = f.mean(-1, keepdim=True)
    inv = torch.rsqrt(torch.clamp(f.square().mean(-1, keepdim=True)
                                  - m1 * m1, min=0.0) + 1e-5)
    xhat = (f - m1) * inv
    dyf = dy.float().reshape(n, g, -1)
    gg = dyf * scale.reshape(g, cg).repeat(1, length // cg)
    sums = ((gg * f).sum(-1, keepdim=True).abs()
            + (m1 * gg.sum(-1, keepdim=True)).abs())
    mag = inv * (gg.abs() + gg.mean(-1, keepdim=True).abs()
                 + xhat.abs() * sums / length)
    if x.dtype == torch.float32:
        dx_err = (got[0] - want[0]).abs().max().item()
    else:
        mag = torch.maximum(mag.reshape(n, q, c), torch.maximum(
            got[0].float().abs(), want[0].float().abs()))
        dx_err = ((got[0].float() - want[0].float()).abs()
                  / bf16_ulp(mag)).max().item()

    def per_channel(t):
        return t.reshape(n, g, length // cg, cg).sum((0, 2)).reshape(c)
    param_err = 0.0
    for k, terms in ((1, (dyf * xhat).abs()), (2, dyf.abs())):
        scale_k = per_channel(terms).clamp(min=1e-30)
        param_err = max(param_err, ((got[k] - want[k]).abs()
                                    / scale_k).max().item())
    return dx_err, param_err


def check_k1_backward(kc, rng, edges: bool):
    """K1's backward kernel against its plain version at the train path's
    maps (and, with ``edges``, K1B_SHAPES), f32 and bf16, relu off and on,
    within K1B_*. Timed in bf16 with relu at the mask-head shape: its own
    device time (the band pass and the reduce over N), call time, the plain
    version, and as yardstick aten's ``native_group_norm_backward`` over
    the [N, Q*C] view with G groups (per-element weights: the bands and
    their periodic affine), whose outputs are a superset of K1's. The
    device time is split by kernel (``backward_timing``: each kernel's own
    ms and the kernels per call). The bound: read x and dy and write dx
    once, as the warp path does (the band stays in registers between its
    two passes)."""
    n, q, c, g = K1B_MAIN
    cases, bad = [], []
    for n_, q_, c_, g_ in (K1B_SHAPES if edges else [K1B_MAIN]):
        x = torch.from_numpy(rng.randn(n_, q_, c_).astype(np.float32) * 2
                             + 1).to(DEVICE)
        dy = torch.from_numpy(rng.randn(n_, q_, c_).astype(np.float32)).to(
            DEVICE)
        scale = torch.from_numpy(rng.uniform(0.5, 1.5, c_).astype(
            np.float32)).to(DEVICE)
        for dtype in (torch.float32, torch.bfloat16):
            for relu in (False, True):
                dx_err, p_err = k1_backward_errors(kc, x.to(dtype),
                                                   dy.to(dtype), scale, g_,
                                                   relu)
                case = dict(shape=[n_, q_, c_], groups=g_,
                            dtype=str(dtype)[6:], relu=relu, dx_err=dx_err,
                            param_err=p_err)
                cases.append(case)
                limit = (K1B_F32_ATOL if dtype == torch.float32
                         else K1B_BF16_ULPS)
                if not (dx_err <= limit and p_err <= K1B_PARAM_RTOL):
                    bad.append(case)
    if bad:
        raise AssertionError(f'band_groupnorm_backward outside tolerance: '
                             f'{bad}')
    xb = torch.from_numpy(rng.randn(n, q, c).astype(np.float32) * 2
                          + 1).to(DEVICE).bfloat16()
    dyb = torch.from_numpy(rng.randn(n, q, c).astype(np.float32)).to(
        DEVICE).bfloat16()
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)).to(
        DEVICE)

    def kernel():
        return kc.band_groupnorm_backward(xb, dyb, scale, g, fuse_relu=True)

    length = q * c // g
    table = scale.reshape(g, c // g).repeat(1, length // (c // g)).reshape(
        -1).bfloat16()
    xv, dyv = xb.view(n, q * c, 1), dyb.view(n, q * c, 1)
    _, mean, rstd = torch.ops.aten.native_group_norm(
        xv, table, None, n, q * c, 1, g, 1e-5)

    def library():
        return torch.ops.aten.native_group_norm_backward(
            dyv, xv, mean, rstd, table, n, q * c, 1, g, [True, True, True])

    nbytes = 3 * xb.numel() * xb.element_size() + 3 * 4 * c
    b_ms, b_by = bound_ms(nbytes, 20 * xb.numel())
    timing = backward_timing(kernel, 200)
    dev_ms = timing.pop('device_ms')
    print(f'kernel band_groupnorm_backward at {list(K1B_MAIN)}: device '
          f'{dev_ms:.4f} ms in {timing["kernels_per_call"]} kernel(s) a '
          f'call, by kernel {json.dumps(timing["by_kernel"])}', flush=True)
    return dict(name='band_groupnorm_backward', route='cuda',
                source='masklab_tpu_torch/csrc/band_groupnorm.cu',
                replaces='masklab_tpu/ops/pallas/groupnorm_kernel.py:208',
                shape=f'[{n}, {q}, {c}] bf16, G={g}, fuse_relu',
                max_abs_err=max(k['dx_err'] for k in cases
                                if k['dtype'] == 'float32'),
                bf16_max_ulp=max(k['dx_err'] for k in cases
                                 if k['dtype'] == 'bfloat16'),
                param_max_rel_err=max(k['param_err'] for k in cases),
                ms=dev_ms, device_ms=dev_ms, call_ms=time_ms(kernel, 200),
                plain_ms=time_ms(lambda: kc.band_groupnorm_backward_plain(
                    xb, dyb, scale, g, fuse_relu=True), 20),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=device_ms(library, 200),
                library_call_ms=time_ms(library, 200), cases=len(cases),
                **timing)


def k1_backward_shapes(step, state, batch) -> list:
    """The maps K1's backward gets in one train step, as [n, q, c, groups,
    dtype, fuse_relu] (the step runs once more with the wrapper wrapped)."""
    from masklab_tpu_torch.ops.cuda import groupnorm
    seen, wrapper = [], groupnorm.band_groupnorm_backward

    def record(x, dy, scale, groups, eps=1e-5, fuse_relu=False):
        seen.append([*x.shape, groups, str(x.dtype)[6:], bool(fuse_relu)])
        return wrapper(x, dy, scale, groups, eps, fuse_relu)
    groupnorm.band_groupnorm_backward = record
    try:
        step(state, batch)
        torch.cuda.synchronize()
    finally:
        groupnorm.band_groupnorm_backward = wrapper
    return seen


def check_train_maps(shapes):
    """K1B_TRAIN_MAPS against the maps ``k1_backward_shapes`` recorded: the
    same maps as a multiset (calls a step, Q, C, groups, dtype, relu), each
    sample count within K1B_TRAIN_N_RTOL. A stale copy fails here instead
    of leaving --kernels-only and the gpu tests on maps the train step no
    longer sends."""
    got, want = sorted(map(tuple, shapes)), sorted(map(tuple, K1B_TRAIN_MAPS))
    if not (len(got) == len(want) and all(
            a[1:] == b[1:] and abs(a[0] - b[0]) <= K1B_TRAIN_N_RTOL * b[0]
            for a, b in zip(got, want))):
        raise AssertionError(f'K1B_TRAIN_MAPS {want} is not what a train '
                             f'step gives K1\'s backward: {got}')


def k1_backward_path(q: int, c: int, g: int, itemsize: int):
    """(path, kernels a call launches) that ``launch_bwd`` in
    csrc/band_groupnorm.cu takes for a map (the torch allocator's tensors
    are 16-byte aligned): the warp path, one persistent launch, where the
    band is whole 16-byte vectors that fit a warp's registers
    (kBwdLaneVectors = 8 a lane) and cg is a power of two dividing a warp's
    vector row; else the band pass and the reduce over N, two."""
    v, cg = 16 // itemsize, c // g
    length = q * cg
    warp = (length % v == 0 and cg & (cg - 1) == 0 and (32 * v) % cg == 0
            and (length // v + 31) // 32 <= 8)
    return ('warp', 1) if warp else ('band pass + reduce', 2)


def k1_backward_at(kc, rng, shapes) -> list:
    """K1's backward at each distinct map of ``k1_backward_shapes``: held
    against its plain version (K1B_*), two calls giving the same bits, and
    timed (``backward_timing``: its device time, split by kernel, and the
    kernels a call launches, which must be those of the map's path,
    ``k1_backward_path``), with the bound and the count of calls per
    step."""
    out = []
    for key in sorted({tuple(sh) for sh in shapes}):
        n, q, c, g, dtype, relu = key
        dt = getattr(torch, dtype)
        x = torch.from_numpy(rng.randn(n, q, c).astype(np.float32) * 2
                             + 1).to(DEVICE).to(dt)
        dy = torch.from_numpy(rng.randn(n, q, c).astype(np.float32)).to(
            DEVICE).to(dt)
        scale = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(
            np.float32)).to(DEVICE)
        dx_err, p_err = k1_backward_errors(kc, x, dy, scale, g, relu)
        limit = K1B_F32_ATOL if dt == torch.float32 else K1B_BF16_ULPS
        if not (dx_err <= limit and p_err <= K1B_PARAM_RTOL):
            raise AssertionError(f'band_groupnorm_backward at train map '
                                 f'{key}: dx {dx_err}, params {p_err}')

        def call():
            return kc.band_groupnorm_backward(x, dy, scale, g, fuse_relu=relu)
        if not all(torch.equal(a, b) for a, b in zip(call(), call())):
            raise AssertionError(f'band_groupnorm_backward at train map '
                                 f'{key}: two calls differ')
        timing = backward_timing(call, 100)
        timing['path'], kernels = k1_backward_path(q, c, g, x.element_size())
        if DEVICE == 'cuda' and timing['kernels_per_call'] != kernels:
            raise AssertionError(f'band_groupnorm_backward at train map '
                                 f'{key}: {timing}')
        b_ms, b_by = bound_ms(3 * x.numel() * x.element_size() + 12 * c,
                              20 * x.numel())
        out.append(dict(
            shape=[n, q, c], groups=g, dtype=dtype, relu=relu,
            per_step=sum(tuple(sh) == key for sh in shapes),
            dx_err=dx_err, param_err=p_err, bound_ms=b_ms, bound_by=b_by,
            **timing))
    return out


def k2_scores(rng, b, c, n, layout='transposed', bf16=True):
    """[B, C, n] forced-dense scores on the card: sigmoid near 2, quantized
    through bf16 (as the bf16 head computes it; ``bf16=False`` keeps the
    f32 sigmoid), so most columns carry exact ties; 5% masked to -1. As the
    main path has them, the transpose of a contiguous [B, n, C] tensor, or
    contiguous."""
    logits = 2.0 + 0.05 * rng.randn(b, n, c).astype(np.float32)
    x = torch.sigmoid(torch.from_numpy(logits))
    if bf16:
        x = x.bfloat16().float()
    x[torch.from_numpy(rng.rand(b, n, c) < 0.05)] = -1.0
    x = x.to(DEVICE).transpose(1, 2)
    return x.contiguous() if layout == 'contiguous' else x


def k2_edges(rng):
    """K2's edge cases as (name, scores, cap): caps 1, 2, 15 and 16 at n =
    81840 (the main path), 81920 (a multiple of 128), 40000, 129 and 1, in
    both layouts; R = 1; columns with fewer finite values than cap; all-(-1)
    and all-equal columns; s = 3, not a multiple of the launch tile; and
    scores that are not all bf16-exact, which take the kernel's (value,
    row) keys: f32 sigmoids, one f32 score among bf16 ones, +0.0 and -0.0
    mixed."""
    cases = []
    for n in (81840, 81920, 40000, 129, 1):
        for layout in ('contiguous', 'transposed'):
            scores = k2_scores(rng, BATCH if n > 129 else 2, 5, n, layout)
            for cap in (1, 2, 15, 16):
                cases.append((f'n={n} {layout} cap={cap}', scores, cap))
    cases.append(('R=1', k2_scores(rng, 1, 1, 81840, 'contiguous'), 16))
    short = k2_scores(rng, 2, 5, 3000).clone()
    short[..., 8 * 24:] = float('-inf')          # s = 24: 8 finite rows
    cases.append(('fewer finite than cap', short, 16))
    for name, value in (('all -1', -1.0), ('all equal', 0.5)):
        cases.append((name, torch.full((2, 5, 3000), value, device=DEVICE),
                       16))
    cases.append(('s=3', k2_scores(rng, 2, 5, 300), 16))
    cases.append(('f32 scores', k2_scores(rng, BATCH, 5, 81840, bf16=False),
                  16))
    one = k2_scores(rng, BATCH, 5, 81840).clone()
    one[3, 2, 40000] += 1e-4
    cases.append(('one f32 score', one, 16))
    signs = torch.from_numpy(rng.rand(2, 5, 3000) < 0.5).to(DEVICE)
    cases.append(('signed zeros', torch.where(signs, 0.0, -0.0), 16))
    return cases


def kernel_names(fn) -> set:
    """The symbols of the device kernels that one call of ``fn`` launches."""
    cuda = torch.autograd.DeviceType.CUDA

    def names(prof):
        return {e.key for e in prof.key_averages() if e.device_type == cuda}

    def body():
        fn()
        torch.cuda.synchronize()

    fn()
    torch.cuda.synchronize()
    prof, _ = traced(body, lambda p: bool(names(p)), 'device kernel')
    return names(prof)


def l2_flusher():
    """A call that evicts the 50 MB L2 by rewriting a 128 MB scratch tensor,
    and its kernels' symbols (for ``device_ms``'s ``exclude``)."""
    scratch = torch.zeros(32 << 20, dtype=torch.int32, device=DEVICE)

    def flush():
        torch.bitwise_not(scratch, out=scratch)
    return flush, kernel_names(flush)


def check_k2(kc, rng, edges: bool):
    """K2 at the main path's call form: the [16, 5, 81840] transpose of a
    contiguous [16, 81840, 5] f32 tensor, read in place, cap 16. Exact
    against the plain version (and, with ``edges``, at k2_edges). Device
    time cold (``ms`` = ``device_ms``: L2 flushed before each launch, only
    K2's own symbol counted; the bound and the aims are read against it)
    and hot (``device_hot_ms``, back to back); ``pool_ms``, all device work
    of ``ops.nms.candidate_pool(masked, 256, 0.05)`` back to back;
    ``torch.topk`` over the padded [80, 128, 640] copy as the yardstick,
    cold like K2. With ``edges``, also ``device_f32_ms``: cold, on f32
    sigmoids, which are not bf16-exact and take the kernel's (value, row)
    keys."""
    from masklab_tpu_torch.ops import nms
    b, c, n, cap, m = BATCH, 5, 81840, 16, 128
    s = -(-n // m)
    masked = k2_scores(rng, b, c, n)
    padded = torch.cat([masked.reshape(b * c, n),
                        masked.new_full((b * c, m * s - n), float('-inf'))],
                       1).reshape(b * c, m, s)

    def kernel():
        return kc.segment_topk_rows(masked, cap)
    vals, idx = kernel()
    pv, pi = kc.segment_topk_plain(padded, cap)
    if not (torch.equal(vals, pv) and torch.equal(idx, pi)):
        bad = int((vals != pv).sum() + (idx != pi).sum())
        raise AssertionError(f'segment_topk differs from plain at {bad} slots')
    flush, flushes = l2_flusher()

    def cold(fn):
        return lambda: (flush(), fn())

    def pool():
        return nms.candidate_pool(masked, 256, 0.05)

    def library():
        return torch.topk(padded, cap, dim=1)

    if kernel_names(library) & flushes:
        raise AssertionError('torch.topk launches a kernel of the L2 flush')
    out = dict(device_ms=device_ms(cold(kernel), 200, 'segment_topk'),
               device_hot_ms=device_ms(kernel, 200, 'segment_topk'),
               call_ms=time_ms(kernel, 200),
               pool_ms=device_ms(pool, 50),
               library_ms=device_ms(cold(library), 200, exclude=flushes),
               library_call_ms=time_ms(library, 200))
    # the road preset's call form: [8, 5, 81600] (5 ratios x 3 scales on
    # C3-C5 + P6 at 512 px), the pool's k = 128 with the same cap
    rb, rn = 8, 81600
    road = k2_scores(rng, rb, c, rn)
    got = kc.segment_topk_rows(road, cap)
    want = kc.segment_topk_rows_plain(road, cap)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError('segment_topk differs from plain at the road '
                             "preset's call form")
    rs = -(-rn // m)
    out.update(road_shape=f'[{rb}, {c}, {rn}] f32 (transposed [B, N, C]), '
               f'cap {cap}',
               road_device_ms=device_ms(cold(lambda: kc.segment_topk_rows(
                   road, cap)), 200, 'segment_topk'),
               road_bound_ms=bound_ms(rb * c * rn * 4
                                      + 2 * rb * c * cap * rs * 4,
                                      rb * c * rn)[0])
    # the trainer's row lengths: the road preset's anchors at the smallest
    # and largest train bucket of a 1080p frame, [8, 5, n] from the loss
    # NMS (pool k = 256, the same cap), exact, and cold at the largest.
    # Their scores come from a generator of their own, so the later phases
    # keep the inputs they had before these cases (check_train_reference
    # fails on most other draws: ROADMAP.md, Queue 3)
    import masklab_tpu_torch as mt
    lengths = trainer_row_lengths(mt)
    trainer_rng = np.random.RandomState(7)
    rows = {n_t: k2_scores(trainer_rng, 8, c, n_t)
            for n_t in (lengths[min(lengths)], lengths[max(lengths)])}
    for n_t, scores in rows.items():
        got = kc.segment_topk_rows(scores, cap)
        want = kc.segment_topk_rows_plain(scores, cap)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f'segment_topk differs from plain at the '
                                 f"trainer's row length {n_t}")
    n_t = lengths[max(lengths)]
    scores, ts = rows[n_t], -(-n_t // m)
    out.update(trainer_row_lengths=lengths,
               trainer_shape=f'[8, {c}, {n_t}] f32 (transposed [B, N, C]), '
               f'cap {cap}',
               trainer_device_ms=device_ms(cold(lambda: kc.segment_topk_rows(
                   scores, cap)), 200, 'segment_topk'),
               trainer_bound_ms=bound_ms(8 * c * n_t * 4
                                         + 2 * 8 * c * cap * ts * 4,
                                         8 * c * n_t)[0])
    if edges:
        bad = []
        cases = k2_edges(rng)
        for name, scores, k in cases:
            got = kc.segment_topk_rows(scores, k)
            want = kc.segment_topk_rows_plain(scores, k)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                bad.append(name)
        if bad:
            raise AssertionError(f'segment_topk differs from plain: {bad}')
        f32 = k2_scores(rng, b, c, n, bf16=False)
        out.update(cases=len(cases), device_f32_ms=device_ms(
            cold(lambda: kc.segment_topk_rows(f32, cap)), 200, 'segment_topk'))
    # read b*c*n scores once; write f32 values and i32 indices
    nbytes = b * c * n * 4 + 2 * vals.numel() * 4
    b_ms, b_by = bound_ms(nbytes, b * c * n)
    out['hot_below_bound'] = out['device_hot_ms'] < b_ms
    return dict(name='segment_topk', route='cuda',
                source='masklab_tpu_torch/csrc/segment_topk.cu',
                replaces='masklab_tpu/ops/pallas/topk_kernel.py:53',
                shape=f'[{b}, {c}, {n}] f32 (transposed [B, N, C]), cap {cap}',
                max_abs_err=0.0, ms=out['device_ms'],
                plain_ms=time_ms(lambda: kc.segment_topk_plain(padded, cap),
                                 20),
                bound_ms=b_ms, bound_by=b_by,
                bound_share_cold=b_ms / out['device_ms'], **out)


def nms_inputs(rng, r, k):
    """Score-sorted clustered yxyx boxes (long suppression chains)."""
    centers = rng.uniform(40, 470, (r, 12, 2))
    pick = rng.randint(0, 12, (r, k))
    c = np.take_along_axis(centers, pick[..., None].repeat(2, -1), 1)
    c = c + rng.normal(0, 6, (r, k, 2))
    hw = rng.uniform(20, 90, (r, k, 2))
    boxes = np.concatenate([c - hw / 2, c + hw / 2], -1)[..., [1, 0, 3, 2]]
    valid = rng.rand(r, k) > 0.1
    boxes = np.ascontiguousarray(boxes, dtype=np.float32)
    return (torch.from_numpy(boxes).to(DEVICE),
            torch.from_numpy(valid).to(DEVICE))


def nms_edges(rng):
    """K3's edge cases as (name, boxes, valid, t, max_outputs): K from 1 to
    2048 (one word, word edges, the cluster-distributed mask) at caps 1,
    100 and K; no valid box; integer-grid boxes whose IoU equals t exactly
    (e.g. [0,0,10,10] against [0,0,10,5] at t=0.5); zero-area boxes."""
    cases = []
    for k in (1, 63, 64, 65, 256, 500, 1536, 2048):
        boxes, valid = nms_inputs(rng, 3, k)
        for cap in sorted({1, 100, k}):
            cases.append((f'K={k} cap={cap}', boxes, valid, 0.5, cap))
    boxes, valid = nms_inputs(rng, 4, 256)
    cases.append(('no valid box', boxes, torch.zeros_like(valid), 0.5, 100))
    lo = rng.randint(0, 8, (4, 128, 2))
    grid = np.concatenate([lo, lo + rng.randint(1, 6, (4, 128, 2))], -1)
    grid[:, :3] = [[0, 0, 10, 10], [0, 0, 10, 5], [0, 0, 10, 6]]
    cases.append(('IoU == t on an integer grid',
                  torch.from_numpy(grid.astype(np.float32)).to(DEVICE),
                  torch.ones(4, 128, dtype=torch.bool, device=DEVICE), 0.5,
                  128))
    boxes, valid = nms_inputs(rng, 2, 100)
    flat = torch.from_numpy(rng.rand(2, 100) < 0.3).to(DEVICE)
    boxes = boxes.clone()
    boxes[..., 2] = torch.where(flat, boxes[..., 0], boxes[..., 2])
    boxes[:, 0, 2] = boxes[:, 0, 0]
    boxes[:, 1:4] = boxes[:, :1]            # three copies of a zero-area box
    cases.append(('zero-area boxes', boxes.contiguous(), valid, 0.5, 100))
    return cases


def check_k3(kc, rng, edges: bool):
    """K3 at both NMS stages: 80 x K=256 (t=0.4) and 16 x K=500 (t=0.6),
    100 kept at most, exact against the plain version (and, with
    ``edges``, at nms_edges). Times are one forward's two launches. With
    ``edges`` the device time is also split: ``build_ms`` is the
    build-only instance of the kernel (same source, no sweep),
    ``sweep_ms`` the rest. Besides the bytes / operations bound,
    ``chain_bound_ms`` is the greedy sweep's latency chain: the sets of a
    launch run side by side, the launches one after the other, and each
    set walks its K boxes in order."""
    stages = [(BATCH * 5, 256, 0.4), (BATCH, 500, 0.6)]
    out = dict(call_ms=0.0, device_ms=0.0, plain_ms=0.0)
    if edges:
        from masklab_tpu_torch.ops.cuda import _build
        out['build_ms'] = 0.0
        lib = _build.library()
    nbytes = flops = chain_cycles = 0.0
    for r, k, thr in stages:
        boxes, valid = nms_inputs(rng, r, k)
        got = kc.nms_keep_mask(boxes, valid, thr, 100)
        want = kc.nms_keep_mask_plain(boxes, valid, thr, 100)
        if not torch.equal(got, want):
            raise AssertionError(f'nms_keep_mask differs from plain at '
                                 f'{int((got != want).sum())} of {r}x{k}')
        call = lambda: kc.nms_keep_mask(boxes, valid, thr, 100)  # noqa: E731
        out['call_ms'] += time_ms(call, 200)
        out['device_ms'] += device_ms(call, 200, 'nms_keep')
        out['plain_ms'] += time_ms(lambda: kc.nms_keep_mask_plain(
            boxes, valid, thr, 100), 3, warmup=1)
        if edges:
            scratch = torch.empty_like(valid)
            stream = torch.cuda.current_stream().cuda_stream

            def build():
                _build.check(lib.mlk_nms_keep_build_only(
                    boxes.data_ptr(), valid.data_ptr(), scratch.data_ptr(),
                    r, k, thr, 100, stream), 'nms_keep build-only')
            out['build_ms'] += device_ms(build, 200, 'nms_keep')
        # boxes 16 B + valid 1 B in, keep 1 B out; ~14 ops per IoU pair
        nbytes += r * k * (16 + 1 + 1)
        flops += r * k * (k - 1) / 2 * 14
        most_kept = int(got.sum(1).max())
        chain_cycles += (k * SWEEP_CYCLES_PER_BOX
                         + most_kept * SWEEP_CYCLES_PER_KEEP)
    if edges:
        out['sweep_ms'] = out['device_ms'] - out['build_ms']
        bad = []
        cases = nms_edges(rng)
        for name, boxes, valid, thr, cap in cases:
            got = kc.nms_keep_mask(boxes, valid, thr, cap)
            want = kc.nms_keep_mask_plain(boxes, valid, thr, cap)
            if not torch.equal(got, want):
                bad.append(f'{name}: {int((got != want).sum())} differ')
        if bad:
            raise AssertionError(f'nms_keep_mask differs from plain: {bad}')
        out['cases'] = len(cases)
    b_ms, b_by = bound_ms(nbytes, flops)
    return dict(name='nms_keep', route='cuda',
                source='masklab_tpu_torch/csrc/nms_keep.cu',
                replaces='masklab_tpu/ops/pallas/nms_kernel.py:93',
                shape='[80, 256] t=0.4 + [16, 500] t=0.6, cap 100',
                max_abs_err=0.0, ms=out['device_ms'], bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                chain_bound_ms=chain_cycles / max_sm_clock_hz() * 1e3, **out)


def narrow(cfg):
    """Width 32, depth 1: the card-vs-CPU check's model."""
    cfg.backbone.num_features = 32
    for group in (cfg.detection, cfg.instance, cfg.semantic):
        group.num_features = 32
        group.num_depth = 1
    cfg.semantic.num_aspp_features = 32
    return cfg


def headline_config(mt):
    """bench.py's headline: mobilenet, widths 128, depth 4, bf16, 512 px."""
    cfg = mt.ModelConfiguration()
    cfg.backbone.backbone_type = 'mobilenet'
    cfg.compute.compute_dtype = 'bfloat16'
    cfg.postprocess.resolution = (SIZE, SIZE)
    return cfg


def road_config(mt):
    """bench.py's second inference configuration: the road preset
    (seresnet34, squeeze-excite heads, 5 ratios x 3 scales, k = 128 pool),
    bf16, 512 px, one card (``mesh_data`` 1)."""
    cfg = mt.road_project_config()
    cfg.compute.compute_dtype = 'bfloat16'
    cfg.compute.mesh_data = 1
    cfg.postprocess.resolution = (SIZE, SIZE)
    return cfg


def check_reference(mt, rng, cfg):
    """A narrow float32 model at 512 px on the card vs on the CPU: dense
    heads within 1e-4; NMS fed the card's own scores and boxes gives the
    card's proposals exactly; the mask branch fed the card's features and
    proposals gives the card's masks within 1e-4."""
    from masklab_tpu_torch.ops.boxes import decode_boxes
    from masklab_tpu_torch.ops.nms import batched_class_aware_nms
    det = cfg.detection
    images = torch.from_numpy(
        rng.randint(0, 256, (2, SIZE, SIZE, 3)).astype(np.float32))
    runs = {}
    for dev in (DEVICE, 'cpu'):
        model = mt.force_dense(mt.build_masklab(cfg, device=dev, seed=1))
        with torch.inference_mode():
            out = model.raw_heads(images.to(dev))
            boxes = decode_boxes(out['loc_pred'], out['priors'])
            nms = dict(min_confidence=det.min_confidence,
                       nms_iou_threshold=det.nms_iou_threshold,
                       post_iou_threshold=det.post_iou_threshold,
                       max_outputs=det.nms_max_output_size,
                       candidates_per_class=cfg.compute.nms_candidates_per_class)
            if dev == DEVICE:
                props = batched_class_aware_nms(out['cls_pred'], boxes, **nms)
                masks = model.mask_branch(out['features'], props,
                                          out['image_hw'])
                runs[dev] = dict(out=out, boxes=boxes, props=props,
                                 masks=masks)
            else:
                gpu = runs[DEVICE]
                props = batched_class_aware_nms(
                    gpu['out']['cls_pred'].cpu(), gpu['boxes'].cpu(), **nms)
                masks = model.mask_branch(
                    [f.cpu() for f in gpu['out']['features']],
                    gpu['props'].cpu(), out['image_hw'])
                runs[dev] = dict(out=out, props=props, masks=masks)
    gpu, cpu = runs[DEVICE], runs['cpu']
    errs = {k: (gpu['out'][k].cpu() - cpu['out'][k]).abs().max().item()
            for k in ('cls_pred', 'loc_pred', 'seg_pred')}
    errs['roi_masks'] = (gpu['masks'].cpu() - cpu['masks']).abs().max().item()
    for k, e in errs.items():
        if not e <= 1e-4:
            raise AssertionError(f'reference: {k} max abs err {e} > 1e-4')
    if not torch.equal(gpu['props'].cpu(), cpu['props']):
        raise AssertionError('reference: NMS on the card differs from the '
                             'CPU on identical inputs')
    filled = int((gpu['props'][..., 4] >= 0).sum())
    if filled != 2 * det.nms_max_output_size:
        raise AssertionError(f'reference: {filled} proposal slots filled')
    errs['anchors'] = gpu['out']['cls_pred'].shape[1]
    return errs


def train_config(mt):
    """bench.py's training configuration (``_bench_train_step``, "BASELINE
    config 5"): resnext50, every other width and depth the defaults (128,
    depth 4), bf16."""
    cfg = mt.ModelConfiguration()
    cfg.backbone.backbone_type = 'resnext50'
    cfg.compute.compute_dtype = 'bfloat16'
    return cfg


def _train_step_run(mt, cfg, batch, dev: str, float64: bool = False):
    """One train step of ``cfg``'s model (seed 2) on ``dev`` -> {name: the
    value as a float64 CPU tensor} over the loss terms (``loss:``), every
    gradient (``grad:``, read as the step's first moment (1 - b1) * g, one
    float product), every parameter's change (``change:``), the new
    batch_stats (``stats:``) and box state (``box:``); and {``change:``
    name: 2 float32 ulps of the parameter's largest entry}, which the
    subtraction leaves. ``float64``: parameters, convs and BatchNorm in
    float64 (the loss terms, the heads' outputs and the GroupNorm statistics
    stay float32, as the model computes them)."""
    from masklab_tpu_torch import train
    model = mt.build_masklab(cfg, device=dev, seed=2)
    if float64:
        model.double()
        for m in model.modules():
            if hasattr(m, 'compute_dtype'):
                m.compute_dtype = torch.float64
        model.dtype = torch.float64
        batch = {k: v.double() if v.is_floating_point() else v
                 for k, v in batch.items()}
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    state = train.TrainState(model, train.rectified_adam(
        train.cyclic_lr(1e-4, 1e-3, 700)))
    state, metrics = train.make_train_step(model, with_metrics=False)(
        state, {k: v.to(dev) for k, v in batch.items()})
    out = {f'loss:{k}': v for k, v in metrics.items()}
    out.update({f'grad:{k}': v for k, v in state.opt_state.mu.items()})
    out.update({f'change:{k}': v.detach() - start[k]
                for k, v in model.named_parameters()})
    out.update({f'stats:{k}': v for k, v in state.batch_stats.items()})
    out.update({f'box:{i}': t for i, t in enumerate(state.box_loss_state)})
    slack = {f'change:{k}': float(2 * np.spacing(np.float32(
        v.abs().max().item()))) for k, v in start.items()}
    return {k: v.detach().cpu().double() for k, v in out.items()}, slack


def _witness_readings(got: dict, cpu: dict, exact: dict, slack: dict):
    """{name: |got - exact| over (TRAIN_REF_RATIO x |cpu - exact| +
    TRAIN_REF_FLOOR x max|exact| + slack)}, each a largest entry: above 1
    is outside. ``exact`` is the float64 step, ``cpu`` the float32 step on
    the CPU, whose own distance from it says how far float32 rounding moves
    that tensor."""
    out = {}
    for k, w in exact.items():
        err = (got[k] - w).abs().max().item()
        limit = (TRAIN_REF_RATIO * (cpu[k] - w).abs().max().item()
                 + TRAIN_REF_FLOOR * w.abs().max().item() + slack.get(k, 0.0))
        out[k] = err / max(limit, 1e-30)
    return out


def _reading_summary(readings: dict) -> dict:
    """The largest reading of each group (loss, grad / change of the
    backbone and of the heads, stats, box), the tensor it came from, and
    the count of tensors above 1."""
    groups = {}
    for k, r in readings.items():
        kind, name = k.split(':', 1)
        if kind in ('grad', 'change'):
            kind += '_backbone' if name.startswith('backbone') else '_heads'
        g = groups.setdefault(kind, dict(max=0.0, at=None, over=0, n=0))
        g['n'] += 1
        g['over'] += int(not r <= 1.0)
        if not r <= g['max']:
            g['max'], g['at'] = r, name
    return groups


def check_train_reference(mt, rng):
    """One train step of a narrow model on the resnext50 body (heads width
    32, depth 1) at 128 px, batch 2, from the same seeded weights and batch:
    on the card in float32 (TF32 off), on the CPU in float32, and on the CPU
    in float64 (the witness). Every tensor of the step (loss terms,
    gradients, parameter changes, batch_stats, box state) is held to its own
    scale: the card's distance from the witness within TRAIN_REF_RATIO times
    the CPU float32 step's own distance plus TRAIN_REF_FLOOR of the tensor's
    largest entry (``_witness_readings``). Train-mode BatchNorm in float32
    moves the backbone's gradients far (up to ~20% of a tensor's scale on
    the CPU), so a fixed tolerance either hides errors or fails sound runs;
    the CPU's own rounding error of each tensor is the yardstick instead.
    Two sound readings must pass (the card; the CPU step in one thread,
    another summation order) and a control must fail: the card's step with
    TF32 convolutions and matmuls, in the backbone and in the heads."""
    from masklab_tpu_torch import train
    from masklab_tpu_torch.data import make_random_batch
    cfg = narrow(train_config(mt))
    cfg.compute.compute_dtype = 'float32'
    batch = train.as_batch(make_random_batch(
        2, (128, 128), 4, seed=int(rng.randint(1 << 30))), 'cpu')
    exact, slack = _train_step_run(mt, cfg, batch, 'cpu', float64=True)
    cpu, _ = _train_step_run(mt, cfg, batch, 'cpu')
    runs = dict(card=_train_step_run(mt, cfg, batch, DEVICE)[0])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs['cpu_one_thread'] = _train_step_run(mt, cfg, batch, 'cpu')[0]
    finally:
        torch.set_num_threads(threads)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        runs['control_card_tf32'] = _train_step_run(mt, cfg, batch,
                                                     DEVICE)[0]
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    out = {name: _reading_summary(_witness_readings(run, cpu, exact, slack))
           for name, run in runs.items()}
    for name in ('card', 'cpu_one_thread'):
        bad = {g: v for g, v in out[name].items() if not v['max'] <= 1.0}
        if bad:
            raise AssertionError(f'train reference: {name} outside '
                                 f'tolerance {bad}')
    control = out['control_card_tf32']
    for group in ('grad_backbone', 'grad_heads'):
        if not control[group]['max'] > 1.0:
            raise AssertionError(f'train reference: the check passes a TF32 '
                                 f'step in {group}: {control[group]}')
    out['losses'] = {k[5:]: v.item() for k, v in exact.items()
                     if k.startswith('loss:')}
    return out


def reference_draws(mt, n: int) -> list:
    """``check_train_reference`` at the batch seeds of RandomState(0) ..
    RandomState(n - 1): each draw's verdict and its largest reading of
    each group (the card's; the failing run's where one failed)."""
    out = []
    for seed in range(n):
        try:
            readings = check_train_reference(mt, np.random.RandomState(seed))
            verdict = 'pass'
            worst = {g: v['max'] for g, v in readings['card'].items()}
        except AssertionError as e:
            verdict, worst = 'fail', str(e)
        out.append(dict(seed=seed, verdict=verdict, readings=worst))
        print(f'reference draw {seed}: {verdict} {worst}', flush=True)
    return out


def train_path(mt, kc):
    """bench.py's train step on the card: resnext50, bf16, batch 4 at 256 px
    from ``make_random_batch(4, (256, 256), 8)``, seeded weights,
    ``rectified_adam(cyclic_lr(1e-4, 1e-3, 700))``. TRAIN_WARMUP steps,
    then TRAIN_STEPS counted ones, each timed on the host clock between CUDA
    synchronizations, with its kernel launches counted from 0 just before
    it: every loss finite, and K1's forward, K1's backward and K3 launched
    in every step. Then the peak memory of the counted steps, one more step
    traced and split by its ``stage:`` spans, one recording the maps K1's
    backward gets (``k1_backward_shapes``), and one step with metrics."""
    from masklab_tpu_torch import train
    from masklab_tpu_torch.data import make_random_batch
    model = mt.build_masklab(train_config(mt), device=DEVICE, seed=0)
    state = train.TrainState(model, train.rectified_adam(
        train.cyclic_lr(1e-4, 1e-3, 700)))
    step = train.make_train_step(model, with_metrics=False)
    batch = train.as_batch(make_random_batch(
        TRAIN_BATCH, (TRAIN_SIZE, TRAIN_SIZE), 8), DEVICE)
    for _ in range(TRAIN_WARMUP):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses, counts = [], [], []
    for i in range(TRAIN_STEPS):
        kc.reset_launch_counts()
        start = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
        counts.append(kc.launch_counts())
        losses.append({k: v.item() for k, v in metrics.items()})
        if not all(np.isfinite(v) for v in losses[-1].values()):
            raise AssertionError(f'train step {i}: losses {losses[-1]}')
        for name in ('band_groupnorm', 'band_groupnorm_backward', 'nms_keep'):
            if counts[-1][name] == 0:
                raise AssertionError(f'train step {i}: {name} not launched')
    peak = torch.cuda.max_memory_allocated()
    totals = {k: sum(c[k] for c in counts) for k in counts[0]}
    profile = stage_profile(lambda: step(state, batch))
    k1b_shapes = k1_backward_shapes(step, state, batch)
    check_train_maps(k1b_shapes)
    with_metrics = train.make_train_step(model, with_metrics=True)
    _, metrics = with_metrics(state, batch)
    metrics = {k: v.item() for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f'train step with metrics: {metrics}')
    return dict(config='resnext50 bf16 b4@256', steps=TRAIN_STEPS,
                ms_per_step=statistics.median(times), step_ms=times,
                peak_memory_bytes=peak, first_losses=losses[0],
                last_losses=losses[-1], launches=totals,
                launches_per_step=counts, metrics_step=metrics,
                k1_backward_shapes=k1b_shapes, **profile)


def stage_profile(fn):
    """One traced call of ``fn`` (a request, a train step), split by its
    ``stage:`` spans. For each stage: ``host_ms``, the span on the host
    clock (the tracer's own cost included); ``device_ms``, from the stage's
    first device operation to its last; ``busy_ms``, the device operations
    inside that extent. Then the device's busy share of the traced call and
    the operations that took the most device time."""
    cuda = torch.autograd.DeviceType.CUDA

    def body():
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - start) * 1e3

    prof, window_ms = traced(
        body, lambda p: any(e.device_type == cuda for e in p.events()),
        'device operation', host=True)
    host, device, ops = {}, {}, []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end)
        if e.name.startswith('stage:'):
            (device if e.device_type == cuda else host)[e.name[6:]] = span
        elif e.device_type == cuda:
            ops.append((*span, e.name))

    def busy(lo, hi):
        return sum(max(0, min(b, hi) - max(a, lo)) for a, b, _ in ops) / 1e3

    stages = {}
    for name, (a, b) in host.items():
        stages[name] = dict(host_ms=(b - a) / 1e3)
        if name in device:
            lo, hi = device[name]
            stages[name].update(device_ms=(hi - lo) / 1e3,
                                busy_ms=busy(lo, hi))
    by_name = {}
    for a, b, name in ops:
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + (b - a) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    host_ops = sorted((e for e in prof.key_averages()
                       if e.device_type != cuda
                       and not e.key.startswith('stage:')),
                      key=lambda e: -e.self_cpu_time_total)[:8]
    busy_ms = sum(b - a for a, b, _ in ops) / 1e3
    return dict(stages=stages, traced_ms=window_ms,
                device_busy_ms=busy_ms, device_busy_share=busy_ms / window_ms,
                top_device_ms=dict(top),
                top_host_self_ms={e.key[:60]: [e.self_cpu_time_total / 1e3,
                                               e.count] for e in host_ops})


# The trainer phase: the CLI's etl / train / eval on synthetic 1080p road
# frames (40 frames: 36 train, 4 valid), the road preset at full width,
# bf16, batch 8, the default scale buckets 0.4-0.6 (416x768 to 640x1152),
# head / waist / all phases of one epoch of 2 steps each (step sizes 4)
TRAINER_FRAMES, TRAINER_HW = 40, (1080, 1920)
TRAINER_ARGS = ['--preset=road', '-compute.compute_dtype', 'bfloat16',
                '-train.batch_size', '8',
                '-train.train_head_tune_epoch', '1',
                '-train.train_waist_tune_epoch', '1',
                '-train.train_all_epoch', '1', '-train.head_step_size', '4',
                '-train.waist_step_size', '4', '-train.all_step_size', '4']
TRAINER_PHASES = ('head', 'waist', 'all')
TRAINER_KERNELS = ('band_groupnorm', 'band_groupnorm_backward',
                   'segment_topk', 'nms_keep')


def trainer_row_lengths(mt) -> dict:
    """{scale bucket: K2's row length}, the road preset's anchors at each
    train scale bucket of a TRAINER_HW frame, sized as the generator sizes
    it (each side floored to a multiple of 32)."""
    from masklab_tpu_torch.nn.backbone import grid_padding
    cfg = mt.road_project_config()
    prior = mt.priors_from_config(cfg)
    out = {}
    for s in cfg.compute.scale_buckets:
        h = int(TRAINER_HW[0] * s) // 32 * 32
        w = int(TRAINER_HW[1] * s) // 32 * 32
        out[s] = len(mt.generate_priors(
            h, w, prior, padding=grid_padding(cfg.backbone.backbone_type)))
    return out


def batch_digest(batch: dict) -> str:
    """sha256 of a batch's arrays (keys, dtypes, shapes and bytes)."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(batch):
        a = np.ascontiguousarray(batch[k])
        h.update(f'{k} {a.dtype} {a.shape}'.encode())
        h.update(a.tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def trainer_probe(kc):
    """Wraps, for one CLI train run: the train and eval steps (host ms
    between CUDA synchronizations, kernel launches, K2's row length), the
    uploads, the waits on the prefetcher, each generator's calls (for
    ``replay_generators``), the epoch ends and the checkpoint saves, and
    captures the trainer. Yields the record; restores every original."""
    from masklab_tpu_torch.data import generator as gen_mod
    from masklab_tpu_torch.train import trainer as tr
    from masklab_tpu_torch.train.checkpoints import CheckpointManager
    rec = dict(phase='smoke', in_epoch_end=False, steps=[], evals=[],
               uploads=[], waits=[], epoch_ends=[], saves=[], gens={},
               trainer=None, train_gen=None, last=None)
    originals = []

    def patch(owner, name, make):
        originals.append((owner, name, getattr(owner, name)))
        setattr(owner, name, make(getattr(owner, name)))

    def synced_ms(fn, *args, **kwargs):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - start) * 1e3

    def train_step(orig):
        def make(model, with_metrics=True):
            step = orig(model, with_metrics)

            def run(state, batch):
                before = kc.launch_counts()
                (state, metrics), ms = synced_ms(step, state, batch)
                after = kc.launch_counts()
                h, w = batch['images'].shape[1:3]
                rec['steps'].append(dict(
                    phase=rec['phase'], ms=ms, hw=[h, w],
                    anchors=int(model._priors(h, w, batch['images'].device)
                                .shape[0]),
                    launches={k: after[k] - before[k] for k in after},
                    loss=metrics['loss'].item()))
                rec['last'] = (step, state, batch)
                return state, metrics
            return run
        return make

    def eval_step(orig):
        def make(model, with_metrics=True):
            step = orig(model, with_metrics)

            def run(state, batch):
                metrics, ms = synced_ms(step, state, batch)
                rec['evals'].append(dict(phase=rec['phase'], ms=ms))
                return metrics
            return run
        return make

    def prepare(orig):
        def run(self, batch):
            out, ms = synced_ms(orig, self, batch)
            rec['uploads'].append(dict(phase=rec['phase'], ms=ms,
                                       validation=rec['in_epoch_end']))
            return out
        return run

    def end_epoch(orig):
        def run(self, *args, **kwargs):
            rec['in_epoch_end'] = True
            try:
                _, ms = synced_ms(orig, self, *args, **kwargs)
            finally:
                rec['in_epoch_end'] = False
            rec['epoch_ends'].append(dict(phase=rec['phase'], ms=ms))
        return run

    def run_phase(orig):
        def run(self, name, generator, *args, **kwargs):
            rec.update(phase=name, trainer=self, train_gen=generator)
            return orig(self, name, generator, *args, **kwargs)
        return run

    def save_epoch(orig):
        def run(self, state, loss, epoch):
            path, ms = synced_ms(orig, self, state, loss, epoch)
            rec['saves'].append(dict(phase=rec['phase'], path=path, ms=ms,
                                     bytes=sum(
                os.path.getsize(os.path.join(path, f))
                for f in os.listdir(path))))
            return path
        return run

    def gen_init(orig):
        def run(self, *args, **kwargs):
            orig(self, *args, **kwargs)
            rec['gens'][id(self)] = dict(args=args, kwargs=kwargs,
                                         events=[])
        return run

    def gen_getitem(orig):
        def run(self, index):
            batch = orig(self, index)
            if id(self) in rec['gens']:
                rec['gens'][id(self)]['events'].append(
                    ('get', index, batch_digest(batch)))
            return batch
        return run

    def gen_epoch_end(orig):
        def run(self):
            orig(self)
            if id(self) in rec['gens']:
                rec['gens'][id(self)]['events'].append(('end',))
        return run

    def prefetch_iter(orig):
        def run(self):
            inner = orig(self)
            while True:
                start = time.perf_counter()
                try:
                    item = next(inner)
                except StopIteration:
                    return
                rec['waits'].append(dict(
                    phase=rec['phase'],
                    ms=(time.perf_counter() - start) * 1e3))
                yield item
        return run

    def train_model(orig):
        def run(config, *args, **kwargs):
            torch.cuda.reset_peak_memory_stats()
            trainer, ms = synced_ms(orig, config, *args, **kwargs)
            rec.update(trainer=trainer, train_ms=ms,
                       peak_memory_bytes=torch.cuda.max_memory_allocated())
            return trainer
        return run

    patch(tr, 'make_train_step', train_step)
    patch(tr, 'make_eval_step', eval_step)
    patch(tr, 'train_masklab_model', train_model)
    patch(tr.MaskLabTrainer, '_prepare', prepare)
    patch(tr.MaskLabTrainer, '_end_epoch', end_epoch)
    patch(tr.MaskLabTrainer, 'run_phase', run_phase)
    patch(CheckpointManager, 'save_epoch', save_epoch)
    patch(gen_mod.MaskLabGenerator, '__init__', gen_init)
    patch(gen_mod.MaskLabGenerator, '__getitem__', gen_getitem)
    patch(gen_mod.MaskLabGenerator, 'on_epoch_end', gen_epoch_end)
    patch(gen_mod.PrefetchIterator, '__iter__', prefetch_iter)
    try:
        yield rec
    finally:
        for owner, name, orig in reversed(originals):
            setattr(owner, name, orig)


def replay_generators(rec) -> int:
    """Each generator of the run rebuilt on the host from its arguments
    (the same seed) and driven by the same calls in the same order: every
    batch must have the card run's digest. -> the batches compared."""
    from masklab_tpu_torch.data.generator import MaskLabGenerator
    compared = 0
    for g in rec['gens'].values():
        gen = MaskLabGenerator(*g['args'], **g['kwargs'])
        for event in g['events']:
            if event[0] == 'end':
                gen.on_epoch_end()
                continue
            _, index, digest = event
            if batch_digest(gen[index]) != digest:
                raise AssertionError(f'trainer: batch {index} of a generator '
                                     'differs from its host replay')
            compared += 1
    return compared


def check_trainer_outputs(mt, rec, run_dir) -> dict:
    """The trainer's files and state: metrics.csv 3 rows with val_loss and
    lr, every value finite; 3 checkpoints, no tmp name left, the best the
    lowest parsed loss; the last checkpoint restored into a new state
    equal bit for bit to the trainer's; eval.json's mIoUs finite."""
    import csv
    from masklab_tpu_torch import train
    from masklab_tpu_torch.train.checkpoints import CheckpointManager
    with open(os.path.join(run_dir, 'metrics.csv')) as f:
        rows = list(csv.DictReader(f))
    if len(rows) != len(TRAINER_PHASES) or not {'val_loss', 'lr'} <= set(
            rows[0]):
        raise AssertionError(f'trainer: metrics.csv rows {rows}')
    if not all(np.isfinite(float(v)) for r in rows for v in r.values()):
        raise AssertionError(f'trainer: a logged value is not finite: {rows}')
    names = [n for n in os.listdir(run_dir)
             if os.path.isdir(os.path.join(run_dir, n)) and '-' in n]
    if len(names) != len(TRAINER_PHASES) or any('tmp' in n for n in names):
        raise AssertionError(f'trainer: checkpoints {names}')
    manager = CheckpointManager(run_dir)
    lowest = min(names, key=lambda n: float(n.rsplit('-', 1)[0]))
    if manager.best_checkpoint() != os.path.join(run_dir, lowest):
        raise AssertionError(f'trainer: best {manager.best_checkpoint()}, '
                             f'lowest {lowest}')
    trainer = rec['trainer']
    state = trainer.state
    restored = manager.restore_state(
        train.TrainState(mt.build_masklab(trainer.config, device=DEVICE),
                         state.tx), rec['saves'][-1]['path'])
    same = dict(
        params=all(torch.equal(restored.params[k], v)
                   for k, v in state.params.items()),
        batch_stats=all(torch.equal(restored.batch_stats[k], v)
                        for k, v in state.batch_stats.items()),
        moments=all(torch.equal(a[k], b[k])
                    for a, b in ((restored.opt_state[0].mu,
                                  state.opt_state[0].mu),
                                 (restored.opt_state[0].nu,
                                  state.opt_state[0].nu))
                    for k in b),
        box_state=all(torch.equal(a, b) for a, b in zip(
            restored.box_loss_state, state.box_loss_state)),
        step=restored.step == state.step)
    if not all(same.values()):
        raise AssertionError(f'trainer: restore_state differs: {same}')
    del restored
    with open(os.path.join(run_dir, 'eval.json')) as f:
        evaluation = json.load(f)
    if not all(np.isfinite(evaluation[k])
               for k in ('semantic_miou', 'mask_miou')):
        raise AssertionError(f'trainer: eval.json {evaluation}')
    return dict(metrics_rows=rows, checkpoints=sorted(names),
                best=os.path.basename(manager.best_checkpoint()),
                restored_bit_for_bit=same, eval=evaluation)


def trainer_path(mt, kc, rng):
    """The user's training path on the card, through the CLI: ``etl`` of
    TRAINER_FRAMES synthetic TRAINER_HW frames, ``train`` (TRAINER_ARGS:
    smoke check at the largest bucket, then head / waist / all, each epoch
    validated and checkpointed; the road preset's mesh_data 2 clamped to
    the one card), whose own eval follows, and ``eval`` once more. Every
    step's losses finite and K1, K1's backward, K2 and K3 launched in it;
    the outputs checked (``check_trainer_outputs``); the generators'
    batches equal to their host replay. Then K1's backward's maps in one
    more step, and one traced step (data wait, upload and the step's
    spans)."""
    import shutil
    import tempfile
    from torch.profiler import record_function
    from masklab_tpu_torch import cli, train
    from masklab_tpu_torch.data import make_synthetic_dataset
    from masklab_tpu_torch.data.generator import PrefetchIterator
    root = tempfile.mkdtemp(prefix='chip_smoke_trainer-')
    try:
        data_dir = os.path.join(root, 'data')
        logs = os.path.join(root, 'logs')
        start = time.perf_counter()
        make_synthetic_dataset(data_dir, num_images=TRAINER_FRAMES,
                               image_hw=TRAINER_HW, seed=0)
        synthetic_s = time.perf_counter() - start
        start = time.perf_counter()
        cli.main(['etl', f'-dataset.data_dir={data_dir}'])
        etl_s = time.perf_counter() - start
        # the CLI's own default device is the card
        device = [] if DEVICE == 'cuda' else [f'--device={DEVICE}']
        kc.reset_launch_counts()
        with trainer_probe(kc) as rec:
            start = time.perf_counter()
            cli.main(['train', *TRAINER_ARGS, *device, '-dataset.data_dir',
                      data_dir, '-train.save_dir', logs])
            torch.cuda.synchronize()
            cli_train_s = time.perf_counter() - start
        launches = kc.launch_counts()
        run_dir = os.path.join(logs, os.listdir(logs)[0])
        start = time.perf_counter()
        cli.main(['eval', *TRAINER_ARGS, *device, '-dataset.data_dir',
                  data_dir, '-train.save_dir', run_dir])
        eval_s = time.perf_counter() - start
        steps = rec['steps']
        counted = [s for s in steps if s['phase'] in TRAINER_PHASES]
        if [s['phase'] for s in steps] != ['smoke'] + [
                p for p in TRAINER_PHASES for _ in range(2)]:
            raise AssertionError(f'trainer: steps {[s["phase"] for s in steps]}')
        for i, s in enumerate(steps):
            if not np.isfinite(s['loss']):
                raise AssertionError(f'trainer step {i}: loss {s["loss"]}')
            for name in TRAINER_KERNELS:
                if s['launches'][name] == 0:
                    raise AssertionError(f'trainer step {i} ({s["phase"]}): '
                                         f'{name} not launched')
        outputs = check_trainer_outputs(mt, rec, run_dir)
        start = time.perf_counter()
        replayed = replay_generators(rec)
        replay_s = time.perf_counter() - start

        trainer, (step, state, batch) = rec['trainer'], rec['last']
        k1b_shapes = k1_backward_shapes(step, state, batch)
        step = train.make_train_step(trainer.model)
        prefetcher = PrefetchIterator(rec['train_gen'], prefetch=4)
        it = iter(prefetcher)

        def one_step():
            with record_function('stage:data_wait'):
                b = next(it)
            trainer.state, _ = step(trainer.state, trainer._prepare(b))
        try:
            one_step()
            profile = stage_profile(one_step)
        finally:
            prefetcher.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def by_phase(items, phase, **match):
        return [x['ms'] for x in items if x['phase'] == phase
                and all(x[k] == v for k, v in match.items())]
    import importlib.util
    step_ms = sum(s['ms'] for s in counted)
    waits = [w['ms'] for w in rec['waits'] if w['phase'] in TRAINER_PHASES]
    uploads = [u['ms'] for u in rec['uploads']
               if u['phase'] in TRAINER_PHASES and not u['validation']]
    saves = rec['saves']
    return dict(
        config=f'road seresnet34 bf16 b8, {TRAINER_FRAMES} frames '
               f'{TRAINER_HW[0]}x{TRAINER_HW[1]}',
        synthetic_s=synthetic_s, etl_s=etl_s, cli_train_s=cli_train_s,
        train_s=rec['train_ms'] / 1e3, eval_s=eval_s, replay_s=replay_s,
        steps=len(counted),
        smoke_ms=steps[0]['ms'], smoke_hw=steps[0]['hw'],
        ms_per_step={p: statistics.median(by_phase(counted, p))
                     for p in TRAINER_PHASES},
        step_ms=[s['ms'] for s in counted],
        step_hw=[s['hw'] for s in counted],
        img_per_s=8 * len(counted) / (step_ms / 1e3),
        data_wait_ms=waits, data_wait_ms_per_step=sum(waits) / len(counted),
        data_wait_share=sum(waits) / (sum(waits) + sum(uploads) + step_ms),
        upload_ms=uploads,
        validation_ms=[e['ms'] - s['ms']
                       for e, s in zip(rec['epoch_ends'], saves)],
        checkpoint_ms=[s['ms'] for s in saves],
        checkpoint_bytes=saves[-1]['bytes'],
        peak_memory_bytes=rec['peak_memory_bytes'],
        launches=launches,
        launches_per_step=[s['launches'] for s in counted],
        k2_row_lengths=sorted({s['anchors'] for s in steps}),
        replayed_batches=replayed,
        # the loggers' optional packages, and pandas, which the port's data
        # pipeline does without
        host_packages={m: importlib.util.find_spec(m) is not None
                       for m in ('pandas', 'tensorboard', 'mlflow')},
        first_loss=steps[1]['loss'], last_loss=steps[-1]['loss'],
        k1_backward_shapes=k1b_shapes, **outputs, **profile)


def deployment(mt, cfg):
    """A forced-dense model with seeded weights behind a predictor whose
    default mode is 'visualize', as the servers use it."""
    model = mt.force_dense(mt.build_masklab(cfg, device=DEVICE, seed=0))
    return model, mt.MaskLabPredictor(model, cfg, visualization=True,
                                      device=DEVICE)


def check_outputs(out: dict, mode: str, batch: int, max_out: int) -> None:
    """Shapes and types of the mode's outputs; every detection slot filled
    (forced dense); every analytics row finite."""
    boxes = out['det_boxes']
    if boxes.shape != (batch, max_out, 6):
        raise AssertionError(f'{mode}: det_boxes shape {boxes.shape}')
    filled = int((boxes[..., 4] >= 0).sum())
    if filled != batch * max_out:
        raise AssertionError(f'{mode}: {filled} of {batch * max_out} slots '
                             'filled')
    want = {'raw': {'padded_masks': ((batch, max_out, SIZE, SIZE),
                                     np.uint8),
                    'semantic': ((batch, SIZE, SIZE, 3), np.uint8)},
            'visualize': {'visualize': ((batch, SIZE, SIZE, 3), np.uint8),
                          'summarize': ((batch, max_out + 1, 11),
                                        np.float32)},
            'summarize': {'summarize': ((batch, max_out + 1, 11),
                                        np.float32)}}[mode]
    for key, (shape, dtype) in want.items():
        if out[key].shape != shape or out[key].dtype != dtype:
            raise AssertionError(f'{mode}: {key} {out[key].shape} '
                                 f'{out[key].dtype}, want {shape} {dtype}')
    if 'summarize' in out and not np.isfinite(out['summarize']).all():
        raise AssertionError(f'{mode}: non-finite analytics rows')


def serve_path(kc, model, predictor, batches, mode: str, max_out: int):
    """One path of the deployment: REQUESTS counted requests in ``mode``
    (after one warm-up), every kernel launch and every fallback of the
    candidate pool's certificate counted from 0 just before them; the
    model's outputs of each must be finite, each kernel launched on every
    forward. Then one more request, traced, split by stage."""
    from masklab_tpu_torch.ops import nms
    predictor.predict(batches[0], mode)               # warm-up, not counted
    raw_keys = ('cls_pred', 'loc_pred', 'seg_pred', 'roi_boxes', 'roi_masks')
    finite = []                  # per counted request, one flag per raw key
    hook = model.register_forward_hook(lambda module, args, out: finite.append(
        torch.stack([torch.isfinite(out[k]).all() for k in raw_keys])))
    torch.cuda.synchronize()
    kc.reset_launch_counts()
    nms.pool_fallbacks = 0
    latencies, outputs = [], []
    for images in batches:
        start = time.perf_counter()
        outputs.append(predictor.predict(images, mode))
        latencies.append(time.perf_counter() - start)
    counts = kc.launch_counts()
    fallbacks = nms.pool_fallbacks
    hook.remove()
    if len(finite) != REQUESTS:
        raise AssertionError(f'{mode}: {len(finite)} model forwards in '
                             f'{REQUESTS} requests')
    for i, flags in enumerate(torch.stack(finite).cpu()):
        for k, ok in zip(raw_keys, flags.tolist()):
            if not ok:
                raise AssertionError(f'{mode}: request {i}: non-finite {k}')
    for out in outputs:
        check_outputs(out, mode, len(batches[0]), max_out)
    for name, per_forward in PER_FORWARD.items():
        if counts[name] < per_forward * REQUESTS:
            raise AssertionError(f'{mode}: {name} launched {counts[name]} '
                                 f'times in {REQUESTS} forwards')
    total = sum(latencies)
    stats = dict(mode=mode, batch=len(batches[0]),
                 img_per_s=len(batches[0]) * REQUESTS / total,
                 p50_batch_ms=statistics.median(latencies) * 1e3,
                 latencies_ms=[t * 1e3 for t in latencies],
                 launches=counts, pool_fallbacks=fallbacks)
    stats.update(stage_profile(lambda: predictor.predict(batches[0], mode)))
    return stats


def check_postprocess(model, predictor, frames):
    """The same model outputs through the visualize and summarize
    postprocess on the card and on the CPU: boxes and the annotated frame
    exact; the analytics rows as tests/test_torch_serving.py holds them
    (class, box, confidence and flag columns exact, pixel counts rtol 1e-6,
    the my_road fit's columns rtol 5e-4, atol 1e-3)."""
    x = torch.from_numpy(frames).to(DEVICE)
    with torch.inference_mode():
        down, in_hw, ds_hw = predictor._downsample(x)
        out = model(down)
        on_cpu = {k: v.cpu() for k, v in out.items()
                  if isinstance(v, torch.Tensor)}
        gpu = {mode: predictor._postprocess(out, x, down, in_hw, ds_hw, mode)
               for mode in ('visualize', 'summarize')}
        cpu = {mode: predictor._postprocess(on_cpu, x.cpu(), down.cpu(),
                                            in_hw, ds_hw, mode)
               for mode in ('visualize', 'summarize')}
    errs = {}
    for mode in gpu:
        g = {k: v.cpu() for k, v in gpu[mode].items()}
        c = cpu[mode]
        if not torch.equal(g['det_boxes'], c['det_boxes']):
            raise AssertionError(f'postprocess {mode}: boxes differ')
        if 'visualize' in g:
            changed = int((g['visualize'] != c['visualize']).any(-1).sum())
            errs['visualize_changed_pixels'] = changed
            if changed:
                raise AssertionError(f'postprocess: {changed} frame pixels '
                                     'differ between the card and the CPU')
        gs, cs = g['summarize'], c['summarize']
        exact = [0, 1, 2, 3, 4, 5, 10]
        if not torch.equal(gs[..., exact], cs[..., exact]):
            raise AssertionError(f'postprocess {mode}: analytics columns '
                                 f'{exact} differ')
        for cols, rtol in (([6], 1e-6), ([7, 8, 9], 5e-4)):
            d = (gs[..., cols] - cs[..., cols]).abs()
            excess = (d - 1e-3 - rtol * cs[..., cols].abs()).max().item()
            errs[f'{mode}_cols_{cols[0]}_max_abs'] = d.max().item()
            if excess > 0:
                raise AssertionError(f'postprocess {mode}: columns {cols} '
                                     f'outside tolerance by {excess}')
    errs['frames'] = len(frames)
    return errs


def check_batching(predictor, rng, clients: int = 16):
    """``clients`` threads each submit one 512 px frame (summarize) to a
    MicroBatcher over the predictor, released together: each must be
    answered with its own row, and at least one device batch must hold
    more than one frame."""
    from masklab_tpu_torch.serving.batching import MicroBatcher
    frames = [rng.randint(0, 256, (SIZE, SIZE, 3)).astype(np.uint8)
              for _ in range(clients)]
    mb = MicroBatcher(predictor.predict, max_batch=clients, window_ms=50.0)
    results, errors = {}, {}
    barrier = threading.Barrier(clients)

    def client(i):
        barrier.wait()
        try:
            results[i] = mb.submit(frames[i], 'summarize')
        except Exception as exc:  # noqa: BLE001 - reported below
            errors[i] = exc
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(clients)]
    start = time.perf_counter()
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        mb.close()
    wall_ms = (time.perf_counter() - start) * 1e3
    if errors or len(results) != clients:
        raise AssertionError(f'batching: {len(results)} of {clients} '
                             f'answered, errors {errors}')
    for out in results.values():
        if out['summarize'].shape[0] != 1 \
                or not np.isfinite(out['summarize']).all():
            raise AssertionError('batching: a malformed answer')
    sizes = list(mb.batch_sizes)
    if max(sizes) < 2:
        raise AssertionError(f'batching: no batch above 1 ({sizes})')
    return dict(clients=clients, batch_sizes=sizes, wall_ms=wall_ms)


def check_servers(predictor, cfg, rng):
    """Round trips on localhost: the HTTP server's default (JSON with the
    base64 annotated JPEG), ``?outputs=summarize`` and ``?outputs=jpeg``;
    the gRPC server's Predict."""
    import base64
    import tempfile
    import urllib.request
    import cv2
    from masklab_tpu_torch.serving import (MaskLabGrpcServer, MaskLabServer,
                                           send_image_to_grpc,
                                           send_image_to_server)
    labels = cfg.dataset.instance_labels
    frame = rng.randint(0, 256, (SIZE, SIZE, 3)).astype(np.uint8)
    ok, jpeg = cv2.imencode('.jpg', frame)
    if not ok:
        raise AssertionError('servers: jpeg encode failed')
    body = jpeg.tobytes()
    out = {}

    def decoded_shape(data: bytes):
        return cv2.imdecode(np.frombuffer(data, np.uint8), 1).shape

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'frame.jpg')
        with open(path, 'wb') as f:
            f.write(body)
        http = MaskLabServer(predictor, port=0, instance_labels=labels)
        http.start()
        try:
            start = time.perf_counter()
            full = send_image_to_server(path, port=http.port, deadline_s=60)
            out['http_visualize_ms'] = (time.perf_counter() - start) * 1e3
            if not full['objs'] or decoded_shape(base64.b64decode(
                    full['visualize_jpeg_b64'])) != (SIZE, SIZE, 3):
                raise AssertionError('servers: HTTP visualize answer')
            for query in ('summarize', 'jpeg'):
                req = urllib.request.Request(
                    f'http://localhost:{http.port}/predict?outputs={query}',
                    data=body, method='POST')
                start = time.perf_counter()
                with urllib.request.urlopen(req, timeout=60) as r:
                    kind, data = r.headers['Content-Type'], r.read()
                    header = r.headers.get('X-Masklab-Summary')
                out[f'http_{query}_ms'] = (time.perf_counter() - start) * 1e3
                if query == 'summarize':
                    objs = json.loads(data)['objs']
                else:
                    objs = json.loads(header)
                    if kind != 'image/jpeg' \
                            or decoded_shape(data) != (SIZE, SIZE, 3):
                        raise AssertionError('servers: HTTP jpeg answer')
                if len(objs) != len(full['objs']):
                    raise AssertionError(f'servers: HTTP {query}: '
                                         f'{len(objs)} records')
            out['http_records'] = len(full['objs'])
        finally:
            http.stop()
        grpc_server = MaskLabGrpcServer(predictor, port=0,
                                        instance_labels=labels)
        grpc_server.start()
        try:
            start = time.perf_counter()
            reply = send_image_to_grpc(path, port=grpc_server.port,
                                       deadline_s=60)
            out['grpc_ms'] = (time.perf_counter() - start) * 1e3
        finally:
            grpc_server.stop()
        if len(reply['objs']) != len(full['objs']) or decoded_shape(
                base64.b64decode(reply['visualize_jpeg_b64'])) != (
                SIZE, SIZE, 3):
            raise AssertionError('servers: gRPC answer')
    return out


def serve_deployment(mt, kc, rng, name, cfg, batch, extra=None):
    """The deployment's three modes (raw, visualize, summarize), each with
    its own launch counts; ``extra(model, predictor)`` runs further phases
    on the same predictor."""
    model, predictor = deployment(mt, cfg)
    max_out = cfg.detection.nms_max_output_size
    batches = [rng.randint(0, 256, (batch, SIZE, SIZE, 3)).astype(np.uint8)
               for _ in range(REQUESTS)]
    paths = {}
    for mode in MODES:
        stats = serve_path(kc, model, predictor, batches, mode, max_out)
        paths[f'{name} {mode}'] = stats
        print(f'serve {name} {mode}: b{batch} {stats["img_per_s"]:.2f} '
              f'img/s, p50 batch {stats["p50_batch_ms"]:.2f} ms, latencies '
              f'{[round(t, 2) for t in stats["latencies_ms"]]} ms, launches '
              f'{json.dumps(stats["launches"])}, candidate-pool fallbacks '
              f'{stats["pool_fallbacks"]} in {REQUESTS} requests',
              flush=True)
        print(f'stages {name} {mode}: {json.dumps(stats["stages"])}, '
              f'busy share {stats["device_busy_share"]:.3f}', flush=True)
    more = extra(model, predictor) if extra else {}
    del model, predictor
    torch.cuda.empty_cache()
    return paths, more


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--kernels-only', action='store_true',
                        help='card, build and kernel phases at the main '
                        "path's shapes only")
    parser.add_argument('--serve-only', action='store_true',
                        help='card, build and the two deployments\' serve '
                        'paths only (phase 5 without the headline extras)')
    parser.add_argument('--trainer-only', action='store_true',
                        help='card, build, K2 at the main path and the '
                        "trainer's row lengths, and the trainer phase only")
    parser.add_argument('--reference-draws', type=int, default=0,
                        metavar='N', help='card, build and '
                        'check_train_reference at the batch seeds of '
                        'RandomState(0..N-1) only, each reported')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA card available', file=sys.stderr)
        return 1
    import masklab_tpu_torch as mt
    from masklab_tpu_torch.ops import cuda as kc
    from masklab_tpu_torch.ops.cuda import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f'card: {card}', flush=True)

    _build.library()
    print(f'build: {_build.build_seconds:.1f} s', flush=True)
    for line in _build.register_report():
        print(f'ptxas: {line}', file=sys.stderr)
    print(f'profiler: warm after {warm_profiler()} trace(s)', flush=True)

    rng = np.random.RandomState(0)
    if args.serve_only:
        serve, _ = serve_deployment(mt, kc, rng, 'headline',
                                    headline_config(mt), BATCH)
        road, _ = serve_deployment(mt, kc, rng, 'road', road_config(mt),
                                   ROAD_BATCH)
        finish(card, {'serve': dict(serve, **road)})
        return 0
    if args.reference_draws:
        finish(card, {'reference_draws': reference_draws(
            mt, args.reference_draws)})
        return 0
    if args.trainer_only:
        k2 = check_k2(kc, rng, False)
        print_k2(k2)
        trained = run_trainer(mt, kc, rng)
        finish(card, {'kernels': [k2], 'trainer': trained})
        return 0
    edges = not args.kernels_only
    kernels = [check_k1(kc, rng, edges), check_k1_backward(kc, rng, edges),
               check_k2(kc, rng, edges), check_k3(kc, rng, edges)]
    for k in kernels:
        print(f'kernel {k["name"]}: device {k["device_ms"]:.4f} ms, call '
              f'{k["call_ms"]:.4f} (plain {k["plain_ms"]:.4f}, bound '
              f'{k["bound_ms"]:.4f}) {k["shape"]}', flush=True)
    print_k2(kernels[2])
    if args.kernels_only:
        kernels[1]['train_maps'] = k1_backward_at(kc, rng, K1B_TRAIN_MAPS)
        print(f'kernel band_groupnorm_backward at the train maps: '
              f'{json.dumps(kernels[1]["train_maps"])}', flush=True)
        finish(card, {'kernels': kernels})
        return 0

    reference = {}
    for name, cfg in (('headline', narrow(headline_config(mt))),
                      ('road', narrow(road_config(mt)))):
        cfg.compute.compute_dtype = 'float32'
        reference[name] = check_reference(mt, rng, cfg)
        print(f'reference {name}: {json.dumps(reference[name])}', flush=True)
    reference['train'] = check_train_reference(mt, rng)
    print(f'reference train: {json.dumps(reference["train"])}', flush=True)

    def headline_extras(model, predictor):
        frames = rng.randint(0, 256, (4, SIZE, SIZE, 3)).astype(np.uint8)
        more = dict(postprocess=check_postprocess(model, predictor, frames))
        print(f'postprocess card vs CPU: {json.dumps(more["postprocess"])}',
              flush=True)
        more['batching'] = check_batching(predictor, rng)
        print(f'batching: {json.dumps(more["batching"])}', flush=True)
        more['servers'] = check_servers(predictor, headline_config(mt), rng)
        print(f'servers: {json.dumps(more["servers"])}', flush=True)
        return more

    serve, more = serve_deployment(mt, kc, rng, 'headline',
                                   headline_config(mt), BATCH,
                                   headline_extras)
    road, _ = serve_deployment(mt, kc, rng, 'road', road_config(mt),
                               ROAD_BATCH)
    serve.update(road)
    trained = train_path(mt, kc)
    print(f'train: {trained["config"]}, {trained["ms_per_step"]:.2f} ms/step '
          f'(median of {trained["steps"]}; steps '
          f'{[round(t, 2) for t in trained["step_ms"]]} ms), peak memory '
          f'{trained["peak_memory_bytes"] / 2**30:.2f} GiB, first losses '
          f'{json.dumps(trained["first_losses"])}, last losses '
          f'{json.dumps(trained["last_losses"])}, launches per step '
          f'{json.dumps(trained["launches_per_step"][-1])}', flush=True)
    print(f'stages train: {json.dumps(trained["stages"])}, busy share '
          f'{trained["device_busy_share"]:.3f}, top host ops (self ms, '
          f'calls) {json.dumps(trained["top_host_self_ms"])}', flush=True)
    k1b = kernels[1]
    k1b['train_maps'] = k1_backward_at(kc, rng,
                                       trained.pop('k1_backward_shapes'))
    print(f'kernel band_groupnorm_backward at the train maps: '
          f'{json.dumps(k1b["train_maps"])}', flush=True)
    trainer = run_trainer(mt, kc, rng)
    paths = dict(serve, train=trained, trainer=dict(
        launches={k: sum(c[k] for c in trainer['launches_per_step'])
                  for k in TRAINER_KERNELS}))
    for k in kernels:
        k['launches_by_path'] = {p: v['launches'][k['name']]
                                 for p, v in paths.items()}
        k['launches'] = k['launches_by_path'][
            'train' if k['name'] == 'band_groupnorm_backward'
            else 'headline raw']
        if k['name'] == 'segment_topk':
            k['pool_fallbacks'] = {p: v['pool_fallbacks']
                                   for p, v in serve.items()}
    finish(card, {'kernels': kernels, 'serve': serve, 'train': trained,
                  'trainer': trainer, 'reference': reference, **more})
    return 0


def print_k2(k2) -> None:
    l2 = ' (below the HBM bound: read from L2)' if k2['hot_below_bound'] \
        else ''
    print(f'kernel segment_topk: cold {k2["device_ms"]:.5f} ms, hot '
          f'{k2["device_hot_ms"]:.5f}{l2}, pool {k2["pool_ms"]:.5f}, '
          f'torch.topk {k2["library_ms"]:.5f} cold; f32 scores '
          f'{k2.get("device_f32_ms")}; road form {k2["road_shape"]} cold '
          f'{k2["road_device_ms"]:.5f} (bound {k2["road_bound_ms"]:.5f}); '
          f'trainer rows {json.dumps(k2["trainer_row_lengths"])}, '
          f'{k2["trainer_shape"]} cold {k2["trainer_device_ms"]:.5f} (bound '
          f'{k2["trainer_bound_ms"]:.5f})', flush=True)


def run_trainer(mt, kc, rng) -> dict:
    """``trainer_path``, its lines printed, and K1's backward held and
    timed at the maps a trainer step gave it."""
    trained = trainer_path(mt, kc, rng)
    print(f'trainer: {trained["config"]}, median ms a step by phase '
          f'{json.dumps(trained["ms_per_step"])} (steps '
          f'{[round(t, 2) for t in trained["step_ms"]]} at '
          f'{trained["step_hw"]}; smoke {trained["smoke_ms"]:.2f} at '
          f'{trained["smoke_hw"]}), {trained["img_per_s"]:.2f} img/s, data '
          f'wait {trained["data_wait_ms_per_step"]:.2f} ms a step (share '
          f'{trained["data_wait_share"]:.3f}; waits '
          f'{[round(t, 2) for t in trained["data_wait_ms"]]}), upload '
          f'{[round(t, 2) for t in trained["upload_ms"]]} ms, validation '
          f'{[round(t, 2) for t in trained["validation_ms"]]} ms, checkpoint '
          f'{[round(t, 2) for t in trained["checkpoint_ms"]]} ms / '
          f'{trained["checkpoint_bytes"]} bytes, peak memory '
          f'{trained["peak_memory_bytes"] / 2**30:.2f} GiB, launches per '
          f'step {json.dumps(trained["launches_per_step"])}, K2 row lengths '
          f'{trained["k2_row_lengths"]}, losses {trained["first_loss"]:.5f} '
          f'-> {trained["last_loss"]:.5f}, eval '
          f'{json.dumps(trained["eval"])}, {trained["replayed_batches"]} '
          f'batches equal to their host replay; synthetic '
          f'{trained["synthetic_s"]:.1f} s, etl {trained["etl_s"]:.1f} s, '
          f'cli train {trained["cli_train_s"]:.1f} s (trainer '
          f'{trained["train_s"]:.1f}), eval {trained["eval_s"]:.1f} s, '
          f'replay {trained["replay_s"]:.1f} s; packages '
          f'{json.dumps(trained["host_packages"])}', flush=True)
    print(f'stages trainer: {json.dumps(trained["stages"])}, busy share '
          f'{trained["device_busy_share"]:.3f}, top host ops (self ms, '
          f'calls) {json.dumps(trained["top_host_self_ms"])}', flush=True)
    trained['k1_backward_maps'] = k1_backward_at(
        kc, rng, trained.pop('k1_backward_shapes'))
    print(f'kernel band_groupnorm_backward at the trainer maps: '
          f'{json.dumps(trained["k1_backward_maps"])}', flush=True)
    return trained


def finish(card: str, result: dict) -> None:
    """The last three lines: the result, the card, the device line."""
    print(json.dumps(result))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    sys.exit(main())
