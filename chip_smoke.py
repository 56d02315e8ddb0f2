#!/usr/bin/env python3
"""Smoke run of the PyTorch port (masklab_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--kernels-only | --serve-only | --trainer-only
                           | --deploy-only | --parallel-only | --fused-only
                           | --acceptance-only | --spatial-only
                           | --multi-card | --reference-draws N]

Phases, each of which fails the run (non-zero exit, no result line):

  1. card: prints ``nvidia-smi --query-gpu=name,power.limit``;
  2. build: compiles the CUDA kernels from ``masklab_tpu_torch/csrc``;
  3. kernels: holds each kernel against its plain PyTorch version at the
     main path's shapes and at edge cases (K2, K3, K4 exact; K1 f32 within
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
     K4 at the batch cell's b16 1080p call, without and with the union
     (one launch a call, no thresholded pixel flipped); K5 (eval BatchNorm
     with its epilogue) at resnet50's stem map with relu and at
     EfficientNet-B4's widest expand map with silu (bf16, b16 at 270x480;
     one launch a call, ``torch.equal`` to the plain chain; beside it
     ATen's one-pass ``F.batch_norm`` with the activation in place);
  4. reference: narrow float32 models (width 32, depth 1, 512 px) of the
     headline configuration and of the road preset on the card against the
     same models on the CPU, where every kernel's plain version runs; and
     one train step of a narrow float32 model on the resnext50 body (128
     px) on the card against a float64 step on the CPU, every run on the
     float64 step's loss-NMS proposals and ReLU gates with its own
     targets held to the float64 step's, each tensor within TRAIN_REF_RATIO
     x the larger error of two CPU float32 steps (default threads, one
     thread), with a TF32 step as the control that must fail
     (``check_train_reference``);
  5. serve: two deployments behind ``MaskLabPredictor``, forced dense, 512
     px: the headline (mobilenet, width 128, depth 4, bf16, batch 16) and
     the road preset (seresnet34, squeeze-excite heads, bf16, batch 8).
     Each answers 3 requests in each output mode (raw, visualize,
     summarize), each mode with its launch counts and certificate
     fallbacks counted from 0 just before it; each request's model outputs
     must be finite, every slot must fill, every kernel must launch on
     every forward, K4 once a visualize or summarize call and never in
     raw, and each mode's outputs have their shapes and finite
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
     the 0.4 and 0.6 buckets of a 1080p frame);
  8. deployment: the CLI's default deployment (``ModelConfiguration()``:
     resnet50, widths 128, float32, 540x960) end to end
     (``default_deployment``): checkpoint A, ``cli export --dest``, the
     CLI's serve over the bundle (watcher on, micro-batch 16) with 16 HTTP
     clients sending 1080p JPEG frames for DEPLOY_ROUNDS counted rounds
     (img/s, p50, p99, batch sizes, launches); checkpoint B written into
     the bundle under load and POST /reload (model_version flips, no
     request fails, answers then equal a predictor built on B; the swap's
     ms and peak memory); ``cli process --batch=8`` against per-image
     predictions; K1 against its plain version at every map a b16
     forward gives it; K2 exact and cold at the deployment's [16, 5,
     163275];
  9. backbones: the ten other bodies of the registry at full width, 512
     px, card vs CPU at every endpoint, and one bf16 forward each;
 10. separable: the deployment with separable heads, narrow card vs CPU,
     one full-width summarize request, K1 at the maps it gets.

 11. parallel: data parallelism over torch.distributed (``run_parallel``):
     two gloo ranks on the one card against one process on it (the narrow
     float32 road preset, 2 steps of a global batch of 4 at 128 px, every
     run on the one-process run's loss-NMS proposals and ReLU gates, each
     rank its rows), each tensor within TRAIN_REF_RATIO x the same pair's
     distance on the CPU (two gloo CPU ranks against one CPU process), the
     ranks bitwise equal; the road preset at full width through the
     multihost worker's library (bf16, 2 ranks x 4 at 416x768: K2 at [4,
     5, 99540] a rank; PARALLEL_WARMUP + PARALLEL_STEPS steps, K1, K1's
     backward, K2 and K3 launched in every counted step on each rank, ms a
     step, img/s of the pair, the collectives' share of a traced step,
     peak memory, the ranks bitwise equal), then the worker at world size
     1 over NCCL; the headline predictor over a mesh of two replicas on
     the card (a batch of 15, padded to 16), every mode exact against the
     unsharded predictor on the same shards, boxes and analytics against
     the whole batch, img/s and p50 on 2 replicas and 1, a hot swap
     rebuilding both replicas.

 12. fused: the fused mask head (``compute.fused_mask_head``,
     ``run_fused``): the narrow float32 headline model with it, card
     against CPU as phase 4; the full-width headline predictor with it
     (b16, 512 px, bf16, forced dense) in the three modes as phase 5, K2
     once and K3 twice a forward and K1 never (its GroupNorm is textbook
     per box), its mask branch's host and busy ms beside the per-level
     headline's; FUSED_STEPS counted steps of the bench train config with
     it (every loss finite), ms a step beside the per-level config's;
 13. acceptance: the learning gates (``run_acceptance``):
     ``examples/torch/06_overfit_acceptance.py`` (8 synthetic images, 12 x
     50 steps of the small road model, mask mIoU > 0.8 and semantic mIoU >
     0.6 at 128x160) and ``07_generalization_gate.py`` (30 images, the
     seed-777 split, both > 0.5 on the held-out images), each from a fresh
     synthetic set, their launches counted; a gate below its floor fails
     the run. K1 and K1's backward are then held against their plain
     versions at every distinct map the gates gave them (the small road
     model's float32 C=32, G=16 heads, cg 2), relu off and on.
 14. spatial: the dp x sp spatial sharding (``run_spatial``): JAX's
     spatial test model (mobilenet, widths 16, 128 px) and the narrow
     road preset at 56 x 96 (C3 7 rows, P6 1 row), float32, on a 1 x 2
     and a 2 x 2 mesh of gloo ranks on the card against one process on
     the card: ``raw_heads`` (the ranks' rows put together) and one train
     step on the one-process run's decisions (``fixed_decisions``, each
     rank its rows and blocks), each tensor within TRAIN_REF_RATIO x the
     same mesh's distance on the CPU, every rank bitwise equal; then the
     road preset at full width (bf16) at 1080 x 1920, a global batch of 2
     on 1 x 2 gloo ranks sharing the card: one forward, PARALLEL_WARMUP +
     SPATIAL_STEPS steps, K1, K1's backward, K2 and K3 launched in every
     counted step on each rank, every loss finite, the ranks bitwise
     equal; ms a step and img/s, peak memory a rank beside one process's
     step at the same batch, a traced step's row exchanges, row gathers
     and all-reduces and their share; K2 exact at its call on this path,
     K1 and its backward held at every map the path gave them.

Phases 8-11 run after phase 12, phase 14 after them, phase 7 after it,
and phase 13 last.

Then it prints the ``kernels`` JSON line (each kernel's ``launches`` from
the headline raw path, K1's backward's from the train path, K4's from the
headline summarize path,
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
``--deploy-only`` runs phases 1, 2 and 8-10, ``--parallel-only`` phases 1,
2 and 11, ``--fused-only`` phases 1, 2 and 12 (serving the per-level
headline and 5 per-level train steps beside it), ``--acceptance-only``
phases 1, 2 and 13, ``--spatial-only`` phases 1, 2 and 14.
``--multi-card`` (two cards at least; not part of the default
run, which needs one) runs phases 1, 2 and data parallelism over every
card: the full-width step over one NCCL rank a card against one rank, the
CLI trainer with ``compute.mesh_data`` = the cards, the serving mesh over
them, and (four cards) phase 14's full-width run on a 2 x 2 mesh of NCCL
ranks, one a card, a global batch of 4; with ``--spatial-only``, only
that. ``--reference-draws N`` runs
phases 1, 2 and phase 4's train reference at N fresh batch seeds, reporting
each verdict (a failing draw does not fail the run).
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

STARTED = time.perf_counter()
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
# ragged for 16 groups), K2 once for the candidate pool, K3 in both stages,
# K5 in each of MobileNetV1's 27 BatchNorms (the headline; more in the other
# bodies)
PER_FORWARD = {'band_groupnorm': 12, 'segment_topk': 1, 'nms_keep': 2,
               'batch_norm_act': 27}
# the path whose launches each kernel's row reports ('headline raw' for the
# others): K1's backward trains, K4 reduces the paste in summarize
KERNEL_PATH = {'band_groupnorm_backward': 'train',
               'paste_stats': 'headline summarize'}
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


def k1_cases(kc, rng, shapes, g=16, dtypes=(torch.float32, torch.bfloat16)):
    """K1 at each (n, Q, C), in each of ``dtypes``, relu off and on; raises
    after trying them all if any is outside its tolerance."""
    cases, bad = [], []
    for n, q, c in shapes:
        x = torch.from_numpy(rng.randn(n, q, c).astype(np.float32) * 2
                             + 1).to(DEVICE)
        scale = torch.from_numpy(rng.rand(c).astype(np.float32)).to(DEVICE)
        bias = torch.from_numpy(rng.rand(c).astype(np.float32)).to(DEVICE)
        for dtype in dtypes:
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


@contextlib.contextmanager
def recorded_k1_maps():
    """Within the block, every ragged GroupNorm of the model (the port's
    ``BandGroupNormFn``, whose forward is K1 on the card) records its map:
    yields the list of (n, Q, C, groups, dtype, relu), one a call."""
    from masklab_tpu_torch.nn import layers
    maps, original = [], layers.BandGroupNormFn

    class Recorder:
        @staticmethod
        def apply(x, scale, bias, groups, eps, relu):
            maps.append(tuple(x.shape) + (groups, x.dtype, bool(relu)))
            return original.apply(x, scale, bias, groups, eps, relu)
    layers.BandGroupNormFn = Recorder
    try:
        yield maps
    finally:
        layers.BandGroupNormFn = original


def k1_at_maps(kc, rng, maps) -> list:
    """K1 against its plain version at each distinct (n, Q, C) of the maps
    ``recorded_k1_maps`` saw, in each map's dtype and groups, relu off and
    on; raises if any is outside its tolerance."""
    cases = []
    for g, dtype in sorted({(m[3], m[4]) for m in maps}, key=str):
        shapes = sorted({m[:3] for m in maps if m[3:5] == (g, dtype)})
        for case in k1_cases(kc, rng, shapes, g, dtypes=(dtype,)):
            cases.append(dict(case, groups=g))
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


@contextlib.contextmanager
def recorded_k1_backward_maps():
    """Within the block, every call of K1's backward wrapper records its map:
    yields the list of [n, q, c, groups, dtype, fuse_relu], one a call."""
    from masklab_tpu_torch.ops.cuda import groupnorm
    seen, wrapper = [], groupnorm.band_groupnorm_backward

    def record(x, dy, scale, groups, eps=1e-5, fuse_relu=False):
        seen.append([*x.shape, groups, str(x.dtype)[6:], bool(fuse_relu)])
        return wrapper(x, dy, scale, groups, eps, fuse_relu)
    groupnorm.band_groupnorm_backward = record
    try:
        yield seen
    finally:
        groupnorm.band_groupnorm_backward = wrapper


def k1_backward_shapes(step, state, batch) -> list:
    """The maps K1's backward gets in one train step, as [n, q, c, groups,
    dtype, fuse_relu] (the step runs once more with the wrapper wrapped)."""
    with recorded_k1_backward_maps() as seen:
        step(state, batch)
        torch.cuda.synchronize()
    return seen


def k1_backward_at_maps(kc, rng, maps) -> list:
    """K1's backward against its plain version at each distinct (n, q, c,
    groups, dtype) of the maps ``recorded_k1_backward_maps`` saw, relu off
    and on, within K1B_*; raises after trying them all if any is outside.
    An empty map (n = 0) has nothing to hold."""
    cases, bad = [], []
    for n, q, c, g, dtype in sorted({tuple(m[:5]) for m in maps if m[0]}):
        dt = getattr(torch, dtype)
        x = torch.from_numpy(rng.randn(n, q, c).astype(np.float32) * 2
                             + 1).to(DEVICE).to(dt)
        dy = torch.from_numpy(rng.randn(n, q, c).astype(np.float32)).to(
            DEVICE).to(dt)
        scale = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(
            np.float32)).to(DEVICE)
        for relu in (False, True):
            dx_err, p_err = k1_backward_errors(kc, x, dy, scale, g, relu)
            case = dict(shape=[n, q, c], groups=g, dtype=dtype, relu=relu,
                        dx_err=dx_err, param_err=p_err)
            cases.append(case)
            limit = K1B_F32_ATOL if dt == torch.float32 else K1B_BF16_ULPS
            if not (dx_err <= limit and p_err <= K1B_PARAM_RTOL):
                bad.append(case)
    if bad:
        raise AssertionError(f'band_groupnorm_backward outside tolerance: '
                             f'{bad}')
    return cases


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


def l2_flush():
    """A call that evicts the 50 MB L2 by rewriting a 128 MB scratch
    tensor."""
    scratch = torch.zeros(32 << 20, dtype=torch.int32, device=DEVICE)

    def flush():
        torch.bitwise_not(scratch, out=scratch)
    return flush


def l2_flusher():
    """``l2_flush()`` and its kernels' symbols (for ``device_ms``'s
    ``exclude``)."""
    flush = l2_flush()
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


K5_STEM = (16, 64, 270, 480)     # resnet50's stem map in the batch cells
K5_EXPAND = (16, 144, 270, 480)  # EfficientNet-B4's widest expand map
# (stage 1's first block); with edges also a bottleneck's last BatchNorm with
# its shortcut, and odd C (the scalar path)
K5_EDGES = (((16, 256, 135, 240), 'relu', True),
            ((16, 37, 68, 120), 'silu', True))


def k5_case(kc, shape, act, residual=False, seed=0, timed=True) -> dict:
    """K5 on a seeded bf16 channels_last map against the plain chain:
    one launch a call and ``torch.equal``; with ``timed``, its device ms
    (own symbol), call ms, plain ms, the library's one-pass form (ATen's
    ``F.batch_norm`` on the running statistics, then the activation in
    place: ``library_ms``, the device ms of all its kernels, and the share
    of elements whose bits differ from the plain chain's) and the bound:
    the map read (and the residual), the output written, at 3.35 TB/s."""
    bna = kc.batch_norm_act
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    c, eps = shape[1], 1e-3

    def draw(scale, shift=0.0):
        return (torch.randn(shape, generator=g, device=DEVICE) * scale
                + shift).to(torch.bfloat16).contiguous(
                    memory_format=torch.channels_last)
    x = draw(3.0, 0.5)
    r = draw(2.0) if residual else None
    mean = torch.rand(c, generator=g, device=DEVICE) - 0.5
    var = torch.rand(c, generator=g, device=DEVICE) + 0.5
    weight = torch.rand(c, generator=g, device=DEVICE) + 0.5
    bias = torch.rand(c, generator=g, device=DEVICE) * 0.6 - 0.3
    mul = torch.rsqrt(var + eps) * weight

    def call():
        return bna.batch_norm_act(x, mean, mul, bias, r, act)

    def plain():
        return bna.batch_norm_act_plain(x, mean, mul, bias, r, act)

    def library():
        y = torch.nn.functional.batch_norm(x, mean, var, weight, bias,
                                           False, 0.0, eps)
        if r is not None:
            y.add_(r)
        if act == 'relu':
            y.relu_()
        elif act == 'silu':
            torch.nn.functional.silu(y, inplace=True)
        return y
    before = kc.launch_counts()['batch_norm_act']
    got = call()
    torch.cuda.synchronize()
    launches = kc.launch_counts()['batch_norm_act'] - before
    if launches != 1:
        raise AssertionError(f'batch_norm_act: {launches} launches a call')
    want = plain()
    differ = int((got != want).sum())
    if differ:
        raise AssertionError(f'batch_norm_act {list(shape)} {act}: {differ} '
                             'elements differ from the plain chain')
    out = dict(shape=list(shape), act=act, residual=residual, differ=differ,
               launches_per_call=launches)
    if not timed:
        return out
    e = x.numel()
    nbytes = e * x.element_size() * (3 if residual else 2) + 3 * c * 4
    flops = e * (3 + residual + {None: 0, 'relu': 1, 'silu': 4}[act])
    b_ms, b_by = bound_ms(nbytes, flops)
    dev = device_ms(call, 50, 'batch_norm_act')
    return dict(out, device_ms=dev, call_ms=time_ms(call, 50),
                plain_ms=time_ms(plain, 10), library_ms=device_ms(library, 50),
                library_differ_share=int((library() != want).sum()) / e,
                bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / dev,
                tb_per_s=nbytes / dev / 1e9)


def check_k5(kc, rng, edges: bool):
    """K5 at resnet50's stem map (relu) and at B4's widest expand map
    (silu), bf16 b16 at 270x480, and with ``edges`` at K5_EDGES (untimed).
    ``rng`` is unused: each case draws from a generator of its own."""
    stem = k5_case(kc, K5_STEM, 'relu', seed=51)
    expand = k5_case(kc, K5_EXPAND, 'silu', seed=52)
    more = [k5_case(kc, shape, act, res, seed=53 + i, timed=False)
            for i, (shape, act, res) in enumerate(K5_EDGES if edges else ())]
    return dict(name='batch_norm_act', route='cuda',
                source='masklab_tpu_torch/csrc/batch_norm_act.cu',
                replaces='none (flax nn.BatchNorm, fused by XLA)',
                shape=f'{list(K5_STEM)} bf16 relu', max_abs_err=0.0,
                ms=stem['device_ms'],
                **{k: stem[k] for k in ('device_ms', 'call_ms', 'plain_ms',
                                        'library_ms', 'library_differ_share',
                                        'bound_ms', 'bound_by',
                                        'share_of_bound', 'tb_per_s',
                                        'launches_per_call')},
                expand=expand, edges=more)


PASTE_HW = (1080, 1920)     # the batch cell's frames
PASTE_BOXES = 100            # forced dense: every NMS slot fills
PASTE_CLASSES = 6


def paste_inputs(rng, b, k, hw, ms, kept=1.0):
    """K4's arguments as ``paste_stats_and_union`` makes them for b x k
    forced-dense rows (int boxes, sides log-uniform from one pixel to the
    frame, ``kept`` of them scoring 50 or more, the last two padding),
    random 0/1 ``ms`` x ``ms`` masks and a noisy my_road trapezoid:
    ((y1, y2, x1, x2, keep, masks, my_road), onehot)."""
    from masklab_tpu_torch.serving import postprocess as tpost
    from masklab_tpu_torch.serving.visualize import class_one_hot
    h, w = hw
    conf = np.where(rng.rand(b, k) < kept, rng.uniform(50, 100, (b, k)),
                    rng.uniform(0, 50, (b, k)))
    det = np.stack([rng.rand(b, k) * w, rng.rand(b, k) * h,
                    np.exp(rng.uniform(0, np.log(w), (b, k))),
                    np.exp(rng.uniform(0, np.log(h), (b, k))),
                    rng.randint(0, PASTE_CLASSES, (b, k)), conf], -1)
    det = det.astype(np.int32).astype(np.float32)
    masks = (rng.rand(b, k, ms, ms) > 0.5).astype(np.float32)
    det[:, -2:, 4:] = -1
    masks[:, -2:] = 0
    ys, xs = np.arange(h)[:, None], np.arange(w)[None]
    road = (ys >= h // 3) & (np.abs(xs - w * 0.5) < ys / h * w * 0.4)
    road = road[None] ^ (rng.rand(b, h, w) > 0.97)
    det_t = torch.from_numpy(det).to(DEVICE)
    y1, y2, x1, x2, keep = tpost._paste_edges(det_t, hw, 50.0)
    onehot = class_one_hot(det_t[..., 4].to(torch.int64),
                           PASTE_CLASSES) * keep[..., None]
    return ((y1, y2, x1, x2, keep, torch.from_numpy(masks).to(DEVICE),
             torch.from_numpy(road).to(DEVICE)), onehot)


def k4_flips(kc, args, onehot) -> dict:
    """One wrapper call against the plain version: the differing entries
    of each output (thresholded pixels flipped show in all of them); the
    call must launch the kernel once."""
    before = kc.launch_counts()['paste_stats']
    got = kc.paste_reduce(*args, onehot)
    torch.cuda.synchronize()
    launched = kc.launch_counts()['paste_stats'] - before
    if launched != 1:
        raise AssertionError(f'paste_stats: {launched} launches a call')
    want = kc.paste_reduce_plain(*args, onehot)
    return {name: int((g != w_).sum()) for name, g, w_ in zip(
        ('area', 'inter', 'rowany', 'union'), got, want) if w_ is not None}


def check_k4(kc, rng, edges: bool):
    """K4 at the batch cell's call: b16 x 100 forced-dense boxes, 28 x 28
    masks, 1080 x 1920 frames, without the union (summarize) and with it
    (visualize); exact against the plain version (and, with ``edges``, at
    b2 x 12 at 96 x 128 with a fifth not kept, 32 x 32 masks at 4096 wide,
    14 x 14 and 56 x 56 masks at 200 x 300, and 28 x 28 masks at 5000
    wide, past one column chunk of the kernel). Device time of the summarize call
    (``device_ms``, its own symbol) and of the visualize call
    (``union_device_ms``); ``call_ms`` with the wrapper's box spans, zeroed
    outputs and class words. Bound: the kept boxes' pixels at 4 f32
    operations each (a multiply, an FMA, the keep multiply), against the
    bytes of the masks, the box rows, the road map once, the row map and
    the counts."""
    from masklab_tpu_torch.ops.cuda import paste_stats as ps
    b, k, ms = BATCH, PASTE_BOXES, 28
    args, onehot = paste_inputs(rng, b, k, PASTE_HW, ms)
    flips = {'summarize': k4_flips(kc, args, None),
             'visualize': k4_flips(kc, args, onehot)}
    if edges:
        for name, shape in (('small', (2, 12, (96, 128), 8, 0.8)),
                            ('32x32 at 4096', (2, 20, (64, 4096), 32, 1.0)),
                            ('14x14 at 200x300', (3, 30, (200, 300), 14,
                                                  0.9)),
                            ('56x56 at 200x300', (2, 16, (200, 300), 56,
                                                  0.9)),
                            ('28x28 at 5000 wide', (2, 40, (48, 5000), 28,
                                                    1.0))):
            small, small_onehot = paste_inputs(rng, *shape)
            flips[name] = k4_flips(kc, small, small_onehot)
    bad = {case: f for case, f in flips.items() if any(f.values())}
    if bad:
        raise AssertionError(f'paste_stats differs from plain: {bad}')

    def call():
        return kc.paste_reduce(*args)
    out = dict(call_ms=time_ms(call, 50),
               device_ms=device_ms(call, 50, 'paste_stats'),
               union_device_ms=device_ms(
                   lambda: kc.paste_reduce(*args, onehot), 50, 'paste_stats'),
               plain_ms=time_ms(lambda: kc.paste_reduce_plain(*args), 3,
                                warmup=1))
    y1, y2, x1, x2, keep = args[:5]
    ys, ye, _ = ps.paste_span(y1, y2)
    xs, xe, _ = ps.paste_span(x1, x2)
    pixels = float(((ye - ys).clamp(min=0) * (xe - xs).clamp(min=0)
                    * keep).sum())
    h, w = PASTE_HW
    nbytes = b * k * (ms * ms * 4 + 7 * 4 + h + 2 * 4) + b * h * w
    b_ms, b_by = bound_ms(nbytes, pixels * 4)
    return dict(name='paste_stats', route='cuda',
                source='masklab_tpu_torch/csrc/paste_stats.cu',
                replaces='none (the XLA reductions of masklab_tpu/serving/'
                'postprocess.py:138-200)',
                shape=f'[{b}, {k}] boxes, {ms}x{ms} masks, {h}x{w}',
                max_abs_err=0.0, ms=out['device_ms'], bound_ms=b_ms,
                bound_by=b_by, library_ms=None, kept_pixels=pixels,
                thresholded_pixels=float(kc.paste_reduce(*args)[0].sum()),
                flips=flips, **out)


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


# the train step's discrete decisions, (module, function). The loss NMS's
# proposals are replayed: every run takes the witness's. The targets the
# losses compare with (the anchors' classes, deltas and positive / negative
# / ignore marks from IoU thresholds; the RoIs' mask targets from their best
# gt; the rounded segmentation target) are held: each run computes its own,
# which must equal the witness's except where a value sits within
# TARGET_NEAR of a threshold or a tie (``target_flips``), and then goes on
# with the witness's
REPLAYED_DECISIONS = (('masklab_tpu_torch.models.masklab',
                       'batched_class_aware_nms'),)
HELD_TARGETS = (('masklab_tpu_torch.train.steps', 'batched_assign_boxes'),
                ('masklab_tpu_torch.train.steps', 'assign_masks'),
                ('masklab_tpu_torch.train.steps', 'assign_seg'))
STEP_DECISIONS = REPLAYED_DECISIONS + HELD_TARGETS
# a target's underlying value (an IoU, a mask crop, a resized segmentation)
# this close to its threshold, or to a tie, may be decided either way by
# float32 arithmetic of another order (its own error is ~1e-7)
TARGET_NEAR = 1e-5
# the anchors' encoded box deltas (continuous targets): rtol, atol
TARGET_LOC_TOL = (1e-5, 1e-5)


def _near_anchors(gt_boxes, priors):
    """[B, N]: anchors whose target a float32 rounding may change: an IoU
    with a gt within TARGET_NEAR of 0.4 or 0.5, two gts within TARGET_NEAR
    of a matched anchor's best, or the anchor within TARGET_NEAR of a gt's
    best while another anchor also is."""
    from masklab_tpu_torch.ops.boxes import pairwise_iou
    gt = gt_boxes.float()
    iou = pairwise_iou(gt[..., :4], priors.float()) \
        * (gt[..., 0] != -1.0).float()[..., None]               # [B, G, N]
    near = (((iou - 0.5).abs() <= TARGET_NEAR)
            | ((iou - 0.4).abs() <= TARGET_NEAR)).any(1)
    best = iou.amax(1)
    near |= (((iou >= best[:, None] - TARGET_NEAR).sum(1) > 1)
             & (best >= 0.5 - TARGET_NEAR))
    top = iou >= iou.amax(2, keepdim=True) - TARGET_NEAR
    return near | (top & (top.sum(2, keepdim=True) > 1)).any(1)


def _near_mask_pixels(roi_boxes, gt_boxes, gt_masks, mask_hw, num_classes,
                      match_iou_threshold=0.5):
    """[B, R, mh, mw]: mask-target pixels a float32 rounding may change:
    every pixel of a RoI whose best same-class IoU is within TARGET_NEAR of
    the threshold or of another gt's, and each pixel whose crop is within
    TARGET_NEAR of 0.5. Sharded (phase 14), ``gt_masks`` holds this
    rank's rows and the crops are summed over the ranks, as
    ``assign_masks`` sums them."""
    from masklab_tpu_torch.nn import spatial
    from masklab_tpu_torch.ops.boxes import cxcywh_to_yxyx, pairwise_iou
    from masklab_tpu_torch.ops.roi_align import crop_and_resize_indexed
    image_hw = (spatial.frame_rows(gt_masks.shape[2]), gt_masks.shape[3])
    rows = spatial.crop_rows(None, gt_masks.shape[2])
    out = []
    for rois, gts, masks in zip(roi_boxes.float(), gt_boxes.float(),
                                gt_masks):
        iou = (pairwise_iou(gts[:, :4], rois[:, :4])
               * ((gts[:, None, 5] != -1.0) & (rois[None, :, 5] != -1.0)
                  & (gts[:, None, 4] == rois[None, :, 4])).float())
        best = iou.amax(0)
        near_roi = (((best - match_iou_threshold).abs() <= TARGET_NEAR)
                    | (((iou >= best - TARGET_NEAR).sum(0) > 1)
                       & (best >= match_iou_threshold - TARGET_NEAR)))
        crops = spatial.reduce_crops(crop_and_resize_indexed(
            masks[..., None].float(), cxcywh_to_yxyx(rois[:, :4], image_hw),
            iou.argmax(0), mask_hw, rows))[..., 0]
        out.append(near_roi[:, None, None]
                   | ((crops - 0.5).abs() <= TARGET_NEAR))
    return torch.stack(out)


def target_flips(name: str, args: tuple, own, want) -> tuple:
    """A run's own target ``own`` against the witness's ``want`` (both on
    the CPU), from the target function's arguments ``args``: -> (entries
    that differ within TARGET_NEAR of a threshold or a tie, entries that
    differ elsewhere). Entries are anchors, mask pixels or segmentation
    pixels (sharded, this rank's rows of them)."""
    from masklab_tpu_torch.nn import spatial
    args = tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)
    if name == 'batched_assign_boxes':
        (cls, loc, mark), (wcls, wloc, wmark) = own, want
        rtol, atol = TARGET_LOC_TOL
        loc_off = (loc.double() - wloc).abs() > atol + rtol * wloc.abs()
        differ = ((cls.double() != wcls).any(-1) | loc_off.any(-1)
                  | (mark.double() != wmark).any(-1))
        near = _near_anchors(*args[:2])
    elif name == 'assign_masks':
        differ = own != want
        near = _near_mask_pixels(*args)
    else:
        differ = own.double() != want
        v = spatial.resize_like(args[0].float(), args[1], 'assign_seg',
                                align_corners=True, channels_last=True)
        near = ((v - v.floor()) - 0.5).abs() <= TARGET_NEAR
    return int((differ & near).sum()), int((differ & ~near).sum())


def rank_rows(t: torch.Tensor, n: int, part) -> torch.Tensor:
    """A rank's ``n`` leading rows of the one-process run's ``t``, ``part``
    = (rank, 2) of two ranks (None: all of ``t``). Rank 0 holds the first
    rows, rank 1 the last: so for the batch's images, and for a mask level's
    RoIs, which the mask branch orders image by image."""
    if part is None:
        return t
    if part[1] != 2:
        raise ValueError('rank_rows splits between two ranks')
    return t[:n] if part[0] == 0 else t[t.shape[0] - n:]


@contextlib.contextmanager
def fixed_decisions(decided=None, dtype=torch.float32, hold=True,
                    part=None, fused=False, sp=None, vectors=False):
    """With ``decided`` None (the witness), the step decides, and its
    answers to STEP_DECISIONS ({function name: answer}, on the CPU) and the
    signs of the input of every ReLU of a feature map (``torch.relu`` of a
    4-D tensor; ``'relu'``, in call order), and of mobilenet's ReLU6 (its
    input above 0 and at 6 or above; ``'relu6'``), are recorded in the dict
    yielded. Otherwise, within the block, each REPLAYED_DECISIONS function
    answers what ``decided`` holds for it, cast to ``dtype`` on the
    caller's device, and each ReLU of a feature map gates its input by the
    recorded signs instead of its own (a ReLU6 passes, zeroes or clamps to
    6 as recorded); each HELD_TARGETS function computes
    its own answer, held against the witness's (``target_flips``: with
    ``hold``, an entry that differs away from a threshold raises; the counts
    are yielded under ``'held'``), and answers the witness's. A value within
    float error of a threshold (an IoU at 0.5, a target at 0.5, a near tie
    of two scores, a ReLU input at 0) is decided one way in one run and the
    other way in another, and in the check's small maps one such flip moves
    a gradient far more than float rounding does: every run of the
    reference check must see the same decisions for its distance from the
    witness to measure arithmetic. The ReLU that K1 fuses into a ragged
    GroupNorm stays each run's own (on the card the kernel applies it; its
    plain version's ``torch.relu`` on [N, Q, C] rows is not a feature
    map's), unless ``fused``: then a GroupNorm asked to apply its relu
    applies none, and its input passes through the ReLU of a feature map
    above (recorded or gated like the others). ``part`` = (rank, 2): the
    block runs one of two ranks of a data-parallel step on its rows, and
    takes its rows of ``decided`` (``rank_rows``). ``sp`` = (index, size)
    on the model axis of a dp x sp step: a feature map's gate and the
    segmentation target are then also the rank's block of rows
    (``nn.spatial.blocks``); a map whole on every rank (a mask head's)
    keeps its gate whole. ``vectors``: the ReLUs of [N, C] tensors (the
    squeeze-excite's hidden units) are decided alike."""
    from masklab_tpu_torch.nn.spatial import blocks
    import importlib
    record, saved = {'relu': [], 'relu6': [], 'held': {}}, []

    def cpu(t):
        return tuple(map(cpu, t)) if isinstance(t, tuple) else t.cpu()

    def like(t, ref):
        if isinstance(t, tuple):
            return tuple(like(a, ref) for a in t)
        t = t.to(ref.device)
        return t.to(dtype) if t.is_floating_point() else t

    def rows(t, n):
        if isinstance(t, tuple):
            return tuple(rows(a, n) for a in t)
        return rank_rows(t, n, part)

    def block(t, axis, local):
        if sp is None or t.shape[axis] == local:
            return t
        a, b = blocks(t.shape[axis], sp[1])[sp[0]]
        return t.narrow(axis, a, b - a)

    for module_name, fn_name in STEP_DECISIONS:
        module = importlib.import_module(module_name)
        original = getattr(module, fn_name)
        saved.append((module, fn_name, original))
        held = (module_name, fn_name) in HELD_TARGETS

        def replaced(*args, _fn=original, _name=fn_name, _held=held,
                     **kwargs):
            if decided is None:
                out = _fn(*args, **kwargs)
                if _name in record:
                    raise AssertionError(f'{_name} decided twice in a step')
                record[_name] = cpu(out)
                return out
            want = rows(decided[_name], args[0].shape[0])
            if _name == 'assign_seg':
                want = block(want, 1, args[1].shape[1])
            if _held:
                near, away = target_flips(_name, args,
                                          cpu(_fn(*args, **kwargs)), want)
                record['held'][_name] = dict(near=near, away=away)
                if hold and away:
                    raise AssertionError(
                        f'train reference: {_name} differs from the '
                        f"witness's at {away} entries away from a threshold "
                        f'({near} near one)')
            return like(want, args[0])
        setattr(module, fn_name, replaced)
    relu = torch.relu
    gates = iter(decided['relu']) if decided is not None else None

    def gated(x):
        if x.dim() != 4 and not (vectors and x.dim() == 2):
            return relu(x)
        if gates is None:
            record['relu'].append((x > 0).cpu())
            return relu(x)
        gate = rank_rows(next(gates), x.shape[0], part)
        if x.dim() == 4:
            gate = block(gate, 2, x.shape[2])
        gate = gate.to(x.device)
        if gate.shape != x.shape:
            raise AssertionError(f'relu gate {tuple(gate.shape)} for a map '
                                 f'{tuple(x.shape)}')
        return torch.where(gate, x, torch.zeros_like(x))
    saved.append((torch, 'relu', relu))
    torch.relu = gated
    from masklab_tpu_torch.nn.backbone import mobilenet
    relu6 = mobilenet.relu6
    gates6 = iter(decided['relu6']) if decided is not None else None

    def gated6(x):
        if gates6 is None:
            record['relu6'].append(((x > 0).cpu(), (x >= 6).cpu()))
            return relu6(x)
        pos, top = (block(rank_rows(g, x.shape[0], part), 2,
                          x.shape[2]).to(x.device) for g in next(gates6))
        return torch.where(top, torch.full_like(x, 6.0),
                           torch.where(pos, x, torch.zeros_like(x)))
    saved.append((mobilenet, 'relu6', relu6))
    mobilenet.relu6 = gated6
    if fused:
        from masklab_tpu_torch.nn.layers import GroupNorm
        norm = GroupNorm.forward

        def unfused(self, x, fuse_relu=False):
            return norm(self, gated(x) if fuse_relu else x)
        saved.append((GroupNorm, 'forward', norm))
        GroupNorm.forward = unfused
    try:
        yield record
        if gates is not None and next(gates, None) is not None:
            raise AssertionError('fewer relu calls than the recorded run')
        if gates6 is not None and next(gates6, None) is not None:
            raise AssertionError('fewer relu6 calls than the recorded run')
    finally:
        for module, fn_name, original in saved:
            setattr(module, fn_name, original)


def _train_step_run(mt, cfg, batch, dev: str, float64: bool = False,
                    decided=None, hold: bool = True):
    """One train step of ``cfg``'s model (seed 2) on ``dev`` -> ({name: the
    value as a float64 CPU tensor} over the loss terms (``loss:``), every
    gradient (``grad:``, read as the step's first moment (1 - b1) * g, one
    float product), every parameter's change (``change:``), the new
    batch_stats (``stats:``) and box state (``box:``); {``change:`` name: 2
    float32 ulps of the parameter's largest entry}, which the subtraction
    leaves; the dict ``fixed_decisions`` yields: the step's discrete
    decisions, or the held targets' counts). ``float64``: parameters, convs
    and BatchNorm in float64, GroupNorm's statistics with them (the loss
    terms and the heads' outputs stay float32, as the model computes
    them).
    ``decided``, ``hold``: another run's decisions, taken instead of this
    run's own, and whether its targets are held to them
    (``fixed_decisions``)."""
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
    with fixed_decisions(decided, torch.float64 if float64
                         else torch.float32, hold) as record:
        state, metrics = train.make_train_step(model, with_metrics=False)(
            state, {k: v.to(dev) for k, v in batch.items()})
    if decided is None and len(record) != len(STEP_DECISIONS) + 3:
        raise AssertionError(f'train reference: decisions {sorted(record)} '
                             'in one step')
    out = {f'loss:{k}': v for k, v in metrics.items()}
    out.update({f'grad:{k}': v for k, v in state.opt_state.mu.items()})
    out.update({f'change:{k}': v.detach() - start[k]
                for k, v in model.named_parameters()})
    out.update({f'stats:{k}': v for k, v in state.batch_stats.items()})
    out.update({f'box:{i}': t for i, t in enumerate(state.box_loss_state)})
    slack = {f'change:{k}': float(2 * np.spacing(np.float32(
        v.abs().max().item()))) for k, v in start.items()}
    return ({k: v.detach().cpu().double() for k, v in out.items()}, slack,
            record)


def _witness_readings(got: dict, sound: list, exact: dict, slack: dict):
    """{name: |got - exact| over (TRAIN_REF_RATIO x max over ``sound`` of
    |run - exact| + TRAIN_REF_FLOOR x max|exact| + slack)}, each a largest
    entry: above 1 is outside. ``exact`` is the float64 step; ``sound``
    holds float32 steps on the CPU, whose distances from it say how far
    float32 rounding moves that tensor in sound runs of other summation
    orders."""
    out = {}
    for k, w in exact.items():
        err = (got[k] - w).abs().max().item()
        yard = max((run[k] - w).abs().max().item() for run in sound)
        limit = (TRAIN_REF_RATIO * yard + TRAIN_REF_FLOOR * w.abs().max().item()
                 + slack.get(k, 0.0))
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
    on the CPU in float64 (the witness), whose loss-NMS proposals and ReLU
    gates of the feature maps every other run takes, and against whose
    anchor, mask and segmentation targets every other run's own are held
    (``fixed_decisions``); on the CPU in
    float32 with the default thread count and with one thread (two
    summation orders: the sound runs); on the card in float32 (TF32 off).
    Every tensor of the step (loss terms, gradients, parameter changes,
    batch_stats, box state) is held to its own scale: the card's distance
    from the witness within TRAIN_REF_RATIO times the larger of the sound
    runs' own distances, plus TRAIN_REF_FLOOR of the tensor's largest entry
    (``_witness_readings``). Train-mode BatchNorm in float32 moves the
    backbone's gradients far (up to ~20% of a tensor's scale on the CPU), so
    a fixed tolerance either hides errors or fails sound runs; the rounding
    error of sound runs of each tensor is the yardstick instead. The card
    must pass and a control must fail: the card's step with TF32
    convolutions and matmuls, in the backbone and in the heads (its targets
    are not held: TF32 matmuls move the mask crops)."""
    from masklab_tpu_torch import train
    from masklab_tpu_torch.data import make_random_batch
    cfg = narrow(train_config(mt))
    cfg.compute.compute_dtype = 'float32'
    batch = train.as_batch(make_random_batch(
        2, (128, 128), 4, seed=int(rng.randint(1 << 30))), 'cpu')
    exact, slack, decided = _train_step_run(mt, cfg, batch, 'cpu',
                                            float64=True)

    held = {}

    def run(name, dev, hold=True):
        got, _, record = _train_step_run(mt, cfg, batch, dev,
                                         decided=decided, hold=hold)
        held[name] = record['held']
        return got
    sound = [run('cpu', 'cpu')]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        sound.append(run('cpu_1_thread', 'cpu'))
    finally:
        torch.set_num_threads(threads)
    runs = dict(card=run('card', DEVICE))
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        runs['control_card_tf32'] = run('control_card_tf32', DEVICE,
                                        hold=False)
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    out = {name: _reading_summary(_witness_readings(r, sound, exact, slack))
           for name, r in runs.items()}
    bad = {g: v for g, v in out['card'].items() if not v['max'] <= 1.0}
    if bad:
        raise AssertionError(f'train reference: card outside tolerance {bad}')
    control = out['control_card_tf32']
    for group in ('grad_backbone', 'grad_heads'):
        if not control[group]['max'] > 1.0:
            raise AssertionError(f'train reference: the check passes a TF32 '
                                 f'step in {group}: {control[group]}')
    out['losses'] = {k[5:]: v.item() for k, v in exact.items()
                     if k.startswith('loss:')}
    out['proposals'] = int(
        (decided['batched_class_aware_nms'][..., 4] >= 0).sum())
    out['held_targets'] = held
    return out


def reference_draws(mt, n: int) -> list:
    """``check_train_reference`` at the batch seeds of RandomState(0) ..
    RandomState(n - 1): each draw's verdict and the largest reading of each
    group, the card's and the TF32 control's (the failing check's message
    where one failed)."""
    out = []
    for seed in range(n):
        try:
            readings = check_train_reference(mt, np.random.RandomState(seed))
            verdict = 'pass'
            worst = {run: {g: v['max'] for g, v in readings[run].items()}
                     for run in ('card', 'control_card_tf32')}
            worst['held_targets'] = readings['held_targets']
        except AssertionError as e:
            verdict, worst = 'fail', str(e)
        out.append(dict(seed=seed, verdict=verdict, readings=worst))
        print(f'reference draw {seed}: {verdict} {json.dumps(worst)}',
              flush=True)
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
        def make(model, with_metrics=True, **kwargs):
            step = orig(model, with_metrics, **kwargs)

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
        def make(model, with_metrics=True, **kwargs):
            step = orig(model, with_metrics, **kwargs)

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


def serve_path(kc, model, predictor, batches, mode: str, max_out: int,
               per_forward=None):
    """One path of the deployment: REQUESTS counted requests in ``mode``
    (after one warm-up), every kernel launch and every fallback of the
    candidate pool's certificate counted from 0 just before them; the
    model's outputs of each must be finite, each kernel launched
    ``per_forward`` times a forward at least (a kernel at 0 must not launch
    at all), and the peak memory of the counted requests. Then one more
    request, traced, split by stage."""
    from masklab_tpu_torch.ops import nms
    predictor.predict(batches[0], mode)               # warm-up, not counted
    raw_keys = ('cls_pred', 'loc_pred', 'seg_pred', 'roi_boxes', 'roi_masks')
    finite = []                  # per counted request, one flag per raw key
    hook = model.register_forward_hook(lambda module, args, out: finite.append(
        torch.stack([torch.isfinite(out[k]).all() for k in raw_keys])))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
    for name, per in (PER_FORWARD if per_forward is None
                      else per_forward).items():
        if counts[name] < per * REQUESTS or (per == 0 and counts[name]):
            raise AssertionError(f'{mode}: {name} launched {counts[name]} '
                                 f'times in {REQUESTS} forwards, {per} a '
                                 'forward expected')
    paste_calls = 0 if mode == 'raw' else REQUESTS
    if counts['paste_stats'] != paste_calls:
        raise AssertionError(f'{mode}: paste_stats launched '
                             f'{counts["paste_stats"]} times in {REQUESTS} '
                             f'calls, {paste_calls} expected')
    total = sum(latencies)
    stats = dict(mode=mode, batch=len(batches[0]),
                 img_per_s=len(batches[0]) * REQUESTS / total,
                 p50_batch_ms=statistics.median(latencies) * 1e3,
                 latencies_ms=[t * 1e3 for t in latencies],
                 peak_memory_bytes=torch.cuda.max_memory_allocated(),
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


def serve_deployment(mt, kc, rng, name, cfg, batch, extra=None,
                     per_forward=None):
    """The deployment's three modes (raw, visualize, summarize), each with
    its own launch counts; ``extra(model, predictor)`` runs further phases
    on the same predictor."""
    model, predictor = deployment(mt, cfg)
    max_out = cfg.detection.nms_max_output_size
    batches = [rng.randint(0, 256, (batch, SIZE, SIZE, 3)).astype(np.uint8)
               for _ in range(REQUESTS)]
    paths = {}
    for mode in MODES:
        stats = serve_path(kc, model, predictor, batches, mode, max_out,
                           per_forward)
        paths[f'{name} {mode}'] = stats
        print(f'serve {name} {mode}: b{batch} {stats["img_per_s"]:.2f} '
              f'img/s, p50 batch {stats["p50_batch_ms"]:.2f} ms, latencies '
              f'{[round(t, 2) for t in stats["latencies_ms"]]} ms, peak '
              f'{stats["peak_memory_bytes"] / 2**30:.2f} GiB, launches '
              f'{json.dumps(stats["launches"])}, candidate-pool fallbacks '
              f'{stats["pool_fallbacks"]} in {REQUESTS} requests',
              flush=True)
        print(f'stages {name} {mode}: {json.dumps(stats["stages"])}, '
              f'busy share {stats["device_busy_share"]:.3f}', flush=True)
    more = extra(model, predictor) if extra else {}
    del model, predictor
    torch.cuda.empty_cache()
    return paths, more


# ---- phase 8: the CLI's default deployment, exported, served, reloaded ----

# ModelConfiguration() as it stands: resnet50, widths 128, depth 4, float32,
# the predictor's 540x960 resolution; clients send 1080p frames
DEPLOY_FRAME = (1080, 1920)
DEPLOY_CLIENTS, DEPLOY_ROUNDS = 16, 3
PROCESS_FRAMES, PROCESS_BATCH = 16, 8
# the micro-batcher's largest batch, at which K2's row is held
DEPLOY_MAX_BATCH = 16
# the analytics rows' tolerance of check_postprocess: (columns, rtol), atol
# 1e-3; the other columns (class, box, confidence, flag) exact
TABLE_RTOL = {'pixelSize': 1e-6, 'estimatedSize': 5e-4,
              'estimatedHorizontalLength': 5e-4,
              'estimatedVerticalLength': 5e-4}


def deploy_frames(n: int, seed: int) -> list:
    """``n`` 1080x1920 RGB frames (seeded noise on a smooth ramp) and their
    JPEG bytes, as a camera client would send them."""
    import cv2
    rng = np.random.RandomState(seed)
    h, w = DEPLOY_FRAME
    ramp = np.linspace(0, 160, w, dtype=np.float32)[None, :, None]
    out = []
    for _ in range(n):
        img = np.clip(ramp + rng.randint(0, 96, (h, w, 3)), 0, 255).astype(
            np.uint8)
        ok, jpeg = cv2.imencode('.jpg', img[..., ::-1])
        if not ok:
            raise AssertionError('deployment: jpeg encode failed')
        out.append(jpeg.tobytes())
    return out


def records_close(got: list, want: list) -> int:
    """Analytics records (``summary_to_records``) held to the table
    tolerance; -> the count of records compared."""
    if len(got) != len(want):
        raise AssertionError(f'{len(got)} records, want {len(want)}')
    for a, b in zip(got, want):
        for k, v in b.items():
            if k in TABLE_RTOL:
                if not abs(a[k] - v) <= 1e-3 + TABLE_RTOL[k] * abs(v):
                    raise AssertionError(f'record {k}: {a[k]} vs {v}')
            elif a[k] != v:
                raise AssertionError(f'record {k}: {a[k]} vs {v}')
    return len(want)


def records_gap(got: list, want: list) -> dict:
    """How far two lists of analytics records are apart: the counts, the
    records whose non-numeric fields differ, and each numeric field's
    largest absolute difference over records at the same place."""
    out = dict(n=len(got), n_want=len(want), other_fields=0)
    for a, b in zip(got, want):
        for k, v in b.items():
            if isinstance(v, float):
                out[k] = max(out.get(k, 0.0), abs(a[k] - v))
            elif a[k] != v:
                out['other_fields'] += 1
    return out


def http_predict(port: int, body: bytes, query: str = '') -> dict:
    import urllib.request
    req = urllib.request.Request(f'http://localhost:{port}/predict{query}',
                                 data=body, method='POST')
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def http_json(port: int, path: str, method: str = 'GET') -> dict:
    import urllib.request
    req = urllib.request.Request(f'http://localhost:{port}{path}',
                                 data=b'' if method == 'POST' else None,
                                 method=method)
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def save_deploy_checkpoint(mt, cfg, save_dir: str, seed: int,
                           loss: float) -> str:
    """A checkpoint of the deployment's model with seeded, forced-dense
    weights, built and saved on the CPU (so the card holds only what the
    server holds), through train/checkpoints.py; -> its path."""
    from masklab_tpu_torch import train
    from masklab_tpu_torch.train.checkpoints import CheckpointManager
    model = mt.force_dense(mt.build_masklab(cfg, device='cpu', seed=seed))
    state = train.TrainState(model, train.rectified_adam(1e-3))
    return CheckpointManager(save_dir, None).save_epoch(state, loss, 0)


def reference_predictor(mt, cfg, path: str):
    """A predictor built directly on one checkpoint, on the card."""
    from masklab_tpu_torch.train.checkpoints import (CheckpointManager,
                                                     load_variables)
    model = load_variables(mt.MaskLab(cfg), CheckpointManager(
        os.path.dirname(path), None).restore_variables(path))
    return mt.MaskLabPredictor(model, cfg, visualization=True, device=DEVICE)


def concurrent_round(port: int, bodies: list, query: str = '') -> list:
    """One request per body from its own client thread, released together:
    -> [(latency s, answer or the exception)]."""
    barrier = threading.Barrier(len(bodies))
    out = [None] * len(bodies)

    def client(i):
        barrier.wait()
        start = time.perf_counter()
        try:
            ans = http_predict(port, bodies[i], query)
        except Exception as exc:  # noqa: BLE001 - reported by the caller
            ans = exc
        out[i] = (time.perf_counter() - start, ans)
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(bodies))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    return out


def check_visualize_answer(ans) -> None:
    import base64
    import cv2
    if isinstance(ans, Exception):
        raise AssertionError(f'deployment: a request failed: {ans!r}')
    frame = cv2.imdecode(np.frombuffer(base64.b64decode(
        ans['visualize_jpeg_b64']), np.uint8), 1)
    if frame.shape != DEPLOY_FRAME + (3,) or not ans['objs']:
        raise AssertionError('deployment: a malformed visualize answer')


def flip_under_load(port: int, bodies: list, write_b) -> dict:
    """Clients keep sending (summarize) while checkpoint B is written and
    POST /reload is called: no request may fail. -> the timeline: B's
    rename, the reload's answer, and the first answer of a request sent
    after the reload answered (which B must have served: the model was
    swapped before /reload answered)."""
    stop = threading.Event()
    log, lock = [], threading.Lock()

    def client(i):
        while not stop.is_set():
            start = time.perf_counter()
            try:
                ans = http_predict(port, bodies[i % len(bodies)],
                                   '?outputs=summarize')
            except Exception as exc:  # noqa: BLE001 - reported below
                ans = exc
            with lock:
                log.append((start, time.perf_counter(), ans))
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(DEPLOY_CLIENTS)]
    for th in threads:
        th.start()
    try:
        time.sleep(1.0)
        path = write_b()
        renamed = time.perf_counter()
        reload = http_json(port, '/reload', 'POST')
        reloaded = time.perf_counter()
        deadline = time.time() + 120
        while time.time() < deadline:
            with lock:
                after = sum(1 for s, _, _ in log if s >= reloaded)
            if after >= DEPLOY_CLIENTS:
                break
            time.sleep(0.05)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=300)
    failed = [a for _, _, a in log if isinstance(a, Exception)]
    if failed:
        raise AssertionError(f'deployment: {len(failed)} of {len(log)} '
                             f'requests failed during the flip: {failed[0]!r}')
    first_b = min(e for s, e, _ in log if s >= reloaded)
    return dict(path=path, reload=reload, requests=len(log),
                reload_ms=(reloaded - renamed) * 1e3,
                swap_ms=(first_b - renamed) * 1e3)


def default_deployment(mt, kc) -> dict:
    """The CLI's default deployment end to end on the card, full width:
    checkpoint A (seeded, forced dense) written by train/checkpoints.py,
    ``cli export --dest`` to a bundle, the CLI's ``serve`` (``build_server``,
    the watcher on, micro-batch 16, warmed at 1080x1920) on a free port, 16
    concurrent HTTP clients with 1080p JPEG frames for DEPLOY_ROUNDS
    counted rounds (default mode: visualize), kernel launches counted from
    0 just before them, and one b16 request traced by stage; then
    checkpoint B (another seed, a better loss)
    written into the bundle under load and POST /reload: model_version
    flips to B, no request fails, and sequential summarize answers equal a
    predictor built directly on B (the same batch of 1); then ``cli
    process --batch=8`` over PROCESS_FRAMES frames, each file and record
    equal to that predictor's answer for its frame in the same batches, and
    each record's class, box, confidence and flag equal to its answer for
    the frame alone (the mask-counted columns' gaps and the equal files
    reported); K1 against its plain version at every map of a b16 forward;
    peak memory serving A and during the swap."""
    import tempfile
    import cv2
    from masklab_tpu_torch import cli
    from masklab_tpu_torch.ops import nms
    from masklab_tpu_torch.serving import server as server_module
    from masklab_tpu_torch.serving.predictor import summary_to_records
    cfg = mt.ModelConfiguration()
    labels = cfg.dataset.instance_labels
    bodies = deploy_frames(PROCESS_FRAMES, seed=21)
    out = dict(config='resnet50, widths 128, depth 4, float32, 540x960 '
               'model input, 1080x1920 JPEG frames')
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        save_dir = os.path.join(tmp, 'run')
        t0 = time.perf_counter()
        from masklab_tpu_torch.train.checkpoints import CheckpointManager
        CheckpointManager(save_dir, cfg)           # writes config.json
        a = save_deploy_checkpoint(mt, cfg, save_dir, seed=11, loss=0.9)
        out['checkpoint_s'] = time.perf_counter() - t0
        dest = os.path.join(tmp, 'bundles')
        cli.main(['export', save_dir, f'--dest={dest}'])
        bundle = os.path.join(dest, '1')
        a = os.path.join(bundle, os.path.basename(a))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        server = cli.build_server([
            '--port=0', f'--max-batch={DEPLOY_MAX_BATCH}',
            f'--warmup-sizes={DEPLOY_FRAME[0]}x{DEPLOY_FRAME[1]}',
            f'--device={DEVICE}', '-train.save_dir', bundle])
        out['server_build_s'] = time.perf_counter() - t0
        server.start()
        try:
            port = server.port
            if http_json(port, '/healthz') != {'status': 'ok',
                                               'model_version': None}:
                raise AssertionError('deployment: /healthz before a reload')
            first = http_json(port, '/reload', 'POST')
            if first != {'reloaded': True, 'model_version': a}:
                raise AssertionError(f'deployment: reload of A: {first}')
            predictor = server.watcher.predictor
            model = predictor.model
            finite = []
            hook = model.register_forward_hook(
                lambda m, args, o: finite.append(torch.stack(
                    [torch.isfinite(o[k]).all() for k in
                     ('cls_pred', 'loc_pred', 'seg_pred', 'roi_masks')])))
            for ans in concurrent_round(port, bodies):      # warm-up round
                check_visualize_answer(ans[1])
            finite.clear()
            batches_before = len(server.batcher.batch_sizes)
            torch.cuda.synchronize()
            kc.reset_launch_counts()
            nms.pool_fallbacks = 0
            start = time.perf_counter()
            latencies = []
            for _ in range(DEPLOY_ROUNDS):
                for lat, ans in concurrent_round(port, bodies):
                    check_visualize_answer(ans)
                    latencies.append(lat)
            wall = time.perf_counter() - start
            counts = kc.launch_counts()
            fallbacks = nms.pool_fallbacks
            hook.remove()
            sizes = list(server.batcher.batch_sizes)[batches_before:]
            forwards = len(finite)
            if forwards != len(sizes) or not torch.stack(finite).all():
                raise AssertionError(f'deployment: {forwards} forwards for '
                                     f'{len(sizes)} batches, or non-finite '
                                     'outputs')
            for name, per in PER_FORWARD.items():
                if counts[name] < per * forwards:
                    raise AssertionError(f'deployment: {name} launched '
                                         f'{counts[name]} times in '
                                         f'{forwards} forwards')
            lat_ms = sorted(t * 1e3 for t in latencies)
            out.update(clients=DEPLOY_CLIENTS, rounds=DEPLOY_ROUNDS,
                       img_per_s=len(latencies) / wall,
                       p50_ms=statistics.median(lat_ms),
                       p99_ms=float(np.percentile(lat_ms, 99)),
                       batch_sizes=sizes, forwards=forwards,
                       launches=counts, pool_fallbacks=fallbacks,
                       peak_memory_bytes=torch.cuda.max_memory_allocated())
            print(f'deployment: {out["config"]}; {DEPLOY_CLIENTS} HTTP '
                  f'clients x {DEPLOY_ROUNDS} rounds: '
                  f'{out["img_per_s"]:.2f} img/s, p50 {out["p50_ms"]:.2f} '
                  f'ms, p99 {out["p99_ms"]:.2f} ms, batch sizes {sizes}, '
                  f'launches {json.dumps(counts)}, pool fallbacks '
                  f'{fallbacks}, peak memory '
                  f'{out["peak_memory_bytes"] / 2**30:.2f} GiB', flush=True)
            # one request of a full batch (16 decoded frames, visualize)
            # through the same predictor, traced and split by stage
            stack = np.stack([np.ascontiguousarray(cv2.imdecode(
                np.frombuffer(b, np.uint8), 1)[..., ::-1])
                for b in bodies[:DEPLOY_MAX_BATCH]])
            traced_request = stage_profile(
                lambda: predictor.predict(stack, 'visualize'))
            out.update(stages=traced_request['stages'],
                       traced_ms=traced_request['traced_ms'],
                       device_busy_share=traced_request['device_busy_share'],
                       top_device_ms=traced_request['top_device_ms'])
            print(f'stages deployment: {json.dumps(out["stages"])}, traced '
                  f'{out["traced_ms"]:.2f} ms, busy share '
                  f'{out["device_busy_share"]:.3f}, top device ops '
                  f'{json.dumps(out["top_device_ms"])}', flush=True)
            # K1 against its plain version at every map this path gives it
            with recorded_k1_maps() as maps:
                predictor.predict(stack, 'visualize')
            k1 = k1_at_maps(kc, np.random.RandomState(14), maps)
            out.update(k1_maps=sorted({m[:4] + (m[5],) for m in maps}),
                       k1_calls=len(maps), k1_cases=len(k1),
                       k1_max_abs_err=max(c['err'] for c in k1),
                       k1_max_abs_err_vs_f64=max(c['exact_err'] for c in k1))
            print(f'deployment K1: {len(maps)} ragged GroupNorms in a b16 '
                  f'forward, {len(out["k1_maps"])} maps (n, Q, C, G, relu) '
                  f'{json.dumps(out["k1_maps"])}; each held against the '
                  f'plain version in float32, relu off / on: max abs err '
                  f'{out["k1_max_abs_err"]:.3e} (vs f64 '
                  f'{out["k1_max_abs_err_vs_f64"]:.3e})', flush=True)
            probe = [http_predict(port, b, '?outputs=summarize')['objs']
                     for b in bodies[:4]]
            torch.cuda.reset_peak_memory_stats()
            flip = flip_under_load(port, bodies, lambda: (
                save_deploy_checkpoint(mt, cfg, bundle, seed=12, loss=0.5)))
            out['swap_peak_memory_bytes'] = torch.cuda.max_memory_allocated()
            b = flip['path']
            health = http_json(port, '/healthz')
            if flip['reload']['model_version'] != b \
                    or health['model_version'] != b:
                raise AssertionError(f'deployment: model_version did not '
                                     f'flip to B: {flip["reload"]}, {health}')
            ref_b = reference_predictor(mt, cfg, b)
            compared = 0
            for i, body in enumerate(bodies):
                got = http_predict(port, body, '?outputs=summarize')['objs']
                rgb = cv2.imdecode(np.frombuffer(body, np.uint8), 1)[..., ::-1]
                want = summary_to_records(
                    ref_b.predict(np.ascontiguousarray(rgb),
                                  'summarize')['summarize'][0], labels)
                compared += records_close(got, want)
                if i < len(probe) and got == probe[i]:
                    raise AssertionError('deployment: B answers as A did')
            out.update(flip_requests=flip['requests'],
                       reload_ms=flip['reload_ms'], swap_ms=flip['swap_ms'],
                       b_records_compared=compared)
            print(f'deployment reload: model_version -> '
                  f'{os.path.basename(b)}, {flip["requests"]} requests '
                  f'under load, none failed; reload answered '
                  f'{flip["reload_ms"]:.2f} ms after the rename, B\'s '
                  f'first answer at most {flip["swap_ms"]:.2f} ms after it '
                  '(the first answer to a request sent after the reload '
                  'answered); '
                  f'{compared} records of {len(bodies)} frames equal to a '
                  f'predictor on B; peak memory during the swap '
                  f'{out["swap_peak_memory_bytes"] / 2**30:.2f} GiB',
                  flush=True)
        finally:
            server.stop()
        del server, predictor, model
        torch.cuda.empty_cache()
        src, dst = os.path.join(tmp, 'src'), os.path.join(tmp, 'dst')
        os.makedirs(src)
        for i, body in enumerate(bodies):
            with open(os.path.join(src, f'frame_{i:02d}.jpg'), 'wb') as f:
                f.write(body)
        folder_s = []
        inner = server_module.process_folder

        def timed(*args, **kwargs):
            start = time.perf_counter()
            result = inner(*args, **kwargs)
            folder_s.append(time.perf_counter() - start)
            return result
        server_module.process_folder = timed
        try:
            cli.main(['process', src, dst, f'--batch={PROCESS_BATCH}',
                      f'-train.save_dir={bundle}', f'--device={DEVICE}'])
        finally:
            server_module.process_folder = inner
        with open(os.path.join(dst, 'results.json')) as f:
            results = json.load(f)
        # the predictor's own answer for each image, from the same stacked
        # calls process_folder makes (PROCESS_BATCH frames of one size, in
        # name order): the files must equal it exactly. Against one frame a
        # call (another batch size, so other convolution algorithms), the
        # records' classes, boxes, confidences and flags must be equal too;
        # the forced-dense random masks sit near 0.5, where float noise
        # flips pixels, so the columns counted from the masks (TABLE_RTOL's)
        # and the annotated files are reported, not held
        rgbs = [np.ascontiguousarray(cv2.imdecode(np.frombuffer(
            b, np.uint8), 1)[..., ::-1]) for b in bodies]
        same_batch, single, gaps = {}, 0, []
        for lo in range(0, len(rgbs), PROCESS_BATCH):
            want = ref_b.predict(np.stack(rgbs[lo:lo + PROCESS_BATCH]))
            for j in range(len(rgbs[lo:lo + PROCESS_BATCH])):
                same_batch[lo + j] = (
                    mt.MaskLabPredictor.encode_jpeg(want['visualize'][j]),
                    summary_to_records(want['summarize'][j], labels))
        for i, rgb in enumerate(rgbs):
            name = f'frame_{i:02d}.jpg'
            with open(os.path.join(dst, name), 'rb') as f:
                written = f.read()
            jpeg, records = same_batch[i]
            if written != jpeg or results[name]['objs'] != records:
                raise AssertionError(f'process: {name} differs from the '
                                     "predictor's answer for it")
            alone = ref_b.predict(rgb)
            single += written == mt.MaskLabPredictor.encode_jpeg(
                alone['visualize'][0])
            one = summary_to_records(alone['summarize'][0], labels)
            records_close(results[name]['objs'], [
                {k: v for k, v in r.items() if k not in TABLE_RTOL}
                for r in one])
            gaps.append(records_gap(results[name]['objs'], one))
        mask_gaps = {k: max(g[k] for g in gaps) for k in TABLE_RTOL}
        out.update(process_img_per_s=PROCESS_FRAMES / folder_s[0],
                   process_files_equal=len(rgbs),
                   process_files_equal_to_batch_1=single,
                   process_mask_column_gaps_to_batch_1=mask_gaps)
        print(f'process: {PROCESS_FRAMES} frames at --batch={PROCESS_BATCH}, '
              f'{out["process_img_per_s"]:.2f} img/s; every file and record '
              "equal to the predictor's answer in the same batches; against "
              'one frame a call, every class, box, confidence and flag '
              f'equal, {single} of {PROCESS_FRAMES} files equal, the mask '
              f'columns apart by at most {json.dumps(mask_gaps)}', flush=True)
        del ref_b
        torch.cuda.empty_cache()
    return out


def k2_at_deployment(mt, kc) -> dict:
    """K2 at the default deployment's row: [16, 5, 163275], the transpose
    of [B, N, C] scores (the anchors of ModelConfiguration() at 540x960),
    exact against the plain version; cold device ms (L2 flushed first)
    beside its bound. Its scores come from their own generator."""
    cfg = mt.ModelConfiguration()
    h, w = cfg.postprocess.resolution
    n = len(mt.generate_priors(h, w, mt.priors_from_config(cfg)))
    b, c, cap, m = DEPLOY_MAX_BATCH, 5, 16, 128
    scores = k2_scores(np.random.RandomState(8), b, c, n)
    got = kc.segment_topk_rows(scores, cap)
    want = kc.segment_topk_rows_plain(scores, cap)
    if not all(torch.equal(g, v) for g, v in zip(got, want)):
        raise AssertionError('segment_topk differs from plain at the '
                             "default deployment's row")
    flush = l2_flush()
    s = -(-n // m)
    return dict(shape=f'[{b}, {c}, {n}] f32 (transposed [B, N, C]), cap '
                f'{cap}', anchors=n,
                device_ms=device_ms(lambda: (flush(), kc.segment_topk_rows(
                    scores, cap)), 200, 'segment_topk'),
                bound_ms=bound_ms(b * c * n * 4 + 2 * b * c * cap * s * 4,
                                  b * c * n)[0])


# ---- phase 9: the rest of the backbone zoo ----

NEW_BACKBONES = ('mobilenetv2', 'resnet50', 'resnet50v2', 'resnet101v2',
                 'seresnet50', 'seresnext50', 'vgg16', 'efficientnetb2',
                 'efficientnetb3', 'efficientnetb4')
BACKBONE_OUTPUTS = ('C1', 'C2', 'C3', 'C4', 'C5', 'P6', 'P7')
BACKBONE_RTOL = 1e-4


def check_backbones(mt) -> dict:
    """Each backbone the port gained in this slice through
    ``BackboneNetwork`` at full width (extras 128), 512x512, batch 2,
    float32 (TF32 off) on the card against the same module on the CPU:
    every endpoint within BACKBONE_RTOL of its map's largest magnitude.
    Then the device time of one bf16 forward (weights cast once), by CUDA
    events over 5 calls after 2."""
    from masklab_tpu_torch.nn.backbone import BackboneNetwork
    from masklab_tpu_torch.nn.layers import hold_compute_dtype
    images = torch.from_numpy((np.random.RandomState(9).rand(
        2, SIZE, SIZE, 3) * 255).astype(np.float32))
    out = {}
    for name in NEW_BACKBONES:
        cpu = mt.init_weights(BackboneNetwork(name, BACKBONE_OUTPUTS, 128),
                              seed=3).eval()
        with torch.inference_mode():
            want = cpu(images)
            card = BackboneNetwork(name, BACKBONE_OUTPUTS, 128)
            card.load_state_dict(cpu.state_dict())
            got = card.to(DEVICE).eval()(images.to(DEVICE))
        errs = {k: ((got[k].cpu() - want[k]).abs().max()
                    / want[k].abs().max()).item() for k in BACKBONE_OUTPUTS}
        worst = max(errs, key=errs.get)
        if not errs[worst] <= BACKBONE_RTOL:
            raise AssertionError(f'backbone {name}: {worst} off by '
                                 f'{errs[worst]} of its scale')
        del card, got
        fast = BackboneNetwork(name, BACKBONE_OUTPUTS, 128,
                               dtype=torch.bfloat16)
        fast.load_state_dict(cpu.state_dict())
        fast = hold_compute_dtype(fast.to(DEVICE).eval())
        x = images.to(DEVICE)
        with torch.inference_mode():
            ms = time_ms(lambda: fast(x), 5, warmup=2)
        out[name] = dict(max_rel_err=errs[worst], at=worst,
                         bf16_forward_ms=ms,
                         endpoints={k: list(want[k].shape[1:])
                                    for k in BACKBONE_OUTPUTS})
        print(f'backbone {name}: every endpoint within {errs[worst]:.2e} of '
              f'its scale ({worst}), card vs CPU, f32 512 px b2; bf16 '
              f'forward {ms:.2f} ms', flush=True)
        del fast, cpu
        torch.cuda.empty_cache()
    return out


# ---- phase 10: the separable heads ----

def separable_config(mt):
    """The default deployment with separable heads in detection, instance
    and semantic. The separable segmentation head adds its input (the ASPP
    output beside the skip projection) to its output, as the reference's
    does, so num_aspp_features + num_skip_features = num_features: 96 +
    32 = 128."""
    cfg = mt.ModelConfiguration()
    for group in (cfg.detection, cfg.instance, cfg.semantic):
        group.use_separable_conv = True
    sem = cfg.semantic
    sem.num_aspp_features = sem.num_features - sem.num_skip_features
    return cfg


def check_separable(mt, kc) -> dict:
    """Card vs CPU of the narrow separable model as ``check_reference``
    holds the others (512 px, float32, forced dense; its images from a
    generator of its own, so the later phases keep their inputs); one
    summarize
    request at full width (1080p frame, float32), recording the maps K1
    gets; K1 held against its plain version at [100, 196, 512] (G=16:
    ragged) and at every map the request gave it (``k1_at_maps``), and
    timed at [100, 196, 512] bf16 relu."""
    narrow_cfg = narrow(separable_config(mt))
    narrow_cfg.semantic.num_skip_features = 16
    narrow_cfg.semantic.num_aspp_features = 16
    narrow_cfg.compute.compute_dtype = 'float32'
    out = dict(reference=check_reference(mt, np.random.RandomState(12),
                                         narrow_cfg))
    print(f'separable reference: {json.dumps(out["reference"])}', flush=True)
    cfg = separable_config(mt)
    model = mt.force_dense(mt.build_masklab(cfg, device=DEVICE, seed=5))
    predictor = mt.MaskLabPredictor(model, cfg, device=DEVICE)
    import cv2
    body = deploy_frames(1, seed=31)[0]
    rgb = np.ascontiguousarray(cv2.imdecode(np.frombuffer(
        body, np.uint8), 1)[..., ::-1])
    predictor.predict(rgb, 'summarize')             # warm-up
    torch.cuda.synchronize()
    kc.reset_launch_counts()
    with recorded_k1_maps() as maps:
        start = time.perf_counter()
        res = predictor.predict(rgb, 'summarize')
        ms = (time.perf_counter() - start) * 1e3
    counts = kc.launch_counts()
    check_rows = res['summarize']
    if check_rows.shape != (1, cfg.detection.nms_max_output_size + 1, 11) \
            or not np.isfinite(check_rows).all():
        raise AssertionError('separable: a malformed summarize answer')
    if counts['band_groupnorm'] != len(maps) or not maps:
        raise AssertionError(f'separable: {counts} for {len(maps)} ragged '
                             'GroupNorms')
    cases = (k1_cases(kc, np.random.RandomState(10), [(100, 196, 512)])
             + k1_at_maps(kc, np.random.RandomState(13), maps))
    xb = torch.from_numpy(np.random.RandomState(11).randn(
        100, 196, 512).astype(np.float32)).to(DEVICE).bfloat16()
    scale = torch.ones(512, device=DEVICE)
    bias = torch.zeros(512, device=DEVICE)
    out.update(summarize_ms=ms, launches=counts,
               k1_maps=sorted({m[:4] + (m[5],) for m in maps}),
               k1_cases=cases,
               k1_device_ms_100_196_512=device_ms(
                   lambda: kc.band_groupnorm(xb, scale, bias, 16,
                                             fuse_relu=True),
                   200, 'band_groupnorm'))
    print(f'separable: full width summarize {ms:.2f} ms (1080p frame), '
          f'launches {json.dumps(counts)}; K1 held against its plain '
          f'version at [100, 196, 512] G=16 (f32 / bf16) and at each of the '
          f'request\'s {len(out["k1_maps"])} maps (n, Q, C, G, relu) '
          f'{json.dumps(out["k1_maps"])} in its dtype, relu off / on; '
          '[100, 196, 512] bf16 relu '
          f'{out["k1_device_ms_100_196_512"]:.4f} ms', flush=True)
    del model, predictor
    torch.cuda.empty_cache()
    return out


# ---- phase 11: data parallelism over torch.distributed ----

PARALLEL_WORLD = 2
# the equivalence check: the narrow float32 road preset, a global batch of
# 4 at 128 px, two steps
PARALLEL_EQ_BATCH, PARALLEL_EQ_SIZE, PARALLEL_EQ_STEPS = 4, 128, 2
# the full-width run: the trainer phase's road preset (bf16) at its 0.4
# bucket of a 1080p frame, 4 images a rank
PARALLEL_HW, PARALLEL_RANK_BATCH = (416, 768), 4
PARALLEL_WARMUP, PARALLEL_STEPS = 2, 5
# the serving mesh: two replicas on the one card, a batch that pads; the
# model outputs of its shards against the whole batch's within this share
# of each output's largest value (bf16 convolutions, other cuDNN algorithms
# at another batch size)
MESH_BATCH = 15
MESH_HEADS_RTOL = 5e-2


def spawn_ranks(target, args=(), world=PARALLEL_WORLD, timeout=600.0):
    """``target(rank, world, port, *args)`` in ``world`` spawned processes
    (a module-level function of this script, which the ranks import again)
    -> each rank's result in rank order (``start_ranks`` and its
    ``collect``)."""
    return start_ranks(target, args, world)(timeout)


def free_ports(n: int) -> list:
    """``n`` distinct free TCP ports on localhost (their sockets held open
    together while they are picked)."""
    import socket
    socks = [socket.socket() for _ in range(n)]
    try:
        for sock in socks:
            sock.bind(('localhost', 0))
        return [sock.getsockname()[1] for sock in socks]
    finally:
        for sock in socks:
            sock.close()


def start_ranks(target, args=(), world=PARALLEL_WORLD, port=None):
    """Start ``spawn_ranks``' processes (their rendezvous at ``port``, a
    free one by default) and return ``collect(timeout)``,
    which waits for them: each rank's result in rank order; a rank's error
    raises there with its traceback. Every process is joined or, after an
    error, ended. Arguments and results cross as ``torch.save`` bytes: a
    tensor put on a queue as itself lives in its sender's shared memory,
    gone once the rank exits."""
    import multiprocessing as mp
    ctx = mp.get_context('spawn')
    queue = ctx.Queue()
    port = port or free_ports(1)[0]
    packed = _pack(args)
    # daemons: a rank left behind by a failure elsewhere ends with this
    # process
    procs = [ctx.Process(target=_rank_entry,
                         args=(target, r, world, port, packed, queue),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()

    def collect(timeout=600.0):
        got, errors = {}, []
        try:
            # drain before joining: a rank blocks on a full pipe otherwise
            for _ in procs:
                r, out, error = queue.get(timeout=timeout)
                if error is not None:
                    errors.append(f'rank {r}:\n{error}')
                    break
                got[r] = _unpack(out)
        finally:
            for p in procs:
                p.join(timeout=30 if not errors else 5)
                if p.is_alive():
                    p.terminate()
                    p.join()
        if errors:
            raise AssertionError('a rank failed: ' + errors[0])
        return [got[r] for r in range(world)]
    return collect


def _pack(value) -> bytes:
    import io
    buf = io.BytesIO()
    torch.save(value, buf)
    return buf.getvalue()


def _unpack(data: bytes):
    import io
    return torch.load(io.BytesIO(data), weights_only=False)


def _rank_entry(target, r, world, port, packed, queue):
    import traceback
    try:
        queue.put((r, _pack(target(r, world, port, *_unpack(packed))),
                   None))
    except BaseException:  # noqa: BLE001 - reported to the parent
        queue.put((r, None, traceback.format_exc()))


def _joined(r, world, port, device):
    """Join the group as rank ``r`` on ``device`` with TF32 off, as the
    parent runs; -> the device."""
    from masklab_tpu_torch.parallel import initialize
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return initialize(f'localhost:{port}', world, r, device=device)


def parallel_eq_config(mt):
    """The narrow float32 road preset (seresnet34: BatchNorm, squeeze-excite
    heads)."""
    cfg = narrow(road_config(mt))
    cfg.compute.compute_dtype = 'float32'
    return cfg


def parallel_run(mt, cfg, batch, dev, decided=None, ranks=None) -> dict:
    """PARALLEL_EQ_STEPS train steps of ``cfg``'s model (seed 2) on ``dev``
    from ``batch`` (the global batch; this rank's rows under ``ranks``),
    each step on the decisions ``decided[i]`` (``fixed_decisions``, the
    rank's rows) or, without, recording its own -> {'steps': per step
    {name: value} as ``_train_step_run`` names them, 'decided': each step's
    decisions (the witness's), 'slack', 'params': the last parameters}."""
    from masklab_tpu_torch import parallel, train
    model = mt.build_masklab(cfg, device=dev, seed=2)
    state = train.TrainState(model, train.rectified_adam(
        train.cyclic_lr(1e-4, 1e-3, 700)))
    part = None
    if ranks is not None:
        parallel.replicate_state(state, ranks)
        batch = parallel.shard_batch(batch, ranks)
        part = (ranks.rank, ranks.world)
    batch = {k: v.to(dev) for k, v in batch.items()}
    step = train.make_train_step(model, with_metrics=False, ranks=ranks)
    out = dict(steps=[], decided=[], held=[])
    for i in range(PARALLEL_EQ_STEPS):
        start = {k: v.detach().clone() for k, v in model.named_parameters()}
        with fixed_decisions(None if decided is None else decided[i],
                             part=part, fused=True) as record:
            state, metrics = step(state, batch)
        out['decided'].append(record)
        out['held'].append(record['held'])
        values = {f'loss:{k}': v for k, v in metrics.items()}
        values.update({f'grad:{k}': v for k, v in state.opt_state.mu.items()})
        values.update({f'change:{k}': v.detach() - start[k]
                       for k, v in model.named_parameters()})
        values.update({f'stats:{k}': v for k, v in state.batch_stats.items()})
        values.update({f'box:{j}': t
                       for j, t in enumerate(state.box_loss_state)})
        out['steps'].append({k: v.detach().cpu().double()
                             for k, v in values.items()})
    out['slack'] = {f'change:{k}': float(2 * np.spacing(np.float32(
        v.abs().max().item()))) for k, v in model.named_parameters()}
    out['params'] = {k: v.detach().cpu() for k, v in
                     list(model.named_parameters())
                     + list(model.named_buffers())}
    if decided is not None:
        out.pop('decided')
    return out


def _equivalence_rank(r, world, port, device, batch, decided):
    import masklab_tpu_torch as mt
    import torch.distributed as dist
    from masklab_tpu_torch.parallel import data_ranks
    dev = _joined(r, world, port, device)
    try:
        return parallel_run(mt, parallel_eq_config(mt), batch, dev, decided,
                            data_ranks())
    finally:
        dist.destroy_process_group()


def check_parallel_equivalence(mt, rng) -> dict:
    """Two gloo ranks on the card against one process on the card, the same
    global batch, PARALLEL_EQ_STEPS steps of the narrow float32 road preset;
    every run takes the one-process card run's loss-NMS proposals and ReLU
    gates, those K1 would fuse into the heads' GroupNorms too, its targets
    held to that run's (``fixed_decisions``, each rank its rows): a gate
    within float error of 0 in a mask head's map flips between the runs'
    summation orders and moves a gradient ~9x the yardstick. Each tensor of each step (loss terms, gradients, parameter
    changes, BatchNorm statistics, box state) of the card's pair within
    TRAIN_REF_RATIO x the same pair's distance on the CPU (two gloo ranks
    on the CPU against one CPU process), plus TRAIN_REF_FLOOR of the
    tensor's largest entry (and the parameter changes' 2 ulps): the CPU's
    own float32 distance between the two summation orders is the
    yardstick, as ``check_train_reference``'s. The two ranks' parameters,
    statistics and box state equal bit for bit, on the card and on the
    CPU."""
    from masklab_tpu_torch import train
    from masklab_tpu_torch.data import make_random_batch
    cfg = parallel_eq_config(mt)
    batch = train.as_batch(make_random_batch(
        PARALLEL_EQ_BATCH, (PARALLEL_EQ_SIZE, PARALLEL_EQ_SIZE), 4,
        num_det_classes=len(cfg.dataset.instance_labels),
        num_seg_classes=len(cfg.dataset.semantic_labels),
        seed=int(rng.randint(1 << 30))), 'cpu')
    start = time.perf_counter()
    witness = parallel_run(mt, cfg, batch, DEVICE)
    decided = witness.pop('decided')
    # the two pairs of ranks run while this process runs the CPU's one;
    # each pair has a rendezvous port of its own
    collects = {name: start_ranks(_equivalence_rank, (dev, batch, decided),
                                  port=port)
                for name, dev, port in zip(('card', 'cpu'), (DEVICE, 'cpu'),
                                           free_ports(2))}
    cpu_one = parallel_run(mt, cfg, batch, 'cpu', decided)
    pairs = {name: collect() for name, collect in collects.items()}
    for dev, (a, b) in pairs.items():
        for k, v in a['params'].items():
            if not torch.equal(v, b['params'][k]):
                raise AssertionError(f'parallel ({dev}): the ranks differ '
                                     f'at {k}')
        for sa, sb in zip(a['steps'], b['steps']):
            for k in sa:
                if k.startswith(('stats:', 'box:', 'change:')) and \
                        not torch.equal(sa[k], sb[k]):
                    raise AssertionError(f'parallel ({dev}): the ranks '
                                         f'differ at {k}')
    readings, worst = [], {}
    for i, want in enumerate(witness['steps']):
        card = pairs['card'][0]['steps'][i]
        cpu2, cpu1 = pairs['cpu'][0]['steps'][i], cpu_one['steps'][i]
        step = {}
        for k, w in want.items():
            err = (card[k] - w).abs().max().item()
            yard = (cpu2[k] - cpu1[k]).abs().max().item()
            limit = (TRAIN_REF_RATIO * yard + TRAIN_REF_FLOOR
                     * w.abs().max().item() + witness['slack'].get(k, 0.0))
            step[k] = err / max(limit, 1e-30)
        readings.append(_reading_summary(step))
        bad = {g: v for g, v in readings[-1].items() if not v['max'] <= 1.0}
        if bad:
            raise AssertionError(f'parallel equivalence, step {i + 1}: the '
                                 f'card outside its bound {bad}')
        for g, v in readings[-1].items():
            worst[g] = max(worst.get(g, 0.0), v['max'])
    return dict(config='narrow road seresnet34 float32, global b4@128, '
                       f'{PARALLEL_EQ_STEPS} steps, 2 gloo ranks on one card',
                readings=readings, worst=worst,
                held=[r['held'] for r in pairs['card']],
                losses=[{k[5:]: v.item() for k, v in s.items()
                         if k.startswith('loss:')}
                        for s in witness['steps']],
                seconds=time.perf_counter() - start)


def parallel_road_config(mt):
    """The trainer phase's road preset: full width, bf16."""
    cfg = mt.road_project_config()
    cfg.compute.compute_dtype = 'bfloat16'
    return cfg


def _fullwidth_rank(r, world, port, spread=False):
    """One rank of the full-width run, through the multihost worker's
    library, on card 0 (``spread``: on card ``r``): PARALLEL_WARMUP steps,
    then PARALLEL_STEPS counted ones (host ms between synchronizations,
    kernel launches from 0 before each, the losses), the peak memory, one
    traced step (its ``stage:`` spans and the collectives' host time), the
    parameters' digest."""
    import hashlib
    import masklab_tpu_torch as mt
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from masklab_tpu_torch.ops import cuda as kc
    from masklab_tpu_torch.parallel import multihost
    dev = _joined(r, world, port, f'{DEVICE}:{r if spread else 0}'
                  if DEVICE == 'cuda' else DEVICE)
    try:
        state, step, batch = multihost.setup_step(
            parallel_road_config(mt), PARALLEL_HW, PARALLEL_RANK_BATCH, dev)
        for _ in range(PARALLEL_WARMUP):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, counts, losses = [], [], []
        for _ in range(PARALLEL_STEPS):
            kc.reset_launch_counts()
            start = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - start) * 1e3)
            counts.append(kc.launch_counts())
            losses.append(metrics['loss'].item())
        peak = torch.cuda.max_memory_allocated()
        warm_profiler()
        dist.barrier()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            start = time.perf_counter()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - start) * 1e3
        cuda = torch.autograd.DeviceType.CUDA
        host = [e for e in prof.events() if e.device_type != cuda]
        collective = [(e.time_range.end - e.time_range.start) / 1e3
                      for e in host if e.name == 'collective:all_reduce']
        spans = {e.name[6:]: (e.time_range.end - e.time_range.start) / 1e3
                 for e in host if e.name.startswith('stage:')}
        digest = hashlib.sha256()
        for k, v in state.model.state_dict().items():
            digest.update(k.encode())
            digest.update(v.detach().cpu().contiguous().view(
                torch.uint8).numpy().tobytes())
        return dict(step_ms=times, launches_per_step=counts, losses=losses,
                    peak_memory_bytes=peak, traced_ms=traced_ms,
                    collective_ms=sum(collective),
                    collectives=len(collective), stages_host_ms=spans,
                    backend=dist.get_backend(), digest=digest.hexdigest())
    finally:
        dist.destroy_process_group()


def parallel_fullwidth(mt) -> dict:
    """Two gloo ranks on the card, each through the multihost worker's
    library (``setup_step``): the road preset as the trainer phase runs
    it, global batch 8 = 2 x 4 at PARALLEL_HW (K2 at [4, 5, 99540] a rank).
    Every loss finite; K1, K1's backward, K2 and K3 launched in every
    counted step on each rank; the ranks' parameters and statistics equal
    bit for bit after the last step. Then the worker itself at world size
    1 over NCCL (``python -m masklab_tpu_torch.parallel.multihost``)."""
    start = time.perf_counter()
    ranks = spawn_ranks(_fullwidth_rank)
    for r, res in enumerate(ranks):
        if res['backend'] != 'gloo':
            raise AssertionError(f'rank {r}: backend {res["backend"]}')
        if not all(np.isfinite(res['losses'])):
            raise AssertionError(f'rank {r}: losses {res["losses"]}')
        for i, c in enumerate(res['launches_per_step']):
            for name in TRAINER_KERNELS:
                if c[name] == 0:
                    raise AssertionError(f'rank {r} step {i}: {name} not '
                                         'launched')
    if ranks[0]['digest'] != ranks[1]['digest']:
        raise AssertionError('parallel: the ranks\' parameters differ after '
                             'the last step')
    if ranks[0]['losses'] != ranks[1]['losses']:
        raise AssertionError(f'parallel: the ranks report other losses '
                             f'{ranks[0]["losses"]} {ranks[1]["losses"]}')
    pair_ms = [max(a, b) for a, b in zip(ranks[0]['step_ms'],
                                         ranks[1]['step_ms'])]
    share = [res['collective_ms'] / res['traced_ms'] for res in ranks]
    seconds = time.perf_counter() - start
    port = free_ports(1)[0]
    start = time.perf_counter()
    worker = subprocess.run(
        [sys.executable, '-m', 'masklab_tpu_torch.parallel.multihost',
         f'--coordinator=localhost:{port}', '--num_processes=1',
         '--process_id=0', '--shape=road', f'--device={DEVICE}'],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    backend = 'nccl' if DEVICE == 'cuda' else 'gloo'
    if (worker.returncode != 0 or f'backend {backend}' not in worker.stdout
            or 'MULTIHOST_OK' not in worker.stdout):
        raise AssertionError(f'multihost worker over {backend}: rc '
                             f'{worker.returncode}\n{worker.stdout[-2000:]}'
                             f'\n{worker.stderr[-2000:]}')
    return dict(
        config=f'road seresnet34 bf16, 2 gloo ranks x b{PARALLEL_RANK_BATCH}'
               f' on one card, {PARALLEL_HW[0]}x{PARALLEL_HW[1]}',
        anchors=trainer_row_lengths(mt)[0.4],
        ms_per_step={r: statistics.median(res['step_ms'])
                     for r, res in enumerate(ranks)},
        step_ms=[res['step_ms'] for res in ranks],
        img_per_s=PARALLEL_WORLD * PARALLEL_RANK_BATCH * PARALLEL_STEPS
        / (sum(pair_ms) / 1e3),
        collective_share=share,
        collective_ms=[res['collective_ms'] for res in ranks],
        collectives=ranks[0]['collectives'],
        stages_host_ms=[res['stages_host_ms'] for res in ranks],
        traced_ms=[res['traced_ms'] for res in ranks],
        peak_memory_bytes=[res['peak_memory_bytes'] for res in ranks],
        backend=ranks[0]['backend'], losses=ranks[0]['losses'],
        launches_per_step=[res['launches_per_step'] for res in ranks],
        launches={k: sum(c[k] for res in ranks
                         for c in res['launches_per_step'])
                  for k in ranks[0]['launches_per_step'][0]},
        seconds=seconds,
        nccl_worker=dict(line=[ln for ln in worker.stdout.splitlines()
                               if 'MULTIHOST_OK' in ln][0],
                         seconds=time.perf_counter() - start))


def _shard_rows(out: dict, sl: slice) -> dict:
    return {k: v[sl] for k, v in out.items()}


def mesh_heads_gap(base, images, padded) -> dict:
    """The model's outputs (``raw_heads``: cls_pred, loc_pred, seg_pred) of
    the mesh's two shards against the same rows of the whole batch, on
    ``base``'s model: each as its largest difference over its largest
    |value|."""
    with torch.inference_mode():
        def heads(frames):
            x = torch.from_numpy(np.ascontiguousarray(frames)).to(DEVICE)
            return base.model.raw_heads(base._downsample(x)[0])
        whole = heads(images)
        parts = [heads(images[:8]), heads(padded)]
        out = {}
        for k in ('cls_pred', 'loc_pred', 'seg_pred'):
            shard = torch.cat([parts[0][k], parts[1][k][:7]]).float()
            want = whole[k].float()
            out[k] = ((shard - want).abs().max()
                      / want.abs().max().clamp_min(1e-30)).item()
    return out


def check_serving_mesh(mt, kc, rng) -> dict:
    """The headline predictor (bf16, forced dense, 512 px) over
    ``make_mesh(data=2, devices=['cuda:0', 'cuda:0'])``, a batch of
    MESH_BATCH (padded to 16: shards of 8 and 7 + a zero frame). In each
    mode, with its launches counted from 0 before the request: the answers
    equal the unsharded predictor's on the same shards exactly (the second
    with the zero frame, dropped). Against the whole batch (other cuDNN
    algorithms at another batch size: PERF.md section 6): the shards'
    model outputs within MESH_HEADS_RTOL of the whole batch's
    (``mesh_heads_gap``); what follows them is reported, not held, as the
    share of detection slots, analytics rows and frame pixels that agree
    (forced dense, every score saturates, so NMS's order among near-equal
    scores and masks at 0.5 follow the last bits). Then img/s and p50 of REQUESTS visualize requests of 16
    frames on 2 replicas and on 1; then a ``CheckpointWatcher`` swap: both
    replicas rebuilt, each serving the new checkpoint (the unsharded
    predictor's answers on it, shard by shard)."""
    import tempfile
    from masklab_tpu_torch.parallel import make_mesh
    from masklab_tpu_torch.serving.batching import CheckpointWatcher
    cfg = headline_config(mt)
    model = mt.force_dense(mt.build_masklab(cfg, device='cpu', seed=0))
    mesh = make_mesh(data=2, devices=[f'{DEVICE}:0'] * 2
                     if DEVICE == 'cuda' else ['cpu'] * 2)
    sharded = mt.MaskLabPredictor(model, cfg, mesh=mesh)
    base = mt.MaskLabPredictor(model, cfg, device=DEVICE)
    images = rng.randint(0, 256, (MESH_BATCH, SIZE, SIZE, 3)).astype(np.uint8)
    padded = np.concatenate([images[8:], np.zeros_like(images[:1])])
    max_out = cfg.detection.nms_max_output_size
    heads = mesh_heads_gap(base, images, padded)
    bad = {k: v for k, v in heads.items() if not v <= MESH_HEADS_RTOL}
    if bad:
        raise AssertionError(f'serving mesh: the shards\' model outputs '
                             f'against the whole batch\'s {bad}')
    modes, launches = {}, {}
    for mode in MODES:
        sharded.predict(images[:2], mode)                 # warm-up
        torch.cuda.synchronize()
        kc.reset_launch_counts()
        out = sharded.predict(images, mode)
        counts = kc.launch_counts()
        for name, per_forward in PER_FORWARD.items():
            if counts[name] < per_forward * 2:
                raise AssertionError(f'serving mesh {mode}: {name} launched '
                                     f'{counts[name]} times in 2 forwards')
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        check_outputs(out, mode, MESH_BATCH, max_out)
        shards = [base.predict(images[:8], mode),
                  _shard_rows(base.predict(padded, mode), slice(0, 7))]
        for k in out:
            want = np.concatenate([s[k] for s in shards])
            if not np.array_equal(out[k], want):
                raise AssertionError(f'serving mesh {mode}: {k} differs from '
                                     'the unsharded predictor on its shards')
        whole = base.predict(images, mode)
        g, w = out['det_boxes'], whole['det_boxes']
        same = ((np.abs(g.astype(np.int64) - w).max(-1) <= 1)
                & (g[..., 4] == w[..., 4]))
        gap = dict(slots_equal=float(same.mean()))
        if 'summarize' in out:
            rows = np.abs(out['summarize'] - whole['summarize']) <= 1e-3 + \
                1e-3 * np.abs(whole['summarize'])
            gap['analytics_rows_equal'] = float(rows.all(-1).mean())
        if 'visualize' in out:
            gap['frame_pixels_changed'] = float(
                (out['visualize'] != whole['visualize']).any(-1).mean())
        modes[mode] = dict(exact_against_shards=True, whole_batch_gap=gap,
                           launches=counts)
    timing = {}
    frames = [rng.randint(0, 256, (16, SIZE, SIZE, 3)).astype(np.uint8)
              for _ in range(REQUESTS)]
    for name, pred in (('2 replicas', sharded), ('1 replica', base)):
        pred.predict(frames[0], 'visualize')
        lat = []
        for f in frames:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred.predict(f, 'visualize')
            lat.append((time.perf_counter() - t0) * 1e3)
        timing[name] = dict(img_per_s=16 * REQUESTS / (sum(lat) / 1e3),
                            p50_ms=statistics.median(lat), latencies_ms=lat)
    root = tempfile.mkdtemp(prefix='chip_smoke_mesh-')
    try:
        save_deploy_checkpoint(mt, cfg, root, seed=3, loss=0.5)
        before = sharded.model
        start = time.perf_counter()
        if not CheckpointWatcher(sharded, root).check_once():
            raise AssertionError('serving mesh: the watcher swapped nothing')
        swap_ms = (time.perf_counter() - start) * 1e3
        if (len(sharded.model) != 2 or sharded.model[0] is sharded.model[1]
                or any(a is b for a, b in zip(sharded.model, before))):
            raise AssertionError('serving mesh: the swap did not rebuild '
                                 'both replicas')
        del before
        fresh = mt.MaskLabPredictor(mt.force_dense(mt.build_masklab(
            cfg, device='cpu', seed=3)), cfg, device=DEVICE)
        out = sharded.predict(images, 'summarize')
        want = [fresh.predict(images[:8], 'summarize'),
                _shard_rows(fresh.predict(padded, 'summarize'), slice(0, 7))]
        for k in out:
            if not np.array_equal(out[k], np.concatenate([w[k]
                                                          for w in want])):
                raise AssertionError(f'serving mesh: after the swap {k} is '
                                     'not the new checkpoint\'s')
    finally:
        import shutil
        shutil.rmtree(root, ignore_errors=True)
    del sharded, base
    torch.cuda.empty_cache()
    return dict(config='headline mobilenet bf16 forced dense 512 px, mesh '
                       f'2 x cuda:0, batch {MESH_BATCH} padded to 16',
                heads_gap=heads, modes=modes, timing=timing,
                swap_ms=swap_ms,
                launches=launches)


def run_parallel(mt, kc) -> dict:
    """Phase 11, its lines printed: the equivalence check, the full-width
    run, the serving mesh; its inputs from a generator of its own."""
    rng = np.random.RandomState(11)
    out = dict(equivalence=check_parallel_equivalence(mt, rng))
    eq = out['equivalence']
    print(f'parallel equivalence: {eq["config"]}: the card\'s 2 ranks vs 1 '
          f'process within {TRAIN_REF_RATIO:g}x the CPU\'s own distance '
          f'(worst reading by group {json.dumps(eq["worst"])}); the ranks '
          f'bitwise equal on the card and on the CPU; held targets '
          f'{json.dumps(eq["held"])}; {eq["seconds"]:.1f} s', flush=True)
    out['fullwidth'] = fw = parallel_fullwidth(mt)
    print(f'parallel: {fw["config"]}, backend {fw["backend"]}: ms a step by '
          f'rank {json.dumps(fw["ms_per_step"])} (steps '
          f'{json.dumps([[round(t, 2) for t in s] for s in fw["step_ms"]])}),'
          f' {fw["img_per_s"]:.2f} img/s the pair, collectives '
          f'{[round(s, 3) for s in fw["collective_share"]]} of a traced step '
          f'({fw["collectives"]} all-reduces, host ms '
          f'{[round(m, 2) for m in fw["collective_ms"]]} of '
          f'{[round(m, 2) for m in fw["traced_ms"]]}; spans '
          f'{json.dumps(fw["stages_host_ms"][0])}), peak memory '
          f'{[round(b / 2**30, 2) for b in fw["peak_memory_bytes"]]} GiB a '
          f'rank, losses {json.dumps(fw["losses"])}, launches per step '
          f'{json.dumps(fw["launches_per_step"][0][-1])} on each rank, K2 '
          f'at [{PARALLEL_RANK_BATCH}, 5, {fw["anchors"]}], ranks bitwise '
          f'equal; {fw["seconds"]:.1f} s; NCCL worker: '
          f'{fw["nccl_worker"]["line"]} ({fw["nccl_worker"]["seconds"]:.1f} '
          's)', flush=True)
    out['serving_mesh'] = sm = check_serving_mesh(mt, kc, rng)
    print(f'serving mesh: {sm["config"]}: every mode exact against the '
          f'unsharded shards; model outputs against the whole batch\'s '
          f'{json.dumps(sm["heads_gap"])} (bound {MESH_HEADS_RTOL:g}); '
          f'after NMS against the whole batch '
          f'{json.dumps({m: v["whole_batch_gap"] for m, v in sm["modes"].items()})}'
          f'; {json.dumps({k: [round(v["img_per_s"], 2), round(v["p50_ms"], 2)] for k, v in sm["timing"].items()})}'
          f' (img/s, p50 ms, visualize b16); swap {sm["swap_ms"]:.2f} ms, '
          f'both replicas rebuilt', flush=True)
    return out


# ---- --multi-card: data parallelism over several cards (NCCL) ----

# the CLI trainer over every card: synthetic frames at half of 1080p, two
# images a rank, one epoch of 2 steps a phase
MULTI_FRAMES, MULTI_HW = 24, (540, 960)


def multi_card_step(mt, n: int) -> dict:
    """The full-width parallel step (``_fullwidth_rank``) over ``n`` ranks,
    one card each (NCCL), against one rank alone: ms a step, img/s, the
    collectives' share of a traced step, the ranks bitwise equal, the
    kernels launched in every step on each rank."""
    runs = {}
    for world in (1, n):
        ranks = spawn_ranks(_fullwidth_rank, (True,), world=world)
        for r, res in enumerate(ranks):
            if res['backend'] != ('nccl' if DEVICE == 'cuda' else 'gloo'):
                raise AssertionError(f'{world} ranks: backend '
                                     f'{res["backend"]}')
            if not all(np.isfinite(res['losses'])):
                raise AssertionError(f'rank {r}: losses {res["losses"]}')
            for i, c in enumerate(res['launches_per_step']):
                for name in TRAINER_KERNELS:
                    if c[name] == 0:
                        raise AssertionError(f'{world} ranks, rank {r} step '
                                             f'{i}: {name} not launched')
        if len({res['digest'] for res in ranks}) != 1:
            raise AssertionError(f'{world} ranks: the parameters differ')
        step_ms = [max(t) for t in zip(*(res['step_ms'] for res in ranks))]
        runs[world] = dict(
            ms_per_step=statistics.median(step_ms), step_ms=step_ms,
            img_per_s=world * PARALLEL_RANK_BATCH * len(step_ms)
            / (sum(step_ms) / 1e3),
            collective_share=[res['collective_ms'] / res['traced_ms']
                              for res in ranks],
            peak_memory_bytes=max(res['peak_memory_bytes'] for res in ranks),
            launches={k: sum(c[k] for res in ranks
                             for c in res['launches_per_step'])
                      for k in ranks[0]['launches_per_step'][0]})
    runs['scaling'] = runs[n]['img_per_s'] / (n * runs[1]['img_per_s'])
    return runs


def multi_card_trainer(mt, n: int) -> dict:
    """``cli train --preset=road -compute.mesh_data n`` (bf16, batch 2n)
    over synthetic MULTI_HW frames: ``train_masklab_model`` runs one rank a
    card (this process rank 0); rank 0's run directory holds metrics.csv
    (one finite row a phase), a checkpoint a phase and its eval.json."""
    import csv
    import shutil
    import tempfile
    from masklab_tpu_torch import cli
    from masklab_tpu_torch.data import make_synthetic_dataset
    from masklab_tpu_torch.train import trainer as tr
    root = tempfile.mkdtemp(prefix='chip_smoke_multi-')
    spawned = []
    original = tr._train_on_devices

    def recording(config, devices, kwargs):
        spawned.append(list(devices))
        return original(config, devices, kwargs)
    try:
        data_dir, logs = os.path.join(root, 'data'), os.path.join(root, 'logs')
        make_synthetic_dataset(data_dir, num_images=MULTI_FRAMES,
                               image_hw=MULTI_HW, seed=0)
        cli.main(['etl', f'-dataset.data_dir={data_dir}'])
        args = [a if a != '8' else str(2 * n) for a in TRAINER_ARGS]
        tr._train_on_devices = recording
        start = time.perf_counter()
        try:
            cli.main(['train', *args, '-compute.mesh_data', str(n),
                      '-dataset.data_dir', data_dir, '-train.save_dir', logs])
        finally:
            tr._train_on_devices = original
        seconds = time.perf_counter() - start
        if spawned != [[f'cuda:{r}' for r in range(n)]]:
            raise AssertionError(f'multi-card trainer: ranks {spawned}')
        run_dir = os.path.join(logs, os.listdir(logs)[0])
        with open(os.path.join(run_dir, 'metrics.csv')) as f:
            rows = list(csv.DictReader(f))
        names = [m for m in os.listdir(run_dir) if m[0].isdigit()]
        if (len(rows) != len(TRAINER_PHASES) or len(names) != len(rows)
                or not all(np.isfinite(float(v)) for row in rows
                           for v in row.values())
                or not os.path.exists(os.path.join(run_dir, 'eval.json'))):
            raise AssertionError(f'multi-card trainer: {rows} {names}')
        return dict(ranks=spawned[0], seconds=seconds,
                    losses=[float(row['loss']) for row in rows],
                    val_losses=[float(row['val_loss']) for row in rows])
    finally:
        shutil.rmtree(root, ignore_errors=True)


def multi_card_mesh(mt, rng, n: int) -> dict:
    """The headline predictor (bf16, forced dense, 512 px) over a mesh of
    every card (one replica each) against one replica: the answers exact
    against the unsharded predictor on the same shards, img/s and p50 of
    REQUESTS visualize requests of 16 frames each way."""
    from masklab_tpu_torch.parallel import make_mesh
    cfg = headline_config(mt)
    model = mt.force_dense(mt.build_masklab(cfg, device='cpu', seed=0))
    sharded = mt.MaskLabPredictor(model, cfg, mesh=make_mesh())
    base = mt.MaskLabPredictor(model, cfg, device=DEVICE)
    frames = [rng.randint(0, 256, (16, SIZE, SIZE, 3)).astype(np.uint8)
              for _ in range(REQUESTS)]
    rows = -(-16 // n)
    for mode in MODES:
        out = sharded.predict(frames[0], mode)
        for i in range(n):
            want = base.predict(frames[0][i * rows:(i + 1) * rows], mode)
            for k, v in want.items():
                if not np.array_equal(out[k][i * rows:(i + 1) * rows], v):
                    raise AssertionError(f'multi-card mesh {mode}: {k} of '
                                         f'shard {i} differs')
    timing = {}
    for name, pred in ((f'{n} replicas', sharded), ('1 replica', base)):
        pred.predict(frames[0], 'visualize')
        lat = []
        for f in frames:
            t0 = time.perf_counter()
            pred.predict(f, 'visualize')
            lat.append((time.perf_counter() - t0) * 1e3)
        timing[name] = dict(img_per_s=16 * REQUESTS / (sum(lat) / 1e3),
                            p50_ms=statistics.median(lat))
    return timing


def run_multi_card(mt) -> dict:
    """--multi-card: the parallel step, the CLI trainer and the serving
    mesh over every card present (two at least), their lines printed."""
    n = torch.cuda.device_count()
    if n < 2:
        raise AssertionError(f'--multi-card needs two cards at least, has {n}')
    out = dict(cards=n, step=multi_card_step(mt, n))
    st = out['step']
    print(f'multi-card step: {n} NCCL ranks, one a card (road seresnet34 '
          f'bf16, b{PARALLEL_RANK_BATCH} a rank at {PARALLEL_HW[0]}x'
          f'{PARALLEL_HW[1]}): {st[n]["ms_per_step"]:.2f} ms a step, '
          f'{st[n]["img_per_s"]:.2f} img/s, collectives '
          f'{[round(x, 3) for x in st[n]["collective_share"]]} of a traced '
          f'step; 1 rank {st[1]["ms_per_step"]:.2f} ms, '
          f'{st[1]["img_per_s"]:.2f} img/s; scaling {st["scaling"]:.3f}; '
          f'peak {st[n]["peak_memory_bytes"] / 2**30:.2f} GiB a rank; the '
          'ranks bitwise equal, every kernel in every step', flush=True)
    out['trainer'] = tt = multi_card_trainer(mt, n)
    print(f'multi-card trainer: cli train -compute.mesh_data {n} on '
          f'{tt["ranks"]}: losses {json.dumps(tt["losses"])}, val '
          f'{json.dumps(tt["val_losses"])}, {tt["seconds"]:.1f} s', flush=True)
    out['mesh'] = multi_card_mesh(mt, np.random.RandomState(12), n)
    print(f'multi-card mesh: exact against the unsharded shards; '
          f'{json.dumps(out["mesh"])} (visualize b16)', flush=True)
    out['spatial'] = run_spatial_multi_card(mt, None, n)
    return out


# ---- phase 12: the fused mask head ----

# kernel launches a forward of the fused headline at 512 px, forced dense:
# the fused head's textbook per-box GroupNorm launches no K1; K2 once for
# the candidate pool, K3 in both NMS stages
FUSED_PER_FORWARD = {'band_groupnorm': 0, 'segment_topk': 1, 'nms_keep': 2,
                     'batch_norm_act': 27}
FUSED_WARMUP, FUSED_STEPS = 2, 5


def fused(cfg):
    """``cfg`` with the fused mask head (the headline's and the bench train
    config's instance heads are plain, so MaskLab builds FusedMaskSubNet)."""
    cfg.compute.fused_mask_head = True
    return cfg


def short_train(mt, kc, cfg) -> dict:
    """bench.py's train step (``train_path``'s batch, optimizer and seed) on
    ``cfg``: FUSED_WARMUP steps, then FUSED_STEPS counted ones, each timed on
    the host clock between CUDA synchronizations with its launches counted
    from 0 just before it; every loss finite and K3 launched in every
    step."""
    from masklab_tpu_torch import train
    from masklab_tpu_torch.data import make_random_batch
    model = mt.build_masklab(cfg, device=DEVICE, seed=0)
    state = train.TrainState(model, train.rectified_adam(
        train.cyclic_lr(1e-4, 1e-3, 700)))
    step = train.make_train_step(model, with_metrics=False)
    batch = train.as_batch(make_random_batch(
        TRAIN_BATCH, (TRAIN_SIZE, TRAIN_SIZE), 8), DEVICE)
    for _ in range(FUSED_WARMUP):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses, counts = [], [], []
    for i in range(FUSED_STEPS):
        kc.reset_launch_counts()
        start = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
        counts.append(kc.launch_counts())
        losses.append({k: v.item() for k, v in metrics.items()})
        if not all(np.isfinite(v) for v in losses[-1].values()):
            raise AssertionError(f'{cfg.backbone.backbone_type} step {i}: '
                                 f'losses {losses[-1]}')
        if counts[-1]['nms_keep'] == 0:
            raise AssertionError(f'step {i}: nms_keep not launched')
    out = dict(steps=FUSED_STEPS, ms_per_step=statistics.median(times),
               step_ms=times, peak_memory_bytes=torch.cuda.max_memory_allocated(),
               first_losses=losses[0], last_losses=losses[-1],
               launches={k: sum(c[k] for c in counts) for k in counts[0]},
               launches_per_step=counts[-1])
    del model, state
    torch.cuda.empty_cache()
    return out


def mask_branch_line(name: str, paths: dict) -> str:
    return ', '.join(
        f'{mode} host {paths[f"{name} {mode}"]["stages"]["mask_branch"]["host_ms"]:.2f}'
        f' / busy {paths[f"{name} {mode}"]["stages"]["mask_branch"].get("busy_ms", 0.0):.2f} ms'
        for mode in MODES)


def run_fused(mt, kc, headline=None, per_level_train=None) -> dict:
    """Phase 12: the fused mask head (``compute.fused_mask_head``). The
    narrow float32 headline model with it, card against CPU
    (``check_reference``); the full-width headline predictor with it (b16,
    512 px, bf16, forced dense) in the three modes, K1 launched never, K2
    once and K3 twice a forward, beside the per-level headline's serve paths
    (``headline``: phase 5's, else served here); FUSED_STEPS counted steps
    of the bench train config with it, beside the per-level config's
    (``per_level_train``: phase 6's, else FUSED_STEPS steps here). Its own
    random inputs (RandomState(12)), so later phases draw as before."""
    rng = np.random.RandomState(12)
    cfg = narrow(fused(headline_config(mt)))
    cfg.compute.compute_dtype = 'float32'
    out = dict(reference=check_reference(mt, rng, cfg))
    print(f'reference fused: {json.dumps(out["reference"])}', flush=True)
    if headline is None:
        headline, _ = serve_deployment(mt, kc, rng, 'headline',
                                       headline_config(mt), BATCH)
    out['serve'], _ = serve_deployment(mt, kc, rng, 'fused',
                                       fused(headline_config(mt)), BATCH,
                                       per_forward=FUSED_PER_FORWARD)
    print(f'fused vs per-level headline, mask branch: fused '
          f'{mask_branch_line("fused", out["serve"])}; per-level '
          f'{mask_branch_line("headline", headline)}; img/s fused '
          f'{[round(out["serve"][f"fused {m}"]["img_per_s"], 2) for m in MODES]}'
          f' per-level '
          f'{[round(headline[f"headline {m}"]["img_per_s"], 2) for m in MODES]}',
          flush=True)
    out['per_level_serve'] = {
        m: dict(img_per_s=headline[f'headline {m}']['img_per_s'],
                p50_batch_ms=headline[f'headline {m}']['p50_batch_ms'],
                mask_branch=headline[f'headline {m}']['stages']['mask_branch'])
        for m in MODES}
    out['train'] = short_train(mt, kc, fused(train_config(mt)))
    if per_level_train is None:
        per_level_train = short_train(mt, kc, train_config(mt))
    out['per_level_train_ms'] = per_level_train['ms_per_step']
    t = out['train']
    print(f'fused train: resnext50 bf16 b{TRAIN_BATCH}@{TRAIN_SIZE}, '
          f'{t["ms_per_step"]:.2f} '
          f'ms/step (median of {t["steps"]}; steps '
          f'{[round(x, 2) for x in t["step_ms"]]}), per-level '
          f'{per_level_train["ms_per_step"]:.2f} ms/step; peak '
          f'{t["peak_memory_bytes"] / 2**30:.2f} GiB, losses '
          f'{json.dumps(t["first_losses"])} -> {json.dumps(t["last_losses"])}'
          f', launches per step {json.dumps(t["launches_per_step"])}',
          flush=True)
    return out


# ---- phase 13: the learning gates, examples/torch/06 and 07 ----

ACCEPTANCE_GATES = ('06_overfit_acceptance.py', '07_generalization_gate.py')


def load_example(name: str):
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'examples', 'torch', name)
    spec = importlib.util.spec_from_file_location(name[:2], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_acceptance(kc) -> dict:
    """Phase 13: each gate's ``main`` on the card from a fresh synthetic set
    in a directory of its own (06: 8 images; 07: 30, its seed-777 split),
    at the gate's settings, its launches counted from 0 just before it. A
    gate below its floor raises (its AssertionError is not caught); K1, K1's
    backward and K3 must launch. Every map the gates give K1 and K1's
    backward is recorded, and each kernel is then held against its plain
    version at every distinct one, in its dtype, relu off and on."""
    import tempfile
    out, fwd_maps, bwd_maps = {}, [], []
    for name in ACCEPTANCE_GATES:
        ex = load_example(name)
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.synchronize()
            kc.reset_launch_counts()
            with recorded_k1_maps() as fwd, \
                    recorded_k1_backward_maps() as bwd:
                metrics = ex.main(os.path.join(tmp, 'data'),
                                  os.path.join(tmp, 'logs'), DEVICE)
                torch.cuda.synchronize()
            counts = kc.launch_counts()
        for kernel in ('band_groupnorm', 'band_groupnorm_backward',
                       'nms_keep'):
            if counts[kernel] == 0:
                raise AssertionError(f'acceptance {name}: {kernel} not '
                                     'launched')
        fwd_maps += fwd
        bwd_maps += bwd
        gate = name[:2]
        out[gate] = dict(metrics, launches=counts,
                         floors=[ex.MASK_MIOU_FLOOR, ex.SEMANTIC_MIOU_FLOOR],
                         k1_calls=len(fwd), k1_backward_calls=len(bwd))
        print(f'acceptance {gate}: mask mIoU {metrics["mask_miou"]:.4f} '
              f'(floor {ex.MASK_MIOU_FLOOR}), semantic mIoU '
              f'{metrics["semantic_miou"]:.4f} (floor '
              f'{ex.SEMANTIC_MIOU_FLOOR}), {metrics["images"]} images '
              f'evaluated, {metrics["steps"]} steps, wall '
              f'{metrics["wall_s"]:.1f} s (train {metrics["train_s"]:.1f}, '
              f'eval {metrics["eval_s"]:.1f}), {metrics["img_per_s"]:.2f} '
              f'img/s trained, launches {json.dumps(counts)}', flush=True)
    start = time.perf_counter()
    k1 = k1_at_maps(kc, np.random.RandomState(15), fwd_maps)
    k1b = k1_backward_at_maps(kc, np.random.RandomState(16), bwd_maps)
    kinds = sorted({(c['groups'], c['shape'][1], c['shape'][2],
                     str(c['dtype'])) for c in k1 + k1b}, key=str)
    out['k1_maps'] = dict(
        k1_calls=len(fwd_maps), k1_backward_calls=len(bwd_maps),
        k1_cases=len(k1), k1_backward_cases=len(k1b),
        groups_q_c_dtype=[list(k) for k in kinds],
        k1_f32_max_abs_err=max(
            [c['err'] for c in k1 if c['dtype'] == 'float32'], default=None),
        k1_bf16_max_ulp=max(
            [c['err'] for c in k1 if c['dtype'] == 'bfloat16'], default=None),
        k1_backward_f32_dx_max_abs_err=max(
            [c['dx_err'] for c in k1b if c['dtype'] == 'float32'],
            default=None),
        k1_backward_bf16_dx_max_ulp=max(
            [c['dx_err'] for c in k1b if c['dtype'] == 'bfloat16'],
            default=None),
        k1_backward_param_max_rel_err=max(c['param_err'] for c in k1b),
        check_s=time.perf_counter() - start)
    print(f'acceptance K1 maps: {json.dumps(out["k1_maps"])}', flush=True)
    return out


# ---- phase 14: the dp x sp spatial sharding ----

# the narrow checks: JAX's spatial test model (mobilenet, widths 16, C3-C5)
# at 128 px, and the narrow float32 road preset at 56 x 96 (C3 7 rows, an
# odd count; P6 one row, fewer than the model axis has ranks); a global
# batch of 2, on a 1 x 2 and a 2 x 2 mesh of gloo ranks on the card
SPATIAL_MESHES = ((1, 2), (2, 2))
SPATIAL_EQ_HW = {'jax_test': (128, 128), 'road': (56, 96)}
SPATIAL_EQ_BATCH = 2
# the full-width run: the road preset (seresnet34, squeeze-excite heads,
# bf16, full widths) at a dashcam's 1080 x 1920, a global batch of 2 on a
# 1 x 2 mesh of gloo ranks sharing the card (--multi-card: 2 x 2 over four
# NCCL ranks, one a card, a global batch of 4)
SPATIAL_HW, SPATIAL_BATCH, SPATIAL_STEPS = (1080, 1920), 2, 3
SPATIAL_SPANS = ('collective:row_exchange', 'collective:row_gather',
                 'collective:all_reduce', 'collective:rows')


def spatial_eq_config(mt, name: str):
    """The narrow checks' float32 models."""
    cfg = mt.ModelConfiguration()
    if name == 'road':
        cfg = narrow(road_config(mt))
    else:
        cfg.backbone.backbone_type = 'mobilenet'
        cfg.backbone.backbone_outputs = ('C3', 'C4', 'C5')
        cfg.detection.feature_pyramid_inputs = ('C3', 'C4', 'C5')
        cfg.backbone.num_features = 16
        for g in (cfg.detection, cfg.instance, cfg.semantic):
            g.num_features = 16
            g.num_depth = 1
        cfg.semantic.num_aspp_features = 16
        cfg.detection.nms_max_output_size = 8
        cfg.loss.nms_max_output_size = 8
        cfg.compute.nms_candidates_per_class = 16
    cfg.compute.compute_dtype = 'float32'
    return cfg


def spatial_run(mt, cfg, batch, dev, decided=None, mesh=None,
                float64: bool = False) -> dict:
    """``cfg``'s model (seed 2) on ``dev``: ``raw_heads`` in eval mode,
    then one train step on ``batch`` (the global batch; under ``mesh``
    this rank's piece of the dp x sp layout), on the decisions ``decided``
    (``fixed_decisions``, the rank's rows and blocks) or, without, its own
    recorded -> {'heads': cls_pred, loc_pred (this data row's), seg_pred
    (this rank's rows), 'step': {name: value} as ``_train_step_run`` names
    them, 'decided' (without ``decided``), 'held', 'slack', 'digest'}.
    ``float64``: parameters, convs and BatchNorm in float64, as
    ``_train_step_run``'s."""
    import hashlib
    from masklab_tpu_torch import parallel, train
    model = mt.build_masklab(cfg, device=dev, seed=2)
    if float64:
        model.double()
        for m in model.modules():
            if hasattr(m, 'compute_dtype'):
                m.compute_dtype = torch.float64
        model.dtype = torch.float64
        batch = {k: v.double() if v.is_floating_point() else v
                 for k, v in batch.items()}
    state = train.TrainState(model, train.rectified_adam(
        train.cyclic_lr(1e-4, 1e-3, 700)))
    part = sp = None
    block = contextlib.nullcontext()
    if mesh is not None:
        import torch.distributed as dist
        parallel.replicate_state(state, mesh)
        layout = parallel.spatial_batch_sharding(batch, mesh)
        batch = parallel.spatial_shard_batch(batch, mesh)
        d, m = divmod(dist.get_rank(), mesh.model)
        part = (d, mesh.shape['data']) if mesh.shape['data'] > 1 else None
        sp = (m, mesh.model)
        step = parallel.make_parallel_train_step(
            model, mesh, with_metrics=False, batch_shardings=layout)
        block = parallel.sharded(model, mesh)
    else:
        step = train.make_train_step(model, with_metrics=False)
    batch = {k: v.to(dev) for k, v in batch.items()}
    model.eval()
    with torch.no_grad(), block:
        out = model.raw_heads(batch['images'])
    heads = {k: out[k].detach().cpu().double()
             for k in ('cls_pred', 'loc_pred', 'seg_pred')}
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    with fixed_decisions(decided, torch.float64 if float64 else
                         torch.float32, part=part, fused=True, sp=sp,
                         vectors=True) as record:
        state, metrics = step(state, batch)
    values = {f'loss:{k}': v for k, v in metrics.items()}
    values.update({f'grad:{k}': v for k, v in state.opt_state.mu.items()})
    values.update({f'change:{k}': v.detach() - start[k]
                   for k, v in model.named_parameters()})
    values.update({f'stats:{k}': v for k, v in state.batch_stats.items()})
    values.update({f'box:{j}': t
                   for j, t in enumerate(state.box_loss_state)})
    digest = hashlib.sha256()
    for k, v in list(state.model.state_dict().items()) + [
            (f'box{j}', t) for j, t in enumerate(state.box_loss_state)]:
        digest.update(k.encode())
        digest.update(v.detach().cpu().contiguous().view(
            torch.uint8).numpy().tobytes())
    run = dict(heads=heads, held=record['held'], digest=digest.hexdigest(),
               step={k: v.detach().cpu().double()
                     for k, v in values.items()},
               slack={f'change:{k}': float(2 * np.spacing(np.float32(
                   v.abs().max().item()))) for k, v in start.items()})
    if decided is None:
        run['decided'] = record
    return run


def _spatial_eq_rank(r, world, port, device, mesh_shape, cases):
    """One rank of a narrow check: every case's ``spatial_run`` on the
    mesh."""
    import masklab_tpu_torch as mt
    import torch.distributed as dist
    from masklab_tpu_torch.parallel import make_mesh
    torch.set_num_threads(1)
    dev = _joined(r, world, port, device)
    try:
        mesh = make_mesh(*mesh_shape, devices=[dev] * world)
        return {name: spatial_run(mt, mt.ModelConfiguration().from_dict(
                    cfg), batch, dev, decided, mesh)
                for name, (cfg, batch, decided) in cases.items()}
    finally:
        dist.destroy_process_group()


def _mesh_heads(runs: list, mesh_shape) -> dict:
    """The whole batch's heads from a mesh's ranks (rank d * model + m):
    each data row's cls / loc from its first rank, its seg rows put
    together in rank order."""
    data, model = mesh_shape
    out = {}
    for k in ('cls_pred', 'loc_pred', 'seg_pred'):
        rows = []
        for d in range(data):
            ranks = runs[d * model:(d + 1) * model]
            rows.append(torch.cat([x['heads'][k] for x in ranks], 1)
                        if k == 'seg_pred' else ranks[0]['heads'][k])
        out[k] = torch.cat(rows)
    return out


def check_spatial_equivalence(mt, rng) -> dict:
    """The narrow float32 models (``spatial_eq_config``) on a 1 x 2 and a 2
    x 2 mesh of gloo ranks on the card against one process: ``raw_heads``
    (the ranks' rows put together) and one train step, every run on the
    decisions of one float32 process on the card (the witness: its
    loss-NMS proposals and ReLU gates, its targets held to the witness's;
    ``fixed_decisions``, each rank its rows and blocks). As
    ``check_train_reference`` holds a step: each tensor of the card's mesh
    within TRAIN_REF_RATIO x the largest distance of three sound float32
    runs of one process (the witness on the card, one on the CPU with its
    default threads and one with one thread: other summation orders) from
    a float64 step on the CPU on those decisions, plus TRAIN_REF_FLOOR of
    the tensor's largest entry (and the parameter changes' 2 ulps). The
    mesh's distance from one process on the CPU is no yardstick on the
    card: cuDNN picks other algorithms for a rank's window of rows than
    for the whole map, rounding the CPU's convolutions (each output
    computed alike whatever the map's height) do not add; against it a
    BatchNorm bias's gradient, a sum that cancels, read 7.9 on the first
    run. On each mesh every rank's parameters, statistics and box state
    equal bit for bit."""
    from masklab_tpu_torch import train
    from masklab_tpu_torch.data import make_random_batch
    start = time.perf_counter()
    laps, cases, sound, exact = {}, {}, {}, {}
    for name, hw in SPATIAL_EQ_HW.items():
        cfg = spatial_eq_config(mt, name)
        batch = train.as_batch(make_random_batch(
            SPATIAL_EQ_BATCH, hw, 4,
            num_det_classes=len(cfg.dataset.instance_labels),
            num_seg_classes=len(cfg.dataset.semantic_labels),
            seed=int(rng.randint(1 << 30))), 'cpu')
        witness = spatial_run(mt, cfg, batch, DEVICE)
        decided = witness.pop('decided')
        cases[name] = (cfg.to_dict(), batch, decided)
        sound[name] = [witness]
    laps['witness'] = time.perf_counter() - start
    ports = iter(free_ports(len(SPATIAL_MESHES)))
    collects = {shape: start_ranks(_spatial_eq_rank,
                                   (DEVICE, shape, cases),
                                   world=shape[0] * shape[1],
                                   port=next(ports))
                for shape in SPATIAL_MESHES}
    for name, (cfg, batch, decided) in cases.items():
        cfg = mt.ModelConfiguration().from_dict(cfg)
        sound[name].append(spatial_run(mt, cfg, batch, 'cpu', decided))
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            sound[name].append(spatial_run(mt, cfg, batch, 'cpu', decided))
        finally:
            torch.set_num_threads(threads)
        exact[name] = spatial_run(mt, cfg, batch, 'cpu', decided,
                                  float64=True)
    laps['cpu'] = time.perf_counter() - start
    runs = {}
    for shape, collect in collects.items():
        runs[shape] = collect()
        laps[f'{shape[0]}x{shape[1]}'] = time.perf_counter() - start

    def values(run, heads=None):
        return dict(run['step'], **{f'heads:{k}': v for k, v in
                                   (heads or run['heads']).items()})
    out = dict(meshes={}, laps=laps)
    for shape in SPATIAL_MESHES:
        label = f'{shape[0]}x{shape[1]}'
        for name in cases:
            mesh = [x[name] for x in runs[shape]]
            if len({x['digest'] for x in mesh}) != 1:
                raise AssertionError(f'spatial {label} {name}: the ranks '
                                     'differ')
            got = values(mesh[0], _mesh_heads(mesh, shape))
            want = values(exact[name])
            runs_32 = [values(x) for x in sound[name]]
            step = {}
            for k, w in want.items():
                err = (got[k] - w).abs().max().item()
                yard = max((r[k] - w).abs().max().item() for r in runs_32)
                limit = (TRAIN_REF_RATIO * yard + TRAIN_REF_FLOOR
                         * w.abs().max().item()
                         + sound[name][0]['slack'].get(k, 0.0))
                step[k] = err / max(limit, 1e-30)
            readings = _reading_summary(step)
            bad = {g: v for g, v in readings.items() if not v['max'] <= 1.0}
            if bad:
                raise AssertionError(f'spatial {label} {name}: the card '
                                     f'outside its bound {bad}')
            out['meshes'][f'{label} {name}'] = dict(
                worst={g: v['max'] for g, v in readings.items()},
                held=mesh[0]['held'],
                loss=sound[name][0]['step']['loss:loss'].item())
    out['seconds'] = time.perf_counter() - start
    return out


@contextlib.contextmanager
def recorded_k2_rows():
    """Within the block, every call of K2 by the NMS candidate pool records
    its (scores shape, cap)."""
    from masklab_tpu_torch.ops import nms
    seen, wrapper = [], nms.segment_topk_rows

    def record(scores, cap, *args, **kwargs):
        seen.append((tuple(scores.shape), int(cap)))
        return wrapper(scores, cap, *args, **kwargs)
    nms.segment_topk_rows = record
    try:
        yield seen
    finally:
        nms.segment_topk_rows = wrapper


def k2_at_rows(kc, shape, cap, seed=14) -> dict:
    """K2 at a path's [B, C, n] call (the transpose of [B, n, C] scores),
    exact against its plain version; cold device ms beside its bound."""
    b, c, n = shape
    scores = k2_scores(np.random.RandomState(seed), b, c, n)
    got = kc.segment_topk_rows(scores, cap)
    want = kc.segment_topk_rows_plain(scores, cap)
    if not all(torch.equal(g, v) for g, v in zip(got, want)):
        raise AssertionError(f'segment_topk differs from plain at {shape}, '
                             f'cap {cap}')
    flush, s = l2_flush(), -(-n // 128)
    return dict(shape=list(shape), cap=cap, exact=True,
                device_ms=device_ms(lambda: (flush(), kc.segment_topk_rows(
                    scores, cap)), 100, 'segment_topk'),
                bound_ms=bound_ms(b * c * n * 4 + 2 * b * c * cap * s * 4,
                                  b * c * n)[0])


def _spatial_fullwidth_rank(r, world, port, model_axis=2, spread=False):
    """One rank of the full-width run on card 0 (``spread``: card r): the
    road preset on a (world / model_axis) x model_axis mesh, the global
    batch SPATIAL_BATCH a data row: one forward (its launches), then
    PARALLEL_WARMUP steps (the first recording K1's and K2's maps, the
    second K1's backward's), SPATIAL_STEPS counted ones (host ms between
    synchronizations, launches from 0 before each, the losses), the peak
    memory above what the process held before the model was built, one
    traced step (the collectives' spans: count and host ms),
    the parameters' digest."""
    import hashlib
    import masklab_tpu_torch as mt
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from masklab_tpu_torch import parallel, train
    from masklab_tpu_torch.data import make_random_batch
    from masklab_tpu_torch.ops import cuda as kc
    dev = _joined(r, world, port, f'{DEVICE}:{r if spread else 0}'
                  if DEVICE == 'cuda' else DEVICE)
    try:
        mesh = parallel.make_mesh(world // model_axis, model_axis,
                                  devices=[dev] * world)
        cfg = parallel_road_config(mt)
        base = torch.cuda.memory_allocated(dev)
        model = mt.build_masklab(cfg, device=dev, seed=0)
        state = train.TrainState(model, train.rectified_adam(
            train.cyclic_lr(1e-4, 1e-3, 700)),
            box_beta=cfg.loss.box_loss_beta)
        parallel.replicate_state(state, mesh)
        whole = make_random_batch(
            SPATIAL_BATCH * mesh.shape['data'], SPATIAL_HW, 3,
            num_det_classes=len(cfg.dataset.instance_labels),
            num_seg_classes=len(cfg.dataset.semantic_labels), seed=0)
        layout = parallel.spatial_batch_sharding(whole, mesh)
        batch = train.as_batch(parallel.spatial_shard_batch(whole, mesh),
                               dev)
        step = parallel.make_parallel_train_step(
            model, mesh, with_metrics=False, seed=cfg.train.seed,
            batch_shardings=layout)
        model.eval()
        torch.cuda.synchronize()
        kc.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad(), parallel.sharded(model, mesh):
            fwd = model(batch['images'])
        torch.cuda.synchronize()
        forward = dict(ms=(time.perf_counter() - t0) * 1e3,
                       launches=kc.launch_counts(),
                       finite=all(bool(torch.isfinite(v).all())
                                  for v in fwd.values()))
        with recorded_k1_maps() as k1_maps, recorded_k2_rows() as k2_rows:
            state, _ = step(state, batch)
        k1b_maps = k1_backward_shapes(step, state, batch)
        for _ in range(PARALLEL_WARMUP - 2):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, counts, losses = [], [], []
        for _ in range(SPATIAL_STEPS):
            kc.reset_launch_counts()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            counts.append(kc.launch_counts())
            losses.append(metrics['loss'].item())
        peak = torch.cuda.max_memory_allocated(dev) - base
        warm_profiler()
        dist.barrier()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        cuda = torch.autograd.DeviceType.CUDA
        host = [e for e in prof.events() if e.device_type != cuda]
        spans = {name: [(e.time_range.end - e.time_range.start) / 1e3
                        for e in host if e.name == name]
                 for name in SPATIAL_SPANS}
        digest = hashlib.sha256()
        for k, v in list(state.model.state_dict().items()) + [
                (f'box{j}', t) for j, t in enumerate(state.box_loss_state)]:
            digest.update(k.encode())
            digest.update(v.detach().cpu().contiguous().view(
                torch.uint8).numpy().tobytes())
        return dict(forward=forward, step_ms=times, launches_per_step=counts,
                    losses=losses, peak_memory_bytes=peak,
                    traced_ms=traced_ms,
                    collectives={k[11:]: len(v) for k, v in spans.items()},
                    collective_ms={k[11:]: sum(v) for k, v in spans.items()},
                    k1_maps=k1_maps, k1_backward_maps=k1b_maps,
                    k2_rows=k2_rows, backend=dist.get_backend(),
                    rows=tuple(batch['images'].shape),
                    digest=digest.hexdigest())
    finally:
        dist.destroy_process_group()


def spatial_one_process(mt) -> dict:
    """The full-width run's step in one process on the card at the same
    global batch: ms a step (median of SPATIAL_STEPS after a warm-up) and
    the peak memory above what the process held before the model was built
    (the earlier phases' leftovers out, as a rank holds none)."""
    from masklab_tpu_torch import train
    from masklab_tpu_torch.data import make_random_batch
    cfg = parallel_road_config(mt)
    base = torch.cuda.memory_allocated(DEVICE)
    model = mt.build_masklab(cfg, device=DEVICE, seed=0)
    state = train.TrainState(model, train.rectified_adam(
        train.cyclic_lr(1e-4, 1e-3, 700)), box_beta=cfg.loss.box_loss_beta)
    batch = train.as_batch(make_random_batch(
        SPATIAL_BATCH, SPATIAL_HW, 3,
        num_det_classes=len(cfg.dataset.instance_labels),
        num_seg_classes=len(cfg.dataset.semantic_labels), seed=0), DEVICE)
    step = train.make_train_step(model, with_metrics=False,
                                 seed=cfg.train.seed)
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(SPATIAL_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out = dict(ms_per_step=statistics.median(times), step_ms=times,
               peak_memory_bytes=torch.cuda.max_memory_allocated(DEVICE)
               - base, loss=metrics['loss'].item())
    del model, state, batch
    torch.cuda.empty_cache()
    return out


def check_spatial_fullwidth(kc, ranks: list, world: int, model_axis: int,
                            label: str) -> dict:
    """The full-width ranks' results held: the forward finite with K1, K2
    and K3 launched; every counted step's loss finite with K1, K1's
    backward, K2 and K3 launched on each rank; every rank's parameters,
    statistics and box state and its losses equal bit for bit."""
    for r, res in enumerate(ranks):
        fwd = res['forward']
        if not fwd['finite']:
            raise AssertionError(f'spatial {label} rank {r}: a forward '
                                 'output is not finite')
        for name in ('band_groupnorm', 'segment_topk', 'nms_keep'):
            if fwd['launches'][name] == 0:
                raise AssertionError(f'spatial {label} rank {r}: {name} not '
                                     'launched in the forward')
        if not all(np.isfinite(res['losses'])):
            raise AssertionError(f'spatial {label} rank {r}: losses '
                                 f'{res["losses"]}')
        for i, c in enumerate(res['launches_per_step']):
            for name in TRAINER_KERNELS:
                if c[name] == 0:
                    raise AssertionError(f'spatial {label} rank {r} step '
                                         f'{i}: {name} not launched')
    if len({res['digest'] for res in ranks}) != 1:
        raise AssertionError(f'spatial {label}: the ranks\' parameters '
                             'differ after the last step')
    if any(res['losses'] != ranks[0]['losses'] for res in ranks):
        raise AssertionError(f'spatial {label}: the ranks report other '
                             'losses')
    mesh_ms = [max(ts) for ts in zip(*(res['step_ms'] for res in ranks))]
    images = SPATIAL_BATCH * world // model_axis
    share = [sum(res['collective_ms'].values()) / res['traced_ms']
             for res in ranks]
    return dict(
        config=f'road seresnet34 bf16 full width, {SPATIAL_HW[0]}x'
               f'{SPATIAL_HW[1]}, global batch {images}, mesh {label}',
        rows=[res['rows'] for res in ranks],
        ms_per_step=statistics.median(mesh_ms), step_ms=mesh_ms,
        img_per_s=images * len(mesh_ms) / (sum(mesh_ms) / 1e3),
        forward_ms=[res['forward']['ms'] for res in ranks],
        peak_memory_bytes=[res['peak_memory_bytes'] for res in ranks],
        collectives=ranks[0]['collectives'],
        collective_ms=[res['collective_ms'] for res in ranks],
        collective_share=share, traced_ms=[res['traced_ms']
                                           for res in ranks],
        losses=ranks[0]['losses'], backend=ranks[0]['backend'],
        launches_per_step=[res['launches_per_step'] for res in ranks],
        launches={k: sum(c[k] for res in ranks
                         for c in res['launches_per_step'])
                  for k in ranks[0]['launches_per_step'][0]},
        forward_launches=[res['forward']['launches'] for res in ranks])


def spatial_kernels_at_path(kc, rng, ranks: list) -> dict:
    """K2 exact at each [B, C, n] call the path gave it, K1 and K1's
    backward held at every map it gave them (``k1_at_maps``,
    ``k1_backward_at``)."""
    k2 = [k2_at_rows(kc, shape, cap) for shape, cap in
          sorted({row for res in ranks for row in res['k2_rows']})]
    maps = [m for res in ranks for m in res['k1_maps']]
    bmaps = [m for res in ranks for m in res['k1_backward_maps']]
    return dict(k2=k2, k1=k1_at_maps(kc, rng, maps),
                k1_backward=k1_backward_at(kc, rng, bmaps),
                k1_maps=sorted({tuple(str(v) for v in m) for m in maps}),
                k1_backward_maps=sorted({tuple(m) for m in bmaps}))


def run_spatial(mt, kc) -> dict:
    """Phase 14, its lines printed: the narrow checks, the full-width run on
    1 x 2 gloo ranks beside one process, the kernels at the path's maps;
    its inputs from a generator of its own."""
    rng = np.random.RandomState(14)
    out = dict(equivalence=check_spatial_equivalence(mt, rng))
    eq = out['equivalence']
    print(f'spatial equivalence: the card\'s meshes within '
          f'{TRAIN_REF_RATIO:g}x the distance of sound float32 runs of one '
          f'process from a float64 step (worst reading by group), ranks '
          f'bitwise equal: {json.dumps(eq["meshes"])}; {eq["seconds"]:.1f} '
          f's', flush=True)
    start = time.perf_counter()
    ranks = spawn_ranks(_spatial_fullwidth_rank, (), world=2)
    out['fullwidth'] = fw = check_spatial_fullwidth(kc, ranks, 2, 2, '1x2')
    fw['one_process'] = one = spatial_one_process(mt)
    out['kernels'] = ks = spatial_kernels_at_path(kc, rng, ranks)
    fw['seconds'] = time.perf_counter() - start
    print(f'spatial: {fw["config"]}, backend {fw["backend"]}, rank rows '
          f'{fw["rows"]}: {fw["ms_per_step"]:.2f} ms a step (steps '
          f'{[round(t, 2) for t in fw["step_ms"]]}), {fw["img_per_s"]:.3f} '
          f'img/s; one process at the same batch {one["ms_per_step"]:.2f} '
          f'ms; peak memory above the model\'s start '
          f'{[round(b / 2**30, 3) for b in fw["peak_memory_bytes"]]} GiB a '
          f'rank vs {one["peak_memory_bytes"] / 2**30:.3f} GiB one process;'
          f' a traced step\'s collectives {json.dumps(fw["collectives"])}'
          f' (host ms {json.dumps(fw["collective_ms"][0])}), share '
          f'{[round(s, 3) for s in fw["collective_share"]]} of '
          f'{[round(t, 2) for t in fw["traced_ms"]]} ms; forward '
          f'{[round(t, 2) for t in fw["forward_ms"]]} ms, launches '
          f'{json.dumps(fw["forward_launches"][0])}; losses '
          f'{json.dumps(fw["losses"])}, launches per step '
          f'{json.dumps(fw["launches_per_step"][0][-1])} on each rank, '
          f'ranks bitwise equal; {fw["seconds"]:.1f} s', flush=True)
    print(f'spatial kernels: K2 {json.dumps(ks["k2"])}; K1 at '
          f'{len(ks["k1"])} cases of maps {json.dumps(ks["k1_maps"])}; K1 '
          f'backward at {json.dumps([[c["shape"], c["groups"], c["dtype"], c["relu"], c["dx_err"]] for c in ks["k1_backward"]])}',
          flush=True)
    return out


def run_spatial_multi_card(mt, kc, n: int) -> dict:
    """--multi-card's spatial run: 2 x 2 over four NCCL ranks, one a card,
    at the full-width configuration and a global batch of 4."""
    if n < 4:
        raise AssertionError(f'the 2 x 2 spatial mesh needs four cards, '
                             f'has {n}')
    ranks = spawn_ranks(_spatial_fullwidth_rank, (2, True), world=4)
    if {res['backend'] for res in ranks} != {'nccl'}:
        raise AssertionError('spatial 2x2: not over NCCL')
    out = check_spatial_fullwidth(kc, ranks, 4, 2, '2x2 NCCL')
    print(f'spatial multi-card: {out["config"]}: {out["ms_per_step"]:.2f} '
          f'ms a step, {out["img_per_s"]:.3f} img/s, peak memory '
          f'{[round(b / 2**30, 3) for b in out["peak_memory_bytes"]]} GiB, '
          f'collectives {json.dumps(out["collectives"])} share '
          f'{[round(s, 3) for s in out["collective_share"]]}, losses '
          f'{json.dumps(out["losses"])}', flush=True)
    return out


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
    parser.add_argument('--deploy-only', action='store_true',
                        help="card, build, K2 at the default deployment's "
                        'row, and phases 8-10 only')
    parser.add_argument('--parallel-only', action='store_true',
                        help='card, build and phase 11 (data parallelism) '
                        'only')
    parser.add_argument('--fused-only', action='store_true',
                        help='card, build and phase 12 (the fused mask '
                        'head) only')
    parser.add_argument('--acceptance-only', action='store_true',
                        help='card, build and phase 13 (the learning gates, '
                        'examples/torch/06 and 07) only')
    parser.add_argument('--spatial-only', action='store_true',
                        help='card, build and phase 14 (the dp x sp spatial '
                        'sharding) only; with --multi-card, card, build '
                        'and its 2 x 2 NCCL run only')
    parser.add_argument('--multi-card', action='store_true',
                        help='card, build, and data parallelism over every '
                        'card present (two at least): NCCL ranks, the CLI '
                        'trainer, the serving mesh, the 2 x 2 spatial mesh '
                        '(four cards)')
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
    if args.deploy_only:
        finish(card, run_deployment(mt, kc))
        return 0
    if args.parallel_only:
        finish(card, {'parallel': run_parallel(mt, kc)})
        return 0
    if args.fused_only:
        finish(card, {'fused': run_fused(mt, kc)})
        return 0
    if args.acceptance_only:
        finish(card, {'acceptance': run_acceptance(kc)})
        return 0
    if args.spatial_only and args.multi_card:
        finish(card, {'multi_card': {'spatial': run_spatial_multi_card(
            mt, kc, torch.cuda.device_count())}})
        return 0
    if args.spatial_only:
        finish(card, {'spatial': run_spatial(mt, kc)})
        return 0
    if args.multi_card:
        finish(card, {'multi_card': run_multi_card(mt)})
        return 0
    if args.trainer_only:
        k2 = check_k2(kc, rng, False)
        print_k2(k2)
        trained = run_trainer(mt, kc, rng)
        finish(card, {'kernels': [k2], 'trainer': trained})
        return 0
    edges = not args.kernels_only
    kernels = [check_k1(kc, rng, edges), check_k1_backward(kc, rng, edges),
               check_k2(kc, rng, edges), check_k3(kc, rng, edges),
               check_k4(kc, rng, edges), check_k5(kc, rng, edges)]
    for k in kernels:
        print(f'kernel {k["name"]}: device {k["device_ms"]:.4f} ms, call '
              f'{k["call_ms"]:.4f} (plain {k["plain_ms"]:.4f}, bound '
              f'{k["bound_ms"]:.4f}) {k["shape"]}', flush=True)
    k5 = kernels[5]
    print(f'kernel batch_norm_act: stem {k5["share_of_bound"]:.3f} of the '
          f'bound ({k5["tb_per_s"]:.2f} TB/s), F.batch_norm + relu_ '
          f'{k5["library_ms"]:.4f} ms ({k5["library_differ_share"]:.4f} of '
          f'the elements differ); B4 expand '
          f'{json.dumps(k5["expand"])}; edges {json.dumps(k5["edges"])}',
          flush=True)
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
    fused_head = run_fused(mt, kc, serve, trained)
    deployed = run_deployment(mt, kc)
    parallel = run_parallel(mt, kc)
    spatial_out = run_spatial(mt, kc)
    trainer = run_trainer(mt, kc, rng)
    acceptance = run_acceptance(kc)
    paths = dict(serve, train=trained, trainer=dict(
        launches={k: sum(c[k] for c in trainer['launches_per_step'])
                  for k in TRAINER_KERNELS}),
        deployment=deployed['deployment'], separable=deployed['separable'],
        parallel=parallel['fullwidth'], spatial=spatial_out['fullwidth'],
        **{'serving mesh': parallel['serving_mesh']}, **fused_head['serve'],
        **{'fused train': fused_head['train']},
        **{f'acceptance {g}': a for g, a in acceptance.items()
           if g != 'k1_maps'})
    for k in kernels:
        k['launches_by_path'] = {p: v['launches'].get(k['name'], 0)
                                 for p, v in paths.items()}
        k['launches'] = k['launches_by_path'][KERNEL_PATH.get(
            k['name'], 'headline raw')]
        if k['name'] == 'segment_topk':
            k['pool_fallbacks'] = {p: v['pool_fallbacks']
                                   for p, v in serve.items()}
            k['deployment'] = deployed['k2']
    deployed.pop('k2')
    print(f'total: {time.perf_counter() - STARTED:.1f} s', flush=True)
    finish(card, {'kernels': kernels, 'serve': serve, 'train': trained,
                  'trainer': trainer, 'reference': reference, **deployed,
                  'parallel': parallel, 'spatial': spatial_out,
                  'fused': fused_head,
                  'acceptance': acceptance, **more})
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


def run_deployment(mt, kc) -> dict:
    """Phases 8-10, their lines printed: K2 at the default deployment's
    row, the deployment itself, the backbones, the separable heads."""
    k2 = k2_at_deployment(mt, kc)
    print(f'kernel segment_topk at the default deployment: {k2["shape"]} '
          f'({k2["anchors"]} anchors) exact, cold {k2["device_ms"]:.5f} ms '
          f'(bound {k2["bound_ms"]:.5f})', flush=True)
    out = dict(k2=k2)
    out['deployment'] = default_deployment(mt, kc)
    out['backbones'] = check_backbones(mt)
    out['separable'] = check_separable(mt, kc)
    return out


def finish(card: str, result: dict) -> None:
    """The last three lines: the result, the card, the device line."""
    print(json.dumps(result))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    sys.exit(main())
