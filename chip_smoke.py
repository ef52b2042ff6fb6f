#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (empanada_tpu_torch) on one GPU.

    python3 chip_smoke.py [--earlier DIR]

``--earlier DIR`` names a checkout of the parent commit (for example a
``git archive`` of it unpacked into a git-ignored directory): its refine
kernel, tile copy, gated tile copy and int8 convolution are then built too
and timed beside this one's on the same inputs (``earlier_ms``, ``earlier_device_ms``);
without it those are null.

Phases, each of which fails the run (non-zero exit) when it goes wrong:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the three CUDA sources (csrc/pointrend_refine.cu,
   csrc/refine_profile.cu and csrc/int8_conv.cu, one nvcc each, started
   together), then the host
   C++ library (csrc/core_kernels.cpp), and prints the build seconds and
   ptxas' resource reports;
3. kernel vs plain: the refine kernel against its plain PyTorch version on
   the card at MitoNet_v1's shapes (N = 1, 8 and 32, steps sf = 2 and 4,
   F = 256, K = 8192, bf16) and at a ragged geometry, each at the real
   threshold, all-skip, all-refine and a clustered threshold (the pixels of
   one 16 x 128 tile of each image); two launches at N = 32 are
   bit-identical;
4. refine profile: at B = 8, up (8, 512, 512, 1), features
   (8, 128, 128, 256), sf = 4 and MitoNet_v1's point head, the profiling
   kernels (tile copy, gated tile copy with and without the refine
   kernel's shared memory reserved, the refine step cut after the gather
   and after the interpolation) against their plain versions (the gated
   copy bit for bit at three thresholds, the reservations of MitoNet_v1's
   and the mini's widths, on B = 8, a ragged pair and one image, its
   persistent grid against ``gated_plan``), then their
   CUDA-event and profiler device times beside their bounds: the whole step
   at all-skip and all-refine (select and refine passes apart; its plain
   version's times, ``full_skip_plain`` and ``full_refine_plain``), the MLP's
   TFLOP/s at all-refine, the tile copy against ``copy_`` and the gated
   copies at all-skip and all-refine, unreserved and reserved, and, with
   ``--earlier``, the parent's (medians of 60 calls'
   device times; a ``refine profile: gated copies`` line gives each one's
   ms, the parent's, the bound and its share, the grid and blocks a SM);
5. main path: MitoNet_v1 at full width (seeded random weights, random BN
   statistics, bf16) serves four 512 x 512 uint8 requests and one 600 x 700
   request through PanopticDeepLabRenderEngine, and a 7-slice stack through
   PanopticDeepLabRenderEngine3d; the refine kernel must launch twice per
   slice; the kernel is compared with its plain version on one request's
   real features, and one step (both passes) runs under
   ``torch.cuda.set_sync_debug_mode("error")``;
6. times: CUDA-event times of the engine and its stages (trunk, PointRend,
   postprocess; device busy time from torch.profiler), and of each refine
   step at N = 1 on real features (and its clustered case), N = 8 and
   N = 32: the profiler's device time of the select and refine passes, the
   selected points, chunks and blocks, the bound (and, kept to show what a
   tile-per-block schedule paid, the busiest tile's points and the bound of
   refining whole tiles); at N = 1 also the plain version and the whole
   step through the kernel against the fused_render="never" torch path, in
   turns; printed as JSON;
7. 3D: a seeded 64 x 512 x 512 uint8 volume through
   MultiChipEngine3d.infer_on_axis(vol, "xy") at the engine's auto batch
   (32: two batches) streamed from the resident volume and fused (the
   whole-sweep path), and at B = 8 (eight batches) streamed from the host,
   streamed from the resident volume and fused, in that order; 2 refine
   launches per batch; the kernel against its plain version on
   the first batch's real inputs of both steps; instances; dropped NMS
   centers, with slices/s, Mvox/s, the host stage split, the device's busy
   share and host syncs per batch; then in float32 a 16 x 256 x 256
   volume: the batched engine's per-slice maps against
   PanopticDeepLabRenderEngine3d's on the card, and its filled panoptic
   stack against a CPU run; the f32 2D engine on the card against the CPU
   on a small request;
8. ortho: the same 64 x 512 x 512 volume through
   MultiChipEngine3d.infer_orthoplane (xy, xz and yz sweeps at the auto
   batch) and api.tracker_consensus (pixel vote 2, cluster IoU 0.75), twice
   in one process: pipelined and fused (the default: each axis's host half
   on a worker thread while the next axis is dispatched), then streamed
   from the host.  For each: one warm-up run that keeps the
   first xz and yz batches' inputs of both refine steps (the kernel is held
   against its plain version on them), then the median of 2 timed runs (2
   refine launches per batch per axis, counted around each axis's
   dispatch; the consensus voxels inside the union of the three sweeps'
   voxels; no fused sweep falling back to the per-slice path), one run
   under torch.profiler for the device's busy share, and the host syncs of
   one xz dispatch under the sync debug mode, each attributed to its call
   site in the port; printed as ``ortho:`` lines (output-volume Mvox/s over
   sweeps + consensus, each axis's stage split and its seconds, or its
   dispatch and host seconds apart where the axes overlap, the yz tracker
   finish, instances, dropped NMS centers, fallbacks); then in float32 an 8
   x 128 x 128 volume through the same two calls on the card and on the
   CPU, on both paths, whose per-axis trackers and consensus instances must
   be identical (``f32 ortho:`` line);
9. resume: a checkpointed xy sweep of a 24 x 256 x 256 volume at B = 4
   crashed after 10 slices and resumed on the card; its stack and trackers
   must equal an uninterrupted sweep's (``resume:`` line);
10. engine2d: ``api.Engine2d`` with MitoNet_v1's model: a 512 x 512
    request equal to PanopticDeepLabRenderEngine + ``force_connected``; a
    seeded 4096 x 4096 image in 2048 x 2048 tiles (9 tiles, overlap 128):
    18 refine launches, the kernel held against its plain version on the
    first tile's real step inputs, wall seconds (the faster of 2 runs)
    and the device's busy share; a NucleoNet_base_v2 600 x 700 request
    (padded to 1024 x 1024); ``inference_scale`` 2 on a 1024 x 1024
    request (3 launches, the third step at sf 8 held against the plain
    version, and its device ms beside its bound); a float32 tiled request
    (300 x 340, tiles of 128) equal on the card and the CPU (``engine2d:``
    line);
11. engine3d: ``api.Engine3d`` over phase 7's volume, slice by slice (2
    launches a slice; slices/s beside phase 7's fused B = 32 figure),
    ``MultiChipEngine3d`` at ``inference_scale`` 2 (3 launches a batch, the
    sf 8 step held against the plain version), both engines' panoptic
    stacks written into a chunked store and read back equal to the numpy
    stacks, and in float32 a 16 x 256 x 256 volume whose Engine3d trackers
    and stack on the card equal MultiChipEngine3d's on the card and
    Engine3d's on the CPU (``engine3d:`` line);
12. mini_bc: MitoNet_v1_mini from its config at full width
    (regnety_6p4gf, fpn_dim 160, 3 BiFPN layers, K = 8192; seeded random
    weights and BN statistics, bf16) through ``api.Engine2d`` (four 512 x
    512 requests and one 600 x 700, padded to 640 x 768) and through
    ``MultiChipEngine3d.infer_on_axis(vol, "xy")`` on phase 7's volume at
    the auto batch, fused: 0 refine launches (F = 160 takes the torch
    PointRend path, as JAX takes XLA), the engine's ms, busy share and
    stage split, the torch steps' device ms beside MitoNet_v1's kernel
    steps of phase 6, the sweep's slices/s and busy share; in float32 a 16
    x 256 x 256 sweep and a 256 x 256 request equal on the card and the
    CPU (``mini:`` line).  ``PanopticDeepLabBC`` at MitoNet_v1's widths
    (bf16): four 512 x 512 requests through ``BCEngine`` (4 launches a
    request; the kernel held against its plain version on one request's
    real step inputs of both heads), a 7-slice stack through ``BCEngine3d``
    and ``bc_watershed``; in float32 a request's maps on the card within
    1e-5 of the CPU's and their watershed labels equal; the plain engines
    ``PanopticDeepLabEngine{,3d}`` with ``PanopticDeepLab`` at MitoNet_v1's
    widths in float32, a request and a 7-slice stack equal on the card and
    the CPU (``bc:`` line);
13. train: one train step of MitoNet_v1's widths (aspp_dropout 0, fed
    PointRend points, batch 2, 128 x 128) on the card against the CPU, in
    float32 and float64: the loss, every gradient (over all and per
    tensor), the batch statistics, and the card's AdamW update and moments
    against AdamW's of its own gradients; in float64 also the moments and
    updated parameters against the CPU's; then MitoNet_v1 at full width trained
    through ``train.main`` at ``training/train_config.yaml``'s TRAIN
    defaults (batch 16, 256 x 256 crops, the seven augmentations,
    PanopticLoss with its PointRend term, AdamW/OneCycle, bf16 autocast)
    for two epochs on 64 seeded 512 x 512 blob images written as PNG here,
    validated on 2 (IoU, PQ, F1) through ``PanopticDeepLabEngine``: ms per step
    split into the host's data loading and the step's dispatch (over all
    steps, and over steps 2.. without the first's warm-up), the
    device's step (CUDA events) and busy time (profiler), samples/s, peak
    memory, host syncs per step and their sites, the losses (falling), the
    refine launches of ``eval_step`` and ``validate`` (the kernel held
    against its plain version on validate's real step inputs); and a run
    crashed after its first epoch's checkpoint and resumed: the state
    loaded equal to the state saved, bit for bit, and the resumed
    parameters as close to the straight run's as a second straight run's
    (``train:`` line);
14. cli: the port's command line (``cli.main``, as ``python -m
    empanada_tpu_torch`` runs it) with phase 5's model in a registry of
    its own inside the checkout: ``port`` of its reference-named state dict
    (the inverse of ``port/torch_port.py``'s map, float32) saved as a raw
    state dict, a ``{state_dict}`` checkpoint and a TorchScript archive,
    each bundle's parameters equal to the model's bit for bit; ``models
    export`` / ``import`` / ``archive``; ``infer2d --tile-size 2048`` of
    phase 10's 4096 x 4096 image written as PNG (18 launches, the kernel
    held on the first tile's real step inputs), its TIFF equal to
    ``api.Engine2d``'s map, a 512 x 512 ``--roi`` window and two models
    (MitoNet_v1 + NucleoNet_base_v2) on a 1024 x 1024 crop, each equal to
    the in-process engines; ``infer3d --multichip`` of phase 7's volume
    written as a multipage TIFF (its class TIFF equal to
    ``MultiChipEngine3d`` + ``stack_postprocessing``) and ``--orthoplane
    --store`` (the store equal to ``infer_orthoplane`` +
    ``tracker_consensus``), 2 launches a batch; ``evaluate`` of the xy
    tracker dump against itself and against a copy without every other
    instance, equal to the ``Evaluator``; ``labels count`` / ``small``
    and ``tiles chop`` / ``merge`` (the original back) on the tiled map;
    then ``python -m empanada_tpu_torch models list`` and ``infer2d``
    without ``--device`` in subprocesses on the card.  Each command's wall
    seconds beside the in-process engine's (``cli:`` line); at most 90 s;
15. parallel: worlds of processes started by the script (each runs
    ``chip_smoke.py --world-rank ...``), phase 5's model as a bundle:
    (a) a world of one over NCCL through the command line's
    ``--coordinator``/``--num-processes``/``--process-id``: ``infer3d
    --multichip`` of phase 7's volume and ``infer2d --spatial-shard`` of
    phase 10's 4096 x 4096 image, each equal to the same command in this
    process, and ``train --multichip`` for 2 steps (a checkpoint);
    (b) a world of two over gloo, both ranks on this card:
    ``MultiChipEngine3d`` of phase 7's volume at 32 slices a batch (16 a
    rank) equal to a world of one's at 16, bit for bit, on both ranks;
    ``SpatialEngine2d`` of the 4096 x 4096 image at halo 128, the kernel
    held on each rank's block (2304 x 4096) steps, both ranks' maps equal,
    its sem logits closer to the unsharded forward than two independent
    halves', and by JAX's seam rule (under half their mean error) on the
    512 rows around the seam; one
    data-parallel train step of a MitoNet_v1-width model against a world of
    one's on the concatenated batch, float32 without TF32 within phase 13's
    card limits and float64 within 1e-10, each world's updated parameters
    within 16 eps of AdamW's update of its own gradients (Adam's first
    step moves a parameter by about lr(0) whatever its gradient's size, as
    phase 13 found).  Seconds, slices/s beside a world
    of one's, seconds in collectives, host syncs per batch and refine
    launches per rank (``parallel:`` line); every rank's collectives time
    out after 90 s, each world after 110 s, the phase after 120 s;
16. surface: phase 5's model (a) as an int8 bundle of the same seed's
    float32 weights, loaded in bf16 (the dequantized weights on the card
    bit-equal to the CPU's; the size ratio against the float32 bundle; the
    share of a 512 x 512 request's pixels whose map differs from the float
    bundle's), (b) fetched from a ``file://`` URL into a download cache of
    its own (``Engine2d`` of the URL config equal to the local path's),
    (c) as a 512 x 512 serving artifact exported on ``cuda``, saved, loaded
    and run (the refine kernel launched ``render_steps`` times a request
    through the registered op; the map equal to ``Engine2d``'s device map,
    and after ``force_connected`` to ``Engine2d.infer``; a wrong shape and
    uint16 refused; export seconds, bytes, CUDA-event ms a request beside
    phase 6's ``engine_ms``), (d) ``device_time`` of a request's first
    refine step beside its CUDA-event time, the host ms of a call through
    the op against a direct launch, a ``trace()`` whose Chrome trace names
    the refine kernel, ``StageTimer(sync=True)`` over a request, and (e)
    ``python -m empanada_tpu_torch bench --skip-3d`` in this process (its
    JSON line on a ``bench:`` line); ``surface:`` line; at most 120 s;
17. int8: the int8 convolution kernel (csrc/int8_conv.cu) against its plain
    version, bit for bit, at MitoNet_v1's five int8 shapes (13 convolutions
    a request), N = 1 and 8, bf16 and float32, and its quantized activation
    against the plain quantize, then at four more shapes (C_in % 128 != 0,
    an uneven split of K); each shape's ms on CUDA-graph replays
    beside cuDNN's bf16 conv2d and ``torch._int_mm`` on the im2col'd int8
    operands (weights column-major and row-major; the sums must equal the
    convolution's) and, with ``--earlier``, the parent's kernel in turns;
    the kernel's parts and device activities a call by the profiler (three
    kernels, no memset), its launch plan, the plain ms and
    the bound at the int8 peak; a 512 x 512 MitoNet_v1 request with
    ``int8_execution`` through ``Engine2d`` (13 int8 launches, 2 refine
    launches; ``engine_ms`` beside the float model's in 16 alternating
    turns; the host ms of a layer3 ConvBnAct call, int8 against float; the
    map against the float model's, and the float model's against its
    float32 copy's, ``map_agreement``);
    ``python -m empanada_tpu_torch bench --int8 --skip-3d`` (``bench int8:``
    line; value and mfu beside phase 16's float ones); the napari 2D widget
    (magicgui stubbed by a pass-through) on a seeded int8 model registered
    in a registry of its own, its map equal to ``Engine2d``'s; ``int8:``
    line; at most 90 s.

The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``.  Run from the repository root (the
script imports the port from its own directory).
"""

import itertools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 FLOP/s,
# float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12
K_POINTS = 8192
# phase 14: the tiled image's side and tile, the --roi window's corner and
# side, and the two-model crop's side
CLI_BIG, CLI_TILE, CLI_ROI, CLI_CROP = 4096, 2048, (1024, 2048, 512), 1024


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def blob_image(shape, n_blobs, seed):
    """Seeded EM-like uint8 slice: dark Gaussian blobs on noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, w = shape
    img = rng.normal(0.5, 0.08, size=shape)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(n_blobs):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        sig = rng.uniform(min(h, w) * 0.02, min(h, w) * 0.05)
        img -= 0.4 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig ** 2))
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def graph_ms(fn, calls=20, replays=5):
    """Device milliseconds a call of ``fn()`` by CUDA events around replays
    of a CUDA graph of ``calls`` calls: no host launch cost in the window,
    so calls shorter than their launch are timed as the card runs them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def cuda_ms(fn, iters, warmup=2):
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare_refine(prr, up, thr, feats, coarse, packed, fused, strict=False):
    """Kernel vs plain version on the same inputs: the mask and every
    copied-through pixel bit-exact, refined pixels within the tolerance of
    tests/test_pointrend_fused.py (``strict``: also every refined logit
    within 2^-7 max(1, |plain logit|), one bf16 step).  The kernel takes the
    head's packed weights, the plain version its fused weights
    (``fused_weights``), so a fault of the packing shows here.  Returns
    (max abs error, refined share).  The plain version runs 8 images at a
    time, to bound its memory."""
    import torch

    got = prr.launch(up, thr, feats, coarse, packed).float()
    want = torch.cat([prr.refine_reference(up[i:i + 8], thr[i:i + 8], feats[i:i + 8],
                                           coarse[i:i + 8], fused)
                      for i in range(0, len(up), 8)]).float()
    torch.cuda.synchronize()
    mask = up.float().abs() <= thr[:, None, None, None]
    check(torch.equal(got[~mask], up.float()[~mask]), "copy-through pixels differ from up")
    check(torch.equal(want[~mask], up.float()[~mask]), "plain version changed skipped pixels")
    if not mask.any():
        return 0.0, 0.0
    ref, err = want[mask], (got[mask] - want[mask]).abs()
    check(bool(torch.isfinite(got).all()), "kernel output not finite")
    q_err = torch.quantile(err[:1 << 24], 0.99).item()
    q_ref = torch.quantile(ref.abs()[:1 << 24], 0.99).item()
    check(q_err <= 0.05 * (1 + q_ref), f"refined p99 error {q_err} > 0.05 (1 + {q_ref})")
    check(err.mean().item() < 0.02 * (1 + ref.abs().mean().item()),
          f"refined mean error {err.mean().item()}")
    if strict:
        over = err > 2.0 ** -7 * ref.abs().clamp(min=1.0)
        check(not over.any(), f"{int(over.sum())} refined logits off by more than one bf16 "
              f"step (max |err| {err.max().item():.4g})")
    return err.max().item(), mask.float().mean().item()


def tile_counts(up, thr):
    """Selected pixels (|up| <= thr) in each 16 x 128 output tile."""
    import torch.nn.functional as F

    from empanada_tpu_torch.ops.pointrend_refine import TILE_H, TILE_W

    m = (up.float().abs() <= thr[:, None, None, None])[..., 0].float()
    n, h, w = m.shape
    m = F.pad(m, (0, (-w) % TILE_W, 0, (-h) % TILE_H))
    t = m.reshape(n, m.shape[1] // TILE_H, TILE_H, m.shape[2] // TILE_W, TILE_W)
    return t.sum(dim=(2, 4))


def tile_share(up, thr):
    """Share of 16 x 128 output tiles holding a pixel with |up| <= thr."""
    return (tile_counts(up, thr) > 0).float().mean().item()


def step_bound(up, thr, feats, n_weights):
    """Least time (ms) for one refine step on these inputs: bytes (each
    input read once, the output written once) over HBM rate, against the
    point MLP's FLOPs for the pixels this data selects over bf16 peak.
    Also the FLOP bound if every pixel of every refining tile ran the MLP."""
    fdim = feats.shape[-1]
    d = fdim  # MitoNet_v1: fc_dim == decoder channels == F
    flop_pt = 2 * (fdim + 1) * d + 2 * (2 * (d + 1) * d) + 2 * (d + 1)
    n_sel = int((up.float().abs() <= thr[:, None, None, None]).sum().item())
    nbytes = (2 * up.numel() * 2 + feats.numel() * 2 + feats.numel() // fdim * 2
              + thr.numel() * 4 + n_weights * 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_sel * flop_pt / BF16_FLOP_PER_S * 1e3
    t_tiles = tile_share(up, thr) * up.numel() * flop_pt / BF16_FLOP_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    return {"bound_ms": bound, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flop_per_point": flop_pt, "selected_points": n_sel,
            "bound_tiles_ms": max(t_bytes, t_tiles),
            "max_tile_points": int(tile_counts(up, thr).max().item())}


def stage_times(engine, model, image, engine_ms):
    """Where one 512 x 512 request's time goes: CUDA-event ms of the trunk
    (encoder, decoders, heads), of the two PointRend steps (the head alone
    on the trunk's outputs) and of the postprocess, the host clock around
    one synchronised request, and the device's busy time per request from
    a torch.profiler trace (its share of engine_ms is the busy share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = engine._prepare(image)
    size = tuple(image.shape[-2:])
    with torch.no_grad():
        trunk_ms = cuda_ms(lambda: model(x, render_steps=0, interpolate_ins=False), 10)
        sem_x, _ = model._encode_decode(x)
        coarse = model.semantic_head(sem_x).permute(0, 2, 3, 1)
        feats = sem_x.permute(0, 2, 3, 1)
        pointrend_ms = cuda_ms(lambda: model.semantic_pr(coarse, feats), 10)
        out = engine.infer(x)
        post_ms = cuda_ms(lambda: engine._post_fused(out, 1), 10)
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        engine(image, size)
        host.append((time.perf_counter() - t0) * 1e3)
    n_req = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_req):
            engine.dispatch(image, size)
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            t = getattr(e, "self_device_time_total", None)
            t = getattr(e, "self_cuda_time_total", 0) if t is None else t
            kernels[e.key] = kernels.get(e.key, 0.0) + t / 1e3 / n_req
    busy_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"trunk_ms": trunk_ms, "pointrend_ms": pointrend_ms,
            "postprocess_ms": post_ms, "host_ms_synchronised": sorted(host)[len(host) // 2],
            "device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
            "device_busy_share": busy_ms / engine_ms if busy_ms > 0 else "not measured",
            "top_kernels_ms": [[k[:80], v] for k, v in top]}


def profiled(fn, iters):
    """torch.profiler over ``iters`` calls of ``fn()`` after one warm-up
    call.  A session that records no device activity at all is repeated,
    up to three times: the profiler now and then returns one empty."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        if any(str(e.device_type).endswith("CUDA") for e in prof.events()):
            break
    return prof


def host_ms(fn, calls=200):
    """Wall milliseconds a call over ``calls`` calls of ``fn()`` with one
    synchronisation at the end: the host's cost a call where the device's
    is smaller."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def profile_device(fn, iters, matches):
    """Mean device milliseconds per call of ``fn()`` from torch.profiler,
    for each name -> match of ``matches``: the self device time of the
    kernels and copies whose name holds the match ("" counts every device
    activity)."""
    return device_parts(profiled(fn, iters), iters, matches)


def device_parts(prof, iters, matches):
    """``profile_device``'s readout of a profiler session of ``iters``
    calls."""
    out = {}
    for name, match in matches.items():
        total = 0.0
        for e in prof.key_averages():
            if str(e.device_type).endswith("CUDA") and match in e.key:
                t = getattr(e, "self_device_time_total", None)
                total += getattr(e, "self_cuda_time_total", 0) if t is None else t
        check(total > 0, f"torch.profiler saw no device time for {match or 'the calls'}")
        out[name] = total / 1e3 / iters
    return out


def device_ms(fn, iters, match=""):
    """Mean device milliseconds per call of ``fn()`` (``profile_device``)."""
    return profile_device(fn, iters, {"t": match})["t"]


def device_samples(fn, iters, match=""):
    """Device milliseconds of each kernel or copy whose name holds ``match``
    over ``iters`` calls of ``fn()`` (torch.profiler, ``profiled``)."""
    prof = profiled(fn, iters)
    ms = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
          if str(e.device_type).endswith("CUDA") and match in e.name]
    check(len(ms) >= iters, f"torch.profiler saw {len(ms)} of {iters} calls of "
          f"{match or 'the copy'}")
    return ms


class EarlierKernels:
    """The parent commit's refine kernel and tile copy, built with nvcc from
    a checkout of it (``--earlier DIR``, only read) into this checkout's
    build directory, keyed by the source's hash, and bound through the C entry
    points that commit has (``pointrend_refine_launch(phase, grid, up, thr,
    feat, coarse, packed, out, points, count, n, h2, w2, hc, wc, F, num_fc,
    sf, stream)`` on ``pack_weights``' layout, the entry of every commit
    since the kernel's redesign, ``tile_copy_launch(x, out, n, h, w, stream)``,
    ``gated_tile_copy_launch(x, thr, out, n, h, w, F, D, stream)``), and
    its int8 convolution (``int8_conv_launch(dtype, x, scratch, map,
    w_scale, out, plan, stream)`` with ``int8_weight_map(wq, o, k, map)``
    and ``int8_max_clusters(split)``, the entries of every commit since the
    ``wgmma`` redesign, on this checkout's launch plan and scratch, which
    ``start`` first holds equal to the parent's: ``INT8_PY``, ``INT8_C``), for A/B
    timing in the same process on the same inputs.  ``start`` launches the
    three compilers; the constructor waits for them."""

    SOURCES = ("pointrend_refine", "refine_profile", "int8_conv")
    # what int8_conv takes from this checkout for the parent's entry: the
    # plan and scratch of ops/int8_conv.py, and the C struct and entries
    # that read them
    INT8_PY = ("BM", "MAX_SPLIT", "REDUCE_BLOCKS", "_DTYPES", "Plan", "plan", "_tile_width",
               "output_size", "_scratch")
    INT8_C = {"ConvPlan": r"struct ConvPlan \{[^}]*\};",
              "int8_conv_launch": r"int int8_conv_launch\([^)]*\)",
              "int8_weight_map": r"int int8_weight_map\([^)]*\)",
              "int8_max_clusters": r"int int8_max_clusters\([^)]*\)"}

    @staticmethod
    def int8_layout(root):
        """``INT8_PY``'s and ``INT8_C``'s parts of the checkout at ``root``
        by name: the Python definitions as ASTs without docstrings, the C
        text with its whitespace folded (None where a part is missing)."""
        import ast
        import re

        def dump(node):
            body = getattr(node, "body", None)
            if (isinstance(node, (ast.FunctionDef, ast.ClassDef)) and body
                    and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant)):
                node.body = body[1:]
            return ast.dump(node)

        base = os.path.join(root, "empanada_tpu_torch")
        with open(os.path.join(base, "ops", "int8_conv.py")) as f:
            tree = ast.parse(f.read())
        py = {}
        for node in tree.body:
            names = ([node.name] if isinstance(node, (ast.FunctionDef, ast.ClassDef)) else
                     [t.id for t in getattr(node, "targets", []) if isinstance(t, ast.Name)])
            for name in names:
                py[name] = dump(node)
        with open(os.path.join(base, "csrc", "int8_conv.cu")) as f:
            cu = " ".join(f.read().split())
        parts = {n: py.get(n) for n in EarlierKernels.INT8_PY}
        for name, pattern in EarlierKernels.INT8_C.items():
            m = re.search(pattern, cu)
            parts[name] = m.group(0) if m else None
        return parts

    @staticmethod
    def start(root):
        from empanada_tpu_torch.ops import _build

        here = os.path.dirname(os.path.abspath(__file__))
        ours, theirs = EarlierKernels.int8_layout(here), EarlierKernels.int8_layout(root)
        differ = [n for n in ours if ours[n] != theirs[n]]
        check(not differ, f"--earlier: the parent's int8 launch plan, scratch or entries "
              f"differ from this checkout's ({', '.join(differ)}); bind the parent's in "
              "EarlierKernels.int8_conv")
        os.makedirs(_build.BUILD, exist_ok=True)
        procs = {}
        for name in EarlierKernels.SOURCES:
            src = os.path.join(root, "empanada_tpu_torch", "csrc", f"{name}.cu")
            check(os.path.isfile(src), f"--earlier: {src} not found")
            so = os.path.join(_build.BUILD,
                              f"libearlier_{name}-{_build.source_digest(src)}.so")
            proc = None
            if not os.path.isfile(so):
                proc = subprocess.Popen(
                    [_build._nvcc(), *_build.NVCC_FLAGS, "-o", f"{so}.{os.getpid()}.tmp", src],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            procs[name] = (so, proc)
        return procs

    def __init__(self, procs):
        import ctypes

        libs = {}
        for name, (so, proc) in procs.items():
            if proc is not None:
                log = proc.communicate()[0]
                check(proc.returncode == 0, f"--earlier: nvcc failed for {name}:\n{log}")
                os.replace(f"{so}.{os.getpid()}.tmp", so)
            libs[name] = ctypes.CDLL(so)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        self._refine = libs["pointrend_refine"].pointrend_refine_launch
        self._refine.restype = ci
        self._refine.argtypes = [ci] * 2 + [vp] * 8 + [ci] * 8 + [vp]
        self._refine_blocks = libs["pointrend_refine"].pointrend_refine_blocks_per_sm
        self._refine_blocks.restype = ci
        self._refine_blocks.argtypes = [ci] * 2
        self._packed = {}
        self._copy = libs["refine_profile"].tile_copy_launch
        self._copy.restype = ci
        self._copy.argtypes = [vp] * 2 + [ci] * 3 + [vp]
        self._gated = libs["refine_profile"].gated_tile_copy_launch
        self._gated.restype = ci
        self._gated.argtypes = [vp] * 3 + [ci] * 5 + [vp]
        self._int8 = libs["int8_conv"].int8_conv_launch
        self._int8.restype = ci
        self._int8.argtypes = [ci] + [vp] * 7
        self._int8_map = libs["int8_conv"].int8_weight_map
        self._int8_map.restype = ci
        self._int8_map.argtypes = [vp, ci, ctypes.c_longlong, vp]
        self._int8_clusters = libs["int8_conv"].int8_max_clusters
        self._int8_clusters.restype = ci
        self._int8_clusters.argtypes = [ci]
        self._maps = {}
        self._cards = {}

    @staticmethod
    def _stream(t):
        import torch

        return torch.cuda.current_stream(t.device).cuda_stream

    def refine(self, up, thr, feats, coarse, wts):
        """The parent's whole step (its select pass and "refine_kernel<2>")
        on the head's fused or packed weights."""
        import torch

        from empanada_tpu_torch.ops import pointrend_refine as prr

        if isinstance(wts, prr.PackedWeights):
            packed = wts
        else:  # packed once per weights object, outside the timed calls' work
            if id(wts) not in self._packed:
                self._packed[id(wts)] = (wts, prr.pack_weights(wts))
            packed = self._packed[id(wts)][1]
        n, h2, w2, _ = up.shape
        _, hc, wc, fdim = feats.shape
        phase = prr.PHASES["full"]
        grid = (self._refine_blocks(phase, fdim)
                * torch.cuda.get_device_properties(up.device).multi_processor_count)
        out = torch.empty_like(up)
        points = torch.empty(n * h2 * w2, dtype=torch.int32, device=up.device)
        count = torch.zeros(1, dtype=torch.int32, device=up.device)
        err = self._refine(phase, grid, up.data_ptr(), thr.data_ptr(), feats.data_ptr(),
                           coarse.data_ptr(), packed.buf.data_ptr(), out.data_ptr(),
                           points.data_ptr(), count.data_ptr(), n, h2, w2, hc, wc, fdim,
                           packed.num_fc, h2 // hc, self._stream(up))
        check(err == 0, f"earlier refine launch failed: CUDA error {err}")
        return out

    def tile_copy(self, x):
        """The parent's tile copy (its kernel: "tile_copy_kernel(")."""
        import torch

        out = torch.empty_like(x)
        n, h, w = x.shape
        err = self._copy(x.data_ptr(), out.data_ptr(), n, h, w, self._stream(x))
        check(err == 0, f"earlier tile copy launch failed: CUDA error {err}")
        return out

    def gated_tile_copy(self, x, thr, reserve=None):
        """The parent's gated copy, with the refine kernel's shared memory
        reserved for ``reserve`` = (F, D) or none (its kernels:
        "gated_tile_copy_kernel<true>" and "<false>")."""
        import torch

        out = torch.empty_like(x)
        n, h, w = x.shape
        fdim, dfc = reserve if reserve is not None else (0, 0)
        err = self._gated(x.data_ptr(), thr.data_ptr(), out.data_ptr(), n, h, w, fdim, dfc,
                          self._stream(x))
        check(err == 0, f"earlier gated copy launch failed: CUDA error {err}")
        return out

    def int8_conv(self, x, wq, w_scale, stride, dil):
        """The parent's whole int8 call (absmax, quantize, its GEMM
        "gemm_kernel") on a channels_last x, 3 x 3 weights, padding =
        dilation, through the entry every commit since the kernel's
        redesign has: ``ops/int8_conv.py``'s ``plan`` and ``_scratch``,
        which ``start`` held equal to the parent's, on the parent's own
        cluster occupancy."""
        import ctypes

        import torch

        from empanada_tpu_torch.ops import int8_conv as ic

        x = x.contiguous(memory_format=torch.channels_last)
        wq = wq.contiguous(memory_format=torch.channels_last)
        w_scale = w_scale.contiguous()
        n, c, h, w = x.shape
        o = wq.shape[0]
        shape = (n, h, w, c, o, 3, 3, stride, dil, dil)
        if x.device not in self._cards:
            with torch.cuda.device(x.device):
                clusters = tuple(self._int8_clusters(s) for s in range(1, ic.MAX_SPLIT + 1))
            check(min(clusters) >= 1, f"earlier int8 cluster query failed: {clusters}")
            self._cards[x.device] = (
                torch.cuda.get_device_properties(x.device).multi_processor_count, clusters)
        p = ic.plan(*shape, *self._cards[x.device])
        out = torch.empty((n, o, p.ho, p.wo), dtype=x.dtype, device=x.device,
                          memory_format=torch.channels_last)
        scratch = ic._scratch(x)
        key = (wq.data_ptr(), o, 9 * c)
        if key not in self._maps:  # a TMA map holds the address, not the values
            self._maps[key] = ctypes.create_string_buffer(128)
            err = self._int8_map(wq.data_ptr(), o, 9 * c, self._maps[key])
            check(err == 0, f"earlier int8 weight map failed: CUDA error {err}")
        err = self._int8(ic._DTYPES[x.dtype], x.data_ptr(), scratch.data_ptr(), self._maps[key],
                         w_scale.data_ptr(), out.data_ptr(), (ctypes.c_int * len(p))(*p),
                         self._stream(x))
        check(err == 0, f"earlier int8 conv launch failed: CUDA error {err}")
        return out


def clustered(up):
    """``up`` with every pixel outside one 16 x 128 tile of each image (tile
    b mod the tile count in image b) set to 64, and the threshold 32: the
    selected pixels are that tile's, the worst case of a schedule that gives
    each output tile one block."""
    import torch

    from empanada_tpu_torch.ops.pointrend_refine import TILE_H, TILE_W

    n, h, w, _ = up.shape
    ntx = -(-w // TILE_W)
    out = torch.full_like(up, 64.0)
    for b in range(n):
        q = b % (-(-h // TILE_H) * ntx)
        r0, c0 = q // ntx * TILE_H, q % ntx * TILE_W
        out[b, r0:r0 + TILE_H, c0:c0 + TILE_W] = up[b, r0:r0 + TILE_H, c0:c0 + TILE_W]
    return out, torch.full((n,), 32.0, device=up.device)


def bound(nbytes, flops=0.0, flop_rate=BF16_FLOP_PER_S):
    """Least time (ms) of a function that moves ``nbytes`` and does
    ``flops`` at ``flop_rate``: (bound_ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def abs_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def compare_cut(got, want, up, thr):
    """A refine cut against its plain version: skipped pixels bit-exact
    (copied through); selected pixels within one bf16 rounding of a float32
    channel sum taken in another order (rtol 2^-7, atol 1e-3)."""
    import torch

    mask = up.float().abs() <= thr[:, None, None, None]
    check(torch.equal(got[~mask], up[~mask]), "cut: skipped pixels differ from up")
    g, w = got[mask].float(), want[mask].float()
    check(bool(torch.isfinite(g).all()), "cut output not finite")
    bad = (g - w).abs() > 2.0 ** -7 * w.abs() + 1e-3
    check(not bad.any(), f"cut: {int(bad.sum())} selected pixels off, max |err| "
          f"{abs_err(g, w):.4g}")
    return abs_err(g, w)


def refine_profile(prr, rp, gen, head, dev, earlier):
    """Phase 4: the profiling kernels at B = 8, sf = 4, MitoNet_v1's point
    head.  Returns (kernel entries for the JSON line, the times' dict)."""
    import statistics

    import torch

    bf16 = torch.bfloat16
    wts = head.fused_weights(256)
    packed = head.packed_weights(256)
    feats = torch.randn(8, 128, 128, 256, generator=gen).to(dev, bf16)
    coarse = (1.5 * torch.randn(8, 128, 128, 1, generator=gen)).to(dev, bf16)
    sem = (1.5 * torch.randn(8, 256, 256, 1, generator=gen)).to(dev, bf16)
    up, thr_k = prr.step_inputs(sem, K_POINTS)
    skip = torch.full_like(thr_k, -1.0)
    refine = torch.full_like(thr_k, float("inf"))
    x = up[..., 0]
    reserve = (256, 256)
    errs = {"tile_copy": 0.0, "gated_tile_copy": 0.0, "refine_gather": 0.0,
            "refine_interp": 0.0}

    # each kernel against its plain version (these launches are not counted):
    # the gated copy bit for bit, unreserved and reserved at MitoNet_v1's
    # and the mini's widths, on B = 8, ragged
    # images with and without 16-byte rows, one image and edge values
    # (subnormals, values that double to inf, inf, -0), each launcher's
    # grid against gated_plan's
    ragged = torch.randn(2, 300, 700, generator=gen).to(dev, bf16)
    edges = torch.tensor([1e-40, -1e-40, 3.3e38, -3.3e38, float("inf"), -0.0, 0.0, 2.0])
    edges = edges.repeat(2 * 64 * 64).reshape(2, 64, 512).to(dev, bf16)
    reserves = (None, reserve, (160, 160))
    aligned = torch.randn(3, 40, 264, generator=gen).to(dev, bf16)  # 16-byte rows, edge tiles
    for t, th in ((x, thr_k), (ragged, torch.tensor([0.01, -1.0], device=dev)),
                  (aligned, torch.tensor([0.02, -1.0, 0.5], device=dev)),
                  (x[:1].contiguous(), thr_k[:1].contiguous()),
                  (edges, torch.tensor([0.0, 1e-3], device=dev))):
        check(torch.equal(rp.tile_copy(t), rp.tile_copy_reference(t)), "tile_copy differs")
        for res in reserves:
            info = rp.gated_launch_info(dev, *t.shape, res)
            plan = rp.gated_plan(*t.shape, info["blocks_per_sm"], info["sms"])[0]
            check(info["grid"] == plan, f"gated copy grid {info['grid']}, plan {plan} "
                  f"({tuple(t.shape)}, reserve={res})")
        for thr in (th, torch.full_like(th, -1.0), torch.full_like(th, float("inf"))):
            want = rp.gated_tile_copy_reference(t, thr).view(torch.int16)
            for res in reserves:
                got = rp.gated_tile_copy(t, thr, res).view(torch.int16)
                check(torch.equal(got, want),
                      f"gated_tile_copy differs ({tuple(t.shape)}, reserve={res})")
    for thr in (thr_k, refine):
        for phase in ("gather", "interp"):
            fn = rp.refine_gather if phase == "gather" else rp.refine_interp
            got = fn(up, thr, feats, coarse, packed)
            want = rp.refine_phase_reference(phase, up, thr, feats, coarse)
            torch.cuda.synchronize()
            errs[f"refine_{phase}"] = max(errs[f"refine_{phase}"],
                                          compare_cut(got, want, up, thr))
    print("refine profile: every kernel agrees with its plain version "
          f"(max |err| {json.dumps(errs)})", flush=True)

    # the profiling path: times on the card, launches counted.  Each item is
    # timed twice: CUDA events around back-to-back calls (event_ms: what a
    # caller waits, host overhead included when a call is shorter than its
    # launch) and torch.profiler's device time per call (device_ms: of the
    # kernels whose name holds the match, "" = every device activity)
    for k in rp.launches:
        rp.launches[k] = 0
    prr.launches.update(gather=0, interp=0)
    xs = [x.clone() for _ in range(8)]  # 8 x 4.2 MB in, as much out: past L2
    cyc = itertools.cycle(xs)
    n_px = x.numel()
    feat_bytes = feats.numel() * 2
    items = {
        "copy_plain": (lambda: rp.tile_copy_reference(next(cyc)), 50, ""),
        "gated_plain": (lambda: rp.gated_tile_copy_reference(next(cyc), refine), 5, ""),
    }
    for phase, fn, kname in (("gather", rp.refine_gather, "refine_kernel<0"),
                             ("interp", rp.refine_interp, "refine_kernel<1")):
        items[f"{phase}_refine"] = (lambda fn=fn: fn(up, refine, feats, coarse, packed), 20,
                                    kname)
        items[f"{phase}_plain"] = (lambda phase=phase: rp.refine_phase_reference(
            phase, up, refine, feats, coarse), 2, "")
    # the whole step's plain version at all-skip and all-refine (rows 2b, 3)
    for name, thr, iters in (("full_skip_plain", skip, 3), ("full_refine_plain", refine, 2)):
        items[name] = (lambda thr=thr: prr.refine_reference(up, thr, feats, coarse, packed),
                       iters, "")
    t = {}
    for name, (fn, iters, match) in items.items():
        t[name] = {"event_ms": cuda_ms(fn, iters, warmup=1),
                   "device_ms": device_ms(fn, iters, match)}
    # the whole step: select and refine passes apart, and the parent's
    # kernel where --earlier gave it
    passes = {"select_ms": "select_kernel", "refine_ms": "refine_kernel<2>", "all_ms": ""}
    for name, thr, iters in (("full_skip", skip, 20), ("full_refine", refine, 5)):
        t[name] = profile_device(lambda thr=thr: prr.launch_phase(
            "full", up, thr, feats, coarse, packed), iters, passes)
        t[name]["device_ms"] = t[name]["select_ms"] + t[name]["refine_ms"]
        if earlier is not None:
            t[f"{name}_earlier"] = {"device_ms": device_ms(
                lambda thr=thr: earlier.refine(up, thr, feats, coarse, wts), iters,
                "refine_kernel<2>")}
    # the tile copy against copy_: medians of 30 calls' device times, each
    # form in two rounds, in turns
    forms = {"copy_library": (lambda: torch.empty_like(x).copy_(next(cyc)), ""),
             "copy": (lambda: rp.tile_copy(next(cyc)), "tile_copy_kernel(")}
    if earlier is not None:
        forms["copy_earlier"] = (lambda: earlier.tile_copy(next(cyc)), "tile_copy_kernel(")
    samples = {k: [] for k in forms}
    for _ in range(2):
        for name, (fn, match) in forms.items():
            samples[name] += device_samples(fn, 30, match)
    for name, ms in samples.items():
        t[name] = {"device_ms": statistics.median(ms), "calls": len(ms)}
    # the gated copies at all-skip and all-refine, unreserved and reserved:
    # this kernel and the parent's where --earlier gave it (each profiled
    # alone, so the match is the instantiation's prefix, whatever template
    # parameters follow); medians of 30 calls' device times, two rounds, the
    # second in reverse order
    gated = {}
    for name, thr in (("skip", skip), ("refine", refine)):
        for rname, res in (("", None), ("_reserved", reserve)):
            match = f"gated_tile_copy_kernel<{'true' if res else 'false'}"
            gated[f"gated_{name}{rname}"] = (
                lambda thr=thr, res=res: rp.gated_tile_copy(next(cyc), thr, res), match, res)
            if earlier is not None:
                gated[f"gated_{name}{rname}_earlier"] = (
                    lambda thr=thr, res=res: earlier.gated_tile_copy(next(cyc), thr, res),
                    match, res)
    samples = {k: [] for k in gated}
    for order in (list(gated), list(gated)[::-1]):
        for name in order:
            samples[name] += device_samples(gated[name][0], 30, gated[name][1])
    for name, ms in samples.items():
        t[name] = {"device_ms": statistics.median(ms), "calls": len(ms)}
    torch.cuda.synchronize()
    launches = dict(rp.launches, refine_gather=prr.launches["gather"],
                    refine_interp=prr.launches["interp"])
    check(all(v > 0 for v in launches.values()), f"profiling kernels not launched: {launches}")

    # bounds: each input read once, each output written once; at all-refine
    # every feature pixel is a tap of some selected point
    copy_bytes = 2 * n_px * 2
    mlp_flop_pt = 2 * 257 * 256 + 2 * (2 * 257 * 256) + 2 * 257  # F = D = 256
    n_weights = sum(q.numel() for layer in wts[0] for q in layer) + 2 + wts[1][0].numel()
    b = {
        "copy": bound(copy_bytes),
        "gated": bound(copy_bytes + thr_k.numel() * 4),
        "full_skip": bound(copy_bytes + thr_k.numel() * 4),
        "full_refine": bound(copy_bytes + feat_bytes + coarse.numel() * 2 + n_weights * 2,
                             n_px * mlp_flop_pt),
        "gather": bound(copy_bytes + feat_bytes, n_px * 256, FP32_FLOP_PER_S),
        # three lerps (2 mul + 1 add each) and the channel sum, per channel
        "interp": bound(copy_bytes + feat_bytes + coarse.numel() * 2, n_px * 256 * 10,
                        FP32_FLOP_PER_S),
    }
    t["bounds_ms"] = {k: v[0] for k, v in b.items()}
    t["bound_by"] = {k: v[1] for k, v in b.items()}
    # each gated copy: ms, the parent's, the bound and its share, the grid
    summary = {}
    for key, (_, _, res) in gated.items():
        if key.endswith("_earlier"):  # the parent's: beside this kernel's entry
            continue
        info = rp.gated_launch_info(dev, *x.shape, res)
        parent = t.get(key + "_earlier", {}).get("device_ms")
        summary[key] = {"ms": t[key]["device_ms"], "earlier_ms": parent,
                        "bound_ms": b["gated"][0],
                        "share_of_bound": b["gated"][0] / t[key]["device_ms"],
                        "earlier_share_of_bound": b["gated"][0] / parent if parent else None,
                        "grid": info["grid"], "blocks_per_sm": info["blocks_per_sm"]}
    print("refine profile: gated copies " + json.dumps(summary), flush=True)
    # the MLP's rate at all-refine: its FLOPs over the refine pass less the
    # interpolation cut (both after the same select pass)
    mlp_ms = t["full_refine"]["refine_ms"] - t["interp_refine"]["device_ms"]
    t["mlp_tflops_all_refine"] = n_px * mlp_flop_pt / mlp_ms / 1e9
    t["step_tflops_all_refine"] = n_px * mlp_flop_pt / t["full_refine"]["device_ms"] / 1e9
    t["launches"] = launches
    t["tile_share_kth"] = tile_share(up, thr_k)
    src = "empanada_tpu_torch/csrc/refine_profile.cu"
    cut_src = "empanada_tpu_torch/csrc/pointrend_refine.cu"
    entries = [
        dict(name="tile_copy", route="cuda", source=src,
             replaces="benchmarks/profile_overhead.py:24", launches=launches["tile_copy"],
             max_abs_err=errs["tile_copy"], ms=t["copy"]["device_ms"],
             plain_ms=t["copy_plain"]["device_ms"], bound_ms=b["copy"][0],
             bound_by=b["copy"][1], library_ms=t["copy_library"]["device_ms"],
             earlier_ms=t["copy_earlier"]["device_ms"] if earlier is not None else None,
             per=f"(8, 512, 512) bf16, median of {t['copy']['calls']} calls"),
        dict(name="gated_tile_copy", route="cuda", source=src,
             replaces="benchmarks/profile_overhead.py:27", launches=launches["gated_tile_copy"],
             max_abs_err=errs["gated_tile_copy"], ms=t["gated_refine"]["device_ms"],
             plain_ms=t["gated_plain"]["device_ms"], bound_ms=b["gated"][0],
             bound_by=b["gated"][1], library_ms=None,
             earlier_ms=t["gated_refine_earlier"]["device_ms"] if earlier is not None else None,
             per=f"(8, 512, 512) bf16, every tile gated, no reservation, "
                 f"{rp.GATED_TILES} tiles a group, median of {t['gated_refine']['calls']} calls"),
        dict(name="refine_gather", route="cuda", source=cut_src,
             replaces="benchmarks/profile_refine_parts.py:36", launches=launches["refine_gather"],
             max_abs_err=errs["refine_gather"], ms=t["gather_refine"]["device_ms"],
             plain_ms=t["gather_plain"]["device_ms"], bound_ms=b["gather"][0],
             bound_by=b["gather"][1],
             library_ms=None, per="B = 8, 512 x 512 from 128 x 128 x 256, all-refine, "
                                  "refine pass only"),
        dict(name="refine_interp", route="cuda", source=cut_src,
             replaces="benchmarks/profile_refine_parts.py:36", launches=launches["refine_interp"],
             max_abs_err=errs["refine_interp"], ms=t["interp_refine"]["device_ms"],
             plain_ms=t["interp_plain"]["device_ms"], bound_ms=b["interp"][0],
             bound_by=b["interp"][1],
             library_ms=None, per="B = 8, 512 x 512 from 128 x 128 x 256, all-refine, "
                                  "refine pass only"),
    ]
    return entries, t


def blob_volume(shape, n_blobs, seed):
    """Seeded EM-like uint8 volume: dark 3D Gaussian blobs on noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    vol = rng.normal(0.5, 0.08, size=shape).astype(np.float32)
    for _ in range(n_blobs):
        c = [rng.integers(0, s) for s in shape]
        sig = [rng.uniform(2, 6)] + [rng.uniform(min(shape[1:]) * 0.015,
                                                 min(shape[1:]) * 0.04)] * 2
        lo = [max(0, int(ci - 3 * si)) for ci, si in zip(c, sig)]
        hi = [min(s, int(ci + 3 * si) + 1) for s, ci, si in zip(shape, c, sig)]
        grids = np.ogrid[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
        d2 = sum((g - ci) ** 2 / (2 * si ** 2) for g, ci, si in zip(grids, c, sig))
        vol[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] -= 0.4 * np.exp(-d2)
    return (np.clip(vol, 0, 1) * 255).astype(np.uint8)


def sweep_3d(prr, engine, vol, fused, n_timed=3):
    """Phase 7 at one batch size: a warm-up sweep that keeps the first
    batch's inputs of both refine steps (the kernel is then held against its
    plain version on them, which takes the point head's ``fused`` weights),
    timed sweeps (the refine launches counted over the last), then one under
    torch.profiler for the device's busy time."""
    import warnings

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    launch, captured = prr.launch, []

    def keep_inputs(*args):
        if len(captured) < 2:
            captured.append(args)
        return launch(*args)

    prr.launch = keep_inputs
    try:
        engine.infer_on_axis(vol, "xy")
    finally:
        prr.launch = launch
    check(len(captured) == 2,
          f"3D: the warm-up sweep kept {len(captured)} refine steps' inputs, not 2")
    checks = []
    for sf, (up, thr, feats, coarse, packed) in zip((2, 4), captured):
        err, share = compare_refine(prr, up, thr, feats, coarse, packed, fused)
        checks.append({"sf": sf, "shape": list(up.shape), "max_abs_err": err,
                       "refined_share": share})
        print(f"kernel vs plain on a 3D batch's real inputs: N={len(up)} sf={sf}: "
              f"refined {share:.4f}, max |err| {err:.4g}", flush=True)
    del captured
    walls = []
    for _ in range(n_timed):
        prr.launches["full"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stack, trackers = engine.infer_on_axis(vol, "xy")
        walls.append(time.perf_counter() - t0)
        launches = prr.launches["full"]
    stages = engine.last_timing
    b = engine.last_batch_size
    n_batches = -(-vol.shape[0] // b)
    check(launches == 2 * n_batches,
          f"3D B={b}: refine launched {launches} times for {n_batches} batches")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.infer_on_axis(vol, "xy")
        torch.cuda.synchronize()
    busy = 0.0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            t = getattr(e, "self_device_time_total", None)
            busy += (getattr(e, "self_cuda_time_total", 0) if t is None else t) / 1e6
    # calls that make the host wait for the card (torch's sync debug mode
    # warns on each: blocking copies, .item(), event waits)
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        engine.infer_on_axis(vol, "xy")
    torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    wall = sorted(walls)[len(walls) // 2]
    n_inst = sum(len(t.instances) for t in trackers)
    check(n_inst > 0, f"3D B={b}: no instance tracked")
    check(stack is not None and stack.shape == vol.shape and stack.dtype.name == "int32",
          "3D: filled panoptic stack missing or malformed")
    ids = np.unique(stack[stack > 0])
    check(np.isin(ids, list(trackers[0].instances)).all(),
          "3D: the filled stack holds ids that no tracker has")
    return {"batch": b, "n_batches": n_batches, "refine_launches": launches,
            "path": "fused" if engine.last_fused else "streamed",
            "resident": engine._resident is not None, "fallbacks": engine.fallbacks,
            "kernel_vs_plain": checks,
            "wall_s": walls, "slices_per_s": vol.shape[0] / wall,
            "mvox_per_s": vol.size / wall / 1e6, "instances": n_inst,
            "dropped_centers": engine.last_overflow,
            "device_busy_s": busy if busy > 0 else "not measured",
            "device_busy_share": busy / wall if busy > 0 else "not measured",
            "host_syncs_per_batch": syncs / n_batches,
            "stages_s": {k: v["total_s"] for k, v in stages.items()}}


def f32_volume_check(cfg, engine_kw, MultiChipEngine3d, Engine3d, init_model):
    """Phase 7, float32: a 16 x 256 x 256 volume.  The batched engine's
    per-slice maps against PanopticDeepLabRenderEngine3d's on the card (the
    same normalised slices), and the filled stack against a CPU run."""
    import numpy as np
    import torch

    vol = blob_volume((16, 256, 256), 20, seed=11)
    gpu_model = init_model(cfg, seed=1, device="cuda", dtype=torch.float32)
    cpu_model = init_model(cfg, seed=1, device="cpu", dtype=torch.float32)
    eng = MultiChipEngine3d(cfg, gpu_model, **engine_kw)
    maps = []
    post = eng._post_windows  # the postprocess of a batch on every path

    def keep_maps(*args, **kw):
        out = post(*args, **kw)
        maps.append(out[0].cpu())
        return out

    eng._post_windows = keep_maps
    stack_gpu, _ = eng.infer_on_axis(vol, "xy")
    batched = torch.cat(maps)[:len(vol)].numpy()

    e3 = Engine3d(gpu_model, median_kernel_size=eng.ks, thing_list=cfg["thing_list"],
                  label_divisor=eng.label_divisor, stuff_area=eng.stuff_area,
                  void_label=eng.void_label, nms_threshold=eng.nms_threshold,
                  nms_kernel=eng.nms_kernel, confidence_thr=eng.confidence_thr,
                  padding_factor=eng.padding_factor, max_centers=eng.max_centers)
    with torch.no_grad():
        xs = eng.normalize(torch.from_numpy(vol).cuda(), 255.0)[..., 0].cpu().numpy()
    ref = [m for m in (e3(x[None], x.shape) for x in xs) if m is not None] + e3.end()
    ref = np.stack(ref)
    same = float((batched == ref).mean())
    check(same == 1.0, f"f32 3D: batched maps agree with the render engine on {same:.6f} "
          "of pixels, not all")
    stack_cpu, _ = MultiChipEngine3d(cfg, cpu_model, device="cpu",
                                     **engine_kw).infer_on_axis(vol, "xy")
    agree = float((stack_gpu == stack_cpu).mean())
    check(agree >= 0.999, f"f32 3D: card and CPU stacks agree on {agree:.5f} of voxels")
    return {"path": "fused" if eng.last_fused else "streamed",
            "maps_equal_share": same, "maps_differing_pixels": int((batched != ref).sum()),
            "stack_card_vs_cpu_share": agree,
            "instances_card": len(np.unique(stack_gpu)) - 1,
            "instances_cpu": len(np.unique(stack_cpu)) - 1}


def union_mask(shape, trackers):
    """Boolean volume of every voxel that some tracker's instance holds."""
    import numpy as np

    from empanada_tpu_torch.core.rle import numpy_fill_instances

    painted = np.zeros(shape, dtype=np.int32)
    for axis_trackers in trackers.values():
        for tracker in axis_trackers:
            numpy_fill_instances(painted, tracker.instances)  # ids are > 0
    return painted > 0


def axis_hooks(engine, on_enter, on_exit=None):
    """Wrap the engine's per-axis dispatch (``_sweep_device`` of the fused
    and pipelined paths, ``_infer_streamed`` of the streamed one) so that
    ``on_enter(axis)`` runs before and ``on_exit(axis)`` after it; returns
    the function that removes the wrappers."""
    originals = {name: getattr(engine, name) for name in ("_sweep_device", "_infer_streamed")}

    def wrap(fn):
        def hooked(volume, axis_name, *args, **kw):
            on_enter(axis_name)
            try:
                return fn(volume, axis_name, *args, **kw)
            finally:
                if on_exit is not None:
                    on_exit(axis_name)
        return hooked

    for name, fn in originals.items():
        setattr(engine, name, wrap(fn))
    return lambda: [delattr(engine, name) for name in originals]


def ortho_run(prr, api, engine, cfg, vol):
    """One ortho request: the three sweeps, then the consensus of each
    class (filtered by the engine's ``min_size`` and ``min_extent``, as the
    CLI does).  Returns (trackers, outputs, sweeps_s, consensus_s, refine steps
    launched per axis)."""
    import torch

    per_axis, before = {}, {}

    def enter(axis):
        before[axis] = prr.launches["full"]

    def leave(axis):
        per_axis[axis] = prr.launches["full"] - before[axis]

    unhook = axis_hooks(engine, enter, leave)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trackers = engine.infer_orthoplane(vol)
        t1 = time.perf_counter()
        outs = list(api.tracker_consensus(trackers, None, cfg, pixel_vote_thr=2,
                                          cluster_iou_thr=0.75, min_size=engine.min_size,
                                          min_extent=engine.min_extent))
        t2 = time.perf_counter()
    finally:
        unhook()
    return trackers, outs, t1 - t0, t2 - t1, per_axis


def sync_sites(fn):
    """Calls that make the host wait for the card during ``fn()`` (torch's
    sync debug mode warns on each: blocking copies, ``.item()``, event
    waits), attributed to their call sites: per warning, the innermost
    frame of this repository on the stack and the port's frames above it.
    Returns (count, {site: count}) ordered by count."""
    import traceback
    import warnings

    import torch

    sites, n = {}, 0
    real_show = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        nonlocal n
        if "synchroniz" not in str(message):
            return
        n += 1
        frames = [f for f in traceback.extract_stack()[:-1]
                  if f.filename.startswith(HERE) and "empanada_tpu_torch" in f.filename]
        chain = " < ".join(f"{os.path.relpath(f.filename, HERE)}:{f.lineno} {f.name}"
                           for f in reversed(frames[-3:])) or f"{filename}:{lineno}"
        sites[chain] = sites.get(chain, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            warnings.showwarning = real_show
    return n, dict(sorted(sites.items(), key=lambda kv: -kv[1]))


def ortho_phase(prr, api, engine, cfg, vol, fused):
    """Phase 8 on the card for one engine (module docstring).  Returns (the
    ``ortho:`` record, the refine launches of one timed run)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from empanada_tpu_torch.utils import StageTimer

    t_phase = time.perf_counter()
    launch, captured, current = prr.launch, {}, [None]

    def keep_inputs(*args):
        kept = captured.setdefault(current[0], [])
        if current[0] != "xy" and len(kept) < 2:
            kept.append(args)
        return launch(*args)

    unhook = axis_hooks(engine, lambda axis: current.__setitem__(0, axis))
    prr.launch = keep_inputs
    try:
        engine.infer_orthoplane(vol)
    finally:
        prr.launch = launch
        unhook()
    checks = []
    for axis in ("xz", "yz"):
        check(len(captured.get(axis, [])) == 2,
              f"ortho: the warm-up kept {len(captured.get(axis, []))} {axis} refine steps")
        for sf, (up, thr, feats, coarse, packed) in zip((2, 4), captured[axis]):
            err, share = compare_refine(prr, up, thr, feats, coarse, packed, fused)
            checks.append({"axis": axis, "sf": sf, "shape": list(up.shape),
                           "max_abs_err": err, "refined_share": share})
            print(f"kernel vs plain on an ortho batch's real inputs: {axis} "
                  f"N={len(up)} sf={sf}: refined {share:.4f}, max |err| {err:.4g}",
                  flush=True)
    del captured

    runs, fallbacks = [], engine.fallbacks
    for _ in range(2):
        prr.launches["full"] = 0
        runs.append(ortho_run(prr, api, engine, cfg, vol))
        launches = prr.launches["full"]
        stats = engine.last_axis_stats
    fallbacks = engine.fallbacks - fallbacks
    trackers, outs, _, _, per_axis = runs[-1]
    totals = sorted(r[2] + r[3] for r in runs)
    sweeps_s = sorted(r[2] for r in runs)[len(runs) // 2]
    consensus_s = sorted(r[3] for r in runs)[len(runs) // 2]
    axes = {}
    for axis, a in stats.items():
        n_slices = vol.shape[engine.axes[axis]]
        n_batches = -(-n_slices // a["batch"])
        check(per_axis[axis] == 2 * n_batches,
              f"ortho {axis}: refine launched {per_axis[axis]} times for {n_batches} batches")
        rec = {"batch": a["batch"], "n_batches": n_batches, "path": a["path"],
               "refine_launches": per_axis[axis],
               "instances": sum(len(t.instances) for t in trackers[axis]),
               "dropped_centers": a["dropped_centers"],
               "stages_s": {k: v["total_s"] for k, v in a["timing"].items()}}
        if "seconds" in a:  # a serial sweep
            rec.update(seconds=a["seconds"], slices_per_s=n_slices / a["seconds"])
        else:  # overlapping axes: the dispatch and the host half apart
            rec.update(dispatch_s=a["dispatch_s"], host_s=a["host_s"])
        axes[axis] = rec
        print(f"ortho {axis}: {a['path']}, auto batch {a['batch']}, {n_batches} batches",
              flush=True)
    check(launches == sum(per_axis.values()), "ortho: refine launches outside the sweeps")

    # the consensus: right shapes and types, and only voxels some sweep saw
    union = union_mask(vol.shape, trackers)
    for out_vol, name, instances in outs:
        check(out_vol.shape == vol.shape and out_vol.dtype == np.uint32,
              f"ortho consensus {name}: volume {out_vol.dtype} {out_vol.shape}")
        check(not (out_vol.astype(bool) & ~union).any(),
              f"ortho consensus {name}: voxels outside the union of the three sweeps")
        ids = np.unique(out_vol[out_vol > 0])
        check(np.isin(ids, list(instances)).all(), f"ortho consensus {name}: stray ids")
    n_consensus = sum(len(inst) for _, _, inst in outs)
    check(n_consensus > 0, "ortho: the consensus kept no instance")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.infer_orthoplane(vol)
        torch.cuda.synchronize()
    busy = 0.0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            t = getattr(e, "self_device_time_total", None)
            busy += (getattr(e, "self_cuda_time_total", 0) if t is None else t) / 1e6
    # host syncs of one xz sweep: the fused path's dispatch alone (its
    # host half waits once, on the copy's event), the streamed sweep whole
    if stats["xz"]["path"] == "pipelined":
        syncs, sites = sync_sites(lambda: engine._sweep_device(vol, "xz", StageTimer()))
    else:
        syncs, sites = sync_sites(lambda: engine.infer_on_axis(vol, "xz"))
    total = totals[len(totals) // 2]
    return {"volume": list(vol.shape), "mvox_per_s": vol.size / (sweeps_s + consensus_s) / 1e6,
            "sweeps_s": sweeps_s, "consensus_s": consensus_s,
            "runs_s": [[r[2], r[3]] for r in runs], "median_total_s": total,
            "yz_finish_s": stats["yz"]["timing"]["finish_tracking"]["total_s"],
            "axes": axes, "instances_consensus": n_consensus,
            "dropped_centers": engine.last_overflow, "fallbacks": fallbacks,
            "device_busy_s": busy if busy > 0 else "not measured",
            "device_busy_share": busy / sweeps_s if busy > 0 else "not measured",
            "host_syncs_per_batch_xz": syncs / axes["xz"]["n_batches"],
            "host_sync_sites_xz": sites,
            "kernel_vs_plain": checks,
            "phase_s": time.perf_counter() - t_phase}, launches


def f32_ortho_check(api, cfg, MultiChipEngine3d, init_model, engine_kw, paths):
    """Phase 8, float32: an 8 x 128 x 128 volume through infer_orthoplane
    and tracker_consensus on the card and on the CPU (same weights,
    ``fp32_strict``), once per path of ``paths`` (name -> engine knobs);
    the per-axis trackers and the consensus instances must be identical on
    the card and the CPU, and on the card over the paths."""
    import numpy as np
    import torch

    vol = blob_volume((8, 128, 128), 12, seed=13)
    models = {d: init_model(cfg, seed=1, device=d, dtype=torch.float32) for d in ("cuda", "cpu")}

    def same(a: dict, b: dict) -> bool:
        return list(a) == list(b) and all(
            tuple(a[k]["box"]) == tuple(b[k]["box"])
            and np.array_equal(a[k]["starts"], b[k]["starts"])
            and np.array_equal(a[k]["runs"], b[k]["runs"]) for k in a)

    recs, card = {}, {}
    for path, knobs in paths.items():
        results, n_inst = [], {}
        for device, model in models.items():
            eng = MultiChipEngine3d(cfg, model, device=device, **engine_kw, **knobs)
            t0 = time.perf_counter()
            trackers = eng.infer_orthoplane(vol)
            outs = list(api.tracker_consensus(trackers, None, cfg, pixel_vote_thr=2,
                                              cluster_iou_thr=0.75, device=device,
                                              **engine_kw))
            n_inst[device] = {"seconds": time.perf_counter() - t0,
                              "paths": {a: s["path"] for a, s in eng.last_axis_stats.items()},
                              "per_axis": {a: sum(len(t.instances) for t in trs)
                                           for a, trs in trackers.items()},
                              "consensus": sum(len(i) for _, _, i in outs)}
            results.append(([(a, t.instances) for a, trs in trackers.items() for t in trs],
                            [i for _, _, i in outs]))
        (card_tr, card_cons), (cpu_tr, cpu_cons) = results
        card[path] = results[0]
        same_axes = {a: same(x, y) for (a, x), (_, y) in zip(card_tr, cpu_tr)}
        same_cons = all(same(x, y) for x, y in zip(card_cons, cpu_cons))
        recs[path] = {"trackers_identical": same_axes, "consensus_identical": same_cons,
                      "card": n_inst["cuda"], "cpu": n_inst["cpu"]}
        check(all(same_axes.values()) and same_cons,
              f"f32 ortho {path}: the card's trackers or consensus differ from the CPU's")
        check(sum(n_inst["cpu"]["per_axis"].values()) > 0, "f32 ortho: no instance tracked")
    (first, (tr0, cons0)), *rest = card.items()
    across = {p: all(same(x, y) for (_, x), (_, y) in zip(tr0, tr)) and
              all(same(x, y) for x, y in zip(cons0, cons)) for p, (tr, cons) in rest}
    rec = {"volume": list(vol.shape), "paths": recs, f"card_same_as_{first}": across}
    print("f32 ortho: " + json.dumps(rec), flush=True)
    check(all(across.values()), f"f32 ortho: the paths' card results differ: {across}")
    return rec


def same_trackers(got, want) -> bool:
    """Two lists of trackers with equal instances: ids in the same order,
    boxes, starts and runs."""
    import numpy as np

    return len(got) == len(want) and all(
        list(g.instances) == list(w.instances) and all(
            tuple(g.instances[k]["box"]) == tuple(w.instances[k]["box"])
            and np.array_equal(g.instances[k]["starts"], w.instances[k]["starts"])
            and np.array_equal(g.instances[k]["runs"], w.instances[k]["runs"])
            for k in w.instances) for g, w in zip(got, want))


def resume_check(prr, cfg, model, MultiChipEngine3d, data_parallel):
    """Phase 9: a checkpointed xy sweep of a 24 x 256 x 256 volume at B = 4,
    crashed after 10 slices (a ``MatcherWorker`` that raises, as the tests
    crash it), then resumed on the card from its checkpoint directory; the
    resumed sweep's stack and trackers must equal an uninterrupted sweep's.
    Returns (the ``resume:`` record, refine launches of the resumed sweep)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    vol = blob_volume((24, 256, 256), 40, seed=17)
    kw = dict(batch_size=4, save_panoptic=True, min_size=64, min_extent=2)
    want_stack, want = MultiChipEngine3d(cfg, model, **kw).infer_on_axis(vol, "xy")
    real_worker, count = data_parallel.MatcherWorker, [0]

    class CrashWorker(real_worker):
        def put(self, item):
            if count[0] >= 10:
                raise RuntimeError("simulated crash")
            count[0] += 1
            return super().put(item)

    cdir = tempfile.mkdtemp(prefix="resume-", dir=os.path.join(HERE, "empanada_tpu_torch",
                                                               "build"))
    try:
        data_parallel.MatcherWorker = CrashWorker
        try:
            MultiChipEngine3d(cfg, model, **kw).infer_on_axis(vol, "xy", checkpoint_dir=cdir,
                                                              checkpoint_every=4)
            fail("resume: the crashing sweep did not crash")
        except RuntimeError as exc:
            check("simulated crash" in str(exc), f"resume: unexpected error {exc!r}")
        finally:
            data_parallel.MatcherWorker = real_worker
        segments = sorted(f for f in os.listdir(cdir) if f.startswith("forward_xy."))
        check(segments, "resume: the crashed sweep left no checkpoint")
        torch.cuda.synchronize()
        prr.launches["full"] = 0
        t0 = time.perf_counter()
        got_stack, got = MultiChipEngine3d(cfg, model, **kw).infer_on_axis(
            vol, "xy", checkpoint_dir=cdir, resume=True)
        seconds = time.perf_counter() - t0
        launches = prr.launches["full"]
        left = os.listdir(cdir)
    finally:
        shutil.rmtree(cdir, ignore_errors=True)
    same_stack = bool(np.array_equal(got_stack, want_stack))
    rec = {"volume": list(vol.shape), "batch": 4, "segments_after_crash": len(segments),
           "refine_launches_resumed": launches, "resumed_s": seconds,
           "stack_identical": same_stack, "trackers_identical": same_trackers(got, want),
           "instances": sum(len(t.instances) for t in got), "files_left": left}
    print("resume: " + json.dumps(rec), flush=True)
    check(same_stack and rec["trackers_identical"], "resume: the resumed sweep differs from "
          "the uninterrupted one")
    check(not left, f"resume: the finished sweep left {left}")
    check(launches > 0 and launches % 2 == 0, f"resume: {launches} refine launches")
    check(rec["instances"] > 0, "resume: no instance tracked")
    return rec, launches


def tile_blob_image(shape, n_blobs, seed):
    """Seeded EM-like uint8 image of any size: dark Gaussian blobs (sigma
    8-30 px) on noise, each blob computed in its own window."""
    import numpy as np

    rng = np.random.default_rng(seed)
    img = rng.normal(0.5, 0.08, size=shape).astype(np.float32)
    for _ in range(n_blobs):
        cy, cx = rng.integers(0, shape[0]), rng.integers(0, shape[1])
        sig = rng.uniform(8, 30)
        y0, y1 = max(0, int(cy - 3 * sig)), min(shape[0], int(cy + 3 * sig) + 1)
        x0, x1 = max(0, int(cx - 3 * sig)), min(shape[1], int(cx + 3 * sig) + 1)
        yy, xx = np.ogrid[y0:y1, x0:x1]
        img[y0:y1, x0:x1] -= 0.4 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig ** 2))
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def kept_steps(prr, fn, n):
    """``fn()`` with the refine wrapper keeping the inputs of its first
    ``n`` launches; returns (fn's result, the kept inputs)."""
    launch, kept = prr.launch, []

    def keep(*args):
        if len(kept) < n:
            kept.append(args)
        return launch(*args)

    prr.launch = keep
    try:
        out = fn()
    finally:
        prr.launch = launch
    check(len(kept) == n, f"kept {len(kept)} refine steps' inputs, not {n}")
    return out, kept


def hold_steps(prr, kept, fused, label):
    """The kernel against its plain version on kept step inputs (the mask
    and copied pixels bit-exact; every refined logit within one bf16 step,
    2^-7 max(1, |logit|), of the plain one).  Returns the records."""
    recs = []
    for up, thr, feats, coarse, packed in kept:
        sf = up.shape[1] // feats.shape[1]
        err, share = compare_refine(prr, up, thr, feats, coarse, packed, fused, strict=True)
        recs.append({"sf": sf, "shape": list(up.shape), "features": list(feats.shape),
                     "max_abs_err": err, "refined_share": share})
        print(f"kernel vs plain on {label}: N={len(up)} sf={sf} up {tuple(up.shape[1:3])}: "
              f"refined {share:.4f}, max |err| {err:.4g}", flush=True)
    return recs


def busy_seconds(fn):
    """(fn's result, device busy seconds of one call from torch.profiler)."""
    import torch

    prof = profiled(fn, 1)
    busy = 0.0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            t = getattr(e, "self_device_time_total", None)
            busy += (getattr(e, "self_cuda_time_total", 0) if t is None else t) / 1e6
    torch.cuda.synchronize()
    return busy


def counted(prr, fn):
    """(fn's result, refine launches during it, its wall seconds): the count
    set to 0 just before the call and read just after."""
    import torch

    torch.cuda.synchronize()
    prr.launches["full"] = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, prr.launches["full"], time.perf_counter() - t0


def engine2d_phase(prr, api, cfg, model, fused, card, f32_models):
    """Phase 10 (module docstring).  Returns (the ``engine2d:`` record,
    refine launches per path)."""
    import numpy as np

    from empanada_tpu_torch.engine import PanopticDeepLabRenderEngine
    from empanada_tpu_torch.stitch.tile import Tiler

    rec, launches, holds = {"card": card}, {}, {}
    pre = api.Preprocessor(**cfg["norms"])
    # (a) one 512 x 512 request: Engine2d against the render engine (its
    # defaults) followed by force_connected
    eng = api.Engine2d(cfg, model=model)
    img = blob_image((512, 512), 40, 21)
    got, launches["engine2d_512"], _ = counted(prr, lambda: eng.infer(img))
    ref = PanopticDeepLabRenderEngine(model, thing_list=cfg["thing_list"], label_divisor=1000,
                                      nms_threshold=0.1, nms_kernel=3, confidence_thr=0.3,
                                      padding_factor=cfg["padding_factor"],
                                      coarse_boundaries=True, max_centers=256)
    want = eng.force_connected(ref(pre(img)["image"], img.shape).astype(np.int64))
    check(got.dtype == np.int64 and np.array_equal(got, want),
          "engine2d: Engine2d differs from the render engine + force_connected")
    check(launches["engine2d_512"] == 2, f"engine2d: {launches['engine2d_512']} launches for "
          "one request, not 2")
    rec["request_512"] = {"instances": int(len(np.unique(got[got > 0])))}

    # (b) a 4096 x 4096 image in 2048 x 2048 tiles: 3 x 3 tiles
    big = tile_blob_image((4096, 4096), 2500, 22)
    eng.tile_size = 2048
    tiler = Tiler(big.shape, 2048, 128)
    check(len(tiler) == 9, f"engine2d: {len(tiler)} tiles, not 9")
    _, kept = kept_steps(prr, lambda: eng.infer(big), 2)  # warm-up, first tile's steps
    holds["tile_2048"] = hold_steps(prr, kept, fused, "the first 2048 x 2048 tile")
    del kept
    walls = []
    for _ in range(2):
        tiled, n, wall = counted(prr, lambda: eng.infer(big))
        walls.append(wall)
        check(n == 18, f"engine2d tiled: {n} refine launches for 9 tiles, not 18")
    launches["engine2d_tiled"] = n
    busy = busy_seconds(lambda: eng.infer(big))
    # the tile merge numbers instances from the smallest tile id up, past
    # the label divisor when there are more (as the JAX package does)
    ids = np.unique(tiled[tiled > 0])
    check(tiled.shape == big.shape and tiled.dtype == np.int64 and len(ids) > 0
          and ids.min() >= 1000, f"engine2d tiled: malformed map, ids {ids[:3]}")
    wall = min(walls)
    rec["tiled_4096"] = {"tiles": len(tiler), "tile": 2048, "overlap": tiler.overlap_width,
                         "wall_s": walls, "seconds_per_image": wall,
                         "mpix_per_s": big.size / wall / 1e6, "refine_launches": n,
                         "device_busy_s": busy, "device_busy_share": busy / wall,
                         "instances": int(len(ids)),
                         "ids_past_divisor": int((ids >= 2000).sum()),
                         "dropped_centers": eng.last_overflow}
    eng.tile_size = 0

    # (c) NucleoNet_base_v2: a 600 x 700 request padded to 1024 x 1024
    cfg_n = api.load_config("NucleoNet_base_v2")
    eng_n = api.Engine2d(cfg_n, model=model)
    img_n = blob_image((600, 700), 50, 23)
    (pan_n, kept), n, _ = counted(prr, lambda: kept_steps(prr, lambda: eng_n.infer(img_n), 2))
    check(n == 2, f"engine2d NucleoNet: {n} launches, not 2")
    check(kept[1][0].shape[1:3] == (1024, 1024), "engine2d NucleoNet: not padded to 1024")
    holds["nucleonet_1024"] = hold_steps(prr, kept, fused, "a NucleoNet 1024 x 1024 request")
    launches["engine2d_nucleonet"] = n
    rec["nucleonet_600x700"] = {"padded": [1024, 1024],
                                "instances": int(len(np.unique(pan_n[pan_n > 0])))}
    del kept

    # (d) inference_scale 2 on a 1024 x 1024 request: a third step at sf 8
    eng_s = api.Engine2d(cfg, model=model, inference_scale=2)
    img_s = blob_image((1024, 1024), 80, 24)
    (pan_s, kept), n, _ = counted(prr, lambda: kept_steps(prr, lambda: eng_s.infer(img_s), 3))
    check(n == 3, f"engine2d scale 2: {n} launches, not 3")
    holds["scale2_1024"] = hold_steps(prr, kept, fused, "a scale-2 1024 x 1024 request")
    check([h["sf"] for h in holds["scale2_1024"]] == [2, 4, 8],
          f"engine2d scale 2: steps at sf {[h['sf'] for h in holds['scale2_1024']]}")
    launches["engine2d_scale2"] = n
    check(pan_s.shape == img_s.shape and (pan_s > 0).any(), "engine2d scale 2: empty map")
    up8, thr8, feats8 = kept[2][:3]
    n_weights = sum(q.numel() for layer in fused[0] for q in layer) + 2 + fused[1][0].numel()
    rec["scale2_1024"] = {"instances": int(len(np.unique(pan_s[pan_s > 0]))),
                          "sf8_step": {"up": list(up8.shape),
                                       "launch_ms": device_ms(lambda: prr.launch(*kept[2]), 20),
                                       **step_bound(up8, thr8, feats8, n_weights)}}
    del kept

    # (e) float32: a tiled request on the card against the CPU
    small = blob_image((300, 340), 12, 25)
    f32 = [api.Engine2d(cfg, model=m, device=d, tile_size=128).infer(small)
           for d, m in f32_models.items()]
    same = float((f32[0] == f32[1]).mean())
    rec["f32_tiled_300x340"] = {"tile": 128, "equal_share": same,
                                "instances": [int(len(np.unique(p[p > 0]))) for p in f32]}
    check(same == 1.0, f"engine2d f32 tiled: card and CPU agree on {same:.6f} of pixels")
    rec["kernel_vs_plain"] = holds
    print("engine2d: " + json.dumps(rec), flush=True)
    return rec, launches



def engine3d_phase(prr, api, cfg, model, fused, card, vol, fused_record, MultiChipEngine3d,
                   f32_models):
    """Phase 11 (module docstring).  Returns (the ``engine3d:`` record,
    refine launches per path)."""
    import shutil
    import tempfile

    import numpy as np

    rec, launches, holds = {"card": card, "volume": list(vol.shape)}, {}, {}
    kw = dict(median_kernel_size=3, min_size=64, min_extent=2, save_panoptic=True)
    # the per-slice engine over phase 7's volume
    eng = api.Engine3d(cfg, model=model, **kw)
    (stack, trackers), kept = kept_steps(prr, lambda: eng.infer_on_axis(vol, "xy"), 2)
    holds["engine3d_slice"] = hold_steps(prr, kept, fused, "an Engine3d slice")
    del kept
    (stack, trackers), n, wall = counted(prr, lambda: eng.infer_on_axis(vol, "xy"))
    check(n == 2 * vol.shape[0], f"engine3d: {n} launches for {vol.shape[0]} slices")
    launches["engine3d_xy"] = n
    busy = busy_seconds(lambda: eng.infer_on_axis(vol, "xy"))
    n_inst = sum(len(t.instances) for t in trackers)
    check(n_inst > 0 and stack.shape == vol.shape, "engine3d: no instance or bad stack")
    rec["per_slice"] = {"wall_s": wall, "slices_per_s": vol.shape[0] / wall,
                        "refine_launches": n, "device_busy_s": busy,
                        "device_busy_share": busy / wall, "instances": n_inst,
                        "stages_s": {k: v["total_s"] for k, v in eng.last_timing.items()},
                        "multichip_fused_b32_slices_per_s": fused_record["slices_per_s"]}

    # MultiChipEngine3d at inference_scale 2 (streamed: slices downsampled
    # on the host), three refine steps a batch, the third at sf 8
    eng_s = MultiChipEngine3d(cfg, model, inference_scale=2, **kw)
    _, kept = kept_steps(prr, lambda: eng_s.infer_on_axis(vol, "xy"), 3)
    holds["multichip_scale2"] = hold_steps(prr, kept, fused, "a scale-2 3D batch")
    check([h["sf"] for h in holds["multichip_scale2"]] == [2, 4, 8], "scale 2: steps' sf")
    del kept
    (stack_s, tr_s), n, wall_s = counted(prr, lambda: eng_s.infer_on_axis(vol, "xy"))
    n_batches = -(-vol.shape[0] // eng_s.last_batch_size)
    check(n == 3 * n_batches, f"scale 2: {n} launches for {n_batches} batches, not 3 each")
    launches["multichip_xy_scale2"] = n
    check(not eng_s.last_fused and sum(len(t.instances) for t in tr_s) > 0,
          "scale 2: fused, or no instance")
    rec["multichip_scale2"] = {"batch": eng_s.last_batch_size, "n_batches": n_batches,
                               "wall_s": wall_s, "slices_per_s": vol.shape[0] / wall_s,
                               "refine_launches": n,
                               "instances": sum(len(t.instances) for t in tr_s),
                               "stages_s": {k: v["total_s"]
                                            for k, v in eng_s.last_timing.items()}}

    # the panoptic stack into a chunked store, read back
    sdir = tempfile.mkdtemp(prefix="store-", dir=os.path.join(HERE, "empanada_tpu_torch",
                                                              "build"))
    try:
        stores = {}
        makers = {"engine3d": lambda url: api.Engine3d(cfg, model=model, store_url=url, **kw),
                  "multichip": lambda url: MultiChipEngine3d(cfg, model, store_url=url, **kw)}
        for name, make in makers.items():
            e = make(os.path.join(sdir, name))
            (st, _), n, _ = counted(prr, lambda e=e: e.infer_on_axis(vol, "xy"))
            launches[f"{name}_xy_store"] = n
            stores[name] = st
        numpy_stack = {"engine3d": stack,
                       "multichip": MultiChipEngine3d(cfg, model, **kw).infer_on_axis(
                           vol, "xy")[0]}
        from empanada_tpu_torch.core.chunked import open_chunked

        equal = {}
        for name, st in stores.items():
            back = open_chunked(os.path.join(sdir, name, "panoptic_xy"))
            equal[name] = bool(np.array_equal(np.asarray(st), numpy_stack[name])
                               and np.array_equal(np.asarray(back), numpy_stack[name]))
        chunks = sorted(os.listdir(os.path.join(sdir, "multichip", "panoptic_xy")))
    finally:
        shutil.rmtree(sdir, ignore_errors=True)
    rec["store"] = {"read_back_equal_to_numpy": equal, "files": len(chunks)}
    check(all(equal.values()), f"engine3d store: read back differs from numpy: {equal}")

    # float32 on a 16 x 256 x 256 volume: Engine3d on the card against the
    # batched engine on the card and Engine3d on the CPU
    small = blob_volume((16, 256, 256), 20, seed=11)
    out = {}
    for name, make in (("engine3d_card", lambda: api.Engine3d(cfg, model=f32_models["cuda"],
                                                                **kw)),
                       ("multichip_card", lambda: MultiChipEngine3d(
                           cfg, f32_models["cuda"], **kw)),
                       ("engine3d_cpu", lambda: api.Engine3d(cfg, model=f32_models["cpu"],
                                                             device="cpu", **kw))):
        out[name] = make().infer_on_axis(small, "xy")
    f32 = {k: same_trackers(v[1], out["engine3d_card"][1]) and bool(
        np.array_equal(v[0], out["engine3d_card"][0])) for k, v in out.items()}
    rec["f32_16x256x256"] = {"identical_to_engine3d_card": f32,
                             "instances": sum(len(t.instances)
                                              for t in out["engine3d_card"][1])}
    check(all(f32.values()) and rec["f32_16x256x256"]["instances"] > 0,
          f"engine3d f32: {f32}")
    rec["kernel_vs_plain"] = holds
    print("engine3d: " + json.dumps(rec), flush=True)
    return rec, launches


def mini_bc_phase(prr, api, cfg, card, vol, kernel_steps, engine3d_kw):
    """Phase 12 (module docstring).  Returns ({"mini": record, "bc": record},
    refine launches per path).  ``kernel_steps``: phase 6's records of
    MitoNet_v1's two kernel steps of one 512 x 512 request."""
    import numpy as np
    import torch

    from empanada_tpu_torch.api import init_model_from_config
    from empanada_tpu_torch.engine import (
        BCEngine,
        BCEngine3d,
        PanopticDeepLabEngine,
        PanopticDeepLabEngine3d,
    )
    from empanada_tpu_torch.parallel.data_parallel import MultiChipEngine3d
    from empanada_tpu_torch.stitch.watershed import bc_watershed

    bf16 = torch.bfloat16
    launches = {}
    pre = api.Preprocessor(**cfg["norms"])
    requests = [blob_image((512, 512), 40, 200 + s) for s in range(4)]
    requests.append(blob_image((600, 700), 50, 204))

    # ---- MitoNet_v1_mini at full width: Engine2d and the batched sweep
    cfg_m = api.load_config("MitoNet_v1_mini")
    model_m = init_model_from_config(cfg_m, seed=0, device="cuda", dtype=bf16)
    pr_m = model_m.semantic_pr
    fdim = pr_m.point_head.fc1.in_features - 1
    check(pr_m.fused_render == "auto" and fdim == cfg_m["model_kwargs"]["fpn_dim"],
          f"mini: fused_render {pr_m.fused_render}, F {fdim}")
    check(not prr.fused_step_supported(256, 256, 128, 128, 1, fdim, bf16),
          f"mini: the refine kernel claims F = {fdim}")
    rec = {"card": card, "feature_dim": fdim, "padding_factor": cfg_m["padding_factor"]}
    eng = api.Engine2d(cfg_m, model=model_m)
    maps, n, wall = counted(prr, lambda: [eng.infer(img) for img in requests])
    launches["mini_engine2d"] = n
    check(n == 0, f"mini: {n} refine launches, not 0 (F = 160 takes the torch path)")
    for img, pan in zip(requests, maps):
        check(pan.shape == img.shape and pan.dtype == np.int64, f"mini map {pan.shape}")
    pf = cfg_m["padding_factor"]
    padded = tuple(eng.engine._prepare(pre(requests[-1])["image"]).shape[1:3])
    check(padded == tuple(-(-d // pf) * pf for d in requests[-1].shape),
          f"mini: {requests[-1].shape} padded to {padded}")
    img0 = pre(requests[0])["image"]
    engine_ms = cuda_ms(lambda: eng.engine.dispatch(img0, requests[0].shape), iters=10)
    rec["engine2d"] = {"requests": len(requests), "padded_last": list(padded),
                       "wall_s": wall, "refine_launches": n,
                       "instances": [int(len(np.unique(p[p > 0]))) for p in maps],
                       "engine_ms_per_512_request": engine_ms,
                       "stages": stage_times(eng.engine, model_m, img0, engine_ms)}
    # the plain PointRend steps at F = 160 (torch path) on one request's
    # real features, beside MitoNet_v1's kernel steps from phase 6
    x = eng.engine._prepare(img0)
    with torch.no_grad():
        sem_x, _ = model_m._encode_decode(x)
        coarse = model_m.semantic_head(sem_x).permute(0, 2, 3, 1).contiguous()
        feats = sem_x.permute(0, 2, 3, 1).contiguous()
        steps, sem = [], coarse
        for sf in (2, 4):
            step_ms = device_ms(lambda sem=sem: pr_m.step(sem, coarse, feats), 10)
            steps.append({"sf": sf, "device_ms": step_ms})
            sem = pr_m.step(sem, coarse, feats)
    rec["pointrend_steps"] = {
        "mini_torch_path": steps, "mini_ms": sum(s["device_ms"] for s in steps),
        "mitonet_v1_kernel_ms": sum(s["launch_ms"] for s in kernel_steps),
        "mitonet_v1_kernel_steps": [{"sf": s["sf"], "launch_ms": s["launch_ms"]}
                                    for s in kernel_steps]}
    sweep = MultiChipEngine3d(cfg_m, model_m, **engine3d_kw)
    (stack, trackers), n, _ = counted(prr, lambda: sweep.infer_on_axis(vol, "xy"))
    check(n == 0, f"mini sweep: {n} refine launches, not 0")
    launches["mini_volume_xy"] = n
    walls = []
    for _ in range(2):
        (stack, trackers), n, wall = counted(prr, lambda: sweep.infer_on_axis(vol, "xy"))
        walls.append(wall)
    busy = busy_seconds(lambda: sweep.infer_on_axis(vol, "xy"))
    wall = min(walls)
    n_inst = sum(len(t.instances) for t in trackers)
    check(sweep.last_fused and not sweep.fallbacks, "mini sweep: not fused, or fell back")
    check(stack.shape == vol.shape and stack.dtype.name == "int32", "mini sweep: bad stack")
    rec["volume_xy"] = {"volume": list(vol.shape), "batch": sweep.last_batch_size,
                        "path": "fused", "wall_s": walls,
                        "slices_per_s": vol.shape[0] / wall, "device_busy_s": busy,
                        "device_busy_share": busy / wall, "instances": n_inst,
                        "refine_launches": n,
                        "stages_s": {k: v["total_s"] for k, v in sweep.last_timing.items()}}
    del sweep, stack, trackers
    # float32: a 16 x 256 x 256 volume and a small request, card against CPU
    f32_m = {d: init_model_from_config(cfg_m, seed=1, device=d, dtype=torch.float32)
             for d in ("cuda", "cpu")}
    small_vol = blob_volume((16, 256, 256), 20, seed=12)
    runs = {d: MultiChipEngine3d(cfg_m, m, device=d, **engine3d_kw).infer_on_axis(
        small_vol, "xy") for d, m in f32_m.items()}
    small = blob_image((256, 256), 12, 13)
    pans = {d: api.Engine2d(cfg_m, model=m, device=d).infer(small) for d, m in f32_m.items()}
    rec["f32"] = {
        "volume_16x256x256": {
            "trackers_equal": same_trackers(runs["cuda"][1], runs["cpu"][1]),
            "stack_equal_share": float((runs["cuda"][0] == runs["cpu"][0]).mean()),
            "instances": sum(len(t.instances) for t in runs["cpu"][1])},
        "request_256": {"equal_share": float((pans["cuda"] == pans["cpu"]).mean()),
                        "instances": int(len(np.unique(pans["cpu"][pans["cpu"] > 0])))}}
    print("mini: " + json.dumps(rec), flush=True)
    check(rec["f32"]["volume_16x256x256"]["trackers_equal"]
          and rec["f32"]["volume_16x256x256"]["stack_equal_share"] == 1.0
          and rec["f32"]["request_256"]["equal_share"] == 1.0,
          "mini f32: the card differs from the CPU")
    mini = rec
    del model_m, f32_m, eng, runs

    # ---- BC at MitoNet_v1's widths: BCEngine (4 launches a request), the
    # kernel on both heads' real step inputs, BCEngine3d into the watershed
    bc_cfg = {"arch": "PanopticDeepLabBC", "model_kwargs": cfg["model_kwargs"]}
    model_bc = init_model_from_config(bc_cfg, seed=0, device="cuda", dtype=bf16)
    rec = {"card": card}
    bc = BCEngine(model_bc, padding_factor=cfg["padding_factor"])
    xs = [pre(img)["image"] for img in requests[:4]]
    (outs, kept), n, wall = counted(prr, lambda: kept_steps(
        prr, lambda: [bc(x) for x in xs], 4))
    launches["bc_engine"] = n
    check(n == 4 * len(xs), f"bc: {n} refine launches for {len(xs)} requests, not 4 each")
    for img, out in zip(requests, outs):
        check(out.shape == img.shape + (2,) and bool(np.isfinite(out).all())
              and 0 <= out.min() and out.max() <= 1, "bc: maps malformed")
    heads = (model_bc.semantic_pr.point_head, model_bc.boundary_pr.point_head)
    holds = {}
    for name, head, kept_head in zip(("semantic", "boundary"), heads, (kept[:2], kept[2:])):
        holds[name] = hold_steps(prr, kept_head, head.fused_weights(kept_head[0][2].shape[-1]),
                                 f"the BC {name} head")
    del kept
    x_bc = bc._prepare(xs[0])
    rec["engine"] = {"requests": len(xs), "wall_s": wall, "refine_launches": n,
                     "engine_ms_per_512_request": cuda_ms(lambda: bc.infer(x_bc), 10),
                     "device_busy_ms_per_request": busy_seconds(lambda: bc.infer(x_bc)) * 1e3,
                     "kernel_vs_plain": holds}
    stack = [pre(blob_image((512, 512), 40, 210 + z))["image"] for z in range(7)]
    bc3 = BCEngine3d(model_bc, padding_factor=cfg["padding_factor"], median_kernel_size=3)

    def run3d():
        outs = [bc3(x, size=x.shape[-2:]) for x in stack]
        return [o for o in outs if o is not None] + bc3.end()

    outs3, n, wall = counted(prr, run3d)
    launches["bc_engine3d"] = n
    check(n == 4 * len(stack) and len(outs3) == len(stack),
          f"bc 3d: {n} launches, {len(outs3)} maps for {len(stack)} slices")
    vol_bc = (np.stack(outs3).transpose(3, 0, 1, 2) * 255).astype(np.uint8)
    # thresholds at the stack's own percentiles: random weights give maps
    # that the defaults (0.9 / 0.8 / 0.85) seed nowhere
    thr = dict(thres1=np.percentile(vol_bc[0], 90) / 255,
               thres2=np.percentile(vol_bc[1], 50) / 255,
               thres3=np.percentile(vol_bc[0], 60) / 255)
    t0 = time.perf_counter()
    seg = bc_watershed(vol_bc, **thr)
    ws_s = time.perf_counter() - t0
    check(seg.shape == (len(stack),) + stack[0].shape[-2:], f"bc watershed: {seg.shape}")
    rec["engine3d"] = {"slices": len(stack), "wall_s": wall, "refine_launches": n,
                       "watershed_s": ws_s, "thresholds": thr,
                       "instances": int(len(np.unique(seg[seg > 0]))), "dtype": seg.dtype.name}
    # float32, a small request: the card's maps against the CPU's
    f32_bc = {d: init_model_from_config(bc_cfg, seed=1, device=d, dtype=torch.float32)
              for d in ("cuda", "cpu")}
    small = pre(blob_image((256, 256), 12, 14))["image"]
    bcs = {d: BCEngine(m, device=d)(small) for d, m in f32_bc.items()}
    labels = {}
    for d, out in bcs.items():
        v = (out.transpose(2, 0, 1) * 255).astype(np.uint8)
        labels[d] = bc_watershed(v, thres1=np.percentile(v[0], 90) / 255,
                                 thres2=np.percentile(v[1], 50) / 255,
                                 thres3=np.percentile(v[0], 60) / 255, min_size=16)
    err = float(np.abs(bcs["cuda"] - bcs["cpu"]).max())
    rec["f32_request_256"] = {"max_abs_err": err,
                              "labels_equal_share": float((labels["cuda"]
                                                           == labels["cpu"]).mean()),
                              "instances": int(len(np.unique(labels["cpu"])) - 1)}
    del f32_bc, model_bc, bc, bc3

    # ---- the plain engines with PanopticDeepLab at MitoNet_v1's widths
    plain_kw = {k: v for k, v in cfg["model_kwargs"].items()
                if k not in ("num_fc", "train_num_points", "oversample_ratio",
                             "importance_sample_ratio", "subdivision_num_points")}
    plain = {d: init_model_from_config({"arch": "PanopticDeepLab", "model_kwargs": plain_kw},
                                       seed=2, device=d, dtype=torch.float32)
             for d in ("cuda", "cpu")}
    kw = dict(thing_list=cfg["thing_list"], **{k: v for k, v in cfg["FINETUNE"][
        "engine_params"].items() if k != "thing_list"})
    small = pre(blob_image((256, 256), 12, 15))["image"]
    stack = [pre(blob_image((256, 256), 12, 220 + z))["image"] for z in range(7)]
    out2d, out3d = {}, {}
    for d, m in plain.items():
        out2d[d] = PanopticDeepLabEngine(m, device=d, **kw)(small)
        e3 = PanopticDeepLabEngine3d(m, device=d, median_kernel_size=3, **kw)
        maps = [e3(x) for x in stack]
        out3d[d] = np.stack([p for p in maps if p is not None] + e3.end())
    rec_plain = {"request_256_equal_share": float((out2d["cuda"] == out2d["cpu"]).mean()),
                 "stack_7x256x256_equal_share": float((out3d["cuda"] == out3d["cpu"]).mean()),
                 "instances_2d": int(len(np.unique(out2d["cpu"][out2d["cpu"] > 0]))),
                 "slices": len(out3d["cpu"])}
    rec["plain_engines_f32"] = rec_plain
    print("bc: " + json.dumps(rec), flush=True)
    check(err <= 1e-5 and rec["f32_request_256"]["labels_equal_share"] == 1.0,
          f"bc f32: card vs CPU max |err| {err}, labels {rec['f32_request_256']}")
    check(rec_plain["request_256_equal_share"] == 1.0
          and rec_plain["stack_7x256x256_equal_share"] == 1.0
          and rec_plain["slices"] == len(stack), f"plain engines f32: {rec_plain}")
    return {"mini": mini, "bc": rec}, launches



def blob_example(shape, n_blobs, seed):
    """Seeded EM-like uint8 image of dark elliptic organelles on noise and
    its instance mask (uint16, 0 background)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, w = shape
    img = rng.normal(0.72, 0.06, shape).astype(np.float32)
    mask = np.zeros(shape, np.uint16)
    for i in range(n_blobs):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        ry, rx = rng.uniform(6, 22, 2)
        y0, y1 = max(0, int(cy - ry)), min(h, int(cy + ry) + 1)
        x0, x1 = max(0, int(cx - rx)), min(w, int(cx + rx) + 1)
        yy, xx = np.ogrid[y0:y1, x0:x1]
        inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
        img[y0:y1, x0:x1][inside] = rng.normal(0.3, 0.05)
        mask[y0:y1, x0:x1][inside] = i + 1
    return (np.clip(img, 0, 1) * 255).astype(np.uint8), mask


def train_dataset(root, n_train, n_eval):
    """``root/{train,eval}/blobs/{images,masks}/*.png`` of seeded blob
    examples, written by the port's ``data/imwrite.py``."""
    from empanada_tpu_torch.data.imwrite import imwrite

    for split, n, base in (("train", n_train, 1000), ("eval", n_eval, 2000)):
        for sub in ("images", "masks"):
            os.makedirs(os.path.join(root, split, "blobs", sub))
        for i in range(n):
            img, mask = blob_example((512, 512), 60, base + i)
            imwrite(os.path.join(root, split, "blobs", "images", f"{i:03d}.png"), img)
            imwrite(os.path.join(root, split, "blobs", "masks", f"{i:03d}.png"), mask)


def adamw_expected(p0, grad, group):
    """The parameter after AdamW's first step from ``p0`` and ``grad``,
    computed in float64 on the host as ``torch.optim.AdamW`` computes it:
    decay, then lr / (1 - b1) m / (sqrt(v) / sqrt(1 - b2) + eps)."""
    import torch

    (b1, b2), lr, eps = group["betas"], group["lr"], group["eps"]
    p, g = p0.double(), grad.double()
    m, v = (1 - b1) * g, (1 - b2) * g * g
    return p * (1 - lr * group["weight_decay"]) - lr / (1 - b1) * m / (
        torch.sqrt(v) / (1 - b2) ** 0.5 + eps)


def train_step_check(cfg, dtype):
    """One train step of a MitoNet_v1-width model (aspp_dropout 0) at batch
    2 on 128 x 128 crops with fed PointRend points, in ``dtype`` on the card
    (TF32 off) and on the CPU from the same weights: the loss, every
    gradient, the new batch statistics, Adam's moments and every updated
    parameter compared (tolerances in ``train_phase``); the card's updated
    parameters also against AdamW's update of the card's own gradients,
    computed on the host.  The semantic CE averages every pixel
    (``top_k_percent`` 1): a top 20 % of 32 768 nearly equal pixel losses
    would swap boundary pixels between the two devices.  Returns the
    record."""
    import numpy as np
    import torch

    from empanada_tpu_torch.api import init_model_from_config
    from empanada_tpu_torch.train import PanopticLoss, create_train_state, onecycle_schedule

    kw = dict(cfg["model_kwargs"], aspp_dropout=0.0)
    mcfg = {"arch": cfg["arch"], "model_kwargs": kw}
    rng = np.random.default_rng(5)
    batch = {"image": rng.normal(0, 1, (2, 128, 128, 1)).astype(np.float32),
             "sem": rng.integers(0, 2, (2, 128, 128)).astype(np.int32),
             "ctr_hmp": rng.random((2, 128, 128, 1)).astype(np.float32),
             "offsets": rng.normal(0, 4, (2, 128, 128, 2)).astype(np.float32)}
    coords = rng.random((2, kw["train_num_points"], 2)).astype(np.float32)
    schedule = onecycle_schedule(3e-3, 8)
    lr0, eps = schedule(0), torch.finfo(dtype).eps
    runs = []
    for dev in ("cuda", "cpu"):
        model = init_model_from_config(mcfg, seed=3, device=dev, dtype=dtype)
        state = create_train_state(model, schedule, 0.1)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        b = {k: v.to(dtype) if v.is_floating_point() else v for k, v in b.items()}
        out = model(b["image"], train=True,
                    point_coords=torch.from_numpy(coords).to(dev, dtype))
        loss, _ = PanopticLoss(top_k_percent=1.0)(out, b)
        loss.backward()
        loss = loss.detach()
        names = {id(p): n for n, p in model.named_parameters()}
        p0 = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        for group in state.optimizer.param_groups:
            group["lr"] = lr0
        state.optimizer.step()
        params = {n: p.detach().cpu() for n, p in model.named_parameters()}
        # the update against AdamW's of this device's own gradients, per
        # element over |p0| + lr(0) (the rounding of the stored parameter
        # and of the update term); Adam's moments against (1 - b) g, g^2
        update_err = moment_err = 0.0
        moments = {}
        for group in state.optimizer.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                n = names[id(p)]
                want = adamw_expected(p0[n], grads[n], group)
                update_err = max(update_err, float(
                    ((params[n].double() - want).abs() / (p0[n].double().abs() + lr0)).max()))
                st = state.optimizer.state[p]
                moments[n] = (st["exp_avg"].cpu(), st["exp_avg_sq"].cpu())
                g = grads[n].double()
                for got, want in zip(moments[n], ((1 - b1) * g, (1 - b2) * g * g)):
                    moment_err = max(moment_err, float((got.double() - want).abs().max()
                                                       / want.abs().max().clamp(min=1e-300)))
        runs.append((float(loss), grads, params, moments,
                     {n: b_.detach().cpu() for n, b_ in model.named_buffers()},
                     update_err, moment_err))
    (loss_g, grads_g, params_g, mom_g, stats_g, upd_g, mom_err_g), \
        (loss_c, grads_c, params_c, mom_c, stats_c, _, _) = runs

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm().clamp(min=1e-30))

    # gradients: the relative L2 error over all of them, and per tensor
    # (the worst five, with each tensor's norm beside the largest norm)
    diff = torch.cat([(grads_g[n] - grads_c[n]).flatten() for n in grads_c])
    ref = torch.cat([grads_c[n].flatten() for n in grads_c])
    per = sorted(((rel_l2(grads_g[n], grads_c[n]), n, float(grads_c[n].norm()))
                  for n in grads_c), reverse=True)
    moment_l2 = max(rel_l2(a, b) for n in mom_c for a, b in zip(mom_g[n], mom_c[n]))
    param_err = max(float((params_g[n] - params_c[n]).abs().max()) for n in params_c)
    stat_err = max(float((stats_g[n] - stats_c[n]).abs().max()
                         / stats_c[n].abs().max().clamp(min=1e-30)) for n in stats_c)
    return {"dtype": str(dtype).replace("torch.", ""), "loss_card": loss_g, "loss_cpu": loss_c,
            "loss_rel_err": abs(loss_g - loss_c) / abs(loss_c),
            "grad_rel_l2": float(diff.norm() / ref.norm()),
            "grad_worst_rel_l2": [[n, e, g] for e, n, g in per[:5]],
            "grad_max_norm": max(g for _, _, g in per),
            "moments_worst_rel_l2": moment_l2,
            "param_max_abs_err": param_err, "param_max_abs_err_of_lr0": param_err / lr0,
            "lr0": lr0, "update_err_of_own_grads_in_eps": upd_g / eps,
            "moments_err_of_own_grads_in_eps": mom_err_g / eps,
            "stats_err_of_max": stat_err, "n_tensors": len(grads_c)}


def train_phase(prr, api, card):
    """Phase 13 (module docstring).  Returns (the ``train:`` record, refine
    launches per path)."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import yaml

    from empanada_tpu_torch import fp32_strict
    from empanada_tpu_torch.train import loop
    from empanada_tpu_torch.train.state import batch_to_device
    from empanada_tpu_torch.utils import StageTimer

    t_phase = time.perf_counter()
    cfg = api.load_config("MitoNet_v1")
    rec = {"card": card}

    # ---- 1. one step on the card against the CPU, in float32 (TF32 off)
    # and in float64.  Train-mode batch norm at random init makes the
    # backward of a 50-layer encoder ill-conditioned: float32 rounding
    # moves the gradients by percents (the CPU port against the JAX package
    # on the CPU at these widths: 5.7 % relative L2).  Each limit is a few
    # times the reading of PR 8's runs on the H100 (in brackets; PERF.md).
    # Adam's first step moves a parameter by about lr(0) whatever the
    # gradient's size, so a near-zero gradient whose sign differs moves
    # the two float32 copies up to 2 lr(0) apart: float32 holds the update
    # against AdamW's of the card's own gradients (in float64 on the host,
    # within 16 eps of |p0| + lr(0)), float64 also against the CPU's
    fp32_strict()
    tol = {"float32": dict(loss=2e-5,          # [4.4e-6]
                           grad=0.06,          # global relative L2 [0.0225]
                           grad_tensor=0.1,    # worst tensor [0.0288]
                           stats=3e-5),        # [6.4e-6]
           "float64": dict(loss=1e-10,         # [0]
                           grad=1e-6,          # [5.9e-14]
                           grad_tensor=1e-6,   # [2.1e-13]
                           stats=1e-9,         # [1.1e-14]
                           moments=1e-6,       # worst tensor, relative L2
                           param_of_lr0=1e-3)}  # [7.2e-5]: a gradient near eps
    for dtype in (torch.float32, torch.float64):
        r = train_step_check(cfg, dtype)
        t = tol[r["dtype"]]
        rec[f"{r['dtype']}_step"] = dict(r, tolerances=dict(t, own_update_in_eps=16,
                                                            own_moments_in_eps=16))
        print(f"{r['dtype']} train step, card vs CPU: " + json.dumps(r), flush=True)
        name = f"{r['dtype']} train step"
        check(r["loss_rel_err"] <= t["loss"], f"{name}: loss "
              f"{r['loss_card']} on the card, {r['loss_cpu']} on the CPU")
        check(r["grad_rel_l2"] <= t["grad"], f"{name}: gradients off by "
              f"{r['grad_rel_l2']:.3g} (relative L2)")
        worst = r["grad_worst_rel_l2"][0]
        check(worst[1] <= t["grad_tensor"], f"{name}: gradient of {worst[0]} off by "
              f"{worst[1]:.3g} (relative L2)")
        check(r["stats_err_of_max"] <= t["stats"], f"{name}: batch statistics differ")
        check(r["update_err_of_own_grads_in_eps"] <= 16, f"{name}: the card's update is "
              f"{r['update_err_of_own_grads_in_eps']:.3g} eps from AdamW's of its gradients")
        check(r["moments_err_of_own_grads_in_eps"] <= 16, f"{name}: the card's Adam "
              f"moments are {r['moments_err_of_own_grads_in_eps']:.3g} eps from its gradients'")
        if "moments" in t:
            check(r["moments_worst_rel_l2"] <= t["moments"], f"{name}: Adam's moments "
                  f"differ by {r['moments_worst_rel_l2']:.3g} (relative L2)")
            check(r["param_max_abs_err_of_lr0"] <= t["param_of_lr0"], f"{name}: updated "
                  f"parameters differ by {r['param_max_abs_err']:.3g} (lr(0) {r['lr0']:.3g})")

    # ---- 2. MitoNet_v1 at full width, train_config.yaml's TRAIN defaults
    root = tempfile.mkdtemp(prefix="train-", dir=os.path.join(HERE, "empanada_tpu_torch",
                                                             "build"))
    try:
        t0 = time.perf_counter()
        n_train, n_eval = 64, 2
        train_dataset(root, n_train, n_eval)
        rec["dataset_s"] = time.perf_counter() - t0
        with open(os.path.join(HERE, "empanada_tpu_torch", "training",
                               "train_config.yaml")) as f:
            config = yaml.safe_load(f)
        config["model_name"] = "mitonet_blobs"
        config["MODEL"] = {"arch": cfg["arch"], **cfg["model_kwargs"]}
        config["DATASET"] = {"class_names": {1: "mito"}, "labels": [1], "thing_list": [1],
                             "norms": cfg["norms"]}
        train_cfg = config["TRAIN"]
        train_cfg.update(train_dir=os.path.join(root, "train"),
                         model_dir=os.path.join(root, "straight"), epochs=2, print_freq=4)
        config["EVAL"].update(eval_dir=os.path.join(root, "eval"), epochs_per_eval=2)
        steps_per_epoch = n_train // train_cfg["batch_size"]
        check(train_cfg["batch_size"] == 16 and train_cfg["amp"]
              and len(train_cfg["augmentations"]) == 7
              and train_cfg["augmentations"][2] == {"aug": "RandomCrop", "height": 256,
                                                    "width": 256},
              "train_config.yaml's TRAIN defaults changed")

        # each run's step losses, kept on the device and read after it
        real_make = loop.make_train_step

        def recording(losses):
            def make_step(*args, **kwargs):
                step = real_make(*args, **kwargs)

                def recorded_step(state, batch):
                    aux = step(state, batch)
                    losses.append(aux["total_loss"])
                    return aux
                return recorded_step
            return make_step

        launches, validate_launches, kept = {}, [0], []
        real_validate = loop.validate

        def validate(*args, **kwargs):
            n0 = prr.launches["full"]
            out, steps = kept_steps(prr, lambda: real_validate(*args, **kwargs), 2)
            kept.extend(steps)
            validate_launches[0] += prr.launches["full"] - n0
            return out

        class StepTimer(StageTimer):
            """StageTimer that also keeps each step's seconds."""
            def __init__(self):
                super().__init__()
                self.each = {}

            def add(self, name, seconds, count=1):
                super().add(name, seconds, count)
                self.each.setdefault(name, []).append(seconds)

        timer, losses = StepTimer(), []
        loop.make_train_step, loop.validate = recording(losses), validate
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            prr.launches["full"] = 0
            t0 = time.perf_counter()
            model, state = loop.main(config, timer=timer)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            total = prr.launches["full"]
        finally:
            loop.make_train_step, loop.validate = real_make, real_validate
        peak = torch.cuda.max_memory_allocated()
        launches["train_validate"] = validate_launches[0]
        launches["train_eval_step"] = total - validate_launches[0]
        loss_values = [float(v) for v in losses]
        n_steps = len(loss_values)
        check(n_steps == 2 * steps_per_epoch and state.step == n_steps,
              f"train: {n_steps} steps, not {2 * steps_per_epoch}")
        check(all(np.isfinite(loss_values)), f"train: a loss is not finite: {loss_values}")
        check(loss_values[-1] < loss_values[0], f"train: the loss did not fall: {loss_values}")
        check(launches["train_eval_step"] == 2 * (n_steps // train_cfg["print_freq"]),
              f"train: {launches['train_eval_step']} refine launches in eval_step")
        check(launches["train_validate"] == 2 * n_eval,
              f"train: {launches['train_validate']} refine launches in validate")
        # the plain version takes the trained head's fused weights, rounded
        # to bf16 as the packing rounds them
        layers, pred = model.semantic_pr.point_head.fused_weights(kept[0][2].shape[-1])
        held = hold_steps(prr, kept, ([tuple(w.to(torch.bfloat16) for w in layer)
                                       for layer in layers],
                                      tuple(w.to(torch.bfloat16) for w in pred)), "validate")
        straight = {n: p.detach().clone() for n, p in model.named_parameters()}
        stages = timer.report()
        data_ms = 1e3 * stages["data"]["total_s"] / n_steps
        step_ms = 1e3 * stages["step"]["total_s"] / n_steps
        # steps 2.. alone: without the first step's warm-up.  The timer
        # holds no eval_step (it runs after the step's time is taken, and
        # its results are read back before the next batch is loaded)
        steady_data_ms = 1e3 * float(np.mean(timer.each["data"][1:]))
        steady_step_ms = 1e3 * float(np.mean(timer.each["step"][1:]))

        # the device's step alone: one augmented batch, CUDA events and the
        # profiler over steps of it; host syncs of a step by the debug mode
        batch = batch_to_device(next(iter(loop.WeightedBatchLoader(
            loop._build_dataset(config, cfg["norms"]), 16, seed=7))), "cuda")
        step = loop.make_train_step(loop.PanopticLoss(**train_cfg["criterion_params"]),
                                    amp=True)
        device_step_ms = cuda_ms(lambda: step(state, batch), 4, warmup=1)
        busy_ms = 1e3 * busy_seconds(lambda: step(state, batch))
        n_sync, sites = sync_sites(lambda: [step(state, batch) for _ in range(2)])

        # ---- 3. resume.  A run crashes right after its first epoch's
        # checkpoint and is resumed for the second.  Restoring is exact:
        # the state loaded equals the state saved, bit for bit (parameters,
        # statistics, optimizer state, step, the generator's, the loader's
        # and the augmentations' draws).  The resumed parameters are then
        # held against the straight run's beside a second straight run's:
        # the card's backward is not bit-deterministic, and training from
        # random weights is chaotic, so two straight runs differ already
        def run_cfg(name, **train):
            c = yaml.safe_load(yaml.safe_dump(config))
            c["TRAIN"].update(model_dir=os.path.join(root, name), **train)
            c["EVAL"] = {}
            return c

        def snapshot(st, ldr):
            opt = st.optimizer.state_dict()["state"]
            return {"params": {n: p.detach().clone() for n, p in st.model.named_parameters()},
                    "buffers": {n: b.clone() for n, b in st.model.named_buffers()},
                    "opt": {(i, k): v.clone() for i, s_ in opt.items() for k, v in s_.items()},
                    "step": st.step, "generator": st.generator.get_state(),
                    "loader": ldr.state_dict(),
                    "augment": ldr.dataset.transforms.rng.bit_generator.state}

        def same(a, b):
            if isinstance(a, dict):
                return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
            if isinstance(a, torch.Tensor):
                return torch.equal(a.cpu(), b.cpu())
            return a == b

        class Crash(Exception):
            pass

        saved, loaded = {}, {}
        real_save, real_load = loop.save_checkpoint, loop.load_checkpoint

        def save_then_crash(path, st, config, epoch=0, loader=None, **kw):
            real_save(path, st, config, epoch=epoch, loader=loader, **kw)
            saved.update(snapshot(st, loader))
            raise Crash

        def load_and_keep(path, st, return_epoch=False, loader=None, **kw):
            out = real_load(path, st, return_epoch=return_epoch, loader=loader, **kw)
            loaded.update(snapshot(st, loader))
            return out

        run_losses = {"straight_2": [], "crashed": [], "resumed": []}
        try:
            loop.make_train_step = recording(run_losses["straight_2"])
            model2, _ = loop.main(run_cfg("straight_2"))
            loop.make_train_step = recording(run_losses["crashed"])
            loop.save_checkpoint = save_then_crash
            try:
                loop.main(run_cfg("resumed"))
                fail("train: the crashing run did not crash")
            except Crash:
                pass
            loop.save_checkpoint = real_save
            loop.make_train_step = recording(run_losses["resumed"])
            loop.load_checkpoint = load_and_keep
            t0 = time.perf_counter()
            resumed_model, resumed = loop.main(run_cfg("resumed", resume=True))
            resumed_s = time.perf_counter() - t0
        finally:
            loop.make_train_step, loop.save_checkpoint = real_make, real_save
            loop.load_checkpoint = real_load
        restored = bool(saved) and same(saved, loaded)

        def param_diff(m):
            return torch.cat([(straight[n] - p.detach()).abs().flatten()
                              for n, p in m.named_parameters()])

        d_resumed, d_straight = param_diff(resumed_model), param_diff(model2)
        resume = {"steps": resumed.step, "resumed_s": resumed_s, "restored_exactly": restored,
                  "max_abs_diff": float(d_resumed.max()),
                  "median_abs_diff": float(d_resumed.median()),
                  "straight_runs_max_abs_diff": float(d_straight.max()),
                  "straight_runs_median_abs_diff": float(d_straight.median()),
                  "losses": {k: [float(v) for v in vs] for k, vs in run_losses.items()}}
        check(resumed.step == n_steps, f"resume: {resumed.step} steps, not {n_steps}")
        check(restored, "resume: the state loaded differs from the state saved")
        check(len(run_losses["crashed"]) == steps_per_epoch
              and len(run_losses["resumed"]) == steps_per_epoch,
              "resume: the crashed or the resumed run took the wrong number of steps")
        check(resume["median_abs_diff"] <= 3 * resume["straight_runs_median_abs_diff"],
              "resume: the resumed parameters differ from the straight run's more than a "
              "second straight run's do")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    rec.update({
        "model": "MitoNet_v1 (resnet50, output stride 16, decoder 256, instance decoder, "
                 "PointRend 1024 train points), seeded LeCun-normal weights",
        "settings": "train_config.yaml TRAIN defaults: batch 16, 256 x 256 crops, 7 "
                    "augmentations, PanopticLoss + PointRend, AdamW/OneCycle, amp bf16",
        "dataset": {"train_images": n_train, "eval_images": n_eval, "size": 512},
        "epochs": 2, "steps": n_steps, "wall_s": wall,
        "ms_per_step": data_ms + step_ms, "host_data_ms_per_step": data_ms,
        "host_dispatch_ms_per_step": step_ms, "device_step_ms": device_step_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_busy_share": busy_ms / (data_ms + step_ms),
        "samples_per_s": 16 * n_steps / (stages["data"]["total_s"] + stages["step"]["total_s"]),
        "samples_per_s_device_bound": 16e3 / device_step_ms,
        "steady": {"steps": f"2-{n_steps}", "ms_per_step": steady_data_ms + steady_step_ms,
                   "host_data_ms_per_step": steady_data_ms,
                   "host_dispatch_ms_per_step": steady_step_ms,
                   "samples_per_s": 16e3 / (steady_data_ms + steady_step_ms),
                   "device_busy_share": busy_ms / (steady_data_ms + steady_step_ms)},
        "host_data_ms_each_step": [1e3 * v for v in timer.each["data"]],
        "host_dispatch_ms_each_step": [1e3 * v for v in timer.each["step"]],
        "peak_memory_allocated_gib": peak / 2 ** 30,
        "host_syncs_per_step": n_sync / 2, "host_sync_sites": sites,
        "loss_first": loss_values[0], "loss_last": loss_values[-1], "losses": loss_values,
        "refine_launches": launches, "kernel_vs_plain": held, "resume": resume,
        "phase_s": time.perf_counter() - t_phase})
    print("train: " + json.dumps(rec), flush=True)
    return rec, launches


def scripted_state_dict(sd):
    """A TorchScript module whose state dict is ``sd`` (the published
    archives' format): a module tree with ``sd``'s tensors as buffers."""
    import torch

    class Holder(torch.nn.Module):
        def forward(self, x):
            return x

    root = Holder()
    for key, t in sd.items():
        node = root
        *mods, leaf = key.split(".")
        for m in mods:
            if not hasattr(node, m):
                node.add_module(m, Holder())
            node = getattr(node, m)
        node.register_buffer(leaf, t.clone())
    return torch.jit.script(root)


def cli_phase(prr, api, cfg, model, fused, card, vol):
    """Phase 14 (module docstring).  Returns (the ``cli:`` record, refine
    launches per command)."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch

    from empanada_tpu_torch import cli
    from empanada_tpu_torch.api import utils as api_utils
    from empanada_tpu_torch.core.chunked import open_chunked
    from empanada_tpu_torch.curation.export import _to_saveable
    from empanada_tpu_torch.data.imread import imread
    from empanada_tpu_torch.data.imwrite import imwrite
    from empanada_tpu_torch.eval import default_evaluator
    from empanada_tpu_torch.parallel.data_parallel import MultiChipEngine3d
    from empanada_tpu_torch.port.torch_port import reference_state_dict

    t_phase = time.perf_counter()
    rec, launches, holds = {"card": card}, {}, {}
    # a registry of its own inside the checkout: HOME for the packaged
    # configs' "~/.empanada_tpu_torch/models/<name>.eptorch" and the
    # subprocesses, MODEL_DIR for this process
    tmp = tempfile.mkdtemp(prefix="cli-", dir=os.path.join(HERE, "empanada_tpu_torch", "build"))
    home = os.path.join(tmp, "home")
    registry = os.path.join(home, ".empanada_tpu_torch")
    old_home, old_registry = os.environ.get("HOME"), api_utils.MODEL_DIR
    os.environ["HOME"] = home
    api_utils.MODEL_DIR = registry

    def path(name):
        return os.path.join(tmp, name)

    def run(*argv):
        """One command in this process: (its stdout lines, wall seconds)."""
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            try:
                cli.main([str(a) for a in argv])
            except SystemExit as e:
                fail(f"cli {argv[0]} exited with {e.code}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lines = buf.getvalue().splitlines()
        for line in lines[:4]:
            print(f"  {argv[0]}: {line[:160]}", flush=True)
        return lines, wall

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def same_params(bundle):
        got = api.load_model_bundle(bundle, device="cpu").state_dict()
        return all(torch.equal(got[k], v.float().cpu()) for k, v in model.state_dict().items())

    try:
        # (a) port: a reference-named state dict of the seeded model (float32,
        # as published) in the three formats; the bundles hold its weights
        os.makedirs(os.path.join(registry, "models"))
        ref = {k: v.float() if v.is_floating_point() else v
               for k, v in reference_state_dict(model, cfg["arch"], cfg["model_kwargs"]).items()}
        torch.save(ref, path("ref_raw.pth"))
        torch.save({"state_dict": ref, "norms": cfg["norms"]}, path("ref_ckpt.pth"))
        torch.jit.save(scripted_state_dict(ref), path("ref_ts.pth"))
        del ref
        ported, port_walls = {}, {}
        for fmt, out, extra in (
                ("raw", os.path.join(registry, "models", "MitoNet_v1"), ["--model", "MitoNet_v1"]),
                ("ckpt", path("ported_ckpt"), ["--model", "MitoNet_v1"]),
                ("ts", path("ported_ts"), [])):
            lines, port_walls[fmt] = run("port", path(f"ref_{fmt}.pth"), "-o", out, *extra)
            ported[fmt] = same_params(out + ".eptorch")
        check(all(ported.values()), f"cli port: bundles differ from the model: {ported}")
        rec["port"] = {"formats": list(ported), "bit_identical": ported, "wall_s": port_walls,
                       "inferred": lines[0][:200]}

        # (b) the bundle through models export / import / archive
        (_, w_exp), (_, w_imp), (_, w_arc) = (
            run("models", "export", "--name", "MitoNet_v1", "--path", path("exported")),
            run("models", "import", "--path", path("exported.empanada_torch"), "--name",
                "MitoNet_v1_imported"),
            run("models", "archive", "--name", "MitoNet_v1_imported", "--path", path("arch")))
        imported = os.path.expanduser(api.load_config("MitoNet_v1_imported")["model"])
        check(same_params(imported) and os.path.isfile(
            path(os.path.join("arch", "MitoNet_v1_imported.empanada_torch"))),
            "cli models: the imported bundle differs, or no archive")
        rec["models"] = {"export_s": w_exp, "import_s": w_imp, "archive_s": w_arc,
                         "imported_bit_identical": True}
        shutil.copy(os.path.join(registry, "models", "MitoNet_v1.eptorch"),
                    os.path.join(registry, "models", "NucleoNet_base_v2.eptorch"))

        # (c) infer2d: phase 10's 4096 x 4096 image as PNG in tiles of 2048
        big = tile_blob_image((CLI_BIG, CLI_BIG), 2500 * CLI_BIG ** 2 // 4096 ** 2, 22)
        imwrite(path("big.png"), big)
        eng = api.Engine2d(cfg, model=model, label_divisor=10000, tile_size=CLI_TILE)
        want, eng_s = timed(lambda: eng.infer(big))
        ((lines, wall), kept), n, _ = counted(prr, lambda: kept_steps(prr, lambda: run(
            "infer2d", path("big.png"), "-o", path("big_pan.tif"), "--tile-size", CLI_TILE), 2))
        holds["tile_2048"] = hold_steps(prr, kept, fused, "the CLI's first 2048 x 2048 tile")
        del kept
        got = imread(path("big_pan.tif"))
        n_inst = int((np.unique(want) % 10000 > 0).sum())
        check(n == 18, f"cli infer2d tiled: {n} refine launches, not 18")
        check(got.dtype == _to_saveable(want).dtype and np.array_equal(got, want),
              "cli infer2d tiled: the TIFF differs from Engine2d.infer")
        check(lines[-1] == f"wrote {path('big_pan.tif')}: {big.shape}, {n_inst} instances",
              f"cli infer2d tiled: printed {lines[-1]!r}")
        launches["cli_infer2d_tiled"] = n
        rec["infer2d_tiled_4096"] = {"wall_s": wall, "engine_s": eng_s,
                                     "overhead_s": wall - eng_s, "refine_launches": n,
                                     "instances": n_inst, "tiff_dtype": str(got.dtype),
                                     "equal": True}

        # (d) a 512 x 512 --roi window of it, and two models on a 1024 x 1024 crop
        y, x, side = CLI_ROI
        window = (slice(y, y + side), slice(x, x + side))
        (lines, wall), n, _ = counted(prr, lambda: run(
            "infer2d", path("big.png"), "-o", path("roi.tif"), "--tile-size", CLI_TILE,
            "--roi", f"{y}:{y + side},{x}:{x + side}"))
        got = imread(path("roi.tif")).astype(np.int64)
        want_roi, eng_s = timed(lambda: eng.infer(big[window]))
        inside = got[window].copy()
        got[window] = 0
        check(n == 2 and np.array_equal(inside, want_roi) and not got.any(),
              f"cli infer2d --roi: {n} launches, or the window differs")
        launches["cli_infer2d_roi"] = n
        rec["infer2d_roi_512"] = {"wall_s": wall, "engine_s": eng_s, "overhead_s": wall - eng_s,
                                  "refine_launches": n, "equal": True}
        crop = big[:CLI_CROP, :CLI_CROP]
        imwrite(path("crop.png"), crop)
        (lines, wall), n, _ = counted(prr, lambda: run(
            "infer2d", path("crop.png"), "-o", path("mm.tif"), "--model", "MitoNet_v1",
            "--model", "NucleoNet_base_v2"))
        configs = [dict(api.load_config(m), model_name=m)
                   for m in ("MitoNet_v1", "NucleoNet_base_v2")]
        pans, eng_s = timed(lambda: [api.Engine2d(c, model=model, label_divisor=10000)
                                     .infer(crop) for c in configs])
        combined, names = api.combine_panoptic_maps(pans, configs, label_divisor=10000)
        same = [np.array_equal(imread(path(f)), w) for f, w in (
            ("mm.tif", combined), ("mm_MitoNet_v1.tif", pans[0]),
            ("mm_NucleoNet_base_v2.tif", pans[1]))]
        check(n == 4 and all(same) and f"combined class 2: {names[2]}" in lines,
              f"cli infer2d two models: {n} launches, equal {same}")
        launches["cli_infer2d_two_models"] = n
        rec["infer2d_two_models_1024"] = {"wall_s": wall, "engine_s": eng_s,
                                          "overhead_s": wall - eng_s, "refine_launches": n,
                                          "equal": same, "classes": names}

        # (e) infer3d --multichip along xy: phase 7's volume as a multipage TIFF
        imwrite(path("vol.tif"), vol)
        kw3 = dict(label_divisor=10000, median_kernel_size=3, min_size=500, min_extent=5)
        fin = dict(label_divisor=10000, min_size=500, min_extent=5)
        e3 = MultiChipEngine3d(cfg, model, **kw3)

        def xy_in_process():
            _, trackers = e3.infer_on_axis(vol, "xy")
            return trackers, list(api.stack_postprocessing({"xy": trackers}, None, cfg, **fin))

        (trackers, outs), eng_s = timed(xy_in_process)
        (lines, wall), n, _ = counted(prr, lambda: run(
            "infer3d", path("vol.tif"), "-o", path("seg_{class}.tif"), "--multichip"))
        n_batches = -(-vol.shape[0] // e3._resolve_batch(vol.shape, 0))
        got = imread(path("seg_mito.tif"))
        check(n == 2 * n_batches and np.array_equal(got, outs[0][0])
              and lines[0] == f"class mito: {len(outs[0][2])} instances",
              f"cli infer3d xy: {n} launches for {n_batches} batches, or the TIFF differs")
        launches["cli_infer3d_xy"] = n
        rec["infer3d_xy"] = {"wall_s": wall, "engine_s": eng_s, "overhead_s": wall - eng_s,
                             "refine_launches": n, "n_batches": n_batches,
                             "instances": len(outs[0][2]), "equal": True}

        # (f) infer3d --multichip --orthoplane --store against the in-process
        # sweeps and consensus into another store
        def ortho_in_process():
            tr = e3.infer_orthoplane(vol)
            return list(api.tracker_consensus(tr, path("inproc.zarr"), cfg, pixel_vote_thr=2,
                                              cluster_iou_thr=0.75, **fin))

        outs_o, eng_s = timed(ortho_in_process)
        (lines, wall), n, _ = counted(prr, lambda: run(
            "infer3d", path("vol.tif"), "--multichip", "--orthoplane", "--store",
            path("cli.zarr")))
        n_batches = sum(-(-vol.shape[a] // e3._resolve_batch(vol.shape, a)) for a in range(3))
        same = np.array_equal(np.asarray(open_chunked(path("cli.zarr/mito"))[:]),
                              np.asarray(open_chunked(path("inproc.zarr/mito"))[:]))
        check(n == 2 * n_batches and same
              and lines[0] == f"class mito: {len(outs_o[0][2])} instances",
              f"cli infer3d ortho: {n} launches for {n_batches} batches, store equal {same}")
        launches["cli_infer3d_ortho"] = n
        rec["infer3d_ortho_store"] = {"wall_s": wall, "engine_s": eng_s,
                                      "overhead_s": wall - eng_s, "refine_launches": n,
                                      "n_batches": n_batches, "instances": len(outs_o[0][2]),
                                      "equal": True}

        # (g) evaluate: the xy tracker dump against itself and against a copy
        # without every other instance, beside the Evaluator called directly
        trackers[0].write_to_json(path("gt.json"))
        with open(path("gt.json")) as f:
            dump = json.load(f)
        dump["instances"] = dict(list(dump["instances"].items())[::2])
        with open(path("pred.json"), "w") as f:
            json.dump(dump, f)
        evals = {}
        for pred in ("gt", "pred"):
            lines, _ = run("evaluate", path("gt.json"), path(f"{pred}.json"))
            got = json.loads("\n".join(lines))
            direct = default_evaluator()(path("gt.json"), path(f"{pred}.json"))
            check(got == {k: float(v) for k, v in direct.items()},
                  f"cli evaluate: {got} differs from the Evaluator's {direct}")
            evals[pred] = got
        tp = len(trackers[0].instances)
        check(all(v == 1.0 for k, v in evals["gt"].items() if k != "pq")
              and evals["gt"]["pq"] == tp / (tp + 1e-5) and evals["pred"]["f1_50"] < 1.0,
              f"cli evaluate: {evals}")
        rec["evaluate"] = {"instances": tp, "self": evals["gt"], "half_deleted": evals["pred"]}

        # (h) labels and tiles on the tiled image's map
        from empanada_tpu_torch.curation import count_labels

        lines, _ = run("labels", "count", path("big_pan.tif"), "-o", path("counts.csv"))
        queue, class_ids = count_labels(want, 10000)
        check(lines[:-1] == [f"class {c}: {len(queue[c])} labels" for c in class_ids],
              f"cli labels count: {lines}")
        lines, _ = run("labels", "small", path("big_pan.tif"), "-o", path("small.tif"))
        _, areas = np.unique(want[want > 0], return_counts=True)
        check(lines[0].startswith(f"removed {int((areas <= 100).sum())} labels"),
              f"cli labels small: {lines[0]}")
        run("tiles", "chop", "--image", path("big_pan.tif"), "--dir", path("tiles"),
            "--patch-size", CLI_TILE)
        run("tiles", "merge", "--dir", path("tiles"), "--out", path("merged"))
        merged, pan_map = imread(path("merged/merged_image.tiff")), imread(path("big_pan.tif"))
        n_tiles = len(os.listdir(path("tiles/im")))
        check(n_tiles == (CLI_BIG // CLI_TILE) ** 2 and merged.dtype == pan_map.dtype
              and np.array_equal(merged, pan_map), "cli tiles: merge does not give back the map")
        rec["labels_tiles"] = {"labels": {int(c): len(queue[c]) for c in class_ids},
                               "small_removed": int((areas <= 100).sum()), "tiles": n_tiles,
                               "merge_equal": True}

        # (i) the entry point itself, in subprocesses on the card: no --device
        env = dict(os.environ, HOME=home)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "empanada_tpu_torch", "models", "list"],
                              cwd=HERE, env=env, capture_output=True, text=True, timeout=300)
        check(proc.returncode == 0 and "MitoNet_v1_imported" in proc.stdout,
              f"python -m empanada_tpu_torch models list: {proc.stderr[-2000:]}")
        list_s = time.perf_counter() - t0
        img = blob_image((512, 512), 40, 21)
        imwrite(path("img.png"), img)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "empanada_tpu_torch", "infer2d",
                               path("img.png"), "-o", path("sub.tif")],
                              cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
        sub_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"python -m empanada_tpu_torch infer2d: "
              f"{proc.stderr[-2000:]}")
        want_sub = api.Engine2d(cfg, model=model, label_divisor=10000).infer(img)
        check(np.array_equal(imread(path("sub.tif")), want_sub),
              "python -m empanada_tpu_torch infer2d (no --device): differs from Engine2d")
        rec["subprocess"] = {"models_list_s": list_s, "infer2d_512_s": sub_s,
                             "infer2d_stdout": proc.stdout.strip()[-200:], "equal": True}
    finally:
        api_utils.MODEL_DIR = old_registry
        if old_home is None:
            os.environ.pop("HOME", None)
        else:
            os.environ["HOME"] = old_home
        shutil.rmtree(tmp, ignore_errors=True)
    rec["kernel_vs_plain"] = holds
    rec["phase_s"] = time.perf_counter() - t_phase
    print("cli: " + json.dumps(rec), flush=True)
    check(rec["phase_s"] <= 90, f"phase 14 took {rec['phase_s']:.1f} s, over its 90 s")
    return rec, launches


# phase 15: a rank's collectives wait at most WORLD_PG_TIMEOUT_S for the
# others, each world's processes get WORLD_TIMEOUT_S, the phase
# PARALLEL_LIMIT_S; the world of two's volume batch (16 slices a rank, the
# batch of the world of one it is held to)
WORLD_PG_TIMEOUT_S, WORLD_TIMEOUT_S, PARALLEL_LIMIT_S = 90, 110, 120
WORLD2_BATCH = 32


def sha(a) -> str:
    import hashlib

    import numpy as np

    a = np.ascontiguousarray(a)
    return hashlib.sha256(a.tobytes() + str((a.shape, a.dtype)).encode()).hexdigest()[:16]


def ddp_step_check(model0, dev, mesh, dtype, n, size):
    """One ``make_train_step`` of ``model0`` (a copy of it in ``dtype``; a
    MitoNet_v1-width model, ASPP dropout and
    PointRend's points from the seeded generator) on this rank's rows of a
    seeded global batch of ``n`` ``size`` x ``size`` crops, in ``dtype``;
    rank 0 then takes the world of one's step on the whole batch from the
    same weights and compares: the global loss, the gradients (relative L2
    over all and the worst tensor), the new batch statistics and Adam's
    moments (largest error over each tensor's largest magnitude).  Adam's
    first step moves a parameter by about lr(0) whatever its gradient's
    size, so the world of two's updated parameters are held, as phase 13
    holds the card's, against AdamW's update of the world's own gradients
    in float64 (in eps of |p0| + lr(0)), and their distance to the world of
    one's is reported.  Everything is compared on the card: 25 M values a
    kind, whose float64 arithmetic on the host took tens of seconds.
    Returns the record."""
    import copy

    import numpy as np
    import torch

    from empanada_tpu_torch.parallel.mesh import data_sharding
    from empanada_tpu_torch.train import (PanopticLoss, create_train_state, make_train_step,
                                          onecycle_schedule)

    rng = np.random.default_rng(7)
    batch = {"image": rng.normal(0, 1, (n, size, size, 1)),
             "sem": rng.integers(0, 2, (n, size, size)).astype(np.int32),
             "ctr_hmp": rng.random((n, size, size, 1)),
             "offsets": rng.normal(0, 4, (n, size, size, 2))}

    def run(rows, m):
        model = copy.deepcopy(model0).to(dev, dtype)
        st = create_train_state(model, onecycle_schedule(3e-3, 8), 0.1, seed=5)
        step = make_train_step(PanopticLoss(), amp=False, mesh=m)
        b = {k: torch.from_numpy(v[rows]).to(dev) for k, v in batch.items()}
        b = {k: v.to(dtype) if v.is_floating_point() else v for k, v in b.items()}
        p0 = {k: p.detach().clone() for k, p in model.named_parameters()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aux = step(st, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        names = {id(p): name for name, p in model.named_parameters()}
        moments = {names[id(p)]: torch.cat([s["exp_avg"].flatten(), s["exp_avg_sq"].flatten()])
                   for p, s in st.optimizer.state.items()}
        lr0 = st.optimizer.param_groups[0]["lr"]
        update_err = torch.stack([((p.detach().double() - adamw_expected(
            p0[names[id(p)]], p.grad.detach(), group)).abs()
            / (p0[names[id(p)]].double().abs() + lr0)).max()
            for group in st.optimizer.param_groups for p in group["params"]]).max()
        rec["update_err_of_own_grads_in_eps"] = float(update_err) / torch.finfo(dtype).eps
        rec["lr0"] = lr0
        return (float(aux["total_loss"]), wall,
                {k: p.grad.detach() for k, p in model.named_parameters()},
                {k: b_.detach() for k, b_ in model.named_buffers()}, moments,
                {k: p.detach() for k, p in model.named_parameters()})

    rec = {"dtype": str(dtype).replace("torch.", ""), "global_batch": [n, size, size]}
    loss, wall, grads, stats, moments, params = run(data_sharding(mesh, n), mesh)
    rec.update(step_s=wall, loss=loss)
    if mesh.rank != 0:
        return rec
    own = rec["update_err_of_own_grads_in_eps"]
    loss1, wall1, grads1, stats1, moments1, params1 = run(slice(None), None)
    rec["update_err_of_own_grads_in_eps"] = own  # the world of two's, not one's

    def of_max(got, want):
        return float(torch.stack([(got[k] - want[k]).abs().max()
                                  / want[k].abs().max().clamp(min=1e-300) for k in want]).max())

    names = list(grads1)
    per_l2 = torch.stack([(grads[k] - grads1[k]).norm() / grads1[k].norm().clamp(min=1e-30)
                          for k in names]).tolist()
    per = sorted(zip(per_l2, names), reverse=True)
    diff = torch.cat([(grads[k] - grads1[k]).flatten() for k in grads1])
    ref = torch.cat([grads1[k].flatten() for k in grads1])
    rec.update(world1_loss=loss1, world1_step_s=wall1,
               loss_rel_err=abs(loss - loss1) / abs(loss1),
               grad_rel_l2=float(diff.norm() / ref.norm()),
               grad_worst_rel_l2=[per[0][1], per[0][0]],
               grad_err_of_max=of_max(grads, grads1), stats_err_of_max=of_max(stats, stats1),
               moments_err_of_max=of_max(moments, moments1),
               params_err_of_max=of_max(params, params1),
               param_max_abs_err_of_lr0=float(torch.stack(
                   [(params[k] - params1[k]).abs().max() for k in params1]).max()) / rec["lr0"])
    return rec


def world_rank(task, rank, world, port, wd):
    """One rank of phase 15's worlds, run as ``chip_smoke.py --world-rank
    TASK RANK WORLD PORT DIR`` (``DIR/spec.json`` says what to run):
    ``cli1`` drives the command line in a world of one over NCCL, ``gloo2``
    is a rank of the world of two over gloo with both ranks on cuda:0.  Its
    record goes to ``DIR/TASK_RANK.json``."""
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    import torch.distributed as dist

    from empanada_tpu_torch import api, fp32_strict
    from empanada_tpu_torch.ops import pointrend_refine as prr
    from empanada_tpu_torch.parallel import (MultiChipEngine3d, SpatialEngine2d, create_mesh,
                                             initialize_multihost)

    with open(os.path.join(wd, "spec.json")) as f:
        spec = json.load(f)
    coord = f"127.0.0.1:{port}"
    rec = {"rank": rank, "imports_s": time.perf_counter() - T_START}
    t_part = time.perf_counter()

    def part(name):
        """Seconds since the last part ended, into ``rec["parts_s"]``."""
        nonlocal t_part
        now = time.perf_counter()
        rec.setdefault("parts_s", {})[name] = now - t_part
        t_part = now

    if task == "cli1":
        from empanada_tpu_torch import cli

        flags = ["--coordinator", coord, "--num-processes", str(world),
                 "--process-id", str(rank)]
        for name, argv in spec["cli"]:
            prr.launches["full"] = 0
            t0 = time.perf_counter()
            cli.main(argv + flags)
            torch.cuda.synchronize()
            rec[name] = {"wall_s": time.perf_counter() - t0,
                         "refine_launches": prr.launches["full"]}
        rec.update(backend=dist.get_backend(), world=dist.get_world_size())
    else:
        # imported beside the world of one (also what the first optimizer
        # imports lazily, seconds of torch's modules); the card once it is
        # done
        torch.optim.AdamW([torch.nn.Parameter(torch.zeros(1))])
        go = os.path.join(wd, "go_gloo2")
        while not os.path.exists(go):
            check(time.perf_counter() - t_part < WORLD_TIMEOUT_S,
                  "parallel: the world of two was not started")
            time.sleep(0.05)
        part("waited")
        dev = torch.device("cuda", 0)
        initialize_multihost(coord, world, rank, device=dev, backend="gloo",
                             timeout_s=WORLD_PG_TIMEOUT_S)
        mesh = create_mesh(device=dev)
        cfg = api.load_config(spec["config"])
        model = api.load_model_from_config(cfg, device=dev, dtype=torch.bfloat16)
        rec.update(backend=mesh.backend, world=mesh.size)
        part("setup")

        # (b1) the batched xy sweep, 16 slices a rank: the first run counts
        # the host syncs, the second is timed and its launches counted
        vol = np.load(spec["volume"])
        eng = MultiChipEngine3d(cfg, model, batch_size=WORLD2_BATCH, device=dev,
                                **spec["engine3d"])
        n_sync, sites = sync_sites(lambda: eng.infer_on_axis(vol, "xy"))
        n_batches = -(-vol.shape[0] // WORLD2_BATCH)
        (stack, trackers), n, wall = counted(prr, lambda: eng.infer_on_axis(vol, "xy"))
        timing = eng.last_timing
        rec["volume"] = {
            "seconds": wall, "slices_per_s": vol.shape[0] / wall, "batch": eng.last_batch_size,
            "slices_per_rank": WORLD2_BATCH // world, "refine_launches": n,
            "collectives_s": timing.get("collectives", {}).get("total_s", 0.0),
            "host_syncs_per_batch": n_sync / n_batches, "sync_sites": dict(list(sites.items())[:4]),
            "stack_sha": sha(stack), "instances": sum(len(t.instances) for t in trackers)}
        part("volume")

        # (b2) the 4096 x 4096 slice in two blocks of 2048 + 2 x 128 rows: the
        # kernel held on this rank's block's steps, then the timed forward
        img = np.load(spec["image"])
        prep = api.Preprocessor(**cfg["norms"])(img)["image"][0]
        sp = SpatialEngine2d(model, cfg["thing_list"], halo=128, device=dev, **spec["spatial"])
        _, kept = kept_steps(prr, lambda: sp.forward(prep), 2)
        fused = model.semantic_pr.point_head.fused_weights(kept[0][2].shape[-1])
        part("spatial_first")
        holds = hold_steps(prr, kept, fused, f"rank {rank}'s spatial block")
        part("spatial_hold")
        del kept
        out, n, wall = counted(prr, lambda: sp.forward(prep))
        pan = sp.postprocess(out, prep.shape)
        part("spatial")
        rec["spatial"] = {"forward_s": wall, "postprocess_s": rec["parts_s"]["spatial"] - wall,
                          "refine_launches": n, "map_sha": sha(pan),
                          "instances": int(len(np.unique(pan[pan > 0]))),
                          "kernel_vs_plain": holds}
        if rank == 0:
            # the seam rule: the sharded logits against the unsharded
            # forward's, beside two independent halves'
            x = torch.from_numpy(prep)[None, ..., None].to(dev, torch.bfloat16)
            h = x.shape[1] // 2
            with torch.no_grad():
                full = model(x)["sem_logits"].float()
                halves = torch.cat([model(x[:, :h])["sem_logits"],
                                    model(x[:, h:])["sem_logits"]], dim=1).float()
            sem = out["sem_logits"].float()
            seam = slice(h - 2 * 128, h + 2 * 128)  # the rows the halo exchange serves
            rec["spatial"].update(err_shard=float((sem - full).abs().mean()),
                                  err_halves=float((halves - full).abs().mean()),
                                  err_shard_seam=float((sem - full)[:, seam].abs().mean()),
                                  err_halves_seam=float((halves - full)[:, seam].abs().mean()),
                                  finite=bool(torch.isfinite(sem).all()))
            del full, halves, x
        del out
        part("seam_reference")

        # (b3) one data-parallel step against the world of one's on the
        # concatenated batch: float32 without TF32, and float64 small
        fp32_strict()
        model0 = api.init_model_from_config(cfg, seed=3, device=dev, dtype=torch.float32)
        part("step_model")
        rec["f32_step"] = ddp_step_check(model0, dev, mesh, torch.float32, 4, 128)
        part("f32_step")
        rec["f64_step"] = ddp_step_check(model0, dev, mesh, torch.float64, 2, 64)
        part("f64_step")
    rec["rank_s"] = time.perf_counter() - T_START
    with open(os.path.join(wd, f"{task}_{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()
    return 0


def start_world(task, world, wd):
    """Start ``world`` ranks of ``task`` (``world_rank``): (their
    processes, their log files, the task)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    logs = [open(os.path.join(wd, f"{task}_{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--world-rank", task,
                               str(r), str(world), str(port), wd], cwd=HERE, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(world)]
    return procs, logs, task


def wait_world(started, wd, timeout):
    """Wait for the ranks of ``start_world``; any rank that fails or
    outlasts ``timeout`` seconds from now fails the phase (the others are
    killed).  Returns their records."""
    procs, logs, task = started
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        stop_world(started)
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(wd, f"{task}_{r}.log")) as f:
                print(f.read()[-4000:], file=sys.stderr)
            fail(f"parallel: rank {r} of {task} exited with {p.returncode} after "
                 f"{time.perf_counter() - t0:.1f} s")
    recs = []
    for r in range(len(procs)):
        with open(os.path.join(wd, f"{task}_{r}.json")) as f:
            recs.append(json.load(f))
    return recs


def stop_world(started):
    """Kill the ranks of ``start_world`` still running; close their logs."""
    procs, logs, _ = started
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    for f in logs:
        f.close()


def parallel_phase(prr, api, cfg, model, card, vol):
    """Phase 15 (module docstring).  Returns (the ``parallel:`` record,
    refine launches per path)."""
    import contextlib
    import gc
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch
    import yaml

    from empanada_tpu_torch import cli
    from empanada_tpu_torch.parallel.data_parallel import MultiChipEngine3d

    t_phase = time.perf_counter()
    rec, launches, worlds = {"card": card}, {}, []
    wd = tempfile.mkdtemp(prefix="parallel-", dir=os.path.join(HERE, "empanada_tpu_torch",
                                                               "build"))

    def path(name):
        return os.path.join(wd, name)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    try:
        # phase 5's model as a bundle with its registry config, phase 7's
        # volume, phase 10's image, a training set of 4 images
        bundle = api.save_model_bundle(path("mitonet"), cfg["arch"], cfg["model_kwargs"], model)
        with open(path("MitoNet_v1.yaml"), "w") as f:
            yaml.safe_dump(dict(cfg, model=bundle), f)
        np.save(path("vol.npy"), vol)
        big = tile_blob_image((4096, 4096), 2500, 22)
        np.save(path("big.npy"), big)
        train_dataset(path("data"), 4, 0)
        with open(os.path.join(HERE, "empanada_tpu_torch", "training",
                               "train_config.yaml")) as f:
            tcfg = yaml.safe_load(f)
        tcfg.update(model_name="mitonet_world", MODEL={"arch": cfg["arch"], **cfg["model_kwargs"]},
                    DATASET={"class_names": {1: "mito"}, "labels": [1], "thing_list": [1],
                             "norms": cfg["norms"]})
        tcfg["TRAIN"].update(train_dir=path("data/train"), model_dir=path("train"), epochs=1,
                             batch_size=2, print_freq=1, metrics=[])
        tcfg["EVAL"] = {}
        with open(path("train.yaml"), "w") as f:
            yaml.safe_dump(tcfg, f)
        # the command line's defaults; the streamed path, which a world of
        # two takes
        engine3d = dict(label_divisor=10000, median_kernel_size=3, nms_kernel=3,
                        confidence_thr=0.3, min_size=500, min_extent=5, save_panoptic=True,
                        sweep_fused=False)
        spatial = dict(label_divisor=10000, nms_kernel=3, confidence_thr=0.3, max_centers=256,
                       padding_factor=cfg["padding_factor"])
        infer3d = ["infer3d", path("vol.npy"), "--model", path("MitoNet_v1.yaml"),
                   "--multichip", "--no-progress"]
        infer2d = ["infer2d", path("big.npy"), "--model", path("MitoNet_v1.yaml"),
                   "--spatial-shard"]
        spec = {"config": path("MitoNet_v1.yaml"), "volume": path("vol.npy"),
                "image": path("big.npy"), "engine3d": engine3d, "spatial": spatial,
                "cli": [["infer3d", infer3d + ["-o", path("w1_seg_{class}.npy")]],
                        ["infer2d", infer2d + ["-o", path("w1_pan.npy")]],
                        ["train", ["train", path("train.yaml"), "--multichip"]]]}
        with open(path("spec.json"), "w") as f:
            json.dump(spec, f)

        # the world of one's results in this process: the commands without
        # a world, the sweep at 16 and at 32 slices a batch
        out = {}
        with contextlib.redirect_stdout(io.StringIO()):
            _, out["infer3d_s"] = timed(lambda: cli.main(
                infer3d + ["-o", path("ref_seg_{class}.npy")]))
            _, out["infer2d_s"] = timed(lambda: cli.main(infer2d + ["-o", path("ref_pan.npy")]))
        sweeps = {}
        for b in (WORLD2_BATCH // 2, WORLD2_BATCH):
            eng = MultiChipEngine3d(cfg, model, batch_size=b, **engine3d)
            eng.infer_on_axis(vol, "xy")  # warm-up
            (stack, _), n, wall = counted(prr, lambda: eng.infer_on_axis(vol, "xy"))
            sweeps[b] = {"seconds": wall, "slices_per_s": vol.shape[0] / wall,
                         "refine_launches": n, "stack_sha": sha(stack)}
        del eng, stack
        rec["world1_in_process"] = dict(out, sweeps=sweeps)
        gc.collect()
        torch.cuda.empty_cache()

        # (a) a world of one over NCCL through the command line's flags;
        # the world of two's ranks start beside it, import, and wait for it
        # to end before they touch the card
        t0 = time.perf_counter()
        worlds.append(start_world("cli1", 1, wd))
        worlds.append(start_world("gloo2", 2, wd))
        (w1,) = wait_world(worlds[0], wd, WORLD_TIMEOUT_S)
        wall = time.perf_counter() - t0
        check(w1["backend"] == "nccl" and w1["world"] == 1, f"parallel: world of one {w1}")
        same3d = np.array_equal(np.load(path("w1_seg_mito.npy")),
                                np.load(path("ref_seg_mito.npy")))
        same2d = np.array_equal(np.load(path("w1_pan.npy")), np.load(path("ref_pan.npy")))
        ckpt = os.path.isfile(path("train/mitonet_world_checkpoint.pt"))
        check(same3d, "parallel: infer3d --multichip in a world of one differs from one process")
        check(same2d, "parallel: infer2d --spatial-shard in a world of one differs from one "
              "process")
        check(ckpt, "parallel: train --multichip in a world of one wrote no checkpoint")
        check(w1["infer3d"]["refine_launches"] == 4 and w1["infer2d"]["refine_launches"] == 2,
              f"parallel: world of one's refine launches {w1}")
        rec["nccl_world1"] = dict(w1, process_wall_s=wall, infer3d_equal=same3d,
                                  infer2d_equal=same2d, train_checkpoint=ckpt)
        launches["parallel_cli_world1"] = sum(w1[k]["refine_launches"]
                                              for k in ("infer3d", "infer2d", "train"))

        # (b) a world of two over gloo, both ranks on cuda:0
        t0 = time.perf_counter()
        with open(path("go_gloo2"), "w"):
            pass
        ranks = wait_world(worlds[1], wd, WORLD_TIMEOUT_S)
        wall = time.perf_counter() - t0
        r0, r1 = ranks
        vols = [r["volume"] for r in ranks]
        check(all(v["stack_sha"] == sweeps[WORLD2_BATCH // 2]["stack_sha"] for v in vols),
              "parallel: the world of two's volume differs from the world of one's "
              f"({[v['stack_sha'] for v in vols]} vs {sweeps[WORLD2_BATCH // 2]['stack_sha']})")
        check(all(v["refine_launches"] == 4 for v in vols),
              f"parallel: volume refine launches per rank {[v['refine_launches'] for v in vols]}")
        sps = [r["spatial"] for r in ranks]
        check(sps[0]["map_sha"] == sps[1]["map_sha"], "parallel: the ranks' spatial maps differ")
        check(all(s["refine_launches"] == 2 for s in sps),
              f"parallel: spatial refine launches per rank {[s['refine_launches'] for s in sps]}")
        # JAX's seam rule (tests/test_spatial.py: under half the tiles'
        # mean error) on the rows around the seam; over the whole slice the
        # sharded logits must be the closer too, but the factor is not
        # JAX's there: at two 2048-row blocks both means are mostly the
        # align-corners grid shift they share, and the blocks at the ends
        # see zero halo rows (PERF.md)
        sp0 = sps[0]
        check(sp0["finite"] and sp0["err_shard"] < sp0["err_halves"]
              and sp0["err_shard_seam"] < 0.5 * sp0["err_halves_seam"],
              f"parallel: the sharded logits are off the unsharded forward by "
              f"{sp0['err_shard']:.4g} ({sp0['err_shard_seam']:.4g} at the seam), two halves "
              f"by {sp0['err_halves']:.4g} ({sp0['err_halves_seam']:.4g})")
        f32, f64 = r0["f32_step"], r0["f64_step"]
        # float32: phase 13's card limits for a step against another
        # device's; float64: 1e-10
        check(f32["loss_rel_err"] <= 2e-5 and f32["grad_rel_l2"] <= 0.06
              and f32["grad_worst_rel_l2"][1] <= 0.1 and f32["stats_err_of_max"] <= 3e-5,
              f"parallel: float32 step of the world of two: {f32}")
        check(max(f64[k] for k in ("loss_rel_err", "grad_err_of_max", "stats_err_of_max",
                                   "moments_err_of_max")) <= 1e-10
              and max(r["update_err_of_own_grads_in_eps"] for r in (f32, f64)) <= 16,
              f"parallel: float64 step of the world of two: {f64}")
        max_err = max(h["max_abs_err"] for s in sps for h in s["kernel_vs_plain"])
        rec["gloo_world2"] = {"process_wall_s": wall, "ranks": ranks,
                              "slices_per_s": [v["slices_per_s"] for v in vols],
                              "world1_slices_per_s": {
                                  b: s["slices_per_s"] for b, s in sweeps.items()},
                              "collectives_s": [v["collectives_s"] for v in vols],
                              "host_syncs_per_batch": [v["host_syncs_per_batch"] for v in vols]}
        rec["batch_invariant_world1"] = (sweeps[WORLD2_BATCH // 2]["stack_sha"]
                                         == sweeps[WORLD2_BATCH]["stack_sha"])
        launches["parallel_volume_world2"] = sum(v["refine_launches"] for v in vols)
        launches["parallel_spatial_world2"] = sum(s["refine_launches"] for s in sps)
    finally:
        for started in worlds:
            stop_world(started)
        shutil.rmtree(wd, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    print("parallel: " + json.dumps(rec), flush=True)
    check(rec["phase_s"] <= PARALLEL_LIMIT_S,
          f"phase 15 took {rec['phase_s']:.1f} s, over its {PARALLEL_LIMIT_S} s")
    return rec, launches, max_err


# phase 16: the surface of ROADMAP item 13 (int8 bundles, the URL cache,
# the serving artifact, profiling, bench), within a limit of its own
SURFACE_LIMIT_S = 120


def surface_phase(prr, api, cfg, model, card, engine_ms, step1, refine_args):
    """Phase 16 on MitoNet_v1 at full width (phase 5's model, bf16).
    ``step1``: phase 6's record of a request's first refine step (its
    CUDA-event ``kernel_ms``); ``refine_args``: that step's real inputs
    (up, thr, features, coarse, packed weights).  Returns (record,
    {path: refine launches}); each path's count is set to 0 just before it
    and read just after."""
    import contextlib
    import hashlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch

    from empanada_tpu_torch import cli
    from empanada_tpu_torch.api import utils as api_utils
    from empanada_tpu_torch.api.deploy import export_serving_artifact, load_serving_artifact
    from empanada_tpu_torch.utils import StageTimer, device_time, trace

    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    rec, launches = {"card": card}, {}
    tmp = tempfile.mkdtemp(prefix="surface-", dir=os.path.join(HERE, "empanada_tpu_torch",
                                                                "build"))
    old_cache = os.environ.get(api_utils.CACHE_ENV)
    pre = api.Preprocessor(**cfg["norms"])
    img = blob_image((512, 512), 40, 0)  # phase 5's first request
    try:
        # (a) int8 bundle of phase 5's weights (float32 from the same seed)
        f32 = api.init_model_from_config(cfg, seed=0, device="cpu", dtype=torch.float32)
        plain = api.save_model_bundle(os.path.join(tmp, "f32"), cfg["arch"],
                                      cfg["model_kwargs"], f32)
        q = api.save_model_bundle(os.path.join(tmp, "int8"), cfg["arch"], cfg["model_kwargs"],
                                  f32, quantize=True)
        q_card = api_utils.load_model_bundle(q, device="cuda", dtype=bf16)
        q_cpu = api_utils.load_model_bundle(q, device="cpu", dtype=bf16).state_dict()
        unequal = [k for k, v in q_card.state_dict().items() if not torch.equal(v.cpu(), q_cpu[k])]
        check(not unequal, f"int8 bundle: {len(unequal)} tensors differ card vs CPU: "
              f"{unequal[:3]}")
        f_card = api_utils.load_model_bundle(plain, device="cuda", dtype=bf16)
        x = pre(img)["image"]
        engines = {name: api.Engine2d(cfg, model=m).engine for name, m in
                   (("float", f_card), ("int8", q_card))}
        maps = {}
        for name, eng in engines.items():
            maps[name], n, _ = counted(prr, lambda eng=eng: eng(x, img.shape))
            launches[f"surface_int8_{name}"] = n
            check(n == 2, f"int8 bundle: {n} refine launches for the {name} request")
        rec["int8"] = {"bytes_float32": os.path.getsize(plain), "bytes_int8": os.path.getsize(q),
                       "size_ratio": os.path.getsize(plain) / os.path.getsize(q),
                       "dequantized_card_equals_cpu": True,
                       "map_against_float": map_agreement(maps["int8"], maps["float"])}
        del q_card, f_card, engines, q_cpu

        # (b) the URL cache: a file:// bundle fetched into a cache of its own
        sha = hashlib.sha256(open(plain, "rb").read()).hexdigest()
        os.environ[api_utils.CACHE_ENV] = os.path.join(tmp, "cache")
        url_cfg = dict(cfg, model=f"file://{plain}", model_sha256=sha)
        local = api.Engine2d(dict(cfg, model=plain)).infer(img)
        fetched = api.Engine2d(url_cfg).infer(img)
        check(np.array_equal(local, fetched), "URL cache: the fetched bundle's map differs")
        cached = os.listdir(os.path.join(tmp, "cache"))
        check(len(cached) == 1, f"URL cache: {cached}")
        rec["url_cache"] = {"cached": cached, "equal": True, "sha256_checked": True}

        # (c) the serving artifact: exported on the card, saved, loaded, run
        art = os.path.join(tmp, "mitonet.serve")
        e2 = api.Engine2d(cfg, model=model)
        t0 = time.perf_counter()
        _, n_export, _ = counted(prr, lambda: export_serving_artifact(
            cfg, art, img.shape, platforms="cuda", model=model))
        export_s = time.perf_counter() - t0
        launches["surface_export"] = n_export
        served = load_serving_artifact(art)
        steps = served.meta["engine_params"]["render_steps"]
        check(served.meta["refine_op_calls"] == steps,
              f"artifact: {served.meta['refine_op_calls']} op calls for {steps} steps")
        got, n, _ = counted(prr, lambda: served(img))
        launches["surface_artifact"] = n
        check(n == steps, f"artifact: {n} refine launches for one request, not {steps}")
        want, _, _ = counted(prr, lambda: e2._dispatch(img).cpu().numpy())
        check(np.array_equal(got, want), "artifact: its map differs from Engine2d's device map")
        check(np.array_equal(e2.force_connected(got.astype(np.int64)), e2.infer(img)),
              "artifact: force_connected of its map differs from Engine2d.infer")
        for bad, match in ((np.zeros((256, 256), np.uint8), "specialized"),
                           (img.astype(np.uint16), "uint8")):
            try:
                served(bad)
            except ValueError as e:
                check(match in str(e), f"artifact refused with {e}")
            else:
                fail(f"artifact accepted a {bad.dtype} {bad.shape} input")
        x_u8 = torch.from_numpy(img).cuda()
        served_ms, n_timed, _ = counted(prr, lambda: cuda_ms(lambda: served.dispatch(x_u8), 10))
        launches["surface_artifact_timed"] = n_timed
        rec["artifact"] = {"export_s": export_s, "bytes": os.path.getsize(art),
                           "ms_per_request": served_ms, "engine_ms": engine_ms,
                           "launches_per_request": n, "equal_to_engine2d": True,
                           "refused": ["shape", "uint16"]}

        # (d) profiling: device_time of one refine step, a trace, a stage timer
        up, thr, feats, coarse, packed = refine_args
        dt, n, _ = counted(prr, lambda: device_time(
            lambda u: prr.refine(u, thr, feats, coarse, packed), up, iters=20, trials=3,
            stats=True))
        launches["surface_device_time"] = n

        # the op's dispatch: host ms a call through the registered op against
        # a direct launch, in turns (launch, op, op, launch); at ~0.03 ms of
        # device time a step the loop waits on the host
        paths = {"launch": lambda: prr.launch(up, thr, feats, coarse, packed),
                 "op": lambda: prr.refine(up, thr, feats, coarse, packed)}
        turns, n, _ = counted(prr, lambda: [(k, host_ms(paths[k]))
                                            for k in ("launch", "op", "op", "launch")])
        launches["surface_op_dispatch"] = n
        host = {k: sum(v for name, v in turns if name == k) / 2 for k in paths}
        (prof_ev, n_trace, _) = counted(prr, lambda: _traced(trace, tmp, served, img))
        launches["surface_trace"] = n_trace
        timer = StageTimer(sync=True)
        with timer.stage("dispatch"):
            pan = served.dispatch(x_u8)
        with timer.stage("fetch"):
            pan.cpu()
        rec["profiling"] = {"op_dispatch_ms": host["op"] - host["launch"],
                            "host_ms_per_call": host,
                            "device_time_step1_ms": dt["s"] * 1e3,
                            "device_time_stats": dt, "event_step1_ms": step1["kernel_ms"],
                            "trace_refine_events": prof_ev, "stage_timer": timer.report()}
        check(prof_ev > 0, "trace: no refine_kernel event in the Chrome trace")

        # (e) bench --skip-3d through the command line
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            _, n, bench_s = counted(prr, lambda: cli.main(["bench", "--skip-3d"]))
        launches["surface_bench"] = n
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        check(line["value"] and line["value"] > 0, f"bench: {line}")
        rec["bench_s"] = bench_s
        rec["bench"] = line
        print("bench: " + json.dumps(line), flush=True)
    finally:
        if old_cache is None:
            os.environ.pop(api_utils.CACHE_ENV, None)
        else:
            os.environ[api_utils.CACHE_ENV] = old_cache
        shutil.rmtree(tmp, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    print("surface: " + json.dumps(rec), flush=True)
    check(rec["phase_s"] <= SURFACE_LIMIT_S,
          f"phase 16 took {rec['phase_s']:.1f} s, over its {SURFACE_LIMIT_S} s")
    return rec, launches


# phase 17: int8_execution (the int8 convolution kernel on MitoNet_v1's
# shapes, an int8 request, bench --int8) and the napari widgets on the card,
# within a limit of its own
INT8_LIMIT_S = 90
# the H100 SXM's dense int8 tensor-core peak (NVIDIA data sheet), op/s
INT8_OPS_PER_S = 1979e12
# MitoNet_v1's int8 convolutions in one 512 x 512 request: (name, count, input
# side, channels, stride, dilation); 13 in all
INT8_SHAPES = (("layer2_block1", 1, 128, 128, 2, 1), ("layer2_blocks2-4", 3, 64, 128, 1, 1),
               ("layer3_block1", 1, 64, 256, 2, 1), ("layer3_blocks2-6", 5, 32, 256, 1, 1),
               ("layer4_blocks1-3", 3, 32, 512, 1, 2))
# shapes beyond MitoNet_v1's, held bit for bit only: (name, N, input side,
# C_in, C_out, stride, dilation).  C % 128 != 0 (a tap's last K step is
# partly past C; below 128 channels, and at stride 9, the activations take
# the cp.async path), a ragged output whose split of K does not divide it
# evenly (9 steps over 4 blocks on 132 SMs), a 3-tap dilation
INT8_EXTRA = (("c96", 1, 20, 96, 64, 1, 1), ("c160_stride2", 2, 17, 160, 136, 2, 1),
              ("ragged_uneven_split", 1, 57, 128, 128, 1, 1),
              ("c32_dilation3", 1, 9, 32, 8, 1, 3), ("stride9", 1, 40, 128, 64, 9, 1))


def int8_shape_times(ic, x, w, wq, w_scale, stride, dil, earlier=None):
    """One int8 shape on one input, the kernel beside cuDNN's bf16 conv2d on
    the same input and weights and ``torch._int_mm`` on the im2col'd int8
    operands (the product alone; ``int_mm_row_ms`` with the weights
    row-major, the layout the kernel does not use): each one's ms a call by
    CUDA events over a CUDA graph's replays (``*_ms``, the clock of the
    comparison); with ``earlier``, the parent's kernel on the same inputs,
    in turns with this one (this, parent, parent, this: ``earlier_ms``);
    the kernel's parts (absmax and quantize passes, GEMM: each the mean
    device ms of its kernel's events) and its device activities a call
    from one torch.profiler pass; the launch plan; the plain version's
    device ms; the bound."""
    import torch
    import torch.nn.functional as F

    n, c, h, _ = x.shape
    o = wq.shape[0]
    ho = ic.output_size(h, 3, stride, dil, dil)
    iters = 20
    prof = profiled(lambda: ic.launch(x, wq, w_scale, stride, dil, dil), iters)
    # each part: the mean of the kernel's events the profiler kept (late in
    # the script it drops some, so a total over the calls would read short)
    events = [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
              if str(e.device_type).endswith("CUDA")]
    parts = {}
    for key, kind in (("gemm_ms", "gemm_kernel"), ("absmax_ms", "absmax_kernel"),
                      ("quantize_ms", "quantize_kernel")):
        ms = [t for name, t in events if kind in name]
        check(ms, f"torch.profiler saw no {kind}")
        parts[key] = sum(ms) / len(ms)
    parts["kernel_profiler_ms"] = parts["gemm_ms"] + parts["absmax_ms"] + parts["quantize_ms"]
    acts = [name for name, _ in events]
    kinds = {k for k in ("absmax_kernel", "quantize_kernel", "gemm_kernel")
             if any(k in a_ for a_ in acts)}
    p = ic.launch_plan(x, wq, w_scale, stride, dil, dil)
    xq, _, _ = ic.launch_quantize(x)
    # im2col: rows (image, output pixel), columns (channel, kh, kw)
    cols = F.unfold(xq.float(), 3, dilation=dil, padding=dil, stride=stride)
    a = cols.transpose(1, 2).reshape(-1, c * 9).to(torch.int8).contiguous()
    b = wq.reshape(o, c * 9).t()  # column-major: cuBLASLt's int8 layout, its fast path
    b_row = b.contiguous()
    wb = w.to(x.dtype)
    m, k = n * ho * ho, 9 * c
    nbytes = x.numel() * x.element_size() + wq.numel() + 4 * o + m * o * x.element_size()
    bound_ms, bound_by = bound(nbytes, 2.0 * m * o * k, INT8_OPS_PER_S)
    kernel = lambda: ic.launch(x, wq, w_scale, stride, dil, dil)  # noqa: E731
    calls = {"cudnn_bf16": lambda: F.conv2d(x, wb, stride=stride, padding=dil, dilation=dil),
             "int_mm": lambda: torch._int_mm(a, b), "int_mm_row": lambda: torch._int_mm(a, b_row)}
    want = _int32_conv(xq, wq, stride, dil)
    rec = {"n": n, "gemm_mnk": [m, o, k], **parts,
           "plan": {"tiles": p.tiles_m * p.tiles_n, "split": p.split, "k_steps": p.k_steps,
                    "blocks": p.split * p.tiles_m * p.tiles_n, "tile_width": p.wb},
           "device_activities_per_call": len(acts) / iters,
           "kernel_kinds": sorted(kinds),
           "others_per_call": sum(not any(k in a_ for k in kinds) for a_ in acts) / iters,
           "plain_ms": device_ms(lambda: ic.int8_conv_reference(x, wq, w_scale, stride, dil,
                                                                dil), 3),
           "int_mm_equal": all(bool(torch.equal(torch._int_mm(a, bb).reshape(n, ho, ho, o), want))
                               for bb in (b, b_row)),
           "bound_ms": bound_ms, "bound_by": bound_by}
    if earlier is not None:
        got = earlier.int8_conv(x, wq, w_scale, stride, dil)
        rec["earlier_equal"] = bool(torch.equal(
            got, ic.int8_conv_reference(x, wq, w_scale, stride, dil, dil)))
        turns = {"kernel": [], "earlier": []}
        for who in ("kernel", "earlier", "earlier", "kernel"):
            turns[who].append(graph_ms(kernel if who == "kernel" else (
                lambda: earlier.int8_conv(x, wq, w_scale, stride, dil))))
        rec["kernel_ms"] = sum(turns["kernel"]) / 2
        rec["earlier_ms"] = sum(turns["earlier"]) / 2
    else:
        rec["kernel_ms"] = graph_ms(kernel)
        rec["earlier_ms"] = None
    rec.update({f"{name}_ms": graph_ms(fn) for name, fn in calls.items()})
    rec["gemm_tops"] = 2.0 * m * o * k / parts["gemm_ms"] / 1e9
    rec["call_tops"] = 2.0 * m * o * k / rec["kernel_ms"] / 1e9
    return rec


def map_agreement(got, want) -> dict:
    """How far panoptic map ``got`` agrees with ``want`` (ids, 0 the
    background), in measures that a renumbering of instances does not move:
    the fraction of pixels whose foreground differs; the instances of each
    map and those matched one to one at IoU > 0.5, with the matches' mean
    IoU; the fraction of pixels whose id differs once ``got``'s matched ids
    take ``want``'s (unmatched ones a fresh id). ``ids_differing_fraction``
    compares the raw ids, which one extra instance renumbers."""
    import numpy as np

    got, want = np.asarray(got, np.int64).ravel(), np.asarray(want, np.int64).ravel()
    ids_g, area_g = np.unique(got, return_counts=True)
    ids_w, area_w = np.unique(want, return_counts=True)
    pair, inter = np.unique(got * (int(ids_w.max()) + 1) + want, return_counts=True)
    pg, pw = pair // (int(ids_w.max()) + 1), pair % (int(ids_w.max()) + 1)
    union = (area_g[np.searchsorted(ids_g, pg)] + area_w[np.searchsorted(ids_w, pw)] - inter)
    iou = inter / union
    hit = (pg > 0) & (pw > 0) & (iou > 0.5)
    fresh = int(max(ids_g.max(), ids_w.max())) + 1
    to_want = dict(zip(pg[hit].tolist(), pw[hit].tolist()))
    lut = np.array([0 if i == 0 else to_want.get(int(i), fresh + j)
                    for j, i in enumerate(ids_g)], np.int64)
    relabeled = lut[np.searchsorted(ids_g, got)]
    return {"ids_differing_fraction": float((got != want).mean()),
            "foreground_differing_fraction": float(((got > 0) != (want > 0)).mean()),
            "instances": int((ids_g > 0).sum()), "instances_reference": int((ids_w > 0).sum()),
            "instances_matched": int(hit.sum()),
            "matched_mean_iou": float(iou[hit].mean()) if hit.any() else 0.0,
            "matched_pixels_differing_fraction": float((relabeled != want).mean())}


def _int32_conv(xq, wq, stride, dil):
    """The int32 sums of the convolution, NHWC, exactly (float64 conv)."""
    import torch
    import torch.nn.functional as F

    acc = F.conv2d(xq.double(), wq.double(), stride=stride, padding=dil, dilation=dil)
    return acc.permute(0, 2, 3, 1).to(torch.int32)


def int8_phase(prr, api, cfg, model, card, bench_float, earlier=None):
    """Phase 17 (module docstring) beside phase 5's float ``model``.
    ``bench_float``: phase 16's ``bench --skip-3d`` line; ``earlier``: the
    parent's kernels (``--earlier``) or None.  Returns (record, {path: int8
    convolution launches}, {path: refine launches}, the int8 kernel's entry
    of the kernels' line)."""
    import contextlib
    import io
    import shutil
    import tempfile
    import types

    import numpy as np
    import torch

    from empanada_tpu_torch import cli
    from empanada_tpu_torch.api import utils as api_utils
    from empanada_tpu_torch.models.blocks import ConvBnAct
    from empanada_tpu_torch.napari_plugin import widgets
    from empanada_tpu_torch.ops import int8_conv as ic

    t_phase = time.perf_counter()
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator().manual_seed(17)
    rec, launches, refine_launches = {"card": card}, {}, {}

    def counted_int8(fn):
        torch.cuda.synchronize()
        ic.launches["conv"] = 0
        out, n_refine, seconds = counted(prr, fn)
        return out, ic.launches["conv"], n_refine, seconds

    # (a) the kernel against its plain version, bit for bit, at every shape,
    # N = 1 and 8, bf16 and float32 (the images of a batch differ in scale);
    # the quantized activation against the plain quantize
    inputs, checked, max_err = {}, 0, 0.0
    for name, count, side, c, stride, dil in INT8_SHAPES:
        w = (torch.randn(c, c, 3, 3, generator=gen) / (3.0 * c ** 0.5)).cuda()
        wq, w_scale = ic.quantize_weight(w)
        for n in (1, 8):
            for dt in (bf16, f32):
                x = torch.randn(n, c, side, side, generator=gen)
                x[-1] *= 3.0
                x = x.to("cuda", dt).contiguous(memory_format=torch.channels_last)
                got = ic.launch(x, wq, w_scale, stride, dil, dil)
                want = ic.int8_conv_reference(x, wq, w_scale, stride, dil, dil)
                check(got.dtype == dt and got.is_contiguous(memory_format=torch.channels_last),
                      f"int8 {name} N={n} {dt}: output {got.dtype} {got.stride()}")
                max_err = max(max_err, abs_err(got, want))
                check(torch.equal(got, want), f"int8 {name} N={n} {dt}: kernel differs from "
                      f"the plain version by {abs_err(got, want):.4g}")
                xq, a_scale, _ = ic.launch_quantize(x)
                xr, ar = ic.quantize_activation_reference(x)
                check(torch.equal(xq, xr) and torch.equal(a_scale, ar),
                      f"int8 {name} N={n} {dt}: quantized activation differs")
                checked += 1
                if dt == bf16:
                    inputs[name, n] = (x, w, wq, w_scale, stride, dil)
    uneven = []
    for name, n, side, c, o, stride, dil in INT8_EXTRA:
        w = (torch.randn(o, c, 3, 3, generator=gen) / (3.0 * c ** 0.5)).cuda()
        wq, w_scale = ic.quantize_weight(w)
        for dt in (bf16, f32):
            x = torch.randn(n, c, side, side, generator=gen)
            x[-1] *= 3.0
            x = x.to("cuda", dt).contiguous(memory_format=torch.channels_last)
            p = ic.launch_plan(x, wq, w_scale, stride, dil, dil)
            if p.k_steps % p.split and name not in uneven:
                uneven.append(name)
            got = ic.launch(x, wq, w_scale, stride, dil, dil)
            want = ic.int8_conv_reference(x, wq, w_scale, stride, dil, dil)
            max_err = max(max_err, abs_err(got, want))
            check(torch.equal(got, want), f"int8 {name} {dt} (split {p.split} of {p.k_steps} "
                  f"K steps): kernel differs from the plain version by {abs_err(got, want):.4g}")
            checked += 1
    check(uneven, "int8: no extra case splits K unevenly")
    print(f"int8 kernel vs plain: {checked} cases (5 shapes x N = 1, 8 x bf16, float32, and "
          f"{len(INT8_EXTRA)} more x bf16, float32; uneven splits: {', '.join(uneven)}) "
          "bit-identical, quantized activations identical", flush=True)

    # (b) times of each shape at N = 1 (a request) and N = 8 (bench's batch)
    shapes = []
    for name, count, side, c, stride, dil in INT8_SHAPES:
        shapes.append({"shape": name, "convs_per_request": count, "channels": c,
                       "stride": stride, "dilation": dil, "input_side": side,
                       "times": [int8_shape_times(ic, *inputs[name, n], earlier=earlier)
                                 for n in (1, 8)]})
        check(all(t["int_mm_equal"] for t in shapes[-1]["times"]),
              f"int8 {name}: torch._int_mm's sums differ from the convolution's")
        check(all(t.get("earlier_equal", True) for t in shapes[-1]["times"]),
              f"int8 {name}: the parent's kernel differs from the plain version")
        # three kernels and nothing else (no memset) a call; the profiler drops
        # events late in the script, so the kinds are checked, not the count
        check(all(len(t["kernel_kinds"]) == 3 and t["others_per_call"] == 0
                  and t["device_activities_per_call"] <= 3 for t in shapes[-1]["times"]),
              f"int8 {name}: a call is not the three kernels alone: "
              f"{[(t['kernel_kinds'], t['device_activities_per_call']) for t in shapes[-1]['times']]}")
    del inputs
    rec["shapes"] = shapes

    def per_request(key):
        return sum(s["convs_per_request"] * s["times"][0][key] for s in shapes)

    # (c) a 512 x 512 MitoNet_v1 request with int8_execution (phase 5's seed)
    cfg8 = dict(cfg, model_kwargs=dict(cfg["model_kwargs"], int8_execution=True))
    m8 = api.init_model_from_config(cfg8, seed=0, device="cuda", dtype=bf16)
    engines = {"int8": api.Engine2d(cfg8, model=m8), "float": api.Engine2d(cfg, model=model)}
    img = blob_image((512, 512), 40, 0)  # phase 5's first request
    maps = {}
    for key, eng in engines.items():
        maps[key], n8, n_ref, _ = counted_int8(lambda eng=eng: eng.infer(img))
        launches[f"int8_engine2d_{key}"] = n8
        refine_launches[f"int8_engine2d_{key}"] = n_ref
        check(n_ref == 2, f"int8 phase: {n_ref} refine launches for the {key} request")
    m32 = api.init_model_from_config(cfg, seed=0, device="cuda", dtype=f32)
    maps["float32"] = api.Engine2d(cfg, model=m32).infer(img)
    del m32
    check(launches["int8_engine2d_int8"] == 13,
          f"int8 request: {launches['int8_engine2d_int8']} int8 launches, expected 13")
    check(launches["int8_engine2d_float"] == 0, "the float request launched the int8 kernel")
    check(maps["int8"].shape == img.shape and len(np.unique(maps["int8"])) > 1,
          "int8 request: an empty or misshapen map")
    turns = {"float": [], "int8": []}
    (_, n8, n_ref, _) = counted_int8(lambda: [turns[k].append(cuda_ms(
        lambda k=k: engines[k]._dispatch(img), 10)) for k in ("float", "int8", "int8", "float") * 4])
    launches["int8_engine2d_timed"], refine_launches["int8_engine2d_timed"] = n8, n_ref

    # the int8 path's host cost a convolution: host ms a call of a layer3
    # ConvBnAct (1 x 256 x 32 x 32 bf16), int8 against float, 200 calls each
    # in turns (float, int8, int8, float); at ~0.02 ms of device time a call
    # the loop waits on the host
    x3 = torch.randn(1, 256, 32, 32, generator=gen).to("cuda", bf16).contiguous(
        memory_format=torch.channels_last)
    cbas = {k: ConvBnAct(256, 256, 3, int8_execution=k == "int8").to("cuda", bf16).eval()
            for k in ("float", "int8")}
    with torch.inference_mode():
        host_turns, n8, _, _ = counted_int8(lambda: [(k, host_ms(lambda k=k: cbas[k](x3)))
                                                     for k in ("float", "int8", "int8", "float")])
    launches["int8_host_dispatch"] = n8
    host = {k: sum(v for name, v in host_turns if name == k) / 2 for k in cbas}
    rec["request"] = {
        "int8_launches_per_request": launches["int8_engine2d_int8"],
        "engine_ms": sum(turns["int8"]) / len(turns["int8"]),
        "engine_ms_float": sum(turns["float"]) / len(turns["float"]),
        "turns_ms": turns,
        "conv_bn_act_host_ms": host,
        "int8_host_ms_added_per_request": 13 * (host["int8"] - host["float"]),
        "map_against_float": map_agreement(maps["int8"], maps["float"]),
        # the yardstick: the float model in bf16 against itself in float32
        "float_map_against_float32": map_agreement(maps["float"], maps["float32"]),
        "int8_convs_ms": per_request("kernel_ms"),
        "replaced_cudnn_bf16_ms": per_request("cudnn_bf16_ms")}
    del engines, m8

    # (d) bench --int8 --skip-3d through the command line
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _, n8, n_ref, bench_s = counted_int8(lambda: cli.main(["bench", "--int8", "--skip-3d"]))
    launches["int8_bench"], refine_launches["int8_bench"] = n8, n_ref
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    check(line.get("int8_execution") is True and line["value"] and line["value"] > 0,
          f"bench --int8: {line}")
    check(n8 > 0, "bench --int8 launched no int8 convolution")
    rec["bench"] = {"value": line["value"], "mfu": line["mfu"], "seconds": bench_s,
                    "float_value": bench_float["value"], "float_mfu": bench_float["mfu"]}
    print("bench int8: " + json.dumps(line), flush=True)

    # (e) the napari 2D widget (magicgui stubbed) on the card, on a seeded
    # int8 model registered in a registry of its own, against Engine2d
    tmp = tempfile.mkdtemp(prefix="napari-", dir=os.path.join(HERE, "empanada_tpu_torch",
                                                               "build"))
    old_dir, old_gui = api_utils.MODEL_DIR, widgets._magicgui
    try:
        api_utils.MODEL_DIR = tmp
        widgets._magicgui = lambda: (lambda **_: (lambda fn: fn))
        f32_model = api.init_model_from_config(cfg8, seed=0, device="cpu", dtype=f32)
        bundle = api.save_model_bundle(os.path.join(tmp, "smoke_int8"), cfg8["arch"],
                                       cfg8["model_kwargs"], f32_model)
        api_utils.add_new_model("smoke_int8", dict(cfg8, model=bundle))
        viewer = types.SimpleNamespace(dims=types.SimpleNamespace(current_step=(0, 0, 0)))
        layer = types.SimpleNamespace(data=img, name="em")
        (pan, meta, kind), n8, n_ref, widget_s = counted_int8(
            lambda: widgets.slice_inference_widget()(viewer, layer, model_name="smoke_int8"))
        launches["napari_widget"], refine_launches["napari_widget"] = n8, n_ref
        want = api.Engine2d(api_utils.load_config("smoke_int8"),
                            label_divisor=10000).infer(img)
        check(np.array_equal(pan, want), "napari widget: its map differs from Engine2d's")
        check(n8 == 13 and kind == "labels" and meta["name"] == "em_panoptic",
              f"napari widget: {n8} int8 launches, {kind}, {meta}")
        rec["napari_widget"] = {"equal_to_engine2d": True, "int8_launches": n8,
                                "seconds": widget_s, "dtype": "float32"}
    finally:
        api_utils.MODEL_DIR, widgets._magicgui = old_dir, old_gui
        shutil.rmtree(tmp, ignore_errors=True)

    by = {"bytes": 0.0, "operations": 0.0}
    for s in shapes:
        t = s["times"][0]
        by[t["bound_by"]] += s["convs_per_request"] * t["bound_ms"]
    entry = {
        "name": "int8_conv",
        "route": "cuda",
        "source": "empanada_tpu_torch/csrc/int8_conv.cu",
        "replaces": "empanada_tpu/models/blocks.py:62",
        "launches": launches["int8_engine2d_int8"],
        "launches_by_path": dict(launches),
        "max_abs_err": max_err,
        "ms": per_request("kernel_ms"),
        "plain_ms": per_request("plain_ms"),
        "bound_ms": per_request("bound_ms"),
        "bound_by": max(by, key=by.get),
        "library_ms": per_request("int_mm_ms"),
        "cudnn_bf16_ms": per_request("cudnn_bf16_ms"),
        "earlier_ms": per_request("earlier_ms") if earlier is not None else None,
        "gemm_ms": per_request("gemm_ms"),
        "profiler_ms": per_request("kernel_profiler_ms"),
        "kernels_per_call": len(shapes[0]["times"][0]["kernel_kinds"]),
        "device_activities_per_call": shapes[0]["times"][0]["device_activities_per_call"],
        "other_activities_per_call": shapes[0]["times"][0]["others_per_call"],
        "faster_than_earlier": ({f"{s['shape']}_n{t['n']}": t["kernel_ms"] < t["earlier_ms"]
                                 for s in shapes for t in s["times"]}
                                if earlier is not None else None),
        "per": "one 512x512 MitoNet_v1 request's 13 int8 convolutions at N = 1, each "
               "whole call (absmax, quantize, implicit GEMM: kernels_per_call) by CUDA "
               "events over CUDA-graph replays (profiler_ms, gemm_ms: torch.profiler's "
               "device time, the mean of each kernel's events); earlier_ms: the "
               "parent's kernel in turns with this one; "
               "library_ms: torch._int_mm on the im2col'd int8 operands (the product "
               "alone, column-major weights), cudnn_bf16_ms: the bf16 convolutions "
               "replaced, both on the graph clock; not a Pallas kernel (XLA's integer "
               "convolution)",
    }
    rec["phase_s"] = time.perf_counter() - t_phase
    print("int8: " + json.dumps(rec), flush=True)
    check(rec["phase_s"] <= INT8_LIMIT_S,
          f"phase 17 took {rec['phase_s']:.1f} s, over its {INT8_LIMIT_S} s")
    return rec, launches, refine_launches, entry


def _traced(trace, tmp, served, img) -> int:
    """Events of the refine kernel in the Chrome trace of one request."""
    import torch

    with trace(os.path.join(tmp, "trace")):
        served(img)
        torch.cuda.synchronize()
    events = json.load(open(os.path.join(tmp, "trace", "trace.json")))["traceEvents"]
    return sum(1 for e in events if "refine_kernel" in str(e.get("name", "")))


def step_record(prr, up, thr, feats, coarse, packed, fused, n_weights, earlier):
    """Phase 6, one refine step at N = len(up): the profiler's device time of
    the select and refine passes (and of every device activity of the call:
    the counter's zeroing too), the points, chunks and blocks, the step's
    bound; with ``earlier``, the parent's kernel on the same inputs, in
    turns (parent, this, this, parent)."""
    def launch():
        return prr.launch(up, thr, feats, coarse, packed)

    passes = {"select_ms": "select_kernel", "refine_ms": "refine_kernel<2>", "launch_ms": ""}
    runs, earlier_ms = [], []
    for who in ("earlier", "this", "this", "earlier"):
        if who == "this":
            runs.append(profile_device(launch, 20, passes))
        elif earlier is not None:
            earlier_ms.append(device_ms(lambda: earlier.refine(up, thr, feats, coarse, fused),
                                        20, "refine_kernel<2>"))
    rec = {k: sum(r[k] for r in runs) / len(runs) for k in passes}
    rec["device_ms"] = rec["select_ms"] + rec["refine_ms"]
    rec["earlier_device_ms"] = sum(earlier_ms) / 2 if earlier_ms else None
    b = step_bound(up, thr, feats, n_weights)
    rec.update(n=len(up), points_per_chunk=prr.POINTS_PER_CHUNK,
               chunks=-(-b["selected_points"] // prr.POINTS_PER_CHUNK),
               blocks=prr.persistent_grid(up.device, "full", feats.shape[-1]), **b)
    return rec


def main():
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--earlier", metavar="DIR",
                        help="a checkout of the parent commit: its refine kernel, tile "
                             "copy and int8 convolution are timed beside this one's "
                             "(earlier_ms)")
    parser.add_argument("--world-rank", nargs=5, metavar=("TASK", "RANK", "WORLD", "PORT", "DIR"),
                        help="run one rank of phase 15's worlds (the phase starts them)")
    args = parser.parse_args()
    if args.world_rank:
        task, rank, world, port, wd = args.world_rank
        return world_rank(task, int(rank), int(world), int(port), wd)

    # ---- 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs on a GPU")
    if not os.path.isfile(os.path.join(HERE, "empanada_tpu_torch", "__init__.py")):
        fail(f"the port's package is not beside this script in {HERE}")
    sys.path.insert(0, HERE)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)

    import numpy as np

    from empanada_tpu_torch import api, fp32_strict
    from empanada_tpu_torch.api import Preprocessor, init_model_from_config, load_config
    from empanada_tpu_torch.core import native
    from empanada_tpu_torch.engine import (
        PanopticDeepLabRenderEngine,
        PanopticDeepLabRenderEngine3d,
    )
    from empanada_tpu_torch.models.point_rend import StandardPointHead
    from empanada_tpu_torch.ops import _build
    from empanada_tpu_torch.ops import pointrend_refine as prr
    from empanada_tpu_torch.ops import refine_profile as rp
    from empanada_tpu_torch.parallel import data_parallel
    from empanada_tpu_torch.parallel.data_parallel import MultiChipEngine3d

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    t_start = time.perf_counter()

    # ---- 2. build: one compiler process per CUDA source, all started
    # together, then the host library; a failed build raises
    t0 = time.perf_counter()
    cuda_srcs = ("pointrend_refine", "refine_profile", "int8_conv")
    earlier_build = EarlierKernels.start(args.earlier) if args.earlier else None
    _build.load_all(cuda_srcs)
    native.load()
    earlier = EarlierKernels(earlier_build) if earlier_build else None
    print(f"build: {', '.join(cuda_srcs)} and the host library in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in cuda_srcs:
        info = _build.build_info(name)
        print(f"  {name}: {info['path']}")
        for line in info["log"].splitlines():
            if any(k in line for k in ("entry function", "registers", "spill", "smem")):
                print(f"  ptxas: {line.strip()}")

    # ---- 3. kernel vs plain on the card, MitoNet_v1 shapes
    gen = torch.Generator().manual_seed(0)
    head = StandardPointHead(256, 1, 256, 3)
    with torch.no_grad():
        for p in head.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) / np.sqrt(p.shape[-1]))
    head = head.to(dev, bf16)
    wts = head.fused_weights(256)
    packed = head.packed_weights(256)
    n_weights = sum(q.numel() for layer in wts[0] for q in layer) + 2 + wts[1][0].numel()
    max_err = 0.0
    for n in (1, 8, 32):  # a 2D request, B = 8, the 3D engine's auto batch
        feats = torch.randn(n, 128, 128, 256, generator=gen).to(dev, bf16)
        coarse = (1.5 * torch.randn(n, 128, 128, 1, generator=gen)).to(dev, bf16)
        for hc in (128, 256):  # step 1 (sf 2) and step 2 (sf 4)
            sem = (1.5 * torch.randn(n, hc, hc, 1, generator=gen)).to(dev, bf16)
            up, thr = prr.step_inputs(sem, K_POINTS)
            # the clustered case selects one 16 x 128 tile of each image
            for name, u, t in (("K-th", up, thr), ("all-skip", up, torch.full_like(thr, -1.0)),
                               ("all-refine", up, torch.full_like(thr, float("inf"))),
                               ("clustered", *clustered(up))):
                err, share = compare_refine(prr, u, t, feats, coarse, packed, wts)
                max_err = max(max_err, err)
                print(f"kernel vs plain: N={n} sf={2 * hc // 128} thr={name}: "
                      f"refined {share:.4f}, max |err| {err:.4g}", flush=True)
            if n == 32:  # the list's order changes from launch to launch; the output not
                check(torch.equal(prr.launch(up, thr, feats, coarse, packed),
                                  prr.launch(up, thr, feats, coarse, packed)),
                      f"two launches differ: N=32 sf={2 * hc // 128} K-th")
                print(f"two launches bit-identical: N=32 sf={2 * hc // 128} K-th", flush=True)

    # ragged tiles: a 624 x 700 slice pads to 624 x 704, so the steps are
    # (312, 352) and (624, 704) from a (156, 176) feature grid, and the
    # bottom and right tiles are partial
    feats = torch.randn(2, 156, 176, 256, generator=gen).to(dev, bf16)
    coarse = (1.5 * torch.randn(2, 156, 176, 1, generator=gen)).to(dev, bf16)
    for h, w in ((156, 176), (312, 352)):
        sem = (1.5 * torch.randn(2, h, w, 1, generator=gen)).to(dev, bf16)
        up, thr = prr.step_inputs(sem, K_POINTS)
        for name, t in (("K-th", thr), ("all-skip", torch.full_like(thr, -1.0)),
                        ("all-refine", torch.full_like(thr, float("inf")))):
            err, share = compare_refine(prr, up, t, feats, coarse, packed, wts)
            max_err = max(max_err, err)
            print(f"kernel vs plain, ragged: N=2 ({2 * h}, {2 * w}) thr={name}: "
                  f"refined {share:.4f}, max |err| {err:.4g}", flush=True)

    # ---- 4. refine profile: the profiling kernels, then their times
    profile_entries, profile_times = refine_profile(prr, rp, gen, head, dev, earlier)
    print("refine profile: " + json.dumps(profile_times), flush=True)

    # ---- 5. main path: MitoNet_v1 at full width through the engines
    cfg = load_config("MitoNet_v1")
    model = init_model_from_config(cfg, seed=0, device="cuda", dtype=bf16)
    check(model.semantic_pr.fused_render == "auto", "main path must run fused_render='auto'")
    pre = Preprocessor(**cfg["norms"])
    engine_kw = dict(thing_list=cfg["thing_list"], padding_factor=cfg["padding_factor"],
                     **{k: v for k, v in cfg["FINETUNE"]["engine_params"].items()
                        if k != "thing_list"})
    engine = PanopticDeepLabRenderEngine(model, **engine_kw)
    engine3d = PanopticDeepLabRenderEngine3d(model, median_kernel_size=3, **engine_kw)
    requests = [blob_image((512, 512), 40, seed) for seed in range(4)]
    requests.append(blob_image((600, 700), 50, 4))
    stack = [blob_image((512, 512), 40, 100 + z) for z in range(7)]

    prr.launches["full"] = 0
    maps = [engine(pre(img)["image"], img.shape) for img in requests]
    maps3d = [engine3d(pre(img)["image"], img.shape) for img in stack]
    maps3d = [m for m in maps3d if m is not None] + engine3d.end()
    torch.cuda.synchronize()
    launches = prr.launches["full"]

    n_slices = len(requests) + len(stack)
    check(launches == 2 * n_slices,
          f"refine kernel launched {launches} times for {n_slices} slices, expected 2 each")
    check(len(maps3d) == len(stack), f"3D engine returned {len(maps3d)} of {len(stack)} maps")
    for img, pan in zip(requests + stack, maps + maps3d):
        check(pan.dtype == np.int32 and pan.shape == img.shape,
              f"map {pan.dtype} {pan.shape} for a {img.shape} request")
    n_inst = [len(np.unique(p[p > 0])) for p in maps]
    print(f"main path: {len(requests)} 2D requests + {len(stack)}-slice stack, "
          f"refine launches {launches}, instances per 2D map {n_inst}, "
          f"dropped centers {engine.dropped_centers()}", flush=True)

    # the kernel once more on one request's real features, both steps
    x = engine._prepare(pre(requests[0])["image"])
    with torch.no_grad():
        sem_x, _ = model._encode_decode(x)
        coarse = model.semantic_head(sem_x).permute(0, 2, 3, 1).contiguous()
        feats = sem_x.permute(0, 2, 3, 1).contiguous()
        real_fused = model.semantic_pr.point_head.fused_weights(feats.shape[-1])
        real_wts = model.semantic_pr.point_head.packed_weights(feats.shape[-1])
        steps = []
        sem = coarse
        for sf in (2, 4):
            up, thr = prr.step_inputs(sem, K_POINTS)
            err, share = compare_refine(prr, up, thr, feats, coarse, real_wts, real_fused)
            max_err = max(max_err, err)
            steps.append((sem, up, thr))
            print(f"kernel vs plain on real features: sf={sf}: refined {share:.4f}, "
                  f"max |err| {err:.4g}", flush=True)
            sem = prr.launch(up, thr, feats, coarse, real_wts)
        check(bool(torch.isfinite(sem.float()).all()), "rendered logits not finite")
        step1_args = (steps[0][1], steps[0][2], feats, coarse, real_wts)  # for phase 16
        # one whole step (both passes) makes the host wait for nothing
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            prr.launch(*steps[0][1:], feats, coarse, real_wts)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        print("refine step under set_sync_debug_mode('error'): no host sync", flush=True)

    # ---- 6. times (CUDA events, after warm-up)
    pr_head = model.semantic_pr
    img0 = pre(requests[0])["image"]
    engine_ms = cuda_ms(lambda: engine.dispatch(img0, requests[0].shape), iters=10)
    stages = stage_times(engine, model, img0, engine_ms)
    print("stages: " + json.dumps(stages), flush=True)
    step_times = []
    with torch.no_grad():
        for i, (sem, up, thr) in enumerate(steps):
            kernel_ms = cuda_ms(lambda: prr.launch(up, thr, feats, coarse, real_wts), 20)
            plain_ms = cuda_ms(lambda: prr.refine_reference(up, thr, feats, coarse,
                                                            real_wts), 5)
            # A/B of the whole step, kernel ("auto") against the torch
            # dense/sparse path ("never"), in turns: never, auto, auto, never
            ab = {"never": [], "auto": []}
            for mode in ("never", "auto", "auto", "never"):
                pr_head.fused_render = mode
                ab[mode].append(cuda_ms(lambda: pr_head.step(sem, coarse, feats), 10))
            pr_head.fused_render = "auto"
            rec = step_record(prr, up, thr, feats, coarse, real_wts, real_fused,
                              n_weights, earlier)
            step_times.append(dict(step=i + 1, sf=2 * (i + 1), kernel_ms=kernel_ms,
                                   step_ms=sum(ab["auto"]) / 2, plain_ms=plain_ms,
                                   never_ms=sum(ab["never"]) / 2, ab_ms=ab,
                                   tile_share=tile_share(up, thr), **rec))
        # the clustered case at N = 1, step 1: one tile holds every point
        up_c, thr_c = clustered(steps[0][1])
        step_times.append(dict(step=1, sf=2, case="clustered", **step_record(
            prr, up_c, thr_c, feats, coarse, real_wts, real_fused, n_weights, earlier)))
    # N = 8 and 32 at seeded inputs like phase 3's, the real K-th threshold
    for n in (8, 32):
        for hc in (128, 256):
            feats_n = torch.randn(n, 128, 128, 256, generator=gen).to(dev, bf16)
            coarse_n = (1.5 * torch.randn(n, 128, 128, 1, generator=gen)).to(dev, bf16)
            sem_n = (1.5 * torch.randn(n, hc, hc, 1, generator=gen)).to(dev, bf16)
            up_n, thr_n = prr.step_inputs(sem_n, K_POINTS)
            rec = dict(step=hc // 128, sf=2 * hc // 128, kernel_ms=cuda_ms(
                lambda: prr.launch(up_n, thr_n, feats_n, coarse_n, packed), 20))
            if n == 8:
                rec["plain_ms"] = cuda_ms(lambda: prr.refine_reference(
                    up_n, thr_n, feats_n, coarse_n, wts), 3)
            rec["tile_share"] = tile_share(up_n, thr_n)
            rec.update(step_record(prr, up_n, thr_n, feats_n, coarse_n, packed, wts,
                                   n_weights, earlier))
            step_times.append(rec)
            del feats_n, coarse_n, sem_n, up_n, thr_n
    timing = {"card": card, "engine_ms_per_512_request": engine_ms, "stages": stages,
              "steps": step_times}
    print("times: " + json.dumps(timing), flush=True)

    # ---- 7. 3D: the batched xy sweep of a 64 x 512 x 512 volume at the
    # auto batch (32, two batches) streamed from the resident volume and
    # fused, and at B = 8 (8 batches) streamed from the host, streamed from
    # the resident volume and fused
    vol = blob_volume((64, 512, 512), 300, seed=3)
    engine3d_kw = dict(save_panoptic=True, min_size=64, min_extent=2)
    host_streamed = dict(sweep_fused=False, volume_resident=False)
    resident_streamed = dict(sweep_fused=False)
    runs_3d = ((None, resident_streamed, "streamed"), (None, {}, "fused"),
               (8, host_streamed, "streamed"), (8, resident_streamed, "streamed"),
               (8, {}, "fused"))
    results_3d = [sweep_3d(prr, MultiChipEngine3d(cfg, model, batch_size=b, **engine3d_kw,
                                                  **knobs), vol, real_fused)
                  for b, knobs, _ in runs_3d]
    check([(r["path"], r["resident"]) for r in results_3d]
          == [(path, knobs != host_streamed) for _, knobs, path in runs_3d],
          f"3D: paths {[(r['path'], r['resident']) for r in results_3d]}")
    check(not any(r["fallbacks"] for r in results_3d),
          "3D: a fused sweep fell back to the per-slice path")
    launches_3d = sum(r["refine_launches"] for r in results_3d if r["path"] == "streamed")
    launches_3d_fused = sum(r["refine_launches"] for r in results_3d if r["path"] == "fused")
    max_err = max([max_err] + [c["max_abs_err"] for r in results_3d
                               for c in r["kernel_vs_plain"]])
    print("3d: " + json.dumps({"card": card, "volume": list(vol.shape),
                               "sweeps": results_3d}), flush=True)

    # f32 on the card against f32 on the CPU, same weights, a small request
    fp32_strict()
    cpu_model = init_model_from_config(cfg, seed=1, device="cpu", dtype=torch.float32)
    gpu_model = init_model_from_config(cfg, seed=1, device="cuda", dtype=torch.float32)
    small = blob_image((256, 256), 12, 7)
    xs = pre(small)["image"]
    pans = [PanopticDeepLabRenderEngine(m, device=d, **engine_kw)(xs, small.shape)
            for m, d in ((cpu_model, "cpu"), (gpu_model, "cuda"))]
    equal = float((pans[0] == pans[1]).mean())
    check(equal >= 0.999, f"f32 engine on the card agrees with the CPU on {equal:.5f} of pixels")
    print(f"f32 card vs CPU on a 256 x 256 request: {equal:.6f} of pixels equal, "
          f"{len(np.unique(pans[0]))} vs {len(np.unique(pans[1]))} labels", flush=True)
    f32_3d = f32_volume_check(cfg, engine3d_kw, MultiChipEngine3d,
                              PanopticDeepLabRenderEngine3d, init_model_from_config)
    print("f32 3d: " + json.dumps(f32_3d), flush=True)

    # ---- 8. ortho: the three sweeps and the consensus of phase 7's volume,
    # pipelined and fused (the default) and streamed from the host, on the
    # same volume in the same process
    ortho_kw = dict(min_size=64, min_extent=2)
    ortho, launches_ortho = {}, {}
    for path, knobs in (("pipelined", {}), ("streamed", host_streamed)):
        ortho[path], launches_ortho[path] = ortho_phase(
            prr, api, MultiChipEngine3d(cfg, model, **ortho_kw, **knobs), cfg, vol, real_fused)
        max_err = max([max_err] + [c["max_abs_err"] for c in ortho[path]["kernel_vs_plain"]])
        print("ortho: " + json.dumps({"card": card, "path": path, **ortho[path]}), flush=True)
    check(all(a["path"] == "pipelined" for a in ortho["pipelined"]["axes"].values()),
          "ortho: the default path is not the pipelined one")
    check(ortho["pipelined"]["fallbacks"] == 0, "ortho: a fused sweep fell back")
    t0 = time.perf_counter()
    f32_ortho_check(api, cfg, MultiChipEngine3d, init_model_from_config, ortho_kw,
                    {"pipelined": {}, "streamed": host_streamed})
    phase_s = sum(o["phase_s"] for o in ortho.values()) + time.perf_counter() - t0
    print(f"phase 8 seconds: {phase_s:.1f}", flush=True)

    # ---- 9. resume: a crashed checkpointed sweep resumed on the card
    resume, launches_resume = resume_check(prr, cfg, model, MultiChipEngine3d, data_parallel)

    # ---- 10. engine2d: the public 2D engine (a request, a tiled 4096 x
    # 4096 image, NucleoNet_base_v2 at padding 512, scale 2, f32 tiled)
    t0 = time.perf_counter()
    f32_models = {"cuda": gpu_model, "cpu": cpu_model}
    _, launches_2d = engine2d_phase(prr, api, cfg, model, real_fused, card, f32_models)
    print(f"phase 10 seconds: {time.perf_counter() - t0:.1f}", flush=True)

    # ---- 11. engine3d: the per-slice engine beside the batched one, scale 2,
    # stores, f32
    t0 = time.perf_counter()
    _, launches_3d_api = engine3d_phase(prr, api, cfg, model, real_fused, card, vol,
                                        results_3d[1], MultiChipEngine3d, f32_models)
    print(f"phase 11 seconds: {time.perf_counter() - t0:.1f}", flush=True)

    # ---- 12. mini_bc: MitoNet_v1_mini through the public engines (the
    # torch PointRend path), the BC model through BCEngine{,3d} and the
    # watershed, the plain engines
    t0 = time.perf_counter()
    per_req = [s for s in step_times if s["n"] == 1 and "case" not in s]
    _, launches_12 = mini_bc_phase(prr, api, cfg, card, vol, per_req, engine3d_kw)
    print(f"phase 12 seconds: {time.perf_counter() - t0:.1f}", flush=True)

    # ---- 13. train: MitoNet_v1 trained at full width through train.main,
    # validated through the plain engine (the refine kernel), resumed
    t0 = time.perf_counter()
    _, launches_13 = train_phase(prr, api, card)
    print(f"phase 13 seconds: {time.perf_counter() - t0:.1f}", flush=True)

    # ---- 14. cli: the port's commands as a user runs them, MitoNet_v1 at
    # full width through a registry of its own
    t0 = time.perf_counter()
    _, launches_14 = cli_phase(prr, api, cfg, model, real_fused, card, vol)
    print(f"phase 14 seconds: {time.perf_counter() - t0:.1f}", flush=True)

    # ---- 15. parallel: a world of one over NCCL through the command line,
    # a world of two over gloo on this card
    t0 = time.perf_counter()
    _, launches_15, err_15 = parallel_phase(prr, api, cfg, model, card, vol)
    max_err = max(max_err, err_15)
    print(f"phase 15 seconds: {time.perf_counter() - t0:.1f}", flush=True)

    # ---- 16. surface: int8 bundles, the URL cache, the serving artifact
    # (the refine kernel as a registered op), profiling, bench
    t0 = time.perf_counter()
    surface, launches_16 = surface_phase(prr, api, cfg, model, card, engine_ms, per_req[0],
                                         step1_args)
    print(f"phase 16 seconds: {time.perf_counter() - t0:.1f}", flush=True)

    # ---- 17. int8: the int8 convolution kernel at MitoNet_v1's shapes, an
    # int8 request through Engine2d, bench --int8, the napari 2D widget
    t0 = time.perf_counter()
    _, _, launches_17, int8_entry = int8_phase(prr, api, cfg, model, card, surface["bench"],
                                               earlier)
    print(f"phase 17 seconds: {time.perf_counter() - t0:.1f}", flush=True)

    kernels = [{
        "name": "pointrend_refine",
        "route": "cuda",
        "source": "empanada_tpu_torch/csrc/pointrend_refine.cu",
        "replaces": "empanada_tpu/ops/pallas_pointrend.py:202",
        "launches": (launches + launches_3d + launches_3d_fused
                     + sum(launches_ortho.values()) + launches_resume
                     + sum(launches_2d.values()) + sum(launches_3d_api.values())
                     + sum(launches_12.values()) + sum(launches_13.values())
                     + sum(launches_14.values()) + sum(launches_15.values())
                     + sum(launches_16.values()) + sum(launches_17.values())),
        "launches_by_path": {"render_engines": launches, "volume_xy": launches_3d,
                             "volume_xy_fused": launches_3d_fused,
                             "volume_ortho_pipelined": launches_ortho["pipelined"],
                             "volume_ortho_streamed": launches_ortho["streamed"],
                             "volume_xy_resumed": launches_resume,
                             **launches_2d, **launches_3d_api, **launches_12,
                             **launches_13, **launches_14, **launches_15, **launches_16,
                             **launches_17},
        "max_abs_err": max_err,
        "ms": sum(s["launch_ms"] for s in per_req),
        "passes_ms": sum(s["device_ms"] for s in per_req),
        "event_ms": sum(s["kernel_ms"] for s in per_req),
        "earlier_ms": (sum(s["earlier_device_ms"] for s in per_req)
                       if earlier is not None else None),
        "plain_ms": sum(s["plain_ms"] for s in per_req),
        "bound_ms": sum(s["bound_ms"] for s in per_req),
        "bound_by": max(per_req, key=lambda s: s["bound_ms"])["bound_by"],
        "library_ms": None,
        "per": "one 512x512 request: step 1 (sf 2) + step 2 (sf 4), torch.profiler device "
               "time of every activity of the two calls (the counter's zeroing, the select "
               "and refine passes); passes_ms: the two passes alone",
    }] + profile_entries + [int8_entry]
    print(f"total seconds: {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
