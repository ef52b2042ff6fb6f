#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (empanada_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it goes wrong:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the PointRend refine kernel (csrc/pointrend_refine.cu)
   with nvcc and prints the build seconds and ptxas' resource report;
3. kernel vs plain: the kernel against its plain PyTorch version on the
   card at MitoNet_v1's shapes (N = 1 and 8, steps sf = 2 and 4, F = 256,
   K = 8192, bf16) and at a ragged geometry (partial edge tiles), each at
   the real threshold, all-skip and all-refine;
4. main path: MitoNet_v1 at full width (seeded random weights, random BN
   statistics, bf16) serves four 512 x 512 uint8 requests and one 600 x 700
   request through PanopticDeepLabRenderEngine, and a 7-slice stack through
   PanopticDeepLabRenderEngine3d; the refine kernel must launch twice per
   slice; the kernel is compared with its plain version on one request's
   real features; the f32 engine on the card is held to the f32 engine on
   the CPU on a small request;
5. times: CUDA-event times of the engine and its stages (trunk, PointRend,
   postprocess; device busy time from torch.profiler), of each refine step
   (kernel, plain version, and the whole step through the kernel against
   the fused_render="never" torch path, in turns) and each step's bound,
   printed as JSON.

The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``.  Run from the repository root (the
script imports the port from its own directory).
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
K_POINTS = 8192


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


def compare_refine(prr, up, thr, feats, coarse, wts):
    """Kernel vs plain version on the same inputs: the mask and every
    copied-through pixel bit-exact, refined pixels within the tolerance of
    tests/test_pointrend_fused.py.  Returns (max abs error, refined share)."""
    import torch

    got = prr.launch(up, thr, feats, coarse, wts).float()
    want = prr.refine_reference(up, thr, feats, coarse, wts).float()
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


def main():
    import torch

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

    from empanada_tpu_torch import fp32_strict
    from empanada_tpu_torch.api import Preprocessor, init_model_from_config, load_config
    from empanada_tpu_torch.engine import (
        PanopticDeepLabRenderEngine,
        PanopticDeepLabRenderEngine3d,
    )
    from empanada_tpu_torch.models.point_rend import StandardPointHead
    from empanada_tpu_torch.ops import _build
    from empanada_tpu_torch.ops import pointrend_refine as prr

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    t_start = time.perf_counter()

    # ---- 2. build
    t0 = time.perf_counter()
    _build.load("pointrend_refine")
    info = _build.build_info("pointrend_refine")
    print(f"build: pointrend_refine in {time.perf_counter() - t0:.1f} s -> {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- 3. kernel vs plain on the card, MitoNet_v1 shapes
    gen = torch.Generator().manual_seed(0)
    head = StandardPointHead(256, 1, 256, 3)
    with torch.no_grad():
        for p in head.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) / np.sqrt(p.shape[-1]))
    head = head.to(dev, bf16)
    wts = head.fused_weights(256)
    n_weights = prr.pack_weights(wts).numel()
    max_err = 0.0
    for n in (1, 8):
        feats = torch.randn(n, 128, 128, 256, generator=gen).to(dev, bf16)
        coarse = (1.5 * torch.randn(n, 128, 128, 1, generator=gen)).to(dev, bf16)
        for hc in (128, 256):  # step 1 (sf 2) and step 2 (sf 4)
            sem = (1.5 * torch.randn(n, hc, hc, 1, generator=gen)).to(dev, bf16)
            up, thr = prr.step_inputs(sem, K_POINTS)
            for name, t in (("K-th", thr), ("all-skip", torch.full_like(thr, -1.0)),
                            ("all-refine", torch.full_like(thr, float("inf")))):
                err, share = compare_refine(prr, up, t, feats, coarse, wts)
                max_err = max(max_err, err)
                print(f"kernel vs plain: N={n} sf={2 * hc // 128} thr={name}: "
                      f"refined {share:.4f}, max |err| {err:.4g}", flush=True)

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
            err, share = compare_refine(prr, up, t, feats, coarse, wts)
            max_err = max(max_err, err)
            print(f"kernel vs plain, ragged: N=2 ({2 * h}, {2 * w}) thr={name}: "
                  f"refined {share:.4f}, max |err| {err:.4g}", flush=True)

    # ---- 4. main path: MitoNet_v1 at full width through the engines
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

    prr.refine_launches = 0
    maps = [engine(pre(img)["image"], img.shape) for img in requests]
    maps3d = [engine3d(pre(img)["image"], img.shape) for img in stack]
    maps3d = [m for m in maps3d if m is not None] + engine3d.end()
    torch.cuda.synchronize()
    launches = prr.refine_launches

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
        real_wts = model.semantic_pr.point_head.fused_weights(feats.shape[-1])
        steps = []
        sem = coarse
        for sf in (2, 4):
            up, thr = prr.step_inputs(sem, K_POINTS)
            err, share = compare_refine(prr, up, thr, feats, coarse, real_wts)
            max_err = max(max_err, err)
            steps.append((sem, up, thr))
            print(f"kernel vs plain on real features: sf={sf}: refined {share:.4f}, "
                  f"max |err| {err:.4g}", flush=True)
            sem = prr.launch(up, thr, feats, coarse, real_wts)
        check(bool(torch.isfinite(sem.float()).all()), "rendered logits not finite")

    # ---- 5. times (CUDA events, after warm-up)
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
            b = step_bound(up, thr, feats, n_weights)
            step_times.append(dict(step=i + 1, sf=2 * (i + 1), n=1, kernel_ms=kernel_ms,
                                   step_ms=sum(ab["auto"]) / 2, plain_ms=plain_ms,
                                   never_ms=sum(ab["never"]) / 2, ab_ms=ab,
                                   tile_share=tile_share(up, thr), **b))
    # N = 8 at the seeded inputs of phase 3, the real K-th threshold
    for hc in (128, 256):
        feats8 = torch.randn(8, 128, 128, 256, generator=gen).to(dev, bf16)
        coarse8 = (1.5 * torch.randn(8, 128, 128, 1, generator=gen)).to(dev, bf16)
        sem8 = (1.5 * torch.randn(8, hc, hc, 1, generator=gen)).to(dev, bf16)
        up8, thr8 = prr.step_inputs(sem8, K_POINTS)
        step_times.append(dict(
            step=hc // 128, sf=2 * hc // 128, n=8,
            kernel_ms=cuda_ms(lambda: prr.launch(up8, thr8, feats8, coarse8, wts), 20),
            plain_ms=cuda_ms(lambda: prr.refine_reference(up8, thr8, feats8, coarse8,
                                                          wts), 3),
            tile_share=tile_share(up8, thr8), **step_bound(up8, thr8, feats8, n_weights)))
    timing = {"card": card, "engine_ms_per_512_request": engine_ms, "stages": stages,
              "steps": step_times}
    print("times: " + json.dumps(timing), flush=True)

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

    per_req = [s for s in step_times if s["n"] == 1]
    kernels = [{
        "name": "pointrend_refine",
        "route": "cuda",
        "source": "empanada_tpu_torch/csrc/pointrend_refine.cu",
        "replaces": "empanada_tpu/ops/pallas_pointrend.py:202",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": sum(s["kernel_ms"] for s in per_req),
        "plain_ms": sum(s["plain_ms"] for s in per_req),
        "bound_ms": sum(s["bound_ms"] for s in per_req),
        "bound_by": max(per_req, key=lambda s: s["bound_ms"])["bound_by"],
        "library_ms": None,
        "per": "one 512x512 request: step 1 (sf 2) + step 2 (sf 4)",
    }]
    print(f"total seconds: {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
