"""The port's benchmark on the card (counterpart of the repository root's
``bench.py``, whose flags, sections and JSON keys it mirrors):

    python -m empanada_tpu_torch bench [--skip-3d] [--only SECTION]

It prints ONE JSON line.  The headline ``value`` is Mvox/s of MitoNet_v1's
architecture (PanopticDeepLabPR, resnet50 at output stride 16, K = 8192,
seeded random weights, bf16) through the whole device pipeline of a
512 x 512 x 8 batch: the forward with two PointRend steps (the refine
kernel), the instance cells, the hardened logits and the coarse merge.
``mfu`` is the pipeline's FLOPs, counted by
``torch.utils.flop_counter.FlopCounterMode``, over the time and the card's
dense bf16 peak.  ``--int8`` builds the headline's model with
``int8_execution`` (its wide 3 x 3 encoder convolutions through the int8
kernel, ``ops/int8_conv.py``; their products counted as FLOPs, so ``mfu``
keeps its denominator) and adds ``"int8_execution": true`` to the line; the
3D, ortho, spatial and multimodel sections keep the float model, as the root
script's do.  Without ``--skip-3d`` the line also holds ``value_3d``
(``MultiChipEngine3d`` on a 64 x 512 x 512 blob volume, end to end),
``value_ortho`` (the three sweeps and the consensus of 64 x 256 x 256),
``spatial``, ``multimodel``, ``train_*`` and ``stages_2d``.  ``--only``
runs one section and prints ``{section: result}``.

Every time comes from the card: ``main`` exits without one.  The section
functions take the model, inputs and sizes as arguments, so they run on
any device (a CPU run measures the CPU, and its numbers are nobody's
device metric).  ``--measure-baseline`` (it runs the reference
implementation, which is not in this repository) exits non-zero and says
why.  The root script's ``vs_baseline`` divides by
reference numbers measured on another host; here it is null.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

H = W = 512
BATCH = 8
ITERS = 10

# MitoNet_v1 (configs/MitoNet_v1.yaml), shared by every section
FLAGSHIP_KW = dict(encoder="resnet50", num_classes=1, stage4_stride=16,
                   decoder_channels=256, low_level_stages=[1],
                   low_level_channels_project=[32], ins_decoder=True,
                   subdivision_num_points=8192)
CONFIG = {"model_name": "bench", "class_names": {1: "mito"}, "labels": [1],
          "thing_list": [1], "norms": {"mean": 0.57, "std": 0.12},
          "padding_factor": 128, "description": ""}

# NVIDIA H100 SXM (80 GB HBM3), dense bf16 tensor-core peak without
# sparsity, from NVIDIA's data sheet at the 700 W power limit: the
# denominator of every mfu here, whatever the card's set limit
H100_BF16_DENSE_PEAK = 989e12

METRIC = "MitoNet_v1-arch 2D panoptic inference (fwd+postprocess, 512x512xB8, bf16)"

__all__ = ["build", "blob_images", "blob_volume", "flop_count", "bench_2d",
           "bench_stages", "bench_3d", "bench_ortho", "bench_spatial",
           "bench_multimodel", "bench_train", "main"]


def build(device, kw=None, dtype=torch.bfloat16, seed: int = 0):
    """(pipeline_batch, model): a seeded model of ``kw`` (default
    MitoNet_v1's widths) and its batched device pipeline, normalized
    (B, H, W, 1) float images -> (B, H, W) int32 panoptic maps."""
    from empanada_tpu_torch.api.utils import init_model_from_config
    from empanada_tpu_torch.ops import postprocess as pp

    model = init_model_from_config({"arch": "PanopticDeepLabPR",
                                    "model_kwargs": dict(kw or FLAGSHIP_KW)},
                                   seed=seed, device=device, dtype=dtype).eval()

    @torch.no_grad()
    def pipeline_batch(images):
        out = model(images.to(dtype), render_steps=2, interpolate_ins=False)
        sem = pp.harden_logits(out["sem_logits"], 0.5)
        cells = pp.get_instance_cells(out["ctr_hmp"], out["offsets"], True, 1, 0.1, 7, 256,
                                      keep_coarse=True)
        return pp.merge_semantic_and_instance_coarse(sem, cells, 1000, (1,), 64, 0, 2, 256,
                                                     step=4)

    return pipeline_batch, model


def blob_images(batch: int, h: int, w: int, device, seed: int = 0) -> torch.Tensor:
    """Standardized smooth noise (B, H, W, 1) float32, the root bench's
    2D input."""
    from scipy.ndimage import gaussian_filter

    raw = np.random.default_rng(seed).normal(0, 1, (batch, h, w, 1))
    raw = np.stack([gaussian_filter(im, (12, 12, 0)) for im in raw])
    raw = (raw - raw.mean()) / (raw.std() + 1e-6)
    return torch.as_tensor(raw, dtype=torch.float32, device=device)


def blob_volume(d: int, h: int, w: int, sigma: float, seed: int = 0) -> np.ndarray:
    """The root bench's seeded uint8 blob volume."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    field = gaussian_filter(rng.normal(0, 1, (d, h, w)), (2, sigma, sigma))
    field /= field.std()
    return ((field > 0.6) * 110 + 90 + rng.normal(0, 6, (d, h, w))).clip(0, 255).astype(np.uint8)


def flop_count(fn, *args) -> int:
    """FLOPs of one call of ``fn(*args)`` by ``FlopCounterMode`` (matrix
    products and convolutions; the kernel's MLP is not counted)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn(*args)
    return int(counter.get_total_flops())


def _mfu(flops, seconds, device):
    if not flops or seconds <= 0 or torch.device(device).type != "cuda":
        return None
    return flops / seconds / H100_BF16_DENSE_PEAK


def bench_2d(pipeline_batch, images, iters: int = ITERS, trials: int = 5) -> dict:
    """The headline: ``device_time`` stats of the pipeline on ``images``,
    its Mvox/s and mfu."""
    from empanada_tpu_torch.utils import device_time

    st = device_time(pipeline_batch, images, iters=iters, trials=trials, stats=True)
    flops = flop_count(pipeline_batch, images)
    b, h, w = images.shape[:3]
    return {"mvox_s": b * h * w / st["s"] / 1e6, "stats": st, "flops": flops,
            "mfu": _mfu(flops, st["s"], images.device)}


def bench_stages(model, pipeline_batch, images, iters: int = 6, trials: int = 5) -> dict:
    """Times of the nested prefixes of the pipeline (encoder, + decoders,
    + heads and render, + postprocess) and of each stage's difference, with
    its FLOPs and mfu; a longer prefix measured faster is clamped to a zero
    difference and flagged ``nonmonotone``."""
    from empanada_tpu_torch.utils import device_time

    dtype = next(model.parameters()).dtype

    def nchw(x):
        return x.to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

    prefixes = [
        ("encoder", lambda x: model.encoder(nchw(x), False)),
        ("decoders", lambda x: model._encode_decode(x.to(dtype))),
        ("heads+render", lambda x: model(x.to(dtype), render_steps=2, interpolate_ins=False)),
        ("postprocess", pipeline_batch),
    ]
    out, prev, total = {}, (0.0, 0), None
    for name, fn in prefixes:
        with torch.no_grad():
            st = device_time(fn, images, iters=iters, trials=trials, stats=True)
        flops = flop_count(fn, images)
        ms = st["s"] * 1e3
        stage = {"prefix_ms": ms, "jitter": st["jitter"]}
        if ms < prev[0]:
            stage["nonmonotone"] = True
            ms = prev[0]
        stage["ms"] = ms - prev[0]
        stage["flops"] = flops - prev[1]
        stage["mfu"] = _mfu(stage["flops"], stage["ms"] / 1e3, images.device)
        out[name] = stage
        prev, total = (ms, flops), ms
    for stage in out.values():
        stage["share"] = stage["ms"] / total if total else None
    return out


def _median_runs(run_once, n: int = 3):
    results = sorted((run_once() for _ in range(n)), key=lambda r: r[0])
    walls = [r[0] for r in results]
    return results[(n - 1) // 2], {"runs": n, "median_s": statistics.median(walls),
                                   "min_s": min(walls), "max_s": max(walls)}


_HOST_STAGES = ("host_prep", "host_decode+enqueue", "matcher_drain", "backward_matching",
                "fill_volume")


def _device_busy_s(run, device):
    """Seconds of CUDA kernels in one ``run()`` by ``torch.profiler``;
    None off the card."""
    if torch.device(device).type != "cuda":
        run()
        return None
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    total_us = 0.0
    for evt in prof.key_averages():
        total_us += getattr(evt, "self_device_time_total",
                            getattr(evt, "self_cuda_time_total", 0.0))
    return total_us / 1e6


def _attribution(report: dict, total_s: float, device_s):
    """Wall seconds split into the card's busy time, the main thread's
    host stages and the rest (overlap lets the parts pass the total)."""
    host_s = sum(report.get(s, {}).get("total_s", 0.0) for s in _HOST_STAGES)
    return {"device_s": device_s, "host_s": host_s,
            "transfer_s": max(0.0, total_s - (device_s or 0.0) - host_s),
            "matcher_thread_s": report.get("matcher_busy", {}).get("total_s", 0.0)}


def _engine3d(model, device, max_centers: int, batch_size=None):
    from empanada_tpu_torch.parallel.data_parallel import MultiChipEngine3d

    return MultiChipEngine3d(CONFIG, model, label_divisor=1000, median_kernel_size=3,
                             batch_size=batch_size, max_centers=max_centers, device=device)


def bench_3d(model, volume, device, max_centers: int = 512, runs: int = 3,
             batch_size=None) -> dict:
    """``MultiChipEngine3d`` xy sweep of ``volume`` end to end (after a
    warm-up sweep), the median of ``runs``, with its attribution."""
    from empanada_tpu_torch.utils import StageTimer

    engine = _engine3d(model, device, max_centers, batch_size)
    engine.infer_on_axis(volume, "xy")

    def run_once():
        timer = StageTimer()
        t0 = time.perf_counter()
        engine.infer_on_axis(volume, "xy", timer=timer)
        return time.perf_counter() - t0, timer.report()

    (dt, report), spread = _median_runs(run_once, runs)
    out = {"mvox_s": volume.size / dt / 1e6, "spread": spread,
           "center_overflow": engine.last_overflow, "batch": engine.last_batch_size}
    out.update(_attribution(report, dt, _device_busy_s(
        lambda: engine.infer_on_axis(volume, "xy"), device)))
    return out


def bench_ortho(model, volume, device, max_centers: int = 512, runs: int = 3) -> dict:
    """xy, xz and yz sweeps of ``volume`` and the consensus: output
    Mvox/s, the median of ``runs``, with the sweeps' attribution."""
    from empanada_tpu_torch.stitch.consensus import merge_objects_from_trackers
    from empanada_tpu_torch.utils import StageTimer

    engine = _engine3d(model, device, max_centers)
    engine.infer_orthoplane(volume)

    def run_once():
        timer = StageTimer()
        t0 = time.perf_counter()
        trackers = engine.infer_orthoplane(volume, timer=timer)
        t_sweeps = time.perf_counter() - t0
        merge_objects_from_trackers([trackers[ax][0] for ax in ("xy", "xz", "yz")],
                                    pixel_vote_thr=2, cluster_iou_thr=0.75)
        return time.perf_counter() - t0, (t_sweeps, timer.report())

    (dt, (t_sweeps, report)), spread = _median_runs(run_once, runs)
    out = {"mvox_s": volume.size / dt / 1e6, "spread": spread,
           "center_overflow": engine.last_overflow, "consensus_s": dt - t_sweeps}
    out.update(_attribution(report, t_sweeps, _device_busy_s(
        lambda: engine.infer_orthoplane(volume), device)))
    return out


def bench_spatial(model, image, device, tile_size: int = 512, halo: int = 128,
                  runs: int = 3) -> dict:
    """One big slice as one halo-sharded slice (``spatial_shard``, the
    world of this process) against the serial tiled path."""
    from empanada_tpu_torch.api import Engine2d
    from empanada_tpu_torch.stitch.tile import Tiler

    common = dict(nms_kernel=7, confidence_thr=0.5, max_centers=2048, model=model,
                  device=device)
    engines = {"sharded": Engine2d(CONFIG, spatial_shard=True, spatial_halo=halo, **common),
               "tiled": Engine2d(CONFIG, tile_size=tile_size, **common)}
    side = image.shape[0]
    out = {"side": side, "devices": engines["sharded"].spatial_engine.mesh.size}
    for name, eng in engines.items():
        eng.infer(image[:tile_size, :tile_size] if name == "tiled" else image)

        def run_once(eng=eng):
            t0 = time.perf_counter()
            pan = eng.infer(image)
            return time.perf_counter() - t0, pan

        (dt, pan), spread = _median_runs(run_once, runs)
        out[name] = {"wall_s": dt, "spread": spread, "mpx_s": image.size / dt / 1e6,
                     "instances": int(len(np.unique(pan[(pan >= 1000) & (pan < 2000)])))}
    n_tiles = len(Tiler(image.shape, tile_size=tile_size,
                        overlap_width=min(128, int(tile_size * 0.1))))
    out["tiled"]["dispatches"] = 2 * n_tiles
    out["sharded"]["dispatches"] = 2
    out["speedup_vs_tiled"] = out["tiled"]["wall_s"] / out["sharded"]["wall_s"]
    return out


def bench_multimodel(pipes, images, iters: int = 4, trials: int = 2) -> dict:
    """Two models over one batch in one device clock, and the host's
    combination of their maps."""
    from empanada_tpu_torch.api.inference import combine_panoptic_maps
    from empanada_tpu_torch.utils import device_time

    def both(x):
        return pipes[0](x).sum() + pipes[1](x).sum()

    dt = device_time(both, images, iters=iters, trials=trials)
    cfg = {"model_name": "m", "class_names": {1: "a"}, "labels": [1], "thing_list": [1]}
    pans = [p(images).cpu().numpy() for p in pipes]
    t0 = time.perf_counter()
    for b in range(images.shape[0]):
        combine_panoptic_maps([pans[0][b], pans[1][b]],
                              [dict(cfg, model_name="nucleo"), dict(cfg, model_name="drop")])
    combine_s = time.perf_counter() - t0
    b, h, w = images.shape[:3]
    return {"mvox_s": b * h * w / dt / 1e6, "combine_ms_per_slice": combine_s / b * 1e3}


def bench_train(device, batch: int = 16, side: int = 256, kw=None, iters: int = 8,
                trials: int = 5) -> dict:
    """Train steps of the flagship (``PanopticLoss`` + AdamW/OneCycle,
    float32 parameters under bf16 autocast) on a seeded batch: images a
    second and mfu (one step's FLOPs by ``FlopCounterMode``)."""
    from empanada_tpu_torch.api.utils import init_model_from_config
    from empanada_tpu_torch.train import (
        PanopticLoss,
        create_train_state,
        make_train_step,
        onecycle_schedule,
    )
    from empanada_tpu_torch.utils import device_time

    model = init_model_from_config({"arch": "PanopticDeepLabPR",
                                    "model_kwargs": dict(kw or FLAGSHIP_KW)}, device=device)
    state = create_train_state(model, onecycle_schedule(3e-3, 1000), weight_decay=0.1)
    step = make_train_step(PanopticLoss(), amp=torch.device(device).type == "cuda")
    rng = np.random.default_rng(0)
    targets = {
        "sem": torch.as_tensor(rng.integers(0, 2, (batch, side, side)), device=device),
        "ctr_hmp": torch.as_tensor(rng.random((batch, side, side, 1)), dtype=torch.float32,
                                   device=device),
        "offsets": torch.as_tensor(rng.normal(0, 5, (batch, side, side, 2)),
                                   dtype=torch.float32, device=device),
    }
    image = torch.as_tensor(rng.normal(0, 1, (batch, side, side, 1)), dtype=torch.float32,
                            device=device)

    def fn(image):
        aux = step(state, dict(targets, image=image))
        return sum(aux.values())

    with torch.enable_grad():
        st = device_time(fn, image, iters=iters, trials=trials, stats=True)
        from torch.utils.flop_counter import FlopCounterMode

        counter = FlopCounterMode(display=False)
        with counter:
            fn(image)
    return {"imgs_s": batch / st["s"], "mfu": _mfu(counter.get_total_flops(), st["s"], device),
            "jitter": st["jitter"]}


def main(argv=None):
    parser = argparse.ArgumentParser("empanada-tpu-torch bench")
    parser.add_argument("--measure-baseline", action="store_true")
    parser.add_argument("--skip-3d", action="store_true")
    parser.add_argument("--int8", action="store_true",
                        help="A/B: int8 execution of the wide 3x3 encoder convolutions "
                             "(s8xs8->s32 kernel)")
    parser.add_argument("--only", default=None,
                        choices=["3d", "ortho", "train", "stages", "spatial", "multimodel"])
    args = parser.parse_args(argv)
    if args.measure_baseline:
        raise SystemExit("bench --measure-baseline: the baseline is the reference "
                         "implementation run on the CPU, and its checkout is not part of "
                         "this repository")
    if not torch.cuda.is_available():
        raise SystemExit("bench measures the card: no CUDA device is available")
    device = torch.device("cuda")
    card = {"kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    headline_kw = dict(FLAGSHIP_KW, int8_execution=True) if args.int8 else None

    if args.only:
        fns = {
            "3d": lambda: bench_3d(build(device)[1], blob_volume(64, H, W, 8), device),
            "ortho": lambda: bench_ortho(build(device)[1], blob_volume(64, 256, 256, 6),
                                         device),
            "train": lambda: bench_train(device),
            "stages": lambda: bench_stages(*reversed(build(device, headline_kw)),
                                           blob_images(BATCH, H, W, device)),
            "spatial": lambda: bench_spatial(build(device)[1],
                                             blob_volume(1, 2048, 2048, 16)[0], device),
            "multimodel": lambda: bench_multimodel([build(device, seed=s)[0] for s in (0, 1)],
                                                   blob_images(BATCH, H, W, device)),
        }
        print(json.dumps({args.only: fns[args.only](), "device": card}))
        return

    pipeline_batch, model = build(device, headline_kw)
    images = blob_images(BATCH, H, W, device)
    r2d = bench_2d(pipeline_batch, images)
    st = r2d["stats"]
    out = {
        "metric": METRIC,
        "value": r2d["mvox_s"],
        "unit": "Mvox/s/chip",
        "vs_baseline": None,
        "baseline_fp32": None,
        "baseline_int8": None,
        "mfu": r2d["mfu"],
        "flops": r2d["flops"],
        "spread_2d": {"median_s": st["median_s"], "max_s": st["max_s"],
                      "valid_trials": st["valid_trials"], "jitter": st["jitter"],
                      "window1_s": st["s"]},
        "metric_3d": "3D stack e2e (MultiChipEngine3d 64x512x512, max_centers=512, "
                     "device+host)",
        "metric_ortho": "ortho-plane consensus e2e (xy/xz/yz sweeps + consensus, "
                        "64x256x256, output Mvox/s)",
        "metric_spatial": "big slice (2048^2, spatial-shard against the serial tile loop)",
        "metric_train": "train step (PanopticLoss+AdamW, bf16 autocast, 256^2xB16)",
        "device": card,
    }
    if args.int8:
        out["int8_execution"] = True
    if not args.skip_3d:
        out["stages_2d"] = bench_stages(model, pipeline_batch, images)
        float_pipe, float_model = build(device) if args.int8 else (pipeline_batch, model)
        r3d = bench_3d(float_model, blob_volume(64, H, W, 8), device)
        out["value_3d"] = r3d.pop("mvox_s")
        out["vs_baseline_3d"] = None
        out["attribution_3d"] = r3d
        rortho = bench_ortho(float_model, blob_volume(64, 256, 256, 6), device)
        out["value_ortho"] = rortho.pop("mvox_s")
        out["vs_baseline_ortho"] = None
        out["attribution_ortho"] = rortho
        out["spatial"] = bench_spatial(float_model, blob_volume(1, 2048, 2048, 16)[0],
                                       device)
        out["multimodel"] = bench_multimodel([float_pipe, build(device, seed=1)[0]], images)
        rtrain = bench_train(device)
        out["train_imgs_s"] = rtrain["imgs_s"]
        out["train_mfu"] = rtrain["mfu"]
        out["train_jitter"] = rtrain["jitter"]
        # the second window of the headline, after the other sections
        st2 = bench_2d(pipeline_batch, images)["stats"]
        out["spread_2d"]["window2_s"] = st2["s"]
        if st2["s"] < st["s"]:
            out["value"] = BATCH * H * W / st2["s"] / 1e6
            out["mfu"] = _mfu(r2d["flops"], st2["s"], device)
    print(json.dumps(out))


if __name__ == "__main__":
    sys.exit(main())
