"""Command line of the PyTorch/CUDA port (counterpart of
``empanada_tpu/cli.py``, with its subcommands, flags, defaults, printed
lines and output files):

  empanada-tpu-torch infer2d   <image> --model MitoNet_v1 [--tile-size 2048] ...
  empanada-tpu-torch infer3d   <volume> [--orthoplane] [--store out.zarr] ...
  empanada-tpu-torch train     <config.yaml>
  empanada-tpu-torch finetune  <config.yaml>
  empanada-tpu-torch evaluate  <gt.json> <pred.json>
  empanada-tpu-torch models    [list|info|export|import|archive]
  empanada-tpu-torch tiles     [chop|merge]
  empanada-tpu-torch labels    [count|small|boundary] <labels>
  empanada-tpu-torch port      <checkpoint>
  empanada-tpu-torch docs

Usage: ``python -m empanada_tpu_torch <command> ...``.  The commands that
run a model take ``--device`` (default ``cuda``; ``--device cpu`` runs on
the CPU, as the tests do).  On the card the models run in bfloat16, the
dtype the PointRend refine kernel takes; on the CPU in float32, as the JAX
package's command line runs.  Images are read and written as ``.npy``,
PNG or uncompressed TIFF (``data/imread.py``, ``data/imwrite.py``), and
volumes also from chunked stores.  The flags of what the port does not
have yet exit non-zero and name their ROADMAP item: ``models deploy``,
``serve``, ``--quantize`` and ``bench`` (item 13).

Several cards, one process each: ``--coordinator host:port
--num-processes N --process-id R`` (or ``EMPANADA_COORDINATOR``,
``EMPANADA_NUM_PROCESSES``, ``EMPANADA_PROCESS_ID``) on ``infer2d``,
``infer3d`` and ``train`` join the processes into one world before any
model touches a card (NCCL on the cards, gloo with ``--device cpu``).
Then ``infer3d --multichip`` splits each batch over the world,
``infer2d --spatial-shard`` splits the image's rows and ``train
--multichip`` trains data-parallel; every rank computes the result and
rank 0 writes the files.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ITEM_13 = "ROADMAP item 13"


def _device(args):
    """The torch device of ``--device``; no GPU for ``cuda`` exits naming
    the flag."""
    import torch

    from empanada_tpu_torch.utils import resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError:
        raise SystemExit(f"{args.command}: no CUDA device is available; pass --device cpu "
                         "to run on the CPU")
    return dev, (torch.bfloat16 if dev.type == "cuda" else torch.float32)


def _load_array(path: str):
    if path.endswith(".npy"):
        return np.load(path)
    if os.path.isdir(path) and os.path.exists(os.path.join(path, ".zarray")):
        from empanada_tpu_torch.core.chunked import open_chunked

        return open_chunked(path)
    from empanada_tpu_torch.data.imread import imread

    return imread(path)


def _save_labels(path: str, labels: np.ndarray):
    """Write exactly ``path``: ``.npy`` through numpy, else a (multipage)
    PNG or TIFF of ``_to_saveable`` pages, as the JAX package writes."""
    labels = np.asarray(labels)
    if path.endswith(".npy"):
        np.save(path, labels)
        return
    from empanada_tpu_torch.curation.export import _to_saveable
    from empanada_tpu_torch.data.imwrite import imwrite

    imwrite(path, _to_saveable(labels) if labels.ndim == 2 else
            [_to_saveable(sl) for sl in labels])


def _model_config(name_or_path: str) -> dict:
    from empanada_tpu_torch.api import get_configs, load_config

    if os.path.isfile(name_or_path):
        name = os.path.splitext(os.path.basename(name_or_path))[0]
    elif name_or_path in get_configs():
        name = name_or_path
    else:
        raise SystemExit(f"unknown model '{name_or_path}'; registered: "
                         f"{sorted(get_configs())}")
    config = load_config(name_or_path)
    config.setdefault("model_name", name)
    return config


def _model_list(args) -> list:
    """``--model`` repeats; MitoNet_v1 when it is not given."""
    models = args.model or ["MitoNet_v1"]
    if len(set(models)) != len(models):
        raise SystemExit(f"duplicate --model entries: {models}")
    return models


def _parse_roi(spec: str):
    """'y1:y2,x1:x2' -> ((y1, y2), (x1, x2))."""
    try:
        ys, xs = spec.split(",")
        y1, y2 = (int(v) for v in ys.split(":"))
        x1, x2 = (int(v) for v in xs.split(":"))
    except ValueError:
        raise SystemExit(f"bad --roi '{spec}'; expected y1:y2,x1:x2")
    if y2 <= y1 or x2 <= x1:
        raise SystemExit(f"bad --roi '{spec}'; empty extent")
    return (y1, y2), (x1, x2)


def _init_multihost(args) -> int:
    """Join the world of ``--coordinator``/``--num-processes``/
    ``--process-id`` (or their ``EMPANADA_*`` variables) before any engine
    touches the card; returns this process's rank (0 without a world).  A
    world's size or rank without a coordinator exits, as does a coordinator
    without them."""
    from empanada_tpu_torch.parallel.multihost import initialize_multihost

    coord = args.coordinator or os.environ.get("EMPANADA_COORDINATOR")
    if coord is None:
        for flag in ("num_processes", "process_id"):
            if getattr(args, flag) is not None:
                raise SystemExit(f"--{flag.replace('_', '-')} needs --coordinator "
                                 "(or EMPANADA_COORDINATOR)")
        return 0

    def arg_or_env(attr, env):
        val = getattr(args, attr)
        return int(os.environ[env]) if val is None and os.environ.get(env) else val

    n = arg_or_env("num_processes", "EMPANADA_NUM_PROCESSES")
    pid = arg_or_env("process_id", "EMPANADA_PROCESS_ID")
    if n is None or pid is None:
        raise SystemExit(f"--coordinator {coord} needs --num-processes and --process-id "
                         "(or EMPANADA_NUM_PROCESSES and EMPANADA_PROCESS_ID)")
    dev, _ = _device(args)
    rank, world = initialize_multihost(coord, n, pid, device=dev)
    print(f"multihost: process {rank}/{world}, {dev.type}", file=sys.stderr)
    return rank


def cmd_infer2d(args):
    """2D inference.  ``--roi`` / ``--roi-mask`` confine it to a window or a
    mask's bounding box (pixels outside the mask zeroed, the result written
    back at the offset); a repeated ``--model`` runs each model on the same
    window and also writes their combined map (disjoint class ids, the
    first model wins an overlap)."""
    from empanada_tpu_torch.api import Engine2d, combine_panoptic_maps, load_model_from_config

    if args.spatial_shard and args.spatial_halo % 4:
        raise SystemExit(f"--spatial-halo {args.spatial_halo} must be a multiple of 4")
    lead = _init_multihost(args) == 0
    dev, dtype = _device(args)
    models = _model_list(args)
    image = np.asarray(_load_array(args.image))

    roi_mask = None
    if args.roi_mask is not None:
        roi_mask = np.asarray(_load_array(args.roi_mask)) > 0
        if roi_mask.shape != image.shape:
            raise SystemExit(f"--roi-mask shape {roi_mask.shape} != image shape {image.shape}")
    if args.roi is not None:
        (y1, y2), (x1, x2) = _parse_roi(args.roi)
        if y1 < 0 or x1 < 0 or y2 > image.shape[0] or x2 > image.shape[1]:
            raise SystemExit(f"--roi {args.roi} outside image bounds {image.shape}")
    elif roi_mask is not None:
        ys, xs = np.nonzero(roi_mask)
        if len(ys) == 0:
            raise SystemExit("--roi-mask has no foreground pixels")
        y1, y2, x1, x2 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    else:
        y1, y2, x1, x2 = 0, image.shape[0], 0, image.shape[1]

    window = image[y1:y2, x1:x2]
    if roi_mask is not None:
        window = np.where(roi_mask[y1:y2, x1:x2], window, 0).astype(image.dtype)

    def run_one(config):
        engine = Engine2d(
            config, inference_scale=args.downsampling, label_divisor=args.label_divisor,
            nms_threshold=args.center_confidence, nms_kernel=args.nms_kernel,
            confidence_thr=args.segment_confidence, semantic_only=args.semantic_only,
            fine_boundaries=args.fine_boundaries, tile_size=args.tile_size,
            shape_buckets=args.shape_buckets, spatial_shard=args.spatial_shard,
            spatial_halo=args.spatial_halo,
            model=load_model_from_config(config, device=dev, dtype=dtype), device=dev)
        pan_window = engine.infer(window)
        if roi_mask is not None:
            pan_window = np.where(roi_mask[y1:y2, x1:x2], pan_window, 0)
        if (y2 - y1, x2 - x1) == image.shape:
            return pan_window
        pan = np.zeros(image.shape, dtype=pan_window.dtype)
        pan[y1:y2, x1:x2] = pan_window
        return pan

    configs = [_model_config(m) for m in models]
    pans = [run_one(c) for c in configs]
    if not lead:
        return  # rank 0 writes

    if len(models) == 1:
        pan = pans[0]
    else:
        pan, combined_names = combine_panoptic_maps(pans, configs,
                                                    label_divisor=args.label_divisor)
        root, ext = os.path.splitext(args.output)
        for config, per_model in zip(configs, pans):
            out = f"{root}_{config['model_name']}{ext}"
            _save_labels(out, per_model)
            print(f"wrote {out}")
        for cid, cname in sorted(combined_names.items()):
            print(f"combined class {cid}: {cname}")

    _save_labels(args.output, pan)
    u = np.unique(pan)
    n = int((u % args.label_divisor > 0).sum())  # stuff ids are exact multiples
    print(f"wrote {args.output}: {pan.shape}, {n} instances")


def cmd_infer3d(args):
    """Each ``--model`` in turn over the volume; with several, each model's
    class volumes are written or stored under its own name."""
    lead = _init_multihost(args) == 0
    dev, dtype = _device(args)
    models = _model_list(args)
    for name in models:
        _infer3d_one(args, name, dev, dtype, multi=len(models) > 1, lead=lead)


def _infer3d_one(args, model_name, dev, dtype, multi=False, lead=True):
    from empanada_tpu_torch.api import (
        Engine3d,
        load_model_from_config,
        stack_postprocessing,
        tracker_consensus,
    )
    from empanada_tpu_torch.parallel.data_parallel import MultiChipEngine3d

    config = _model_config(model_name)
    model_name = config["model_name"]  # registry key or config basename
    # the batched engine splits the work over a world and writes from rank
    # 0; the per-slice one does all of it on every rank, so only rank 0's
    # writes
    own_files = lead or args.multichip
    store = args.store if own_files else None
    if multi and store is not None:
        root, ext = os.path.splitext(store)
        store = f"{root}_{model_name}{ext}"
    common = dict(
        inference_scale=args.downsampling, label_divisor=args.label_divisor,
        median_kernel_size=args.median_slices, nms_threshold=args.center_confidence,
        nms_kernel=args.nms_kernel, confidence_thr=args.segment_confidence,
        semantic_only=args.semantic_only, fine_boundaries=args.fine_boundaries,
        min_size=args.min_size, min_extent=args.min_extent, store_url=store,
        save_panoptic=args.save_panoptic, device=dev)
    model = load_model_from_config(config, device=dev, dtype=dtype)
    if args.multichip:
        # over the world's cards; shape_buckets does nothing in eager PyTorch
        engine = MultiChipEngine3d(config, model, batch_size=args.batch_size, **common)
    else:
        engine = Engine3d(config, model=model, shape_buckets=args.shape_buckets, **common)

    ckpt_dir = args.checkpoint_dir if own_files else None
    if multi and ckpt_dir is not None:
        ckpt_dir = os.path.join(ckpt_dir, model_name)
    ckpt_kw = {} if ckpt_dir is None else dict(
        checkpoint_dir=ckpt_dir, checkpoint_every=args.checkpoint_every, resume=args.resume)
    ckpt_kw["progress"] = sys.stderr.isatty() if args.progress is None else args.progress

    volume = _load_array(args.volume)
    if args.orthoplane:
        trackers = engine.infer_orthoplane(volume, **ckpt_kw)
    else:
        _, axis_trackers = engine.infer_on_axis(volume, args.axis, **ckpt_kw)
    if not lead:
        return  # every rank holds the trackers; rank 0 writes
    if args.orthoplane:
        worker = tracker_consensus(
            trackers, store, config, label_divisor=args.label_divisor,
            pixel_vote_thr=args.pixel_vote_thr, cluster_iou_thr=args.cluster_iou_thr,
            allow_one_view=args.allow_one_view, min_size=args.min_size,
            min_extent=args.min_extent, device=dev)
    else:
        worker = stack_postprocessing(
            {args.axis: axis_trackers}, store, config, label_divisor=args.label_divisor,
            min_size=args.min_size, min_extent=args.min_extent, device=dev)

    for vol, class_name, instances in worker:
        tag = f"{model_name}/{class_name}" if multi else class_name
        print(f"class {tag}: {len(instances)} instances")
        if store is None and args.output:
            out = args.output.replace("{class}", tag.replace("/", "_"))
            _save_labels(out, np.asarray(vol))
            print(f"wrote {out}")


def cmd_train(args):
    from empanada_tpu_torch.api.config import load_config
    from empanada_tpu_torch.train import main as train_main

    _init_multihost(args)
    dev, _ = _device(args)
    config = load_config(args.config)
    if args.resume:
        config.setdefault("TRAIN", {})["resume"] = True
    if args.multichip:
        config.setdefault("TRAIN", {})["multichip"] = True
    train_main(config, device=dev)


def cmd_finetune(args):
    from empanada_tpu_torch.api.config import load_config
    from empanada_tpu_torch.train import finetune_main

    dev, _ = _device(args)
    config = load_config(args.config)
    if isinstance(config.get("model_config"), str):
        config["model_config"] = _model_config(config["model_config"])
    _, _, bundle = finetune_main(config, device=dev)
    print(f"finetuned bundle: {bundle}")


def cmd_evaluate(args):
    from empanada_tpu_torch.eval import default_evaluator

    results = default_evaluator()(args.gt, args.pred)
    print(json.dumps({k: float(v) for k, v in results.items()}, indent=2))


def _require(hint: str, **needed):
    for flag, value in needed.items():
        if value is None:
            raise SystemExit(f"{hint}: --{flag} is required")


def cmd_models(args):
    from empanada_tpu_torch.api import get_configs
    from empanada_tpu_torch.api.export import archive_model, export_model, import_model

    if args.quantize:
        raise SystemExit(f"models {args.action} --quantize: int8 bundles are {ITEM_13}")
    if args.action == "list":
        for name, path in sorted(get_configs().items()):
            print(f"{name}\t{path}")
    elif args.action == "info":
        from empanada_tpu_torch.api.utils import model_info_text

        _require("models info", name=args.name)
        try:
            print(model_info_text(args.name))
        except KeyError as e:
            raise SystemExit(f"models info: {e.args[0]}")
    elif args.action == "export":
        _require("models export", name=args.name, path=args.path)
        print(export_model(args.name, args.path))
    elif args.action == "import":
        _require("models import", path=args.path)
        print(import_model(args.path, model_name=args.name))
    elif args.action == "archive":
        _require("models archive", name=args.name, path=args.path)
        print(archive_model(args.name, args.path))
    else:
        raise SystemExit(f"models deploy: a self-contained serving artifact is {ITEM_13}")


def cmd_serve(args):
    raise SystemExit(f"serve: running a deployed serving artifact is {ITEM_13}")


def cmd_tiles(args):
    from empanada_tpu_torch.curation import chop_into_tiles, merge_tiles

    if args.action == "chop":
        _require("tiles chop", image=args.image)
        print(json.dumps(chop_into_tiles(args.image, args.dir, patch_size=args.patch_size,
                                         mask_path=args.mask)))
    else:
        print(json.dumps(merge_tiles(args.dir, args.out)))


def cmd_port(args):
    """A reference torch checkpoint as a port bundle."""
    from empanada_tpu_torch.api import save_model_bundle
    from empanada_tpu_torch.port.torch_port import (
        CheckpointReadError,
        infer_arch_and_kwargs,
        load_reference_model,
        load_torch_checkpoint,
    )

    if args.quantize:
        raise SystemExit(f"port --quantize: int8 bundles are {ITEM_13}")
    config = _model_config(args.model) if args.model else None
    arch = args.arch or (config and config.get("arch"))
    kwargs = (config or {}).get("model_kwargs", {})
    try:
        state_dict, ckpt_arch = load_torch_checkpoint(args.checkpoint,
                                                      allow_pickle=args.allow_pickle)
    except CheckpointReadError as e:
        raise SystemExit(
            f"port: {e}\nport needs a readable checkpoint (TorchScript archive, training "
            "checkpoint, or raw state dict; raw state dicts also need --arch or --model)")
    if arch is None:
        # published archives carry no architecture: recover it from the weights
        arch, kwargs = infer_arch_and_kwargs(state_dict)
        print(f"inferred arch={arch} kwargs={kwargs}")
    out = save_model_bundle(args.output, arch, kwargs,
                            load_reference_model(state_dict, arch, kwargs))
    print(f"ported {args.checkpoint} ({ckpt_arch or arch}) -> {out}")


def cmd_labels(args):
    """Label curation: count ids per class, drop small or border labels."""
    from empanada_tpu_torch.curation import apply_label_filter, count_labels, save_label_lists

    labels = np.asarray(_load_array(args.labels))
    if args.action == "count":
        queue, class_ids = count_labels(labels, args.label_divisor)
        for ci in class_ids:
            print(f"class {ci}: {len(queue[ci])} labels")
        if args.out:
            path = save_label_lists([queue], {c: str(c) for c in class_ids}, args.out)
            print(f"wrote {path}")
    else:
        kwargs = {"filter": "boundary"} if args.action == "boundary" else {
            "filter": "small", "minimum_area_allowed": args.min_area}
        out, n_removed = apply_label_filter(labels.copy(), mode=args.mode, **kwargs)
        _save_labels(args.out or args.labels, out)
        print(f"removed {n_removed} labels -> {args.out or args.labels}")


def cmd_docs(args):
    readme = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "README.md")
    print(open(readme).read() if os.path.exists(readme) else
          "see PARITY.md / README.md in the repo")


def build_parser():
    p = argparse.ArgumentParser("empanada-tpu-torch")
    sub = p.add_subparsers(dest="command", required=True)

    def device_arg(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device: cuda (the default, bfloat16) or cpu (float32)")

    def common_infer(sp):
        sp.add_argument("--model", action="append", default=None,
                        help="registered model name or config path; repeat for "
                             "multi-model panoptic (default MitoNet_v1)")
        sp.add_argument("--downsampling", type=int, default=1,
                        choices=[1, 2, 4, 8, 16, 32, 64],
                        help="inference scale (power of 2, as in the napari widget)")
        # the napari widgets' "maximum objects per class"; the engines'
        # own default stays 1000
        sp.add_argument("--label-divisor", type=int, default=10000, dest="label_divisor")
        sp.add_argument("--center-confidence", type=float, default=0.1,
                        dest="center_confidence")
        sp.add_argument("--nms-kernel", type=int, default=3, dest="nms_kernel")
        sp.add_argument("--segment-confidence", type=float, default=0.3,
                        dest="segment_confidence")
        sp.add_argument("--semantic-only", action="store_true", dest="semantic_only")
        sp.add_argument("--fine-boundaries", action="store_true", dest="fine_boundaries")
        sp.add_argument("--shape-buckets", action="store_true", dest="shape_buckets",
                        help="accepted and ignored: eager PyTorch compiles nothing per shape")
        device_arg(sp)

    def multihost_args(sp):
        sp.add_argument("--coordinator", default=None,
                        help="host:port of rank 0's rendezvous: joins one process per "
                             "card into a world (env: EMPANADA_COORDINATOR)")
        sp.add_argument("--num-processes", type=int, default=None, dest="num_processes",
                        help="processes in the world (env: EMPANADA_NUM_PROCESSES)")
        sp.add_argument("--process-id", type=int, default=None, dest="process_id",
                        help="this process's rank (env: EMPANADA_PROCESS_ID)")

    sp = sub.add_parser("infer2d", help="2D panoptic inference (tiled for big images)")
    sp.add_argument("image")
    sp.add_argument("-o", "--output", default="pan_seg.npy")
    sp.add_argument("--tile-size", type=int, default=0, dest="tile_size")
    sp.add_argument("--spatial-shard", action="store_true", dest="spatial_shard",
                    help="split the slice's rows over the world's cards with halo rows "
                         "exchanged (seam-free, no tiles)")
    sp.add_argument("--spatial-halo", type=int, default=128, dest="spatial_halo")
    sp.add_argument("--roi", default=None, help="confine inference to a window: y1:y2,x1:x2")
    sp.add_argument("--roi-mask", default=None, dest="roi_mask",
                    help="mask file (.npy/image); infer inside its bbox, zero outside")
    common_infer(sp)
    multihost_args(sp)
    sp.set_defaults(func=cmd_infer2d)

    sp = sub.add_parser("infer3d", help="3D stack / ortho-plane inference")
    sp.add_argument("volume")
    sp.add_argument("-o", "--output", default="seg_{class}.npy")
    sp.add_argument("--axis", default="xy", choices=["xy", "xz", "yz"])
    sp.add_argument("--orthoplane", action="store_true")
    sp.add_argument("--multichip", action="store_true",
                    help="the batched MultiChipEngine3d, its batches split over the world")
    sp.add_argument("--batch-size", type=int, default=None, dest="batch_size")
    sp.add_argument("--median-slices", type=int, default=3, dest="median_slices")
    sp.add_argument("--min-size", type=int, default=500, dest="min_size")
    # the napari widget's default; the engines' own stays 4
    sp.add_argument("--min-extent", type=int, default=5, dest="min_extent")
    sp.add_argument("--pixel-vote-thr", type=int, default=2, dest="pixel_vote_thr")
    sp.add_argument("--cluster-iou-thr", type=float, default=0.75, dest="cluster_iou_thr")
    sp.add_argument("--allow-one-view", action="store_true", dest="allow_one_view")
    sp.add_argument("--store", default=None, help="chunked (zarr) store directory")
    sp.add_argument("--save-panoptic", action="store_true", dest="save_panoptic")
    sp.add_argument("--checkpoint-dir", default=None, dest="checkpoint_dir",
                    help="save the forward pass's state here every --checkpoint-every "
                         "slices; with --resume a rerun continues from it (identical to "
                         "an uninterrupted run)")
    sp.add_argument("--checkpoint-every", type=int, default=64, dest="checkpoint_every")
    sp.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint-dir state if present")
    sp.add_argument("--progress", action="store_true", default=None,
                    help="per-slice rate/ETA on stderr (default: on when stderr is a "
                         "terminal)")
    sp.add_argument("--no-progress", dest="progress", action="store_false")
    common_infer(sp)
    multihost_args(sp)
    sp.set_defaults(func=cmd_infer3d)

    sp = sub.add_parser("train", help="train from a yaml config")
    sp.add_argument("config")
    sp.add_argument("--multichip", action="store_true",
                    help="data-parallel training over the world (TRAIN.multichip)")
    sp.add_argument("--resume", action="store_true",
                    help="continue from <model_dir>/model_checkpoint.pt")
    device_arg(sp)
    multihost_args(sp)
    sp.set_defaults(func=cmd_train)

    sp = sub.add_parser("finetune", help="finetune a registered model")
    sp.add_argument("config")
    device_arg(sp)
    sp.set_defaults(func=cmd_finetune)

    sp = sub.add_parser("evaluate", help="compare RLE-JSON tracker dumps")
    sp.add_argument("gt")
    sp.add_argument("pred")
    sp.set_defaults(func=cmd_evaluate)

    sp = sub.add_parser("models", help="registry operations")
    sp.add_argument("action", choices=["list", "info", "export", "import", "archive",
                                       "deploy"])
    sp.add_argument("--name", default=None)
    sp.add_argument("--path", default=None)
    sp.add_argument("--quantize", action="store_true",
                    help="int8 weights (ROADMAP item 13; exits)")
    sp.add_argument("--shape", default="512x512", help="deploy (ROADMAP item 13; exits)")
    sp.add_argument("--platforms", default="cpu,tpu", help="deploy (ROADMAP item 13; exits)")
    sp.add_argument("--center-confidence", type=float, default=0.1, dest="center_confidence")
    sp.add_argument("--nms-kernel", type=int, default=3, dest="nms_kernel")
    sp.add_argument("--segment-confidence", type=float, default=0.3,
                    dest="segment_confidence")
    sp.add_argument("--fine-boundaries", action="store_true", dest="fine_boundaries")
    sp.add_argument("--max-centers", type=int, default=256, dest="max_centers")
    sp.set_defaults(func=cmd_models)

    sp = sub.add_parser("serve", help="run a deployed serving artifact (ROADMAP item 13; "
                                      "exits)")
    sp.add_argument("artifact")
    sp.add_argument("image")
    sp.add_argument("-o", "--output", default="pan_seg.npy")
    sp.set_defaults(func=cmd_serve)

    sp = sub.add_parser("tiles", help="offline big-image tiling")
    sp.add_argument("action", choices=["chop", "merge"])
    sp.add_argument("--image", default=None)
    sp.add_argument("--mask", default=None)
    sp.add_argument("--dir", required=True)
    sp.add_argument("--out", default="merged")
    sp.add_argument("--patch-size", type=int, default=2048, dest="patch_size")
    sp.set_defaults(func=cmd_tiles)

    sp = sub.add_parser("labels", help="count / filter label maps")
    sp.add_argument("action", choices=["count", "small", "boundary"])
    sp.add_argument("labels", help="label map (.npy / tiff / png / chunked store)")
    sp.add_argument("-o", "--out", default=None,
                    help="output (CSV for count, label map for filters)")
    # infer2d/infer3d's default, so that their ids decode by class
    sp.add_argument("--label-divisor", type=int, default=10000, dest="label_divisor")
    sp.add_argument("--min-area", type=int, default=100, dest="min_area")
    sp.add_argument("--mode", default="image", choices=["image", "patches", "volume"])
    sp.set_defaults(func=cmd_labels)

    sp = sub.add_parser("port", help="convert a reference torch checkpoint to a port bundle")
    sp.add_argument("checkpoint")
    sp.add_argument("-o", "--output", default="ported")
    sp.add_argument("--model", default=None, help="registry config supplying arch/kwargs")
    sp.add_argument("--arch", default=None)
    sp.add_argument("--quantize", action="store_true",
                    help="int8 weights (ROADMAP item 13; exits)")
    sp.add_argument("--allow-pickle", action="store_true",
                    help="permit full-pickle torch.load for trusted legacy checkpoints "
                         "(arbitrary code execution risk)")
    sp.set_defaults(func=cmd_port)

    sp = sub.add_parser("docs", help="print the framework documentation")
    sp.set_defaults(func=cmd_docs)

    sub.add_parser("bench", help="the throughput benchmark (ROADMAP item 13; exits)")
    return p


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    # bench would forward everything after it verbatim; it has no port yet
    if argv and argv[0] == "bench":
        raise SystemExit(f"bench: the port's throughput benchmark is {ITEM_13}")
    args = build_parser().parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
