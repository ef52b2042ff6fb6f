"""Config-driven training and finetuning (counterpart of
``empanada_tpu/train/loop.py``), on one card.

``main(config)`` trains from a config with the JAX package's schema
(``training/train_config.yaml``): the dataset and its augmentations, the
weighted batch loader, the model at float32 parameters with bf16 autocast
when ``TRAIN.amp``, AdamW with the decay mask under a OneCycle schedule,
optional encoder freezing (``finetune_layer``) and pretrained encoder
weights (``encoder_pretraining``, a port bundle), the loss, metrics every
``print_freq`` steps on the model in eval mode, a checkpoint every
``save_freq`` epochs and ``validate`` every ``EVAL.epochs_per_eval``.
``finetune_main`` finetunes a registered bundle and registers the result.

Checkpoints are the port's own: a ``torch.save`` of the parameters, the
batch-norm statistics, the optimizer state, the step and epoch counts and
the states of the step's generator, the loader's and the augmentations'
draws (loadable with ``weights_only=True``), written atomically with the
run's config beside it as ``<path>.yaml``.  Resuming restores all of them,
so a resumed run continues the uninterrupted one's draws.

``TRAIN.multichip`` trains data-parallel over the world of processes
(``parallel.multihost``; a world of one without one): ``batch_size`` is
the global batch, each rank loads its ``batch_size // world`` rows with
its shard of the loader's sample stream, and every step is the JAX
package's sharded step (``train/state.py``).  Rank 0 prints, evaluates
the metrics, writes the checkpoints (every rank's draws in them) and
validates while the others wait; a resume restores every rank.

Entry points run on the card: ``device=None`` means "cuda" (this rank's
card in a world) and raises without a GPU; the tests pass ``device="cpu"``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import yaml

from empanada_tpu_torch.api.utils import (
    _init_weights,
    add_new_model,
    load_model_bundle,
    load_model_from_config,
    save_model_bundle,
)
from empanada_tpu_torch.data.augment import create_augmentations
from empanada_tpu_torch.data.datasets import WeightedBatchLoader, create_dataset
from empanada_tpu_torch.data.volume import factor_pad_numpy
from empanada_tpu_torch.engine.engines import PanopticDeepLabEngine
from empanada_tpu_torch.models import create_model
from empanada_tpu_torch.ops import postprocess as pp
from empanada_tpu_torch.parallel.mesh import barrier, create_mesh, replicated
from empanada_tpu_torch.train.losses import BCLoss, PanopticLoss
from empanada_tpu_torch.train.metrics import AverageMeter, ComposeMetrics, EMAMeter, create_metric
from empanada_tpu_torch.train.state import (
    TrainState,
    batch_to_device,
    create_train_state,
    make_eval_step,
    make_train_step,
    onecycle_schedule,
)
from empanada_tpu_torch.utils import resolve_device

__all__ = ["main", "finetune_main", "validate", "freeze_encoder_mask", "save_checkpoint",
           "load_checkpoint", "LOSS_REGISTRY"]

LOSS_REGISTRY = {"PanopticLoss": PanopticLoss, "BCLoss": BCLoss}
CHECKPOINT_EXT = ".pt"


def freeze_encoder_mask(model: torch.nn.Module, finetune_layer: str = "none") -> dict:
    """{parameter name: trainable}.  'none' trains everything;
    'stage1'..'stage4' freeze the encoder's stem and its stages up to and
    including that one; 'all' freezes the whole encoder."""
    names = [n for n, _ in model.named_parameters()]
    if finetune_layer == "none":
        return dict.fromkeys(names, True)
    frozen_stages = {"stage1": 1, "stage2": 2, "stage3": 3, "stage4": 4,
                     "all": 4}[finetune_layer]

    def trainable(name: str) -> bool:
        parts = name.split(".")
        if parts[0] != "encoder":
            return True
        if finetune_layer == "all":
            return False
        sub = parts[1] if len(parts) > 1 else ""
        if sub.startswith("stem"):
            return False
        # resnet: layer{k}_block{j}; regnet: stage{k}_block{j}
        for prefix in ("layer", "stage"):
            if sub.startswith(prefix):
                try:
                    k = int(sub[len(prefix):].split("_")[0])
                except ValueError:
                    return True
                return k > frozen_stages
        return True

    return {n: trainable(n) for n in names}


def _rng_states(loader) -> dict:
    if loader is None:
        return {}
    out = {"loader_rng": loader.state_dict()}
    tfs = getattr(loader.dataset, "transforms", None)
    if tfs is not None:
        out["augment_rng"] = tfs.rng.bit_generator.state
    return out


def save_checkpoint(path: str, state: TrainState, config: dict, epoch: int = 0,
                    loader=None, mesh=None) -> None:
    """Write the run's state at ``path`` (module docstring), atomically: a
    crash mid-write leaves the previous checkpoint whole.  In a world
    (``mesh``) every rank calls it: rank 0 writes, with each rank's
    loader and augmentation draws, while the others wait."""
    rank_rng = None
    if mesh is not None and mesh.distributed:
        rank_rng = [None] * mesh.size
        torch.distributed.all_gather_object(rank_rng, _rng_states(loader), group=mesh.group)
        if mesh.rank != 0:
            barrier(mesh)
            return
    model = state.model
    params = {n: p.detach().cpu() for n, p in model.named_parameters()}
    stats = {n: b.detach().cpu() for n, b in model.named_buffers()}
    blob = {"params": params, "batch_stats": stats,
            "opt_state": state.optimizer.state_dict(), "step": int(state.step),
            "epoch": int(epoch), "generator": state.generator.get_state(),
            **_rng_states(loader)}
    if rank_rng is not None:
        blob["rank_rng"] = rank_rng
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    with open(path + ".yaml", "w") as f:
        yaml.safe_dump({"config": _yaml_safe(config)}, f)
    if rank_rng is not None:
        barrier(mesh)


def load_checkpoint(path: str, state: TrainState, return_epoch: bool = False,
                    loader=None, rank: int = 0):
    """Restore ``state`` (and ``loader``'s and its augmentations' draws,
    when given: those of ``rank`` where the checkpoint holds every rank's)
    from a checkpoint of ``save_checkpoint``."""
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic != b"PK":
        raise ValueError(
            f"{path} is not a checkpoint of the port (a JAX package checkpoint holds "
            "flax msgpack): load it with the JAX package and bring its params and "
            "batch_stats across with empanada_tpu_torch.port.weights.from_flax")
    blob = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict({**blob["params"], **blob["batch_stats"]})
    state.optimizer.load_state_dict(blob["opt_state"])
    state.step = int(blob["step"])
    state.generator.set_state(blob["generator"])
    draws = blob["rank_rng"][rank] if "rank_rng" in blob else blob
    if loader is not None and "loader_rng" in draws:
        loader.load_state_dict(draws["loader_rng"])
        if "augment_rng" in draws:
            loader.dataset.transforms.rng.bit_generator.state = draws["augment_rng"]
    if return_epoch:
        return state, int(blob["epoch"])
    return state


def _yaml_safe(obj):
    if isinstance(obj, dict):
        return {k: _yaml_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_yaml_safe(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    return obj


def _dataset_kwargs(config, transforms) -> dict:
    train_cfg, dataset_cfg = config["TRAIN"], config["DATASET"]
    kw = dict(transforms=transforms, **train_cfg.get("dataset_params", {}))
    if train_cfg["dataset_class"] == "PanopticDataset":
        kw.update(labels=dataset_cfg["labels"], thing_list=dataset_cfg["thing_list"],
                  label_divisor=train_cfg.get("label_divisor", 1000))
    return kw


def _build_dataset(config, norms):
    train_cfg = config["TRAIN"]
    # the inference normalisation closes the augmentations
    augs = list(train_cfg.get("augmentations", [])) + [{"aug": "Normalize", **norms}]
    tfs = create_augmentations(augs, seed=config.get("seed", 0))
    common = _dataset_kwargs(config, tfs)
    dataset_class = train_cfg["dataset_class"]
    dataset = create_dataset(dataset_class, train_cfg["train_dir"], **common)
    for extra_dir in train_cfg.get("additional_train_dirs") or []:
        dataset = dataset + create_dataset(dataset_class, extra_dir, **common)
    return dataset


def _total_steps(loader, train_cfg) -> int:
    epochs = train_cfg.get("epochs", train_cfg.get("schedule_params", {}).get("epochs", 1))
    return max(1, len(loader)) * epochs


def _new_state(model, train_cfg, total_steps, seed) -> TrainState:
    sched = train_cfg.get("schedule_params", {})
    schedule = onecycle_schedule(sched.get("max_lr", 3e-3), total_steps,
                                 sched.get("pct_start", 0.3))
    finetune_layer = train_cfg.get("finetune_layer", "none") or "none"
    trainable = (freeze_encoder_mask(model, finetune_layer)
                 if finetune_layer != "none" else None)
    return create_train_state(
        model, schedule, train_cfg.get("optimizer_params", {}).get("weight_decay", 0.1),
        seed=seed, trainable=trainable)


def _metrics(specs, meter, dataset_cfg) -> ComposeMetrics:
    return ComposeMetrics(
        {spec.get("name", spec["metric"]): create_metric(spec, meter, dataset_cfg["labels"])
         for spec in specs},
        dataset_cfg.get("class_names") or {l: str(l) for l in dataset_cfg["labels"]})


def _to_numpy(tensors: dict) -> dict:
    return {k: v.detach().float().cpu().numpy() if v.is_floating_point()
            else v.cpu().numpy() for k, v in tensors.items()}


def main(config: dict, model_and_state=None, device=None, timer=None):
    """Train from ``config`` (module docstring); returns (model, state).
    ``timer`` (a ``utils.StageTimer``) gets the host's seconds in the
    loader ("data", reading, augmenting and copying a batch) and in the
    step's dispatch ("step")."""
    dev = resolve_device(device)
    train_cfg = config["TRAIN"]
    dataset_cfg = config["DATASET"]
    mesh = create_mesh(device=dev) if train_cfg.get("multichip") else None
    lead = mesh is None or mesh.rank == 0
    model_dir = train_cfg.get("model_dir") or "."
    os.makedirs(model_dir, exist_ok=True)
    norms = dataset_cfg["norms"]
    # multiclass models get a background channel (n + 1); one class is a
    # sigmoid over one channel; an explicit MODEL.num_classes wins
    n_labels = len(dataset_cfg["labels"])
    num_classes = config.get("MODEL", {}).get(
        "num_classes", n_labels + 1 if n_labels > 1 else 1)
    seed = config.get("seed", 0)
    amp = bool(train_cfg.get("amp", True))

    dataset = _build_dataset(config, norms)
    batch_size = train_cfg.get("batch_size", 16)
    if mesh is None:
        loader = WeightedBatchLoader(dataset, batch_size, seed=seed)
    else:
        if batch_size % mesh.size:
            raise ValueError(f"batch_size {batch_size} must be divisible by the "
                             f"{mesh.size} ranks of the world")
        loader = WeightedBatchLoader(dataset, batch_size // mesh.size, seed=seed,
                                     shard=mesh.rank, num_shards=mesh.size)
    epochs = train_cfg.get("epochs", train_cfg.get("schedule_params", {}).get("epochs", 1))

    if model_and_state is None:
        model_config = dict(config["MODEL"])
        arch = model_config.pop("arch")
        model_config["num_classes"] = int(num_classes)
        model = create_model(arch, device="cpu", **model_config)
        _init_weights(model, torch.Generator().manual_seed(seed))
        pretraining = train_cfg.get("encoder_pretraining")
        if pretraining:
            # the encoder's parameters and batch-norm statistics (the JAX
            # package takes params["encoder"] alone and leaves the
            # statistics at their initial 0 and 1, ROADMAP C8)
            pre = load_model_bundle(pretraining, device="cpu").state_dict()
            model.load_state_dict({n: t for n, t in pre.items() if n.startswith("encoder.")},
                                  strict=False)
        model = model.to(dev)
        state = _new_state(model, train_cfg, _total_steps(loader, train_cfg), seed + 1)
    else:
        model, state = model_and_state
    model.train()
    if mesh is not None:
        # every rank starts from rank 0's weights and statistics
        replicated(mesh, [*model.parameters(), *model.buffers()])

    criterion = LOSS_REGISTRY[train_cfg.get("criterion", "PanopticLoss")](
        **train_cfg.get("criterion_params", {}))
    train_step = make_train_step(criterion, remat=bool(train_cfg.get("remat", False)),
                                 amp=amp, mesh=mesh)
    metric_specs = train_cfg.get("metrics", [])
    metrics = _metrics(metric_specs, EMAMeter, dataset_cfg)
    eval_step = make_eval_step(amp) if metric_specs else None

    save_freq = train_cfg.get("save_freq") or epochs
    print_freq = train_cfg.get("print_freq", 50)
    model_name = config.get("model_name") or "model"
    ckpt = os.path.join(model_dir, f"{model_name}_checkpoint{CHECKPOINT_EXT}")

    start_epoch = 0
    resume = train_cfg.get("resume")
    if resume:
        path = resume if isinstance(resume, str) else ckpt
        jax_ckpt = os.path.join(model_dir, f"{model_name}_checkpoint.msgpack")
        if not os.path.exists(path) and os.path.exists(jax_ckpt) and resume is True:
            path = jax_ckpt  # load_checkpoint refuses it by name
        if os.path.exists(path):
            state, start_epoch = load_checkpoint(path, state, return_epoch=True,
                                                 loader=loader,
                                                 rank=0 if mesh is None else mesh.rank)
            if lead:
                print(f"resumed from {path}: epoch {start_epoch}, step {state.step}")
        elif lead:
            print(f"resume requested but no checkpoint at {path}; starting fresh")

    step_count = 0
    for epoch in range(start_epoch, epochs):
        t_epoch = time.time()
        batches = iter(loader)
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            batch = batch_to_device(batch, dev)
            t1 = time.perf_counter()
            aux = train_step(state, batch)
            if timer is not None:
                timer.add("data", t1 - t0)
                timer.add("step", time.perf_counter() - t1)
            step_count += 1
            if lead and step_count % print_freq == 0:
                print(f"epoch {epoch + 1} step {step_count}: loss "
                      f"{float(aux['total_loss']):.4f}")
                if eval_step is not None:
                    # the metrics on the last batch only
                    metrics.evaluate(_to_numpy(eval_step(state, batch["image"])),
                                     _to_numpy(batch))
                    metrics.display()
        if lead:
            print(f"epoch {epoch + 1}/{epochs} done in {time.time() - t_epoch:.1f}s")

        if (epoch + 1) % save_freq == 0 or (epoch + 1) == epochs:
            save_checkpoint(ckpt, state, config, epoch=epoch + 1, loader=loader, mesh=mesh)
        eval_cfg = config.get("EVAL") or {}
        if eval_cfg.get("eval_dir") and (epoch + 1) % eval_cfg.get("epochs_per_eval", 1) == 0:
            if lead:
                validate(config, model, state, device=dev)
            if mesh is not None:
                barrier(mesh)
    return model, state


def validate(config: dict, model, state: TrainState, device=None) -> ComposeMetrics:
    """Panoptic maps of the eval images through ``PanopticDeepLabEngine``
    (the model in eval mode, under bf16 autocast when ``TRAIN.amp``; then
    back in its mode) against the ground truth's maps through the same
    postprocess (``get_panoptic_segmentation`` of its semantics, heatmap
    and offsets, so that instances are compared, not one segment a class);
    the ``EVAL.metrics`` averaged over the images: PQ and F1 of the maps,
    IoU of the engine's semantic logits against the semantics (the JAX
    package has no logits there and fails on train_config.yaml's IoU,
    ROADMAP C7)."""
    dev = resolve_device(device)
    eval_cfg, dataset_cfg, train_cfg = config["EVAL"], config["DATASET"], config["TRAIN"]
    tfs = create_augmentations([{"aug": "Normalize", **dataset_cfg["norms"]}])
    eval_set = create_dataset(train_cfg["dataset_class"], eval_cfg["eval_dir"],
                              **_dataset_kwargs(config, tfs))
    engine_params = dict(eval_cfg.get("engine_params", {}))
    engine_params.setdefault("thing_list", dataset_cfg["thing_list"])
    was_training = model.training
    engine = PanopticDeepLabEngine(model, device=dev, **engine_params)
    metrics = _metrics(eval_cfg.get("metrics", []), AverageMeter, dataset_cfg)
    pad_factor = int(eval_cfg.get("padding_factor", 128))
    amp = bool(train_cfg.get("amp", True))
    try:
        for idx in range(len(eval_set)):
            item = eval_set[idx]
            image = item["image"][..., 0] if item["image"].ndim == 3 else item["image"]
            h, w = image.shape
            with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=amp):
                out = engine.infer(factor_pad_numpy(image.astype(np.float32), pad_factor))
                pan = engine.postprocess(out)[0].cpu().numpy()[:h, :w]
            sem_logits = out["sem_logits"][:, :h, :w].float().cpu().numpy()
            target = batch_to_device({k: item[k][None] for k in ("sem", "ctr_hmp", "offsets")},
                                     dev)
            gt_pan = pp.get_panoptic_segmentation(
                target["sem"], target["ctr_hmp"], target["offsets"], engine.thing_list,
                engine.label_divisor, engine.stuff_area, engine.void_label,
                engine.nms_threshold, engine.nms_kernel, engine.num_classes,
                engine.max_centers)[0].cpu().numpy()
            metrics.evaluate({"pan_seg": pan, "sem_logits": sem_logits},
                             {"pan_seg": gt_pan, "sem": item["sem"][None]})
    finally:
        model.train(was_training)
    metrics.display()
    return metrics


def _crop_size(train_cfg) -> int:
    for aug in train_cfg.get("augmentations", []):
        if aug.get("aug") == "RandomCrop":
            return int(aug["height"])
    return 256


def finetune_main(config: dict, device=None):
    """Finetune the registered bundle of ``config["model_config"]`` (a
    registry dict with its FINETUNE section) on ``TRAIN``/``DATASET``/
    ``EVAL`` as in ``main``, save the result as a bundle in
    ``TRAIN.model_dir`` and register it as ``model_name``.  Returns
    (model, state, bundle path)."""
    dev = resolve_device(device)
    model_config = config["model_config"]
    finetune_params = model_config.get("FINETUNE", {})
    train_cfg = config.setdefault("TRAIN", {})
    train_cfg.setdefault("criterion", finetune_params.get("criterion", "PanopticLoss"))
    train_cfg.setdefault("criterion_params", finetune_params.get("criterion_params", {}))
    train_cfg.setdefault("dataset_class", finetune_params.get(
        "dataset_class", "SingleClassInstanceDataset"))
    train_cfg.setdefault("dataset_params", finetune_params.get("dataset_params", {}))
    dataset_cfg = config.setdefault("DATASET", {})
    for key in ("norms", "labels", "thing_list", "class_names"):
        dataset_cfg.setdefault(key, model_config[key])

    model = load_model_from_config(model_config, device=dev)
    loader = WeightedBatchLoader(_build_dataset(config, model_config["norms"]),
                                 train_cfg.get("batch_size", 16), seed=config.get("seed", 0))
    state = _new_state(model, train_cfg, _total_steps(loader, train_cfg),
                       config.get("seed", 0) + 1)
    model, state = main(config, model_and_state=(model, state), device=dev)

    model_dir = train_cfg.get("model_dir") or "."
    model_name = config.get("model_name") or "finetuned"
    bundle_path = save_model_bundle(os.path.join(model_dir, model_name),
                                    model_config.get("arch", type(model).__name__),
                                    model_config.get("model_kwargs", {}), model)
    add_new_model(model_name, dict(model_config), model_file=bundle_path)
    return model, state, bundle_path
