"""The port's training loop against the JAX package's, in float32 on the
CPU: a bit-identical resume after a crash, ``multichip`` in a world of
one, JAX checkpoints refused,
``validate`` against JAX's on the same weights (PQ and F1 within 1e-6),
and ``finetune_main`` round-tripping a port bundle through the registry.
The learning run is in ``test_torch_learn.py``.
"""

import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

import empanada_tpu.train as JT
import empanada_tpu_torch.train as T
from _torch_port import SMALL_PR, jax_init, one_torch_thread, port_model  # noqa: F401
from empanada_tpu_torch.api import utils as api_utils
from test_torch_train import TRAIN_PR


def make_blob_example(rng, size=64, n_blobs=3):
    """Dark disks on bright noise; mask = instance labels."""
    img = rng.normal(0.8, 0.05, (size, size))
    mask = np.zeros((size, size), dtype=np.int64)
    yy, xx = np.mgrid[0:size, 0:size]
    for i in range(n_blobs):
        cy, cx = rng.integers(10, size - 10, 2)
        r = rng.integers(4, 9)
        blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= r ** 2
        img[blob] = rng.normal(0.25, 0.05)
        mask[blob] = i + 1
    return (np.clip(img, 0, 1) * 255).astype(np.uint8), mask


@pytest.fixture(scope="module")
def blob_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("blobs")
    rng = np.random.default_rng(11)
    for split, n in (("train", 12), ("eval", 2)):
        d = root / split / "source_a"
        (d / "images").mkdir(parents=True)
        (d / "masks").mkdir(parents=True)
        for i in range(n):
            img, mask = make_blob_example(rng)
            Image.fromarray(img).save(d / "images" / f"{i:03d}.png")
            Image.fromarray(mask.astype(np.uint16)).save(d / "masks" / f"{i:03d}.png")
    return str(root)


def _config(blob_dir, model_dir, epochs, arch="PanopticDeepLab", augs=None, **train):
    model = {"arch": arch, "encoder": "resnet18", "decoder_channels": 32,
             "low_level_stages": [1], "low_level_channels_project": [16],
             "ins_decoder": arch != "PanopticDeepLab"}
    if arch == "PanopticDeepLabPR":
        model.update(subdivision_num_points=256, train_num_points=64)
    return {
        "model_name": "blobs", "seed": 0, "MODEL": model,
        "DATASET": {"class_names": {1: "blob"}, "labels": [1], "thing_list": [1],
                    "norms": {"mean": 0.6, "std": 0.2}},
        "TRAIN": {"train_dir": os.path.join(blob_dir, "train"), "model_dir": str(model_dir),
                  "save_freq": 1, "amp": False, "epochs": epochs, "batch_size": 4,
                  "print_freq": 1000, "criterion": "PanopticLoss",
                  "criterion_params": {"top_k_percent": 0.2},
                  "schedule_params": {"max_lr": 3e-3, "pct_start": 0.3},
                  "optimizer_params": {"weight_decay": 0.01},
                  "dataset_class": "SingleClassInstanceDataset",
                  "dataset_params": {"weight_gamma": 0.3},
                  "augmentations": augs or [{"aug": "RandomCrop", "height": 64, "width": 64}],
                  "metrics": [], **train},
    }


class _Crash(Exception):
    pass


def test_resume_is_bit_identical(blob_dir, tmp_path, monkeypatch):
    """Two epochs straight against a run that crashes after its first
    epoch's checkpoint and is resumed: the same parameters, statistics and
    optimizer state, bit for bit (the checkpoint carries the generator's,
    the loader's and the augmentations' draws; PointRend and the
    augmentations draw)."""
    augs = [{"aug": "RandomScale", "scale_limit": [-0.3, 0.3]},
            {"aug": "PadIfNeeded", "min_height": 48, "min_width": 48},
            {"aug": "RandomCrop", "height": 48, "width": 48},
            {"aug": "Rotate", "limit": 180}, {"aug": "HorizontalFlip"}]
    kw = dict(arch="PanopticDeepLabPR", augs=augs)
    _, straight = T.main(_config(blob_dir, tmp_path / "a", 2, **kw), device="cpu")
    save = T.loop.save_checkpoint

    def save_then_crash(*args, **kwargs):
        save(*args, **kwargs)
        raise _Crash

    monkeypatch.setattr(T.loop, "save_checkpoint", save_then_crash)
    with pytest.raises(_Crash):
        T.main(_config(blob_dir, tmp_path / "b", 2, **kw), device="cpu")
    monkeypatch.setattr(T.loop, "save_checkpoint", save)
    cfg = _config(blob_dir, tmp_path / "b", 2, resume=True, **kw)
    _, resumed = T.main(cfg, device="cpu")
    assert resumed.step == straight.step == 6
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    oa, ob = straight.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    for i in oa:
        assert all(torch.equal(oa[i][k], ob[i][k]) for k in oa[i])


def test_multichip_and_jax_checkpoints_raise(blob_dir, tmp_path):
    """``TRAIN.multichip`` in a world of one (no process group) trains as
    the plain run does, bit for bit (worlds of two are in
    test_torch_ddp.py); a JAX checkpoint is refused, and so is the card
    without a GPU."""
    _, plain = T.main(_config(blob_dir, tmp_path / "plain", 1), device="cpu")
    _, multi = T.main(_config(blob_dir, tmp_path / "multi", 1, multichip=True), device="cpu")
    a, b = plain.model.state_dict(), multi.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    jax_ckpt = tmp_path / "blobs_checkpoint.msgpack"
    jax_ckpt.write_bytes(b"\x85\xa6params")
    with pytest.raises(ValueError, match="from_flax"):
        T.main(_config(blob_dir, tmp_path, 1, resume=True), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.main(_config(blob_dir, tmp_path, 1))


EVAL = {"padding_factor": 16, "engine_params": {"label_divisor": 1000,
                                                "confidence_thr": 0.5},
        "metrics": [{"metric": "PQ", "name": "pq", "label_divisor": 1000},
                    {"metric": "F1", "name": "F1_50", "label_divisor": 1000,
                     "iou_thr": 0.5}]}


def test_validate_matches_jax(blob_dir):
    """``validate`` on the same weights as JAX's: PQ and F1 of the eval
    images (the GT through the same postprocess) equal."""
    from empanada_tpu.train.state import TrainState as JaxState

    kw = {k: v for k, v in SMALL_PR.items() if k != "subdivision_num_points"}
    model, variables = jax_init("PanopticDeepLab", kw, size=64)
    tmodel = port_model("PanopticDeepLab", kw, variables)
    cfg = _config(blob_dir, blob_dir, 1)
    cfg["EVAL"] = dict(EVAL, eval_dir=os.path.join(blob_dir, "eval"))
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                      batch_stats=variables["batch_stats"], opt_state=None,
                      tx=optax.identity(), apply_fn=model.apply)
    want = JT.validate(cfg, model, jstate)
    state = T.create_train_state(tmodel, T.onecycle_schedule(1e-3, 1))
    tmodel.train()
    got = T.validate(cfg, tmodel, state, device="cpu")
    assert tmodel.training
    assert got.history.keys() == want.history.keys()
    for k in want.history:
        np.testing.assert_allclose(got.history[k], want.history[k], rtol=1e-6, err_msg=k)
    # train_config.yaml's EVAL metrics: its IoU, on which JAX's validate
    # fails (no logits there, ROADMAP C7), is the mean over the images of
    # the eval-mode logits' IoU
    cfg["EVAL"]["metrics"] = [{"metric": "IoU", "name": "semantic_iou",
                               "output_key": "sem_logits", "target_key": "sem"}]
    with pytest.raises(KeyError, match="sem_logits"):
        JT.validate(cfg, model, jstate)
    got = T.validate(cfg, tmodel, state, device="cpu")
    from empanada_tpu_torch.data.augment import create_augmentations
    from empanada_tpu_torch.data.datasets import create_dataset

    items = create_dataset("SingleClassInstanceDataset", cfg["EVAL"]["eval_dir"],
                           transforms=create_augmentations([{"aug": "Normalize",
                                                             "mean": 0.6, "std": 0.2}]))
    ious = []
    for i in range(len(items)):
        x = torch.from_numpy(items[i]["image"])[None]
        logits = T.make_eval_step()(state, x)["sem_logits"].numpy()
        ious.append(T.IoU(T.AverageMeter, [1]).calculate({"sem_logits": logits},
                                                         {"sem": items[i]["sem"][None]})[1])
    np.testing.assert_allclose(got.history["blob_semantic_iou"], [np.mean(ious)], rtol=1e-6)


def test_finetune_round_trips_a_bundle(blob_dir, tmp_path, monkeypatch):
    """A port bundle, registered, finetuned for one epoch with stage1
    frozen: the stem and stage 1 keep their weights (their statistics
    move), the result is saved as a bundle, registered, and loads back
    equal; ``encoder_pretraining`` takes a bundle's encoder parameters and
    batch-norm statistics."""
    from empanada_tpu_torch.api import (
        get_configs,
        init_model_from_config,
        load_config,
        load_model_from_config,
        save_model_bundle,
    )

    monkeypatch.setattr(api_utils, "MODEL_DIR", str(tmp_path / "home"))
    base = load_config("MitoNet_v1")
    kw = dict(TRAIN_PR)
    base["model_kwargs"] = kw
    src = init_model_from_config(base, seed=4, device="cpu")
    base["model"] = save_model_bundle(str(tmp_path / "base"), base["arch"], kw, src)
    start = {k: v.clone() for k, v in src.state_dict().items()}
    cfg = _config(blob_dir, tmp_path / "ft", 1)
    cfg = {"model_name": "ft_blobs", "model_config": base, "seed": 0,
           "TRAIN": dict(cfg["TRAIN"], finetune_layer="stage1")}
    for key in ("criterion", "criterion_params", "dataset_class", "dataset_params"):
        cfg["TRAIN"].pop(key)
    model, state, path = T.finetune_main(cfg, device="cpu")
    assert state.step == 3 and path.endswith(".eptorch") and os.path.isfile(path)
    assert "ft_blobs" in get_configs()
    reg = load_config("ft_blobs")
    assert reg["model"] == path
    back = load_model_from_config(reg, device="cpu")
    sd = model.state_dict()
    for k, v in back.state_dict().items():
        assert torch.equal(v, sd[k]), k
    assert torch.equal(sd["encoder.stem_conv.weight"], start["encoder.stem_conv.weight"])
    assert torch.equal(sd["encoder.layer1_block1.cba1.conv.weight"],
                       start["encoder.layer1_block1.cba1.conv.weight"])
    assert not torch.equal(sd["encoder.layer1_block1.cba1.bn.running_mean"],
                           start["encoder.layer1_block1.cba1.bn.running_mean"])
    assert not torch.equal(sd["encoder.layer2_block1.cba1.conv.weight"],
                           start["encoder.layer2_block1.cba1.conv.weight"])

    pre = _config(blob_dir, tmp_path / "pre", 0, arch="PanopticDeepLabPR",
                  encoder_pretraining=path)
    pretrained, _ = T.main(pre, device="cpu")
    psd = pretrained.state_dict()
    for name, t in back.state_dict().items():
        if name.startswith("encoder."):
            assert torch.equal(psd[name], t), name
