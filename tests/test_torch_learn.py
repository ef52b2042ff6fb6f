"""A learning run of the port's training loop on the CPU, as the JAX
package's ``tests/test_train.py::TestEndToEndTraining::test_main_learns``:
a small model trained on blob images segments a held-out one (IoU > 0.3),
and its checkpoint restores the step and the weights."""

import os

import numpy as np
import torch

import empanada_tpu_torch.train as T
from _torch_port import one_torch_thread  # noqa: F401
from empanada_tpu_torch.models import create_model
from test_torch_train_loop import _config, blob_dir, make_blob_example  # noqa: F401


def test_main_learns(blob_dir, tmp_path):
    """The loop trains a small model that segments a held-out blob image
    (IoU > 0.3, as the JAX package's learning test asks), and its loss
    falls; the checkpoint restores the step."""
    cfg = _config(blob_dir, tmp_path, 20, print_freq=3)
    model, state = T.main(cfg, device="cpu")
    img, mask = make_blob_example(np.random.default_rng(99))
    x = torch.from_numpy((img.astype(np.float32) - 0.6 * 255) / (0.2 * 255))[None, ..., None]
    out = T.make_eval_step()(state, x)
    pred = out["sem_logits"][0, ..., 0].numpy() > 0
    gt = mask > 0
    iou = np.logical_and(pred, gt).sum() / max(1, np.logical_or(pred, gt).sum())
    assert iou > 0.3, f"trained model IoU too low: {iou:.3f}"
    ckpt = os.path.join(str(tmp_path), "blobs_checkpoint.pt")
    fresh = T.create_train_state(create_model("PanopticDeepLab", device="cpu", **{
        k: v for k, v in cfg["MODEL"].items() if k != "arch"}), state.schedule)
    assert T.load_checkpoint(ckpt, fresh).step == state.step == 60
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k
