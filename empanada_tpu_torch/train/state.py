"""Train state and steps (counterpart of ``empanada_tpu/train/state.py``).

The optimizer is ``torch.optim.AdamW`` over two parameter groups, weight
decay on the conv and dense kernels and BiFPN's ``fusion_weights`` and none
on biases and batch-norm parameters (the JAX package's decay mask, taken
here from module types and names: a torch norm's scale is named
``weight``).  Its learning rate follows ``onecycle_schedule``, evaluated at
the step count before the update, as optax does.  AdamW's update
``-lr (m_hat / (sqrt(v_hat) + 1e-8) + wd p)`` is optax's ``adamw``.

A train step runs the forward under ``torch.autocast`` in bfloat16 when
``amp`` (the parameters stay float32; there is no loss scaler, as bf16
needs none), takes the gradients and the optimizer step, and reads nothing
back to the host.  ``remat`` recomputes the forward in the backward
(``torch.utils.checkpoint``) with the same random draws and without
folding the batch statistics in twice: the gradients are identical.

With a ``mesh`` of more than one rank (``parallel.mesh``) a step is the
JAX package's sharded step: each rank's batch is its rows of the global
batch, the forward and the loss run under ``data_parallel`` (global batch
statistics, each rank's share of the global loss, draws at the global
shape), and after the backward the gradients are summed over the ranks, so
every rank takes the step a world of one takes on the concatenated batch
and the optimizer's state stays the same on all of them.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from empanada_tpu_torch.models.blocks import BatchNorm, frozen_batch_stats
from empanada_tpu_torch.parallel.mesh import Mesh, all_reduce, data_parallel

__all__ = ["TrainState", "onecycle_schedule", "decay_mask", "adamw_with_decay_mask",
           "create_train_state", "make_train_step", "make_eval_step", "batch_to_device"]


def onecycle_schedule(max_lr: float, total_steps: int, pct_start: float = 0.3):
    """step -> learning rate: linear from ``max_lr / 25`` to ``max_lr`` over
    ``max(1, int(total_steps * pct_start))`` steps, then a cosine down to
    ``1e-4 max_lr`` over the rest (optax's ``join_schedules`` of
    ``linear_schedule`` and ``cosine_decay_schedule(alpha=1e-4)``)."""
    warmup = max(1, int(total_steps * pct_start))
    decay = max(1, total_steps - warmup)
    init = max_lr / 25.0
    alpha = 1e-4

    def schedule(step: int) -> float:
        if step < warmup:
            return (init - max_lr) * (1.0 - step / warmup) + max_lr
        t = min(step - warmup, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay))
        return max_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def decay_mask(model: nn.Module) -> dict:
    """{parameter name: receives weight decay}: False for every batch-norm
    parameter and every ``bias``, True for the rest."""
    mask = {}
    for mod_name, mod in model.named_modules():
        for name, _ in mod.named_parameters(recurse=False):
            full = f"{mod_name}.{name}" if mod_name else name
            mask[full] = not (isinstance(mod, BatchNorm) or name == "bias")
    return mask


def adamw_with_decay_mask(model: nn.Module, weight_decay: float = 0.1,
                          trainable: Optional[dict] = None) -> torch.optim.AdamW:
    """AdamW (b1 0.9, b2 0.999, eps 1e-8) over the ``trainable``
    parameters (default: all), decayed as ``decay_mask`` says.  A frozen
    parameter is in no group: it gets no update and no decay."""
    mask = decay_mask(model)
    groups = {True: [], False: []}
    for name, p in model.named_parameters():
        if trainable is None or trainable[name]:
            groups[mask[name]].append(p)
    return torch.optim.AdamW(
        [{"params": groups[True], "weight_decay": weight_decay},
         {"params": groups[False], "weight_decay": 0.0}],
        lr=0.0, betas=(0.9, 0.999), eps=1e-8)


class TrainState:
    """What a run carries from step to step: the model (float32 parameters
    and batch-norm statistics), the optimizer, the learning-rate schedule,
    the count of steps taken and the generator of the step's random draws
    (ASPP dropout, PointRend's points) on the model's device."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float], generator: torch.Generator,
                 step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.generator = generator
        self.step = step


def create_train_state(model: nn.Module, schedule, weight_decay: float = 0.1,
                       seed: int = 0, trainable: Optional[dict] = None) -> TrainState:
    """A fresh state: frozen parameters (``trainable`` False) stop taking
    gradients, the optimizer covers the rest, the generator is seeded."""
    if trainable is not None:
        for name, p in model.named_parameters():
            p.requires_grad_(bool(trainable[name]))
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    return TrainState(model, adamw_with_decay_mask(model, weight_decay, trainable),
                      schedule, gen)


def batch_to_device(batch: dict, device) -> dict:
    """numpy batch -> tensors on ``device`` (copies start without waiting)."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(v)
        out[k] = t.to(device, non_blocking=True)
    return out


def _sum_over_ranks(tensors: list, mesh: Mesh) -> None:
    """Sum ``tensors`` (one dtype) over the ranks in place, in one
    collective."""
    flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors]), mesh)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


@contextlib.contextmanager
def _recompute(mesh: Optional[Mesh]):
    with frozen_batch_stats(), data_parallel(mesh):
        yield


def make_train_step(loss_fn, remat: bool = False, amp: bool = True,
                    mesh: Optional[Mesh] = None):
    """``step(state, batch) -> aux``: one optimizer step on a batch of
    device tensors {"image": (B, H, W, 1), targets...}; ``aux`` is the
    loss's dict of 0-d device tensors (``total_loss`` among them), of the
    global batch with a ``mesh`` (module docstring)."""
    dp = mesh if mesh is not None and mesh.distributed else None

    def step(state: TrainState, batch: dict) -> dict:
        model, gen = state.model, state.generator
        dev = batch["image"].device
        lr = state.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.zero_grad(set_to_none=True)
        autocast = torch.autocast(dev.type, dtype=torch.bfloat16, enabled=amp)

        if remat:
            start = gen.get_state()

            def forward(image):
                gen.set_state(start)  # the recomputed forward draws the same
                return model(image, train=True, generator=gen)

            def contexts():
                return contextlib.nullcontext(), _recompute(dp)

            with autocast, data_parallel(dp):
                out = checkpoint(forward, batch["image"], use_reentrant=False,
                                 context_fn=contexts)
        else:
            with autocast, data_parallel(dp):
                out = model(batch["image"], train=True, generator=gen)
        with autocast, data_parallel(dp):
            loss, aux = loss_fn(out, batch)
        loss.backward()
        aux = {k: v.detach() for k, v in aux.items()}
        if dp is not None:
            # each rank's backward is its share of the global loss's
            _sum_over_ranks([p.grad for p in model.parameters() if p.grad is not None], dp)
            keys = sorted(aux)
            total = all_reduce(torch.stack([aux[k].to(loss.dtype) for k in keys]), dp)
            aux = dict(zip(keys, total.unbind()))
        state.optimizer.step()
        state.step += 1
        return aux

    return step


def make_eval_step(amp: bool = False):
    """``eval_step(state, images) -> outputs``: the model in eval mode
    (running statistics, PointRend's subdivision steps), no gradients,
    under bf16 autocast when ``amp``."""

    def step(state: TrainState, images: torch.Tensor) -> dict:
        model = state.model
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad(), torch.autocast(images.device.type, dtype=torch.bfloat16,
                                                 enabled=amp):
                return model(images)
        finally:
            model.train(was_training)

    return step
