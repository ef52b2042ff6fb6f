"""Training losses (counterpart of ``empanada_tpu/train/losses.py``).

Targets are channel-last, as the data layer makes them: ``sem`` (N, H, W)
integer, ``ctr_hmp`` (N, H, W, 1), ``offsets`` (N, H, W, 2); ``cnt``
(N, H, W) for the boundary-contour model.  Every loss is a 0-d tensor on
the outputs' device, in float32 under bf16 compute (float64 for float64
outputs): nothing is read back to the host.

Under ``parallel.mesh.data_parallel`` each rank holds its rows of the
global batch, and every loss returns this rank's share of the global
batch's loss (the shares sum to it over the ranks, so the gradients do
too): ``bootstrap_ce`` the rank's pixels among the global batch's hardest
``top_k_percent`` over the global k, ``offset_l1`` the rank's weighted sum
over the global weights' sum, and the means their local mean over the
world's size (equal shards).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from empanada_tpu_torch.ops.interpolate import point_sample
from empanada_tpu_torch.parallel.mesh import all_gather, all_reduce, current_data_mesh

__all__ = [
    "at_least_f32",
    "bootstrap_ce",
    "heatmap_mse",
    "offset_l1",
    "point_rend_loss",
    "PanopticLoss",
    "BCLoss",
]


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or in its own dtype when that is wider."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _pixel_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position (B)CE in float32 (or wider): sigmoid BCE for one
    channel, softmax CE over the last axis with integer labels otherwise."""
    logits = at_least_f32(logits)
    if logits.shape[-1] == 1:
        return F.binary_cross_entropy_with_logits(logits[..., 0], labels.to(logits.dtype),
                                                  reduction="none")
    c = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, c), labels.reshape(-1).long(),
                           reduction="none").reshape(labels.shape)


def bootstrap_ce(logits, labels, top_k_percent: float = 0.2):
    """(B)CE averaged over the ``top_k_percent`` hardest pixels of the
    whole batch, in float32 (the JAX package reduces in f32 under bf16
    compute too)."""
    pixel = _pixel_ce(logits, labels).reshape(-1)
    mesh = current_data_mesh()
    if mesh is None:
        if top_k_percent == 1.0:
            return pixel.mean()
        k = int(top_k_percent * pixel.numel())
        return torch.topk(pixel, k, sorted=False).values.mean()
    n = pixel.numel() * mesh.size
    if top_k_percent == 1.0:
        return pixel.sum() / n
    k = int(top_k_percent * n)
    # the global k-th largest from every rank's pixels; the pixels tied
    # with it share what is left of k
    everything = torch.cat(all_gather(pixel.detach(), mesh))
    thr = torch.topk(everything, k, sorted=False).values.min()
    n_above = (everything > thr).sum()
    n_tied = (everything == thr).sum()
    zero = torch.zeros_like(pixel)
    above = torch.where(pixel > thr, pixel, zero).sum()
    tied = torch.where(pixel == thr, pixel, zero).sum()
    return (above + tied * ((k - n_above) / n_tied)) / k


def heatmap_mse(output, target):
    mse = torch.mean((at_least_f32(output) - at_least_f32(target)) ** 2)
    mesh = current_data_mesh()
    return mse if mesh is None else mse / mesh.size


def offset_l1(output, target, offset_weights):
    """L1 inside the GT segmentation: the weighted sum over both offset
    channels over the weights' sum; 0 when the weights are all 0."""
    l1 = (at_least_f32(output) - at_least_f32(target)).abs() * offset_weights
    wsum = offset_weights.sum()
    mesh = current_data_mesh()
    if mesh is not None:
        wsum = all_reduce(wsum, mesh)
    return torch.where(wsum == 0, torch.zeros_like(wsum),
                       l1.sum() / torch.clamp(wsum, min=1e-8))


def point_rend_loss(point_logits, point_coords, labels):
    """(B)CE between the point logits (N, P, C) and the labels (N, H, W)
    sampled at ``point_coords`` (N, P, 2) by the nearest pixel."""
    point_labels = point_sample(labels[..., None].to(point_coords.dtype), point_coords,
                                mode="nearest")
    ce = _pixel_ce(point_logits, point_labels[..., 0]).mean()
    mesh = current_data_mesh()
    return ce if mesh is None else ce / mesh.size


class PanopticLoss:
    """``ce_weight`` bootstrapped semantic CE + ``mse_weight`` heatmap MSE +
    ``l1_weight`` offset L1 inside the GT, + ``pr_weight`` PointRend point
    CE when the output has ``sem_points``.  Returns (total, aux dict)."""

    def __init__(self, ce_weight: float = 1, mse_weight: float = 200,
                 l1_weight: float = 0.01, pr_weight: float = 1,
                 top_k_percent: float = 0.2):
        self.ce_weight = ce_weight
        self.mse_weight = mse_weight
        self.l1_weight = l1_weight
        self.pr_weight = pr_weight
        self.top_k_percent = top_k_percent

    def __call__(self, output: dict, target: dict):
        mse = heatmap_mse(output["ctr_hmp"], target["ctr_hmp"])
        ce = bootstrap_ce(output["sem_logits"], target["sem"], self.top_k_percent)
        offset_weights = (target["sem"] > 0)[..., None].to(at_least_f32(output["offsets"]).dtype)
        l1 = offset_l1(output["offsets"], target["offsets"], offset_weights)
        aux = {"ce": ce, "l1": l1, "mse": mse}
        total = self.ce_weight * ce + self.mse_weight * mse + self.l1_weight * l1
        if "sem_points" in output:
            pr_ce = point_rend_loss(output["sem_points"], output["point_coords"],
                                    target["sem"])
            aux["pointrend_ce"] = pr_ce
            total = total + self.pr_weight * pr_ce
        aux["total_loss"] = total
        return total, aux


class BCLoss:
    """Bootstrapped semantic + contour CE, + ``pr_weight`` times both heads'
    PointRend point CE when the output has them."""

    def __init__(self, pr_weight: float = 1, top_k_percent: float = 0.15):
        self.pr_weight = pr_weight
        self.top_k_percent = top_k_percent

    def __call__(self, output: dict, target: dict):
        sem_ce = bootstrap_ce(output["sem_logits"], target["sem"], self.top_k_percent)
        cnt_ce = bootstrap_ce(output["cnt_logits"], target["cnt"], self.top_k_percent)
        aux = {"sem_ce": sem_ce, "cnt_ce": cnt_ce}
        total = sem_ce + cnt_ce
        if "sem_points" in output:
            sem_pr = point_rend_loss(output["sem_points"], output["sem_point_coords"],
                                     target["sem"])
            cnt_pr = point_rend_loss(output["cnt_points"], output["cnt_point_coords"],
                                     target["cnt"])
            aux["sem_pr_ce"] = sem_pr
            aux["cnt_pr_ce"] = cnt_pr
            total = total + self.pr_weight * (sem_pr + cnt_pr)
        aux["total_loss"] = total
        return total, aux
