"""PointRend semantic refinement (counterpart of
``empanada_tpu/models/point_rend.py``): the eval subdivision steps and the
train branch's point sampling.  Tensors at the head's interface are
channel-last, as in the JAX package: logits (N, H, W, C), features
(N, Hc, Wc, F), points (N, P, C)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from empanada_tpu_torch.ops import pointrend_refine as prr
from empanada_tpu_torch.ops.interpolate import (
    bilinear_resize,
    point_sample,
    point_sample_packed,
)
from empanada_tpu_torch.ops.select import kth_largest, top_k_indices
from empanada_tpu_torch.parallel.mesh import global_rand

__all__ = [
    "calculate_uncertainty",
    "get_uncertain_point_coords_on_grid",
    "get_uncertain_point_coords_with_randomness",
    "StandardPointHead",
    "PointRendSemSegHead",
]

FUSED_RENDER = ("auto", "never", "always", "interpret")


def calculate_uncertainty(logits: torch.Tensor) -> torch.Tensor:
    """-(top1 - top2) over channels (last axis); -|logit| for one channel."""
    if logits.shape[-1] == 1:
        return -logits.abs()
    top2 = torch.topk(logits, 2, dim=-1).values
    return (top2[..., 1] - top2[..., 0])[..., None]


def get_uncertain_point_coords_on_grid(uncertainty_map: torch.Tensor, num_points: int):
    """Top-``num_points`` most uncertain grid points of (N, H, W, 1):
    flat indices (N, P) and normalized (x, y) pixel-center coords (N, P, 2)."""
    n, h, w, _ = uncertainty_map.shape
    idx = top_k_indices(uncertainty_map.reshape(n, h * w), min(h * w, num_points))
    xs = (1.0 / w) * (0.5 + (idx % w).float())
    ys = (1.0 / h) * (0.5 + (idx // w).float())
    return idx, torch.stack([xs, ys], dim=-1)


def get_uncertain_point_coords_with_randomness(coarse_logits, num_points: int,
                                               oversample_ratio: int,
                                               importance_sample_ratio: float,
                                               generator=None, uniforms=None):
    """Training-time point sampling: ``num_points * oversample_ratio``
    uniform points, the ``importance_sample_ratio`` most uncertain of them,
    then fresh uniform points to ``num_points`` -> (N, P, 2) (x, y) in
    [0, 1), without gradient.  The draws come from ``generator`` (on the
    logits' device), or are given as ``uniforms`` = (sampled (N, S, 2),
    random (N, P - U, 2)) to replay another draw."""
    if oversample_ratio < 1 or not 0 <= importance_sample_ratio <= 1:
        raise ValueError(f"oversample_ratio {oversample_ratio} must be >= 1 and "
                         f"importance_sample_ratio {importance_sample_ratio} in [0, 1]")
    n, dev = coarse_logits.shape[0], coarse_logits.device
    num_sampled = int(num_points * oversample_ratio)
    num_uncertain = int(importance_sample_ratio * num_points)
    num_random = num_points - num_uncertain
    with torch.no_grad():
        if uniforms is None:
            # at the global batch's shape under data parallelism
            # (parallel.mesh)
            sampled = global_rand((n, num_sampled, 2), generator=generator, device=dev)
            rand = global_rand((n, num_random, 2), generator=generator, device=dev)
        else:
            sampled, rand = (u.to(dev, torch.float32) for u in uniforms)
        logits = point_sample(coarse_logits.detach(), sampled)
        uncertainty = calculate_uncertainty(logits)[..., 0]
        idx = torch.topk(uncertainty, num_uncertain, dim=1).indices
        picked = torch.gather(sampled, 1, idx[..., None].expand(-1, -1, 2))
        if num_random > 0:
            picked = torch.cat([picked, rand], dim=1)
    return picked


class StandardPointHead(nn.Module):
    """Per-point MLP over [fine features; coarse logits], the coarse logits
    re-appended after every hidden layer."""

    def __init__(self, in_features: int, num_classes: int, fc_dim: int,
                 num_fc: int = 3, coarse_pred_each_layer: bool = True):
        super().__init__()
        self.num_classes = num_classes
        self.num_fc = num_fc
        self.coarse_pred_each_layer = coarse_pred_each_layer
        extra = num_classes if coarse_pred_each_layer else 0
        nin = in_features + num_classes
        for k in range(num_fc):
            self.add_module(f"fc{k + 1}", nn.Linear(nin, fc_dim))
            nin = fc_dim + extra
        self.predictor = nn.Linear(nin, num_classes)
        self._packed = None  # (key, pointrend_refine.PackedWeights)
        self._frozen = None  # (feature_dim, in_features, fc_dim, num_fc) of freeze_packed

    def fcs(self):
        return [getattr(self, f"fc{k + 1}") for k in range(self.num_fc)]

    def forward(self, fine_grained_features, coarse_features):
        x = torch.cat([fine_grained_features, coarse_features], dim=-1)
        for layer in self.fcs():
            x = F.relu(layer(x))
            if self.coarse_pred_each_layer:
                x = torch.cat([x, coarse_features], dim=-1)
        return self.predictor(x)

    def _split(self, layer, x, coarse):
        # [x, coarse] @ W + b == x @ W[:-nc] + coarse @ W[-nc:] + b
        kern = layer.weight.t()
        if not self.coarse_pred_each_layer:
            return x @ kern + layer.bias
        nc = coarse.shape[-1]
        return x @ kern[:-nc] + coarse @ kern[-nc:] + layer.bias

    def dense_lowres(self, features_lo, coarse_hi, resize):
        """Dense evaluation on an upsampled grid with the first layer's
        feature product at LOW resolution: ``resize(f @ W_f)`` equals
        ``resize(f) @ W_f`` (both linear, zero padding commutes)."""
        fdim = features_lo.shape[-1]
        fc1 = self.fc1
        kern = fc1.weight.t()
        g = resize(features_lo @ kern[:fdim])
        x = F.relu(g + coarse_hi @ kern[fdim:] + fc1.bias)
        for layer in self.fcs()[1:]:
            x = F.relu(self._split(layer, x, coarse_hi))
        return self._split(self.predictor, x, coarse_hi)

    def fused_weights(self, feature_dim: int):
        """The split weights the refine kernel takes: per hidden layer
        (W_fine (in, D), W_coarse (1, D), bias (1, D)); predictor
        ((1, D), w_coarse, bias) with the two scalars as float32.  Detached:
        the render is inference only."""
        if self.num_classes != 1 or not self.coarse_pred_each_layer:
            raise ValueError("fused weights need one class and coarse_pred_each_layer")
        if self.fc1.in_features != feature_dim + 1:
            raise ValueError(f"point head takes {self.fc1.in_features - 1} feature "
                             f"channels, not {feature_dim}")
        layers = []
        for layer in self.fcs():
            kern = layer.weight.detach().t()
            layers.append((kern[:-1].contiguous(), kern[-1:].contiguous(),
                           layer.bias.detach()[None, :]))
        kern = self.predictor.weight.detach().t()
        bias = self.predictor.bias.detach()
        return layers, (kern[:-1, 0][None, :], kern[-1, 0].float(), bias[0].float())

    def packed_weights(self, feature_dim: int):
        """``fused_weights`` in the refine kernel's layout
        (``pointrend_refine.pack_weights``), built once and cached on the
        head; a parameter changed in place or replaced (its ``_version`` or
        ``data_ptr``) rebuilds it."""
        if self._frozen is not None:
            fdim, *widths = self._frozen
            if fdim != feature_dim:
                raise ValueError(f"point head frozen for F={fdim}, not {feature_dim}")
            return prr.PackedWeights(self.packed, *widths)
        key = (feature_dim,) + tuple((p._version, p.data_ptr(), p.device, p.dtype)
                                     for p in self.parameters())
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, prr.pack_weights(self.fused_weights(feature_dim)))
        return self._packed[1]

    def freeze_packed(self, feature_dim: int):
        """Pack the weights once and keep the buffer as the non-persistent
        buffer ``packed``, which ``packed_weights`` then returns without
        looking at the parameters: ``torch.export`` traces fake parameters,
        whose data no cache key can read, and lifts the buffer into the
        program as a constant.  Later changes to the parameters are not
        seen; ``api/deploy.py`` freezes a copy of the model."""
        packed = prr.pack_weights(self.fused_weights(feature_dim))
        self.register_buffer("packed", packed.buf, persistent=False)
        self._frozen = (feature_dim, packed.in_features, packed.fc_dim, packed.num_fc)


class PointRendSemSegHead(nn.Module):
    """Coarse semantic logits + iterative point refinement.

    With ``train`` True the head samples ``train_num_points`` points
    (``get_uncertain_point_coords_with_randomness``, or the given
    ``point_coords``) and returns the coarse logits unchanged with the point
    head's logits there: {"sem_seg_logits", "point_logits", "point_coords"};
    it never reaches the refine kernel, which has no backward.

    ``fused_render``: "auto" sends each step that the refine kernel takes
    (``pointrend_refine.fused_step_supported``) through it and the rest down
    the dense/sparse torch path; "never" always takes the torch path;
    "always" requires the kernel and raises where a step does not fit;
    "interpret" runs the kernel's plain version on any device for the
    steps the kernel takes.
    """

    def __init__(self, in_features: int, num_classes: int, fc_dim: int,
                 num_fc: int = 3, subdivision_num_points: int = 8192,
                 fused_render: str = "auto", train_num_points: int = 1024,
                 oversample_ratio: int = 3, importance_sample_ratio: float = 0.75):
        super().__init__()
        self.train_num_points = train_num_points
        self.oversample_ratio = oversample_ratio
        self.importance_sample_ratio = importance_sample_ratio
        if fused_render not in FUSED_RENDER:
            raise ValueError(f"fused_render={fused_render!r}: expected one of "
                             f"{FUSED_RENDER}")
        self.num_classes = num_classes
        self.subdivision_num_points = subdivision_num_points
        self.fused_render = fused_render
        self.point_head = StandardPointHead(in_features, num_classes, fc_dim, num_fc)

    def _fused_step_ok(self, h2, w2, features, dtype) -> bool:
        if self.fused_render == "never":
            return False
        ok = prr.fused_step_supported(h2, w2, features.shape[1], features.shape[2],
                                      self.num_classes, features.shape[-1], dtype)
        if self.fused_render == "always" and not ok:
            raise ValueError(f"fused_render='always': step to ({h2}, {w2}) does "
                             "not fit the refine kernel")
        return ok

    def forward(self, coarse_sem_seg_logits, features, subdivision_steps: int = 2,
                train: bool = False, generator=None, point_coords=None):
        if train:
            if point_coords is None:
                point_coords = get_uncertain_point_coords_with_randomness(
                    coarse_sem_seg_logits, self.train_num_points, self.oversample_ratio,
                    self.importance_sample_ratio, generator)
            coarse_points = point_sample(coarse_sem_seg_logits, point_coords)
            fine_points = point_sample(features, point_coords)
            return {"sem_seg_logits": coarse_sem_seg_logits,
                    "point_logits": self.point_head(fine_points, coarse_points),
                    "point_coords": point_coords}
        sem = coarse_sem_seg_logits
        for _ in range(subdivision_steps):
            sem = self.step(sem, coarse_sem_seg_logits, features)
        return {"sem_seg_logits": sem}

    def step(self, sem, coarse, features):
        """One subdivision step (N, h, w, C) -> (N, 2h, 2w, C); every step
        re-samples the original ``coarse`` logits."""
        n, h, w, c = sem.shape
        h2, w2 = 2 * h, 2 * w
        num_points = min(h2 * w2, self.subdivision_num_points)
        if self._fused_step_ok(h2, w2, features, sem.dtype):
            fdim = features.shape[-1]
            args = (sem, features.contiguous(), coarse.to(features.dtype).contiguous())
            if self.fused_render == "interpret" or features.device.type == "cpu":
                return prr.refine_step_reference(*args, self.point_head.fused_weights(fdim),
                                                 self.subdivision_num_points)
            return prr.fused_refine_step(*args, self.point_head.packed_weights(fdim),
                                         self.subdivision_num_points)
        sem = bilinear_resize(sem, (h2, w2), align_corners=False)
        uncertainty = calculate_uncertainty(sem)
        if h2 * w2 <= 8 * num_points:
            return self._dense_step(sem, uncertainty, coarse, features, num_points)
        return self._sparse_step(sem, uncertainty, coarse, features, num_points)

    def _dense_step(self, sem, uncertainty, coarse, features, num_points):
        """Refine every grid point; keep the refined value where the
        uncertainty reaches the K-th value (a tie superset of the top K)."""
        n, h2, w2, c = sem.shape
        kth = kth_largest(uncertainty.reshape(n, -1), num_points).to(uncertainty.dtype)
        mask = uncertainty >= kth[:, None, None, None]

        def resize(t):
            return bilinear_resize(t, (h2, w2), align_corners=False, zeros_padding=True)

        coarse_dense = resize(coarse)
        if sem.dtype == torch.bfloat16:
            dense = self.point_head.dense_lowres(features, coarse_dense, resize)
        else:
            dense = self.point_head(resize(features), coarse_dense)
        return torch.where(mask, dense, sem)

    def _sparse_step(self, sem, uncertainty, coarse, features, num_points):
        """Select the top K points, sample, run the point head, scatter."""
        n, h2, w2, c = sem.shape
        idx, coords = get_uncertain_point_coords_on_grid(uncertainty, num_points)
        fdim = features.shape[-1]
        if coarse.shape[1:3] == features.shape[1:3]:
            dt = torch.promote_types(features.dtype, coarse.dtype)
            packed = torch.cat([features.to(dt), coarse.to(dt)], dim=-1)
            pts = point_sample_packed(packed, coords)
            fine = pts[..., :fdim].to(features.dtype)
            coarse_pts = pts[..., fdim:].to(coarse.dtype)
        else:
            fine = point_sample_packed(features, coords)
            coarse_pts = point_sample_packed(coarse, coords)
        point_logits = self.point_head(fine, coarse_pts)
        flat = sem.reshape(n, h2 * w2, c).clone()
        flat.scatter_(1, idx[..., None].expand(-1, -1, c), point_logits.to(flat.dtype))
        return flat.reshape(n, h2, w2, c)
