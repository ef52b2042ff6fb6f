"""Accuracy metrics between two label arrays (counterpart of
``empanada_tpu/curation/accuracy.py``): pixel precision, recall, F1 and IoU,
and instance metrics after a Hungarian matching."""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

from empanada_tpu_torch.stitch.matcher import fast_matcher

__all__ = ["compute_pixel_metrics", "compute_instance_metrics"]


def compute_pixel_metrics(gt_labels: np.ndarray, pred_labels: np.ndarray) -> dict:
    gt = np.asarray(gt_labels) > 0
    pred = np.asarray(pred_labels) > 0
    tp = int(np.logical_and(gt, pred).sum())
    fp = int(np.logical_and(~gt, pred).sum())
    fn = int(np.logical_and(gt, ~pred).sum())
    precision = tp / (tp + fp) if tp + fp else 1.0
    recall = tp / (tp + fn) if tp + fn else 1.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    iou = tp / (tp + fp + fn) if tp + fp + fn else 1.0
    return {"precision": precision, "recall": recall, "f1": f1, "iou": iou}


def _nd_matcher(gt: np.ndarray, pred: np.ndarray, iou_thr: float):
    """Exact Hungarian instance matching of label volumes of any dimension
    from the intersections of label pairs (``fast_matcher`` takes 2D maps
    only)."""
    g = gt.ravel()
    p = pred.ravel()
    keep = (g > 0) & (p > 0)
    gl = np.unique(gt[gt > 0])
    pl = np.unique(pred[pred > 0])
    if len(gl) == 0 or len(pl) == 0 or not keep.any():
        return (
            (np.array([], np.int64), np.array([], np.int64)),
            (gl, pl),
            np.array([]),
        )
    g_areas = dict(zip(*np.unique(g[g > 0], return_counts=True)))
    p_areas = dict(zip(*np.unique(p[p > 0], return_counts=True)))
    pairs, counts = np.unique(
        np.stack([g[keep], p[keep]]), axis=1, return_counts=True
    )
    gi = {v: i for i, v in enumerate(gl)}
    pi = {v: i for i, v in enumerate(pl)}
    iou = np.zeros((len(gl), len(pl)))
    for (gv, pv), inter in zip(pairs.T, counts):
        iou[gi[gv], pi[pv]] = inter / (g_areas[gv] + p_areas[pv] - inter)
    rows, cols = linear_sum_assignment(iou, maximize=True)
    ok = iou[rows, cols] >= iou_thr
    return (
        (gl[rows[ok]], pl[cols[ok]]),
        (gl, pl),
        iou[rows[ok], cols[ok]],
    )


def compute_instance_metrics(
    gt_labels: np.ndarray, pred_labels: np.ndarray, iou_thr: float = 0.5
) -> dict:
    gt = np.asarray(gt_labels).astype(np.int64)
    pred = np.asarray(pred_labels).astype(np.int64)
    if gt.ndim == 2:
        matched_labels, all_labels, matched_ious = fast_matcher(gt, pred, iou_thr=iou_thr)
    else:
        matched_labels, all_labels, matched_ious = _nd_matcher(gt, pred, iou_thr)
    tp = len(matched_labels[0])
    fn = len(np.setdiff1d(all_labels[0], matched_labels[0]))
    fp = len(np.setdiff1d(all_labels[1], matched_labels[1]))
    if tp + fp + fn == 0:
        return {"f1": 1.0, "precision": 1.0, "recall": 1.0, "tp": 0, "fp": 0, "fn": 0,
                "mean_matched_iou": 1.0}
    precision = tp / (tp + fp) if tp + fp else 1.0
    recall = tp / (tp + fn) if tp + fn else 1.0
    f1 = tp / (tp + 0.5 * fp + 0.5 * fn)
    return {
        "f1": f1, "precision": precision, "recall": recall,
        "tp": tp, "fp": fp, "fn": fn,
        "mean_matched_iou": float(matched_ious.mean()) if len(matched_ious) else 0.0,
    }
