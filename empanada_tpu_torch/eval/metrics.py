"""Evaluation metrics (counterpart of ``empanada_tpu/eval/metrics.py``).

The instance and panoptic metrics take the matched and unmatched labels of
a Hungarian matching and the matched IoUs; a match below the IoU threshold
counts as a false positive and a false negative at once.  Empty inputs
score 1.
"""

from __future__ import annotations

import numpy as np

from empanada_tpu_torch.core.rle import rle_iou

__all__ = [
    "f1", "ap", "precision", "recall", "panoptic_quality", "semantic_iou",
    "f1_50", "f1_75", "precision_50", "precision_75", "recall_50", "recall_75",
]


def _counts(gt_unmatched, pred_unmatched, matched_ious, iou_thr):
    """(tp, fp, fn) at ``iou_thr``."""
    failed = int(np.count_nonzero(matched_ious < iou_thr))
    tp = int(np.count_nonzero(matched_ious >= iou_thr))
    return tp, len(pred_unmatched) + failed, len(gt_unmatched) + failed


def f1(gt_matched, gt_unmatched, pred_matched, pred_unmatched, matched_ious, iou_thr=0.5):
    tp, fp, fn = _counts(gt_unmatched, pred_unmatched, matched_ious, iou_thr)
    if tp + fp + fn == 0:
        return 1
    return tp / (tp + 0.5 * fp + 0.5 * fn)


def ap(gt_matched, gt_unmatched, pred_matched, pred_unmatched, matched_ious, iou_thr=0.5):
    tp, fp, fn = _counts(gt_unmatched, pred_unmatched, matched_ious, iou_thr)
    if tp + fp + fn == 0:
        return 1
    return tp / (tp + fp + fn)


def precision(gt_matched, gt_unmatched, pred_matched, pred_unmatched, matched_ious,
              iou_thr=0.5):
    tp, fp, _ = _counts(gt_unmatched, pred_unmatched, matched_ious, iou_thr)
    if tp + fp == 0:
        return 1
    return tp / (tp + fp)


def recall(gt_matched, gt_unmatched, pred_matched, pred_unmatched, matched_ious, iou_thr=0.5):
    tp, _, fn = _counts(gt_unmatched, pred_unmatched, matched_ious, iou_thr)
    if tp + fn == 0:
        return 1
    return tp / (tp + fn)


def panoptic_quality(gt_matched, gt_unmatched, pred_matched, pred_unmatched, matched_ious):
    """Segmentation quality (mean IoU of the true positives, with 1e-5 in
    the denominator) times recognition quality (F1 at IoU 0.5)."""
    tp, fp, fn = _counts(gt_unmatched, pred_unmatched, matched_ious, 0.5)
    if tp + fp + fn == 0:
        return 1
    sq = matched_ious[matched_ious >= 0.5].sum() / (tp + 1e-5)
    rq = tp / (tp + 0.5 * fp + 0.5 * fn)
    return sq * rq


def semantic_iou(gt_rle, pred_rle):
    """IoU of two merged semantic RLEs, (n, 2) arrays of (start, run)."""
    if len(gt_rle) == 0 and len(pred_rle) == 0:
        return 1
    if len(gt_rle) == 0 or len(pred_rle) == 0:
        return 0
    return rle_iou(gt_rle[:, 0], gt_rle[:, 1], pred_rle[:, 0], pred_rle[:, 1])


def f1_50(**kwargs):
    return f1(**kwargs, iou_thr=0.5)


def f1_75(**kwargs):
    return f1(**kwargs, iou_thr=0.75)


def precision_50(**kwargs):
    return precision(**kwargs, iou_thr=0.5)


def precision_75(**kwargs):
    return precision(**kwargs, iou_thr=0.75)


def recall_50(**kwargs):
    return recall(**kwargs, iou_thr=0.5)


def recall_75(**kwargs):
    return recall(**kwargs, iou_thr=0.75)
