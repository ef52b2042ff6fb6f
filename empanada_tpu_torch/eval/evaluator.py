"""Offline evaluator of two tracker dumps (counterpart of
``empanada_tpu/eval/evaluator.py``): a ground-truth and a predicted
RLE-JSON file, as ``stitch.tracker.InstanceTracker.write_to_json`` writes
them, scored by dictionaries of semantic, instance and panoptic metrics."""

from __future__ import annotations

import json

import numpy as np

from empanada_tpu_torch.core.rle import merge_rles, string_to_rle
from empanada_tpu_torch.stitch.matcher import rle_matcher

__all__ = ["Evaluator", "default_evaluator"]


def _merge_encodings_for_semantic(encodings) -> np.ndarray:
    """Every instance's RLE string merged into one semantic RLE, (n, 2)."""
    runs = [np.stack(string_to_rle(enc), axis=1) for enc in encodings]
    runs = np.concatenate(runs) if runs else np.empty((0, 2), dtype=np.int64)
    if len(runs) == 0:
        return np.empty((0, 2), dtype=np.int64)
    return np.stack(merge_rles(runs[:, 0], runs[:, 1]), axis=1)


def _instances(instance_dict: dict) -> dict:
    out = {}
    for k, attrs in instance_dict.items():
        starts, runs = string_to_rle(attrs["rle"])
        out[int(k)] = {"box": tuple(attrs["box"]), "starts": starts, "runs": runs}
    return out


class Evaluator:
    """``Evaluator(semantic_metrics, instance_metrics, panoptic_metrics)(gt,
    pred)`` -> ``{metric name: value}``; each argument maps names to
    functions, None leaves that group out."""

    def __init__(self, semantic_metrics=None, instance_metrics=None, panoptic_metrics=None):
        self.semantic_metrics = semantic_metrics
        self.instance_metrics = instance_metrics
        self.panoptic_metrics = panoptic_metrics

    def __call__(self, gt_json_fpath: str, pred_json_fpath: str,
                 return_instances: bool = False):
        with open(gt_json_fpath) as f:
            gt_json = json.load(f)
        with open(pred_json_fpath) as f:
            pred_json = json.load(f)
        if gt_json["class_id"] != pred_json["class_id"]:
            raise ValueError(f"prediction class {pred_json['class_id']} and ground truth "
                             f"class {gt_json['class_id']} must match")

        results, instances = {}, None
        if self.semantic_metrics is not None:
            gt_rle = _merge_encodings_for_semantic(
                [a["rle"] for a in gt_json["instances"].values()])
            pred_rle = _merge_encodings_for_semantic(
                [a["rle"] for a in pred_json["instances"].values()])
            results.update({name: func(gt_rle, pred_rle)
                            for name, func in self.semantic_metrics.items()})

        if self.instance_metrics is not None or self.panoptic_metrics is not None:
            (gt_matched, pred_matched), (gt_labels, pred_labels), ious = rle_matcher(
                _instances(gt_json["instances"]), _instances(pred_json["instances"]))
            instances = {"gt_matched": gt_matched, "pred_matched": pred_matched,
                         "gt_unmatched": np.setdiff1d(gt_labels, gt_matched),
                         "pred_unmatched": np.setdiff1d(pred_labels, pred_matched),
                         "matched_ious": ious}
            for metrics in (self.instance_metrics, self.panoptic_metrics):
                if metrics is not None:
                    results.update({name: func(**instances) for name, func in metrics.items()})

        if return_instances:
            return results, instances
        return results


def default_evaluator() -> Evaluator:
    """The standard metrics: semantic IoU; F1, precision and recall at IoU
    0.5 and 0.75; AP at 0.5; PQ."""
    from empanada_tpu_torch.eval import metrics as M

    return Evaluator(
        semantic_metrics={"iou": M.semantic_iou},
        instance_metrics={
            "f1_50": M.f1_50, "f1_75": M.f1_75,
            "precision_50": M.precision_50, "precision_75": M.precision_75,
            "recall_50": M.recall_50, "recall_75": M.recall_75,
            "ap_50": M.ap,
        },
        panoptic_metrics={"pq": M.panoptic_quality},
    )
