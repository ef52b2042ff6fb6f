"""Offline evaluation of RLE-JSON tracker dumps (counterpart of
``empanada_tpu/eval``)."""

from empanada_tpu_torch.eval.evaluator import Evaluator, default_evaluator
from empanada_tpu_torch.eval.metrics import (
    ap,
    f1,
    f1_50,
    f1_75,
    panoptic_quality,
    precision,
    precision_50,
    precision_75,
    recall,
    recall_50,
    recall_75,
    semantic_iou,
)

__all__ = [
    "Evaluator", "default_evaluator", "ap", "f1", "f1_50", "f1_75",
    "panoptic_quality", "precision", "precision_50", "precision_75",
    "recall", "recall_50", "recall_75", "semantic_iou",
]
