"""Training metrics (counterpart of ``empanada_tpu/train/metrics.py``):
meters, per-class IoU, panoptic quality (SQ * RQ through Hungarian
matching), instance F1 and the ComposeMetrics aggregator, on numpy
arrays (channel-last logits)."""

from __future__ import annotations

import numpy as np

from empanada_tpu_torch.stitch.matcher import fast_matcher

__all__ = ["EMAMeter", "AverageMeter", "IoU", "PQ", "F1", "ComposeMetrics",
           "METRIC_REGISTRY", "create_metric"]


class EMAMeter:
    """Bias-corrected exponential moving average."""

    def __init__(self, momentum: float = 0.98):
        self.mom = momentum
        self.reset()

    def reset(self):
        self.val = 0
        self.avg = 0
        self.sum = 0
        self.count = 0

    def update(self, val):
        self.val = val
        self.sum = (self.sum * self.mom) + (val * (1 - self.mom))
        self.count += 1
        self.avg = self.sum / (1 - self.mom ** self.count)


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0
        self.avg = 0
        self.sum = 0
        self.count = 0

    def update(self, val):
        self.val = val
        self.sum = self.sum + val
        self.count += 1
        self.avg = self.sum / self.count


class _BaseMetric:
    def __init__(self, meter, labels):
        self.meters = {l: meter() for l in labels}
        self.labels = labels

    def update(self, value_dict):
        for l, v in value_dict.items():
            self.meters[l].update(v)

    def reset(self):
        for l in self.labels:
            self.meters[l].reset()

    def average(self):
        return {l: meter.avg for l, meter in self.meters.items()}


class IoU(_BaseMetric):
    """Per-class IoU between logits and integer targets.

    Output logits are channel-last (N, H, W, C)."""

    def __init__(self, meter, labels, output_key="sem_logits", target_key="sem", **kwargs):
        super().__init__(meter, labels)
        self.output_key = output_key
        self.target_key = target_key

    def calculate(self, output, target):
        logits = np.asarray(output[self.output_key])
        tgt = np.asarray(target[self.target_key])
        n_classes = logits.shape[-1]

        if n_classes > 1:
            pred = np.argmax(logits, axis=-1)
            per_class = {}
            for l in self.labels:
                p = pred == l
                t = tgt == l
                inter = np.logical_and(p, t).sum()
                union = p.sum() + t.sum() - inter
                per_class[l] = float((inter + 1e-5) / (union + 1e-5))
            return per_class

        pred = logits[..., 0] > 0  # sigmoid(x) > 0.5 <=> x > 0
        t = tgt > 0
        inter = np.logical_and(pred, t).sum()
        union = pred.sum() + t.sum() - inter
        return {self.labels[0]: float((inter + 1e-5) / (union + 1e-5))}


class _PanSegMetric(_BaseMetric):
    def __init__(self, meter, labels, label_divisor, iou_thr=0.5,
                 output_key="pan_seg", target_key="pan_seg", **kwargs):
        super().__init__(meter, labels)
        self.label_divisor = label_divisor
        self.iou_thr = iou_thr
        self.output_key = output_key
        self.target_key = target_key

    def _to_class_seg(self, pan_seg, label):
        seg = np.copy(pan_seg)
        min_id = label * self.label_divisor
        max_id = min_id + self.label_divisor
        seg[(seg < min_id) | (seg >= max_id)] = 0
        return seg

    def _counts(self, output, target, label):
        pred = self._to_class_seg(output, label)
        tgt = self._to_class_seg(target, label)
        matched_labels, all_labels, matched_ious = fast_matcher(
            tgt, pred, iou_thr=self.iou_thr
        )
        tp = len(matched_labels[0])
        fn = len(np.setdiff1d(all_labels[0], matched_labels[0]))
        fp = len(np.setdiff1d(all_labels[1], matched_labels[1]))
        return tp, fp, fn, matched_ious


class PQ(_PanSegMetric):
    """Panoptic quality = SQ * RQ at an IoU threshold (default 0.5)."""

    def calculate(self, output, target):
        out = np.asarray(output[self.output_key]).squeeze().astype(np.int64)
        tgt = np.asarray(target[self.target_key]).squeeze().astype(np.int64)
        per_class = {}
        for label in self.labels:
            tp, fp, fn, matched_ious = self._counts(out, tgt, label)
            if tp + fp + fn == 0:
                per_class[label] = 1.0
                continue
            sq = matched_ious.sum() / (tp + 1e-5)
            rq = tp / (tp + 0.5 * fp + 0.5 * fn)
            per_class[label] = float(sq * rq)
        return per_class


class F1(_PanSegMetric):
    """Instance detection F1 at an IoU threshold."""

    def calculate(self, output, target):
        out = np.asarray(output[self.output_key]).squeeze().astype(np.int64)
        tgt = np.asarray(target[self.target_key]).squeeze().astype(np.int64)
        per_class = {}
        for label in self.labels:
            tp, fp, fn, _ = self._counts(out, tgt, label)
            if tp + fp + fn == 0:
                per_class[label] = 1.0
            else:
                per_class[label] = float(tp / (tp + 0.5 * fn + 0.5 * fp))
        return per_class


class ComposeMetrics:
    """Evaluate, print and keep the history of several metrics."""

    def __init__(self, metrics_dict, class_names, reset_on_print=True):
        self.metrics_dict = metrics_dict
        self.class_names = class_names
        self.reset_on_print = reset_on_print
        self.history = {}

    def evaluate(self, output, target):
        for metric in self.metrics_dict.values():
            metric.update(metric.calculate(output, target))

    def display(self):
        print_rows = []
        for metric_name, metric in self.metrics_dict.items():
            for l, v in metric.average().items():
                name = f"{self.class_names[l]}_{metric_name}"
                print_rows.append((name, float(v)))
            if self.reset_on_print:
                metric.reset()
        for name, value in print_rows:
            self.history.setdefault(name, []).append(value)
            print(name, value)


METRIC_REGISTRY = {"IoU": IoU, "PQ": PQ, "F1": F1}


def create_metric(spec: dict, meter, class_labels):
    """A metric from a config spec: {"metric": name, "name": ..., kwargs}."""
    spec = dict(spec)
    name = spec.pop("metric")
    spec.pop("name", None)
    labels = spec.pop("labels", None) or class_labels
    return METRIC_REGISTRY[name](meter, labels, **spec)
