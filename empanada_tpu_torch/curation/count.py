"""Label counting and its spreadsheet (counterpart of
``empanada_tpu/curation/count.py``)."""

from __future__ import annotations

import csv

import numpy as np

__all__ = ["count_labels", "save_label_lists"]


def count_labels(label_values: np.ndarray, label_divisor: int):
    """The nonzero label ids grouped by class (``id // label_divisor``; one
    class 1 when the divisor is 0): ``({class_id: [ids]}, [class_ids])``."""
    label_values = np.unique(np.asarray(label_values))
    label_values = label_values[label_values > 0]
    if label_divisor == 0:
        return {1: label_values.tolist()}, [1]
    class_ids = np.unique(label_values // label_divisor).tolist()
    label_queue = {}
    for ci in class_ids:
        ids = label_values[(label_values >= ci * label_divisor)
                           & (label_values < (ci + 1) * label_divisor)]
        label_queue[ci] = ids.tolist()
    return label_queue, class_ids


def save_label_lists(label_queues, class_names, file_path: str) -> str:
    """Write each class's ids as a CSV row (name, class id, count, ids...);
    returns the path written.  An ``.xlsx`` path becomes ``.csv``: the
    port writes no spreadsheet format (the JAX package writes xlsx when
    openpyxl is installed, CSV otherwise)."""
    rows = []
    for queue in label_queues:
        for class_id, ids in queue.items():
            rows.append([class_names.get(class_id, str(class_id)), class_id, len(ids)] + ids)
    if file_path.endswith(".xlsx"):
        file_path = file_path[:-5] + ".csv"
    with open(file_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["class_name", "class_id", "count", "label_ids..."])
        writer.writerows(rows)
    return file_path
