"""Array slicing helper (counterpart of ``empanada_tpu/core/masks.py``)."""

from __future__ import annotations

__all__ = ["take"]


def take(array, indices, axis: int = 0):
    """Slice ``array`` at ``indices`` along ``axis`` (works on any array-like
    that supports numpy-style tuple indexing, e.g. chunked stores)."""
    sel = tuple(slice(None) if n != axis else indices for n in range(array.ndim))
    return array[sel]
