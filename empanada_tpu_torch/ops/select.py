"""Order statistics for the PointRend render (counterpart of
``empanada_tpu/ops/select.py``).

The JAX package radix-selects the K-th value because a TPU ``top_k`` is a
full sort.  Here ``torch.kthvalue`` gives the exact K-th value and
``torch.topk`` the indices, for any sign and dtype.  The JAX package's
single-operand packed top-k assumes non-positive bf16 input; nothing here
carries that precondition.
"""

from __future__ import annotations

import torch

__all__ = ["kth_largest", "kth_smallest_nonneg", "top_k_indices", "top_k_mask_indices"]


def kth_largest(x: torch.Tensor, k: int) -> torch.Tensor:
    """Exact k-th largest value per row of ``x`` (n, m), as float32; k is
    1-indexed and ``k >= m`` returns the row minimum."""
    x = x.float()
    m = x.shape[1]
    if k >= m:
        return x.amin(dim=1)
    return torch.kthvalue(x, m - k + 1, dim=1).values


def kth_smallest_nonneg(x: torch.Tensor, k: int) -> torch.Tensor:
    """Exact k-th smallest value per row of ``x`` (n, m), as float32; k is
    1-indexed and ``k >= m`` returns the row maximum.  Exact for any sign;
    the name keeps the JAX counterpart's."""
    x = x.float()
    m = x.shape[1]
    if k >= m:
        return x.amax(dim=1)
    return torch.kthvalue(x, k, dim=1).values


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries per row (n, m); which of several
    equal values at the k-th place are taken is unspecified, as for the
    JAX package (PARITY.md "Known divergences" 2)."""
    return torch.topk(x, min(k, x.shape[1]), dim=1).indices


def top_k_mask_indices(x: torch.Tensor, k: int, block: int = 128) -> torch.Tensor:
    """(n, k) int32 indices of the k largest entries per row of ``x``
    (n, m), as the JAX package's sort-free form orders them: the entries
    above the exact k-th value in ascending position, then entries equal
    to it, ascending, filling the remaining slots.  ``k >= m`` gives
    0..m-1 padded with zeros.  ``block`` is the JAX form's compaction
    block, kept for its signature: ``m`` must be a multiple of it."""
    n, m = x.shape
    if k >= m:
        base = torch.arange(m, dtype=torch.int32, device=x.device).expand(n, m)
        return torch.cat([base, base.new_zeros((n, k - m))], dim=1)
    if m % block:
        raise ValueError(f"row length {m} is not a multiple of block {block}")
    xf = x.float()
    kth = kth_largest(xf, k)[:, None]
    rank = torch.where(xf > kth, 0, torch.where(xf == kth, 1, 2))
    order = torch.sort(rank, dim=1, stable=True).indices[:, :k]
    return order.to(torch.int32)
