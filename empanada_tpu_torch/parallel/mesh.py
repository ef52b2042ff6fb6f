"""Worlds of processes, one per card, and the collectives the port's
parallel paths use (counterpart of ``empanada_tpu/parallel/mesh.py``).

The JAX package scales over a ``jax.sharding.Mesh``: one program, the batch
or row axis of its arrays sharded over the chips, collectives inserted by
XLA.  The port scales as the reference does (``empanada_napari/
multigpu.py``): one process per card in a ``torch.distributed`` world, NCCL
between cards and gloo on the CPU, each rank holding its part of the
batch or image and calling the collectives here itself.  A ``Mesh`` names
that world; without a process group it is a world of one, where every
collective is the identity and no communication happens.

gloo moves CPU tensors only in its point-to-point calls, and takes CUDA
tensors in its collectives by copying them through the host itself.  So on
a gloo group (the caller's choice, never a fallback: two ranks sharing one
card can use no NCCL) every collective here moves a CUDA tensor through a
host buffer and back, and the result lands on the tensor's own device.

``data_parallel(mesh)`` binds a world for the train step's data
parallelism: inside it, a train-mode ``models.blocks.BatchNorm`` takes its
statistics over the global batch, the losses of ``train/losses.py``
return this rank's share of the global batch's loss, and ``global_rand``
draws at the global batch's shape and keeps this rank's rows, so that a
world of n takes the step a world of one takes on the concatenated batch.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from empanada_tpu_torch.utils import resolve_device

__all__ = [
    "Mesh",
    "create_mesh",
    "create_mesh_grid",
    "data_sharding",
    "replicated",
    "pad_to_multiple",
    "all_gather",
    "all_reduce",
    "all_reduce_grad",
    "barrier",
    "exchange_neighbors",
    "data_parallel",
    "current_data_mesh",
    "global_rand",
]


@dataclass(frozen=True)
class Mesh:
    """A world of ``size`` ranks along one axis: the process group (None
    for the default group, or for a world of one without any), this
    rank's place in it, this rank's device, the backend ("nccl", "gloo",
    or "" for a world of one without a group) and the axis name."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    backend: str
    axis_name: str = "data"

    @property
    def distributed(self) -> bool:
        return self.size > 1

    def global_rank(self, rank: int) -> int:
        """The world rank of this axis's ``rank``."""
        return rank if self.group is None else dist.get_global_rank(self.group, rank)


def create_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
                device=None) -> Mesh:
    """The world of the default process group, or a world of one when none
    is initialised (``parallel.multihost.initialize_multihost``).
    ``n_devices`` must be None or the world's size: one process drives one
    card, so a mesh over fewer cards is a smaller world.  ``device`` is this
    rank's device by the entry-point rule (``utils.resolve_device``)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"a mesh of {n_devices} devices needs a world of {n_devices} "
                             "processes (initialize_multihost); none is initialised")
        return Mesh(None, 0, 1, dev, "", axis_name)
    size = dist.get_world_size()
    if n_devices not in (None, size):
        raise ValueError(f"n_devices={n_devices}: the world has {size} processes, one "
                         "card each")
    return Mesh(None, dist.get_rank(), size, dev, dist.get_backend(), axis_name)


def create_mesh_grid(shape, axis_names=("data", "spatial"), device=None) -> dict:
    """The world as a grid of ``shape`` = (rows, columns) ranks, rank = row
    * columns + column (the row-major device order of a 2-D JAX mesh):
    {axis name: this rank's ``Mesh`` along that axis}, the first along its
    column (the ranks of its column, one per row), the second along its
    row.  Every rank makes every group, in the same order."""
    dev = resolve_device(device)
    rows, cols = shape
    if not dist.is_initialized() or dist.get_world_size() != rows * cols:
        size = dist.get_world_size() if dist.is_initialized() else 1
        raise ValueError(f"a {rows} x {cols} grid needs a world of {rows * cols} processes, "
                         f"not {size}")
    row, col = divmod(dist.get_rank(), cols)
    row_groups = [dist.new_group([r * cols + c for c in range(cols)]) for r in range(rows)]
    col_groups = [dist.new_group([r * cols + c for r in range(rows)]) for c in range(cols)]
    backend = dist.get_backend()
    return {axis_names[0]: Mesh(col_groups[col], row, rows, dev, backend, axis_names[0]),
            axis_names[1]: Mesh(row_groups[row], col, cols, dev, backend, axis_names[1])}


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def data_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a global batch of ``n`` (which the world
    divides): rank r holds rows [r n / size, (r + 1) n / size), as a mesh
    axis shards axis 0."""
    if n % mesh.size:
        raise ValueError(f"a batch of {n} does not divide over {mesh.size} ranks")
    c = n // mesh.size
    return slice(mesh.rank * c, (mesh.rank + 1) * c)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as a flat uint8 view: collectives that
    only move data take every dtype so (neither NCCL nor gloo has int16)."""
    return t.reshape(-1).view(torch.uint8)


def replicated(mesh: Mesh, tensors):
    """Broadcast ``tensors`` (an iterable of contiguous tensors) from rank
    0 in place, so that every rank holds rank 0's values; returns them."""
    tensors = list(tensors)
    if mesh.distributed:
        for t in tensors:
            # detached: a parameter's storage is written, not its graph
            _via_host(mesh, _bytes(t.detach()), lambda h: dist.broadcast(
                h, mesh.global_rank(0), group=mesh.group))
    return tensors


def _host(mesh: Mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.device.type == "cuda"


def _via_host(mesh: Mesh, t: torch.Tensor, op) -> None:
    """Run the in-place collective ``op`` on ``t``, through a host copy
    on a gloo group when ``t`` lives on a card."""
    if _host(mesh, t):
        h = t.cpu()
        op(h)
        t.copy_(h)
    else:
        op(t)


def all_gather(t: torch.Tensor, mesh: Mesh) -> list:
    """Every rank's ``t`` (equal shapes and dtypes), in rank order, on
    ``t``'s device."""
    if not mesh.distributed:
        return [t]
    src = _bytes(t.contiguous())
    if _host(mesh, src):
        src = src.cpu()
    out = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(out, src, group=mesh.group)
    return [o.to(t.device).view(t.dtype).reshape(t.shape) for o in out]


def all_reduce(t: torch.Tensor, mesh: Mesh, op: str = "sum") -> torch.Tensor:
    """The sum ("sum"), mean ("mean") or maximum ("max") of ``t`` over the
    ranks, as a new tensor on ``t``'s device (no gradient)."""
    if op not in ("sum", "mean", "max"):
        raise ValueError(f"op {op!r}: expected 'sum', 'mean' or 'max'")
    out = t.detach().clone()
    if not mesh.distributed:
        return out
    red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    _via_host(mesh, out, lambda h: dist.all_reduce(h, red, group=mesh.group))
    return out / mesh.size if op == "mean" else out


def barrier(mesh: Mesh) -> None:
    if mesh.distributed:
        dist.barrier(group=mesh.group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward sums the incoming gradient over
    the ranks: rank r's input feeds every rank's share of the loss."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return all_reduce(t, mesh)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.mesh), None


def all_reduce_grad(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable all-reduce sum (the identity in a world of one)."""
    return _AllReduceSum.apply(t, mesh) if mesh.distributed else t


def exchange_neighbors(to_prev: torch.Tensor, to_next: torch.Tensor, mesh: Mesh):
    """Send ``to_prev`` to rank r - 1 and ``to_next`` to rank r + 1;
    returns (what rank r - 1 sent to its next, what rank r + 1 sent to its
    previous), zeros at the ends of the world (every rank's tensors of one
    kind have equal shapes).  NCCL pairs the calls in one
    ``batch_isend_irecv``; gloo sends host copies."""
    from_prev, from_next = torch.zeros_like(to_next), torch.zeros_like(to_prev)
    if not mesh.distributed:
        return from_prev, from_next
    r, n = mesh.rank, mesh.size
    host = _host(mesh, to_prev)
    bufs = [_bytes(x.contiguous()) for x in (to_prev, to_next, from_prev, from_next)]
    bufs = [x.cpu() if host else x for x in bufs]
    ops = []
    if r > 0:
        prev = mesh.global_rank(r - 1)
        ops += [dist.P2POp(dist.isend, bufs[0], prev, group=mesh.group),
                dist.P2POp(dist.irecv, bufs[2], prev, group=mesh.group)]
    if r < n - 1:
        nxt = mesh.global_rank(r + 1)
        ops += [dist.P2POp(dist.isend, bufs[1], nxt, group=mesh.group),
                dist.P2POp(dist.irecv, bufs[3], nxt, group=mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return (bufs[2].to(to_next.device).view(to_next.dtype).reshape(to_next.shape),
            bufs[3].to(to_prev.device).view(to_prev.dtype).reshape(to_prev.shape))


# ---- the train step's data parallelism -----------------------------------

_DATA = threading.local()


@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh]):
    """Bind ``mesh`` as the world of the batch axis (module docstring) in
    this thread; a world of one binds nothing."""
    prev = getattr(_DATA, "mesh", None)
    _DATA.mesh = mesh if mesh is not None and mesh.distributed else None
    try:
        yield
    finally:
        _DATA.mesh = prev


def current_data_mesh() -> Optional[Mesh]:
    """The world bound by ``data_parallel`` in this thread, or None."""
    return getattr(_DATA, "mesh", None)


def global_rand(shape, generator=None, device=None) -> torch.Tensor:
    """``torch.rand(shape)`` of this rank's rows: under ``data_parallel``
    the draw is at the global batch's shape (``shape[0]`` times the world)
    and rank r keeps its rows, so every rank's generator advances as a
    world of one's does on the concatenated batch."""
    mesh = current_data_mesh()
    if mesh is None:
        return torch.rand(shape, generator=generator, device=device)
    full = torch.rand((shape[0] * mesh.size, *shape[1:]), generator=generator, device=device)
    return full[data_sharding(mesh, full.shape[0])]
