"""Spawned ``torch.distributed`` worlds on the CPU for the port's parallel
tests (tests/test_torch_{parallel,spatial,ddp}.py): ``run_world(fn, n,
*args)`` starts n processes (spawn), joins them into a gloo world of n
ranks through ``parallel.multihost.initialize_multihost`` (unless
``init=False``, for code that joins the world itself), calls ``fn(rank, n,
*args)`` in each and returns every rank's result.  A rank that raises or
hangs fails the call with its traceback.  The functions the ranks run are
below, in this module, which imports torch and the port only: a spawned
rank imports neither JAX nor a test module."""

import os
import socket
import tempfile
import traceback

import torch
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, outdir, fn, args, init):
    import torch.distributed as dist

    from empanada_tpu_torch.parallel.multihost import initialize_multihost

    torch.set_num_threads(1)
    try:
        if init:
            initialize_multihost(f"127.0.0.1:{port}", world, rank, device="cpu",
                                 timeout_s=120)
        result = fn(rank, world, *args)
        torch.save(result, os.path.join(outdir, f"{rank}.pt"))
    except BaseException:
        with open(os.path.join(outdir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn, world: int, *args, init: bool = True, timeout: float = 300.0) -> list:
    """Every rank's ``fn(rank, world, *args)`` (with ``init=False`` the
    rendezvous port is ``args``' first element, which the caller gets from
    ``free_port``)."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as outdir:
        port = free_port() if init else None
        procs = [ctx.Process(target=_entry, args=(r, world, port, outdir, fn, args, init))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errors = {}
        for r in range(world):
            path = os.path.join(outdir, f"{r}.err")
            if os.path.exists(path):
                errors[r] = open(path).read()
        if hung or errors or any(p.exitcode for p in procs):
            raise AssertionError(f"world of {world}: ranks {hung} hung, exit codes "
                                 f"{[p.exitcode for p in procs]}, errors:\n"
                                 + "\n".join(f"rank {r}:\n{e}" for r, e in errors.items()))
        return [torch.load(os.path.join(outdir, f"{r}.pt"), weights_only=False)
                for r in range(world)]


# ---- what the ranks run ------------------------------------------------------


def port_model_from(arch, kw, state, dtype=torch.float32):
    """The port's model on the CPU with ``state`` (a state dict) loaded."""
    from empanada_tpu_torch.models import create_model

    model = create_model(arch, device="cpu", **kw)
    model.load_state_dict(state)
    return model.to(dtype)


def spatial_rank(rank, world, arch, kw, state, image, halo, engine_cases, grid=None):
    """``spatial_sharded_forward`` of ``image`` (numpy outputs), then per
    engine case (kind, kwargs, uint8 or normalised image) the panoptic map
    of ``SpatialEngine2d`` ("spatial") or ``Engine2d(spatial_shard=True)``
    ("engine2d"); with ``grid`` = (shape, image), also the forward over
    the world as a data x spatial grid (or None)."""
    from empanada_tpu_torch.api import Engine2d
    from empanada_tpu_torch.parallel.mesh import create_mesh, create_mesh_grid
    from empanada_tpu_torch.parallel.spatial import SpatialEngine2d, spatial_sharded_forward

    model = port_model_from(arch, kw, state)
    mesh = create_mesh(axis_name="spatial", device="cpu")
    out = spatial_sharded_forward(model, torch.from_numpy(image), mesh, halo)
    maps = []
    for kind, ekw, img in engine_cases:
        if kind == "spatial":
            maps.append(SpatialEngine2d(model, device="cpu", **ekw)(img))
        else:
            maps.append(Engine2d(model=model, device="cpu", spatial_shard=True, **ekw).infer(img))
    grid_out = None
    if grid is not None:
        axes = create_mesh_grid(grid[0], device="cpu")
        grid_out = spatial_sharded_forward(model, torch.from_numpy(grid[1]), axes["spatial"],
                                           halo, data_mesh=axes["data"])
        grid_out = {k: v.numpy() for k, v in grid_out.items()}
    return {k: v.numpy() for k, v in out.items()}, maps, grid_out


def multihost_rank(rank, world):
    """The world as the ranks see it, a collective of each kind, and a
    second initialisation (which returns the world that exists)."""
    import torch.distributed as dist

    from empanada_tpu_torch.parallel import initialize_multihost, is_multihost
    from empanada_tpu_torch.parallel.mesh import (
        all_gather,
        all_reduce,
        all_reduce_grad,
        create_mesh,
        data_sharding,
        replicated,
    )
    from empanada_tpu_torch.parallel.multihost import local_device_slice

    mesh = create_mesh(device="cpu")
    x = torch.tensor([rank + 1.0, 2.0 * rank], requires_grad=True)
    y = all_reduce_grad(x, mesh)
    (y * (rank + 1)).sum().backward()  # d/dx of sum_r (r + 1) sum(y)
    return dict(
        again=initialize_multihost("127.0.0.1:1", 99, 0, device="cpu"),
        mesh=(mesh.rank, mesh.size, mesh.backend, str(mesh.device)),
        backend=dist.get_backend(), multihost=is_multihost(), local=local_device_slice(),
        sum=all_reduce(torch.tensor([rank + 1.0]), mesh).item(),
        mean=all_reduce(torch.tensor([rank + 1.0]), mesh, "mean").item(),
        max=all_reduce(torch.tensor([rank + 1.0]), mesh, "max").item(),
        gather=[int(t) for t in all_gather(torch.tensor(rank * 10), mesh)],
        rows=data_sharding(mesh, 8),
        replicated=replicated(mesh, [torch.tensor([float(rank)])])[0].item(),
        y=y.detach().tolist(), grad=x.grad.tolist())


def engine3d_rank(rank, world, cfg, arch, kw, state, vol, engine_kw, runs, ckpt_dir):
    """Per run (kwargs) the world's ``MultiChipEngine3d`` xy sweep:
    (stack, instances, last_batch_size); then a resume from ``ckpt_dir``
    (a world of one's partial sweep): the error it raises."""
    from empanada_tpu_torch.parallel.data_parallel import MultiChipEngine3d

    model = port_model_from(arch, kw, state)
    out = []
    for run in runs:
        eng = engine3d(MultiChipEngine3d, cfg, model, engine_kw, run)
        stack, trackers = eng.infer_on_axis(vol, "xy")
        out.append((stack, instances(trackers), eng.last_batch_size))
    eng = MultiChipEngine3d(cfg, model, device="cpu", batch_size=4, **engine_kw)
    try:
        eng.infer_on_axis(vol, "xy", checkpoint_dir=ckpt_dir, resume=True)
        refused = None
    except ValueError as e:  # the expected refusal, returned to the test
        refused = str(e)
    return out, refused


def engine3d(cls, cfg, model, engine_kw, run):
    """``cls(cfg, model, ...)`` on the CPU with ``run``'s kwargs; a
    ``max_runs`` entry patches the packed rows' capacity (the JAX engine's
    ``max_runs_per_row``)."""
    run = dict(run)
    max_runs = run.pop("max_runs", None)
    eng = cls(cfg, model, device="cpu", **engine_kw, **run)
    if max_runs is not None:
        eng._max_runs = lambda width: max_runs
    return eng


def instances(trackers):
    """Tracker instances as plain data: per tracker {id: (box, starts, runs)}."""
    import numpy as np

    return [{int(k): (tuple(int(b) for b in v["box"]), np.asarray(v["starts"]),
                      np.asarray(v["runs"])) for k, v in t.instances.items()}
            for t in trackers]


def cli_rank(rank, world, port, home, argvs):
    """``cli.main`` of each argv with this rank's world flags, the
    registry under ``home``."""
    from empanada_tpu_torch.api import utils as api_utils
    from empanada_tpu_torch.cli import main

    api_utils.MODEL_DIR = home
    for argv in argvs:
        main(argv + ["--device", "cpu", "--coordinator", f"127.0.0.1:{port}",
                     "--num-processes", str(world), "--process-id", str(rank)])
    return rank


def train_steps(arch, kw, state, batch, dtype, n_steps, remat=False, mesh=None):
    """``n_steps`` of ``make_train_step`` (no autocast, dropout and
    PointRend's points from a seeded generator) on ``batch`` (numpy): each
    step's aux, the last step's gradients, the model's state and Adam's
    moments after."""
    from empanada_tpu_torch import train as T

    model = port_model_from(arch, kw, state, dtype)
    st = T.create_train_state(model, T.onecycle_schedule(1e-3, 10), 0.1, seed=3)
    step = T.make_train_step(T.PanopticLoss(), remat=remat, amp=False, mesh=mesh)
    tensors = {k: torch.from_numpy(v).to(dtype) if v.dtype.kind == "f" else torch.from_numpy(v)
               for k, v in batch.items()}
    aux = [{k: float(v) for k, v in step(st, tensors).items()} for _ in range(n_steps)]
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    moments = {f"{n}.{k}": st.optimizer.state[p][k].clone() for n, p in model.named_parameters()
               for k in ("exp_avg", "exp_avg_sq")}
    return dict(aux=aux, grads=grads, moments=moments,
                state={k: v.clone() for k, v in model.state_dict().items()})


def ddp_steps_rank(rank, world, arch, kw, state, batch, dtype, n_steps, remat_cases):
    """``train_steps`` of this rank's rows of the global ``batch`` in the
    world, once per entry of ``remat_cases``."""
    from empanada_tpu_torch.parallel.mesh import create_mesh, data_sharding

    mesh = create_mesh(device="cpu")
    rows = data_sharding(mesh, batch["image"].shape[0])
    local = {k: v[rows] for k, v in batch.items()}
    return [train_steps(arch, kw, state, local, dtype, n_steps, remat, mesh)
            for remat in remat_cases]


def ddp_grads_rank(rank, world, arch, kw, state, batch, coords):
    """One data-parallel forward and backward with the given PointRend
    points (this rank's rows of them): the global loss, the summed
    gradients and the new batch statistics."""
    from empanada_tpu_torch import train as T
    from empanada_tpu_torch.parallel.mesh import all_reduce, create_mesh, data_parallel
    from empanada_tpu_torch.parallel.mesh import data_sharding

    mesh = create_mesh(device="cpu")
    rows = data_sharding(mesh, batch["image"].shape[0])
    local = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
    model = port_model_from(arch, kw, state)
    with data_parallel(mesh):
        out = model(local["image"], train=True, point_coords=torch.from_numpy(coords[rows]))
        loss, _ = T.PanopticLoss()(out, local)
    loss.backward()
    return dict(loss=float(all_reduce(loss, mesh)),
                grads={n: all_reduce(p.grad, mesh) for n, p in model.named_parameters()},
                buffers={n: b.clone() for n, b in model.named_buffers()})


class _Crash(Exception):
    pass


def train_main_rank(rank, world, straight, crashing):
    """``train.main`` of ``straight``; then of ``crashing``, which stops
    right after its first epoch's checkpoint, resumed: each run's state
    and step count."""
    from empanada_tpu_torch import train as T
    from empanada_tpu_torch.train import loop

    def run(cfg):
        model, st = T.main(cfg, device="cpu")
        return dict(state={k: v.clone() for k, v in model.state_dict().items()}, step=st.step)

    out = [run(straight)]
    save = loop.save_checkpoint

    def save_then_crash(*args, **kwargs):
        save(*args, **kwargs)
        raise _Crash

    loop.save_checkpoint = save_then_crash
    try:
        T.main(crashing, device="cpu")
    except _Crash:  # the crash this run is made of
        pass
    finally:
        loop.save_checkpoint = save
    out.append(run(dict(crashing, TRAIN=dict(crashing["TRAIN"], resume=True))))
    return out
