"""Data-parallel training (``TRAIN.multichip``) in gloo worlds of CPU
processes (tests/_torch_world.py): a world of n takes the step a world of
one takes on the concatenated batch, which is what the JAX package's
sharded step computes.

- float64, world 2 against world 1 on the concatenated batch, two steps of
  ``make_train_step`` with ASPP dropout and PointRend's random points from
  the seeded generator (drawn at the global shape), the global
  ``bootstrap_ce`` top-k, ``offset_l1``'s global weight sum and global
  batch statistics: losses, gradients, Adam's moments and running
  statistics within 1e-12 of each tensor's largest magnitude, the
  parameters within 1e-10 (Adam's first step divides a gradient by its
  own magnitude plus 1e-8, so an element whose gradient is near 1e-8
  turns a last-bit difference of the sums into ~6e-12 of its tensor's
  largest parameter: measured on this batch); every rank's model the same
  bit for bit; the same with ``remat``;
- float32, world 2 against JAX's step on a 2-device mesh (JAX's points fed
  in) on the batch of tests/test_torch_train.py's one-device step, one
  image a rank: the loss within 1e-5 relative, every gradient at rtol
  1e-4 with a floor of 1e-4 of its largest magnitude, the new statistics
  at 1e-5 (that test's tolerances).  On a batch of four at random init the
  float32 step is too ill-conditioned for them: JAX's own steps on one and
  on two devices differ there by 4 % of a gradient's largest entry;
- ``train.main`` with ``TRAIN.multichip`` at world 2: one checkpoint,
  every rank's parameters identical, and a run crashed after its first
  epoch's checkpoint and resumed bit-identical to a straight one.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import empanada_tpu.train as JT
from _torch_port import jax_init, one_torch_thread, port_model  # noqa: F401
from _torch_world import ddp_grads_rank, ddp_steps_rank, run_world, train_main_rank, train_steps
from empanada_tpu.parallel.mesh import create_mesh as jax_mesh
from test_torch_train import TRAIN_PR, _batch, _close, _tensors
from test_torch_train_loop import _config, blob_dir  # noqa: F401

ARCH = "PanopticDeepLabPR"
DDP_PR = dict(TRAIN_PR, aspp_dropout=0.5)
F64 = 1e-12
F64_PARAMS = 1e-10


def _close64(got, want, tol=F64):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-300))


@pytest.fixture(scope="module")
def f64_steps():
    _, variables = jax_init(ARCH, DDP_PR, size=64)
    state = port_model(ARCH, DDP_PR, variables).state_dict()
    batch = _batch(4, 64, seed=21)
    one = train_steps(ARCH, DDP_PR, state, batch, torch.float64, 2)
    ranks = run_world(ddp_steps_rank, 2, ARCH, DDP_PR, state, batch, torch.float64, 2,
                      [False, True])
    return one, ranks


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_f64_world_of_two_step_is_the_concatenated_step(f64_steps, remat):
    one, ranks = f64_steps
    for runs in ranks:
        got = runs[int(remat)]
        for ga, wa in zip(got["aux"], one["aux"]):
            assert sorted(ga) == sorted(wa)
            for k in wa:
                _close64(ga[k], wa[k])
        for name, g in one["grads"].items():
            _close64(got["grads"][name], g)
        for name, m in one["moments"].items():
            _close64(got["moments"][name], m)
        for name, v in one["state"].items():
            _close64(got["state"][name], v, F64_PARAMS if name in one["grads"] else F64)
    # the ranks hold the same model, bit for bit
    for name, v in ranks[0][0]["state"].items():
        assert torch.equal(ranks[1][0]["state"][name], v), name


def test_f32_world_of_two_grads_match_jax_mesh():
    model, variables = jax_init(ARCH, TRAIN_PR, size=64)
    batch = _batch(2, 64, seed=3)
    loss_fn = JT.PanopticLoss()
    mesh = jax_mesh(2)

    @jax.jit
    def step(params, batch_stats, batch):
        def compute(params):
            out, mutated = model.apply({"params": params, "batch_stats": batch_stats},
                                       batch["image"], train=True,
                                       rngs={"points": jax.random.key(11)},
                                       mutable=["batch_stats"])
            loss, _ = loss_fn(out, batch)
            return loss, (out["point_coords"], mutated["batch_stats"])
        return jax.value_and_grad(compute, has_aux=True)(params)

    shard, repl = NamedSharding(mesh, P("data")), NamedSharding(mesh, P())
    (loss, (coords, new_bs)), grads = step(
        jax.device_put(variables["params"], repl), jax.device_put(variables["batch_stats"], repl),
        {k: jax.device_put(jnp.asarray(v), shard) for k, v in batch.items()})
    tmodel = port_model(ARCH, TRAIN_PR, variables)
    want = _tensors(jax.tree.map(np.asarray, grads), tmodel, jax.tree.map(np.asarray, new_bs))
    ranks = run_world(ddp_grads_rank, 2, ARCH, TRAIN_PR, tmodel.state_dict(), batch,
                      np.asarray(coords))
    for got in ranks:
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
        for name, _ in tmodel.named_parameters():
            _close(got["grads"][name].numpy(), want[name].numpy(), 1e-4, 1e-4)
        for name, b in got["buffers"].items():
            _close(b.numpy(), want[name].numpy(), 1e-5, 1e-5)


def test_train_main_multichip_world_of_two(blob_dir, tmp_path):  # noqa: F811
    kw = dict(arch=ARCH, multichip=True)
    straight = _config(blob_dir, tmp_path / "a", 2, **kw)
    crashing = _config(blob_dir, tmp_path / "b", 2, **kw)
    r0, r1 = run_world(train_main_rank, 2, straight, crashing)
    assert sorted(os.listdir(tmp_path / "a")) == ["blobs_checkpoint.pt",
                                                  "blobs_checkpoint.pt.yaml"]
    # 12 images, a global batch of 4: 3 steps an epoch
    assert [run["step"] for run in r0] == [run["step"] for run in r1] == [6, 6]
    for a, b in zip(r0, r1):
        for name, v in a["state"].items():
            assert torch.equal(b["state"][name], v), name
    for name, v in r0[0]["state"].items():  # the resumed run is the straight one
        assert torch.equal(r0[1]["state"][name], v), name
