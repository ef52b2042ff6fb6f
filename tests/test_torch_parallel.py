"""The port's worlds of processes (``parallel/multihost.py``,
``parallel/mesh.py``), its data-parallel ``MultiChipEngine3d`` and the
command line's world flags, in gloo worlds of CPU processes
(tests/_torch_world.py), against the JAX package on a virtual mesh of the
same size (tests/conftest.py) and against the port's own world of one:

- ``initialize_multihost`` at world 2: rank and size, the collectives
  (sum, mean, max, gather, broadcast, the differentiable sum and its
  backward), a second call harmless; a no-op without a coordinator, a
  raise on a coordinator nobody serves and without a GPU;
- ``MultiChipEngine3d`` at world 2 on an 8 x 64 x 64 volume, median windows
  crossing ranks and batches (kernels 3 and 5, batches 4, 2 and the auto
  batch; packed rows past their capacity, dense maps): stacks and tracker
  instances equal JAX's on a 2-device mesh and
  the port's world of one, every rank the same; a resume of a world of
  one's checkpoint refused;
- ``infer3d --multichip`` and ``infer2d --spatial-shard`` with
  ``--coordinator`` in two processes: the volume equal to one process's,
  the map equal to JAX's ``Engine2d(spatial_shard=True)`` on 2 devices.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import yaml

from _torch_port import SMALL_PR, jax_init, one_torch_thread, port_model  # noqa: F401
from _torch_world import (
    cli_rank,
    engine3d,
    engine3d_rank,
    free_port,
    instances,
    multihost_rank,
    run_world,
)
from conftest import make_blob_image
from empanada_tpu import api as jax_api
from empanada_tpu.parallel.data_parallel import MultiChipEngine3d as JaxEngine3d
from empanada_tpu.parallel.mesh import create_mesh as jax_mesh
from empanada_tpu_torch import api
from empanada_tpu_torch.cli import main as port_main
from empanada_tpu_torch.parallel import initialize_multihost
from empanada_tpu_torch.parallel import data_parallel as dp
from empanada_tpu_torch.parallel.data_parallel import MultiChipEngine3d
from test_torch_checkpoint import _crashing

ARCH = "PanopticDeepLabPR"
CFG = {"class_names": {1: "mito"}, "labels": [1], "thing_list": [1], "model": "unused",
       "padding_factor": 16, "norms": {"mean": 0.57571, "std": 0.12765}}
ENGINE_KW = dict(min_size=10, min_extent=1, max_centers=64, confidence_thr=0.5,
                 save_panoptic=True)
# the last two: rows past a capacity of 5 runs send their slices' dense
# maps, gathered (2 of the 8 slices, one on each rank), and ids past 65535
# send every slice dense
RUNS = [dict(batch_size=4, median_kernel_size=3),
        dict(batch_size=2, median_kernel_size=5, volume_resident=False),
        dict(batch_size=None, median_kernel_size=3),
        dict(batch_size=4, median_kernel_size=3, max_runs=5),
        dict(batch_size=4, median_kernel_size=3, label_divisor=40000)]


def test_initialize_multihost_world_of_two():
    r0, r1 = run_world(multihost_rank, 2)
    for rank, got in enumerate((r0, r1)):
        assert got["again"] == (rank, 2)
        assert got["mesh"] == (rank, 2, "gloo", "cpu") and got["backend"] == "gloo"
        assert got["multihost"] and got["local"] == (rank, rank + 1)
        assert (got["sum"], got["mean"], got["max"]) == (3.0, 1.5, 2.0)
        assert got["gather"] == [0, 10] and got["rows"] == slice(4 * rank, 4 * rank + 4)
        assert got["replicated"] == 0.0
        # y = x_0 + x_1; rank r's loss (r + 1) sum(y): every x gets 1 + 2
        assert got["y"] == [3.0, 2.0] and got["grad"] == [3.0, 3.0]


def test_initialize_multihost_no_op_and_failures(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_multihost() == (0, 1) and not dist.is_initialized()
    with pytest.raises(ValueError, match="num_processes"):
        initialize_multihost("127.0.0.1:1234", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            initialize_multihost("127.0.0.1:1234", 2, 0)
    # rank 1 of a world whose rank 0 never serves the rendezvous
    with pytest.raises(RuntimeError):
        initialize_multihost(f"127.0.0.1:{free_port()}", 2, 1, device="cpu", timeout_s=2)
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """JAX's sweeps on a 2-device mesh, the port's world of one and world of
    two, and the world of two's attempt to resume a world of one's
    checkpoint."""
    model, variables = jax_init(ARCH, SMALL_PR, size=64)
    tmodel = port_model(ARCH, SMALL_PR, variables)
    vol = np.stack([make_blob_image((64, 64), n_blobs=5, seed=60 + i) for i in range(8)])
    want, one = [], []
    for run in RUNS:
        jrun = dict(run, volume_resident=False)
        if "max_runs" in jrun:
            jrun["max_runs_per_row"] = jrun.pop("max_runs")
        jeng = JaxEngine3d(CFG, model_and_variables=(model, variables), mesh=jax_mesh(2),
                           sweep_fused=False, **ENGINE_KW, **jrun)
        stack, trackers = jeng.infer_on_axis(vol, "xy")
        want.append((stack, instances(trackers), jeng.last_batch_size))
        teng = engine3d(MultiChipEngine3d, CFG, tmodel, ENGINE_KW, run)
        stack, trackers = teng.infer_on_axis(vol, "xy")
        one.append((stack, instances(trackers), teng.last_batch_size))

    # a world of one's sweep crashed after 6 slices, 4 of them checkpointed
    ckpt_dir = str(tmp_path_factory.mktemp("ckpt"))
    eng = MultiChipEngine3d(CFG, tmodel, device="cpu", batch_size=4, **ENGINE_KW)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dp, "MatcherWorker", _crashing(dp.MatcherWorker, 6))
        with pytest.raises(RuntimeError, match="simulated crash"):
            eng.infer_on_axis(vol, "xy", checkpoint_dir=ckpt_dir, checkpoint_every=4)
    assert os.listdir(ckpt_dir)
    ranks = run_world(engine3d_rank, 2, CFG, ARCH, SMALL_PR, tmodel.state_dict(), vol,
                      ENGINE_KW, RUNS, ckpt_dir)
    return want, one, ranks


def _assert_same(got, want):
    (gstack, ginst, gb), (wstack, winst, wb) = got, want
    assert gb == wb
    np.testing.assert_array_equal(gstack, wstack)
    assert [sorted(d) for d in ginst] == [sorted(d) for d in winst]
    for gd, wd in zip(ginst, winst):
        for k in wd:
            assert gd[k][0] == wd[k][0], k
            np.testing.assert_array_equal(gd[k][1], wd[k][1])
            np.testing.assert_array_equal(gd[k][2], wd[k][2])


@pytest.mark.parametrize("run", range(len(RUNS)), ids=["b4-k3", "b2-k5-host", "auto-k3",
                                                       "row-overflow", "dense"])
def test_world_of_two_sweep_matches_jax_and_world_of_one(sweeps, run):
    want, one, ranks = sweeps
    assert sum(len(d) for d in want[run][1]) >= 2  # instances, not a blank sweep
    for sweeps_of_rank, _ in ranks:
        _assert_same(sweeps_of_rank[run], want[run])
        _assert_same(sweeps_of_rank[run], one[run])


def test_resume_on_another_world_is_refused(sweeps):
    for _, refused in sweeps[2]:
        assert refused is not None and "n_dev" in refused and "(1, 2)" in refused


def test_cli_world_flags_in_two_processes(tmp_path):
    model, variables = jax_init(ARCH, SMALL_PR, size=64)
    bundle = api.save_model_bundle(str(tmp_path / "bundle"), ARCH, SMALL_PR,
                                   port_model(ARCH, SMALL_PR, variables))
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(yaml.dump(dict(CFG, model=bundle)))
    vol = np.stack([make_blob_image((64, 64), n_blobs=5, seed=80 + i) for i in range(8)])
    img = make_blob_image((150, 173), n_blobs=6, seed=3)
    np.save(tmp_path / "vol.npy", vol)
    np.save(tmp_path / "img.npy", img)

    def argvs(out):
        os.makedirs(out, exist_ok=True)
        return [["infer3d", str(tmp_path / "vol.npy"), "-o", f"{out}/seg_{{class}}.npy",
                 "--model", str(cfg_path), "--multichip", "--batch-size", "4",
                 "--min-size", "10", "--min-extent", "1"],
                ["infer2d", str(tmp_path / "img.npy"), "-o", f"{out}/pan.npy", "--model",
                 str(cfg_path), "--spatial-shard", "--spatial-halo", "32"]]

    home = str(tmp_path / "home")
    assert run_world(cli_rank, 2, free_port(), home, argvs(str(tmp_path / "world")),
                     init=False) == [0, 1]
    for argv in argvs(str(tmp_path / "one"))[:1]:
        port_main(argv + ["--device", "cpu"])
    seg = np.load(tmp_path / "world" / "seg_mito.npy")
    np.testing.assert_array_equal(seg, np.load(tmp_path / "one" / "seg_mito.npy"))
    assert seg.shape == vol.shape and seg.max() > 0
    # the CLI's defaults through JAX's engine on a 2-device mesh
    want = jax_api.Engine2d(
        dict(CFG, model=bundle), label_divisor=10000, nms_threshold=0.1, nms_kernel=3,
        confidence_thr=0.3, spatial_shard=True, spatial_halo=32,
        spatial_mesh=jax_mesh(2, axis_name="spatial"),
        model_and_variables=(model, variables)).infer(img)
    got = np.load(tmp_path / "world" / "pan.npy")
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 2
