"""The port's halo-sharded slice (``parallel/spatial.py``) in gloo worlds of
CPU processes against the JAX package's on a virtual mesh of the same
size (tests/conftest.py), same weights (the flax tree carried over by the
weight bridge), float32:

- ``exchange_halo_rows`` at worlds of 1, 2 and 4 equals JAX's exactly;
- ``spatial_sharded_forward`` of a small PanopticDeepLab (resnet18,
  decoder 32) at world 4 on 512 x 256 equals JAX's on a 4-device mesh
  within 1e-5 of each output's largest magnitude, and is closer to the
  unsharded forward than four independent tiles (JAX's seam rule); the
  same world as a 2 x 2 data x spatial grid on two 512 x 128 images equals
  JAX's on a (2, 2) mesh with ``data_axis``;
- ``SpatialEngine2d`` and ``Engine2d(spatial_shard=True)`` maps of a small
  PanopticDeepLabPR at world 2 equal JAX's, every rank the same map (the
  random-weight inputs hold no PointRend top-k or Hungarian ties, PARITY
  "Known divergences" 2 and 8); ``Engine2d(spatial_shard=True,
  inference_scale=2)`` of the PanopticDeepLab at world 4 equals JAX's (the
  logits resized to the target); of the PointRend model at world 2 it
  gives the image's map on every rank, where JAX's crop divides by zero
  (ROADMAP C9, pinned beside it).

A world of n is held to JAX's n-device mesh, not to the unsharded forward:
the sharded function depends on the shard count (halo truncation, zero
rows at the ends, align-corners grids per block)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from _torch_port import SMALL_PR, jax_init, one_torch_thread, port_model  # noqa: F401
from _torch_world import run_world, spatial_rank
from conftest import make_blob_image
from empanada_tpu import api as jax_api
from empanada_tpu.parallel.mesh import create_mesh as jax_mesh
from empanada_tpu.parallel.spatial import SpatialEngine2d as JaxSpatialEngine2d
from empanada_tpu.parallel.spatial import exchange_halo_rows as jax_exchange
from empanada_tpu.parallel.spatial import spatial_sharded_forward as jax_sharded
from empanada_tpu_torch.parallel.mesh import create_mesh
from empanada_tpu_torch.parallel.spatial import exchange_halo_rows

PDL = dict(encoder="resnet18", num_classes=1, decoder_channels=32, low_level_stages=[1],
           low_level_channels_project=[16], ins_decoder=False)
CFG = {"class_names": {1: "mito"}, "labels": [1], "thing_list": [1], "model": "unused",
       "padding_factor": 16, "norms": {"mean": 0.57571, "std": 0.12765}}
TOL = 1e-5


def _exchange_rank(rank, world, x, halo):
    rows = x.shape[1] // world
    block = torch.from_numpy(x[:, rank * rows:(rank + 1) * rows])
    return exchange_halo_rows(block, halo, create_mesh(device="cpu")).numpy()


def _jax_exchange(x, world, halo):
    mesh = jax_mesh(world, axis_name="spatial")
    fn = shard_map(lambda b: jax_exchange(b, halo, "spatial"), mesh=mesh,
                   in_specs=P(None, "spatial"), out_specs=P(None, "spatial"), check_vma=False)
    out = np.asarray(fn(jnp.asarray(x)))
    rows = x.shape[1] // world + 2 * halo
    return [out[:, r * rows:(r + 1) * rows] for r in range(world)]


@pytest.mark.parametrize("world", [1, 2, 4])
def test_exchange_halo_rows_matches_jax(world):
    x = np.random.default_rng(world).normal(size=(2, 32, 5, 3)).astype(np.float32)
    want = _jax_exchange(x, world, 4)
    got = (run_world(_exchange_rank, world, x, 4) if world > 1
           else [_exchange_rank(0, 1, x, 4)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def worlds():
    """JAX's outputs and maps, and the port's from one world of 4 (the
    forward) and one of 2 (the engines)."""
    pdl, pdl_vars = jax_init("PanopticDeepLab", PDL, size=64)
    pr, pr_vars = jax_init("PanopticDeepLabPR", SMALL_PR, size=64)
    x = np.random.default_rng(0).normal(0, 1, (1, 512, 256, 1)).astype(np.float32)
    halo = 128
    want = jax.jit(lambda v, im: jax_sharded(pdl, v, im, jax_mesh(4, axis_name="spatial"),
                                             halo=halo))(pdl_vars, jnp.asarray(x))
    plain = jax.jit(pdl.apply, static_argnames=("train",))
    full = np.asarray(plain(pdl_vars, jnp.asarray(x), train=False)["sem_logits"])
    tiles = np.concatenate([np.asarray(plain(pdl_vars, jnp.asarray(x[:, i * 128:(i + 1) * 128]),
                                             train=False)["sem_logits"]) for i in range(4)], 1)
    state = port_model("PanopticDeepLab", PDL, pdl_vars).state_dict()
    img = make_blob_image((150, 173), n_blobs=6, seed=3)
    s2kw = dict(confidence_thr=0.5, max_centers=64, spatial_halo=32, inference_scale=2)
    jax_scale2 = jax_api.Engine2d(CFG, spatial_shard=True, spatial_mesh=jax_mesh(4, "spatial"),
                                  model_and_variables=(pdl, pdl_vars), **s2kw).infer(img)
    x2 = np.random.default_rng(3).normal(0, 1, (2, 512, 128, 1)).astype(np.float32)
    grid_mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "spatial"))
    want_grid = jax.jit(lambda v, im: jax_sharded(pdl, v, im, grid_mesh, halo=halo,
                                                  data_axis="data"))(pdl_vars, jnp.asarray(x2))
    (got, (scale2,), grid), *rest = run_world(
        spatial_rank, 4, "PanopticDeepLab", PDL, state, x, halo,
        [("engine2d", dict(model_config=CFG, **s2kw), img)], ((2, 2), x2))
    for other, (other_scale2,), other_grid in rest:  # every rank holds the outputs
        for k in got:
            np.testing.assert_array_equal(other[k], got[k])
            np.testing.assert_array_equal(other_grid[k], grid[k])
        np.testing.assert_array_equal(other_scale2, scale2)

    # the engines at world 2: a normalised 150 x 173 slice (rows padded to
    # 160, 80 a block) and a uint8 image through Engine2d
    mesh2 = jax_mesh(2, axis_name="spatial")
    ekw = dict(thing_list=[1], halo=32, padding_factor=16, max_centers=64,
               confidence_thr=0.5, nms_kernel=7)
    norm = np.random.default_rng(2).normal(0.5, 0.3, (150, 173)).astype(np.float32)
    e2kw = dict(confidence_thr=0.5, max_centers=64, spatial_halo=32)
    jax_maps = [JaxSpatialEngine2d(pr, pr_vars, mesh=mesh2, **ekw)(norm),
                jax_api.Engine2d(CFG, spatial_shard=True, spatial_mesh=mesh2,
                                 model_and_variables=(pr, pr_vars), **e2kw).infer(img)]
    pr_state = port_model("PanopticDeepLabPR", SMALL_PR, pr_vars).state_dict()
    cases = [("spatial", ekw, norm), ("engine2d", dict(model_config=CFG, **e2kw), img),
             ("engine2d", dict(model_config=CFG, inference_scale=2, **e2kw), img)]
    ranks = run_world(spatial_rank, 2, "PanopticDeepLabPR", SMALL_PR, pr_state,
                      x[:, :128, :128], 32, cases)
    with pytest.raises(ZeroDivisionError):  # C9: JAX's crop of the rendered logits
        jax_api.Engine2d(CFG, spatial_shard=True, spatial_mesh=mesh2, inference_scale=2,
                         model_and_variables=(pr, pr_vars), **e2kw).infer(img)
    return dict(want={k: np.asarray(v) for k, v in want.items()}, got=got, full=full,
                tiles=tiles, jax_maps=jax_maps, rank_maps=[maps for _, maps, _ in ranks],
                img=img, scale2=scale2, jax_scale2=np.asarray(jax_scale2), grid=grid,
                want_grid={k: np.asarray(v) for k, v in want_grid.items()})


@pytest.mark.parametrize("grid", [False, True], ids=["rows", "data-x-rows"])
@pytest.mark.parametrize("key", ["sem_logits", "ctr_hmp", "offsets"])
def test_sharded_forward_matches_jax(worlds, key, grid):
    got, want = ((worlds["grid"][key], worlds["want_grid"][key]) if grid
                 else (worlds["got"][key], worlds["want"][key]))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


def test_sharded_forward_is_closer_than_tiles(worlds):
    err_shard = np.abs(worlds["got"]["sem_logits"] - worlds["full"]).mean()
    err_tiles = np.abs(worlds["tiles"] - worlds["full"]).mean()
    assert err_shard < 0.5 * err_tiles, (err_shard, err_tiles)


@pytest.mark.parametrize("case", ["spatial_engine", "engine2d"])
def test_engine_maps_match_jax(worlds, case):
    i = ["spatial_engine", "engine2d"].index(case)
    want = np.asarray(worlds["jax_maps"][i])
    for maps in worlds["rank_maps"]:
        assert maps[i].shape == want.shape
        np.testing.assert_array_equal(maps[i], want)
    assert len(np.unique(want)) > 2  # instances, not a blank map


def test_scale2_spatial_engine(worlds):
    """Scale 2 through the spatial path: the plain model's map equals
    JAX's; the PointRend model's (C9) is the image's map, the same on both
    ranks, with instances."""
    np.testing.assert_array_equal(worlds["scale2"], worlds["jax_scale2"])
    maps = [m[2] for m in worlds["rank_maps"]]
    assert maps[0].shape == worlds["img"].shape and maps[0].dtype == np.int64
    np.testing.assert_array_equal(maps[0], maps[1])
    assert len(np.unique(maps[0])) > 2
