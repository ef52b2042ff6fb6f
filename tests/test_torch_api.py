"""The port's public API (``empanada_tpu_torch.api``) against the JAX
package's, in float32 on the CPU with the same weights (flax values carried
by the weight bridge): configs with ``BASE`` inheritance and the registry,
bundles (the port's own format, and a JAX bundle carried into it),
the other architectures through configs and bundles,
``combine_panoptic_maps``, ``Engine2d`` (plain, tiled with objects crossing
tiles, semantic-only, ``inference_scale`` 2, ``force_connected``,
``update_params``) and ``Engine3d`` (an xy sweep whose trackers also equal
the batched ``MultiChipEngine3d``'s, the morphological filters,
``infer_orthoplane`` with the consensus, crash and resume across both
packages, progress lines).  Maps, trackers and volumes must be equal."""

import os

import jax
import numpy as np
import pytest
import torch
import yaml

import empanada_tpu.api.inference as jax_inference
from _torch_port import SMALL_PR, jax_init, one_torch_thread, port_model  # noqa: F401
from conftest import make_blob_image
from empanada_tpu import api as jax_api
from empanada_tpu_torch import api
from empanada_tpu_torch.api import inference
from empanada_tpu_torch.core.chunked import ChunkedArray
from empanada_tpu_torch.stitch.tile import Tiler
from empanada_tpu_torch.parallel.data_parallel import MultiChipEngine3d
from test_torch_checkpoint import _crash
from test_torch_ortho import _volume, assert_same_instances, assert_same_trackers

CFG = {
    "model_name": "tiny",
    "class_names": {1: "mito"},
    "labels": [1],
    "thing_list": [1],
    "model": "unused",
    "padding_factor": 16,
    "norms": {"mean": 0.57571, "std": 0.12765},
}
KW2D = dict(nms_kernel=3, max_centers=32, confidence_thr=0.5)
KW3D = dict(median_kernel_size=3, min_size=10, min_extent=1, max_centers=32,
            confidence_thr=0.5)


@pytest.fixture(scope="module")
def models():
    model, variables = jax_init("PanopticDeepLabPR", SMALL_PR, size=64)
    return model, variables, port_model("PanopticDeepLabPR", SMALL_PR, variables)


@pytest.fixture(scope="module")
def engines2d(models):
    """One (port, JAX) Engine2d pair for the file: the JAX engine compiles
    once per shape."""
    model, variables, tmodel = models
    return (api.Engine2d(CFG, model=tmodel, device="cpu", **KW2D),
            jax_api.Engine2d(CFG, model_and_variables=(model, variables), **KW2D))


def _set(pair, **params):
    """The same ``update_params`` on both engines (all arguments given)."""
    full = dict(inference_scale=1, label_divisor=1000, nms_threshold=0.1, nms_kernel=3,
                confidence_thr=0.5, fine_boundaries=False, semantic_only=False,
                tile_size=0)
    full.update(params)
    for eng in pair:
        eng.update_params(**full)


def _same_map(got, want):
    assert got.dtype == np.int64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---- configs, registry, bundles ----------------------------------------


def test_load_config_base_inheritance(tmp_path):
    (tmp_path / "base.yaml").write_text(yaml.dump({"a": 1, "nested": {"x": 1, "y": 2}}))
    (tmp_path / "child.yaml").write_text(
        yaml.dump({"BASE": "base.yaml", "nested": {"y": 3}, "b": 2}))
    (tmp_path / "grandchild.yaml").write_text(yaml.dump({"BASE": "child.yaml", "c": 4}))
    for name in ("child", "grandchild"):
        path = str(tmp_path / f"{name}.yaml")
        assert api.load_config(path) == jax_api.load_config(path)
    assert api.load_config(str(tmp_path / "grandchild.yaml")) == {
        "a": 1, "b": 2, "c": 4, "nested": {"x": 1, "y": 3}}
    (tmp_path / "cycle.yaml").write_text(yaml.dump({"BASE": "cycle.yaml"}))
    with pytest.raises(ValueError, match="cycle"):
        api.load_config(str(tmp_path / "cycle.yaml"))


@pytest.mark.parametrize("name", ["MitoNet_v1", "NucleoNet_base_v2", "DropNet_base_v1",
                                  "MitoNet_v1_mini"])
def test_registry_configs_are_the_jax_configs(name):
    """The port's copy equals the JAX package's config but for the bundle
    path (the port's own format) and the description."""
    assert sorted(api.get_configs()) == ["DropNet_base_v1", "MitoNet_v1",
                                         "MitoNet_v1_mini", "NucleoNet_base_v2"]
    got = api.load_config(name)
    want = jax_api.load_config(jax_api.get_configs()[name])
    for cfg in (got, want):
        cfg.pop("model"), cfg.pop("description")
    assert got == want
    assert got["padding_factor"] == {"MitoNet_v1": 16, "MitoNet_v1_mini": 128}.get(name, 512)


BUNDLE_ARCHS = {
    "PanopticDeepLab": dict(encoder="regnety_200mf", decoder_channels=32,
                            low_level_stages=[1], low_level_channels_project=[16]),
    "PanopticDeepLabBC": dict(SMALL_PR),
    "PanopticBiFPN": dict(encoder="regnety_200mf", fpn_dim=32, fpn_layers=2),
    "PanopticBiFPNPR": dict(encoder="regnety_200mf", fpn_dim=32, fpn_layers=2,
                            subdivision_num_points=256),
}


@pytest.mark.parametrize("arch", sorted(BUNDLE_ARCHS))
def test_architectures_through_configs_and_bundles(arch, tmp_path):
    """``init_model_from_config`` builds each architecture from its seed
    alone (the transposed convs too), and its bundle loads back
    (``load_model_from_config``) with the same weights and the same maps."""
    cfg = {"arch": arch, "model_kwargs": BUNDLE_ARCHS[arch]}
    model = api.init_model_from_config(cfg, seed=3, device="cpu")
    again = api.init_model_from_config(cfg, seed=3, device="cpu")
    for (k, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
    path = api.save_model_bundle(str(tmp_path / arch), arch, BUNDLE_ARCHS[arch], model)
    back = api.load_model_from_config({**cfg, "model": path}, device="cpu")
    assert type(back) is type(model)
    for (k, a), (k2, b) in zip(model.state_dict().items(), back.state_dict().items()):
        assert k == k2 and torch.equal(a, b)
    x = torch.from_numpy(np.random.default_rng(4).normal(0, 1, (1, 128, 128, 1))
                         .astype(np.float32))
    with torch.no_grad():
        out, out_back = model(x), back(x)
    for k in out:
        assert torch.equal(out[k], out_back[k])


def test_bundle_round_trip_and_a_jax_bundle(tmp_path, models, engines2d):
    model, variables, tmodel = models
    path = api.save_model_bundle(str(tmp_path / "tiny"), "PanopticDeepLabPR", SMALL_PR,
                                 tmodel)
    back = api.load_model_bundle(path, device="cpu")
    for (k, a), (k2, b) in zip(tmodel.state_dict().items(), back.state_dict().items()):
        assert k == k2 and torch.equal(a, b)
    # a JAX bundle reaches the port through the weight bridge
    jpath = jax_api.save_model_bundle(str(tmp_path / "jax"), "PanopticDeepLabPR", SMALL_PR,
                                      variables)
    with pytest.raises(ValueError, match="from_flax"):
        api.load_model_bundle(jpath, device="cpu")
    _, jvars = jax_api.load_model_bundle(jpath)
    carried = port_model("PanopticDeepLabPR", SMALL_PR, jax.tree.map(np.asarray, jvars))
    cpath = api.save_model_bundle(str(tmp_path / "carried"), "PanopticDeepLabPR", SMALL_PR,
                                  carried)
    # the bundle's variables are the JAX engine's, so that engine's map is
    # the JAX bundle's (without compiling a second JAX engine)
    assert jax.tree.all(jax.tree.map(np.array_equal, jax.tree.map(np.asarray, jvars),
                                     variables))
    _set(engines2d)
    img = make_blob_image((70, 90), n_blobs=6, seed=1)
    got = api.Engine2d({**CFG, "model": cpath}, device="cpu", **KW2D).infer(img)
    _same_map(got, engines2d[1].infer(img))
    with pytest.raises(FileNotFoundError):
        api.Engine2d({**CFG, "model": str(tmp_path / "missing.eptorch")}, device="cpu")


# ---- combine_panoptic_maps (the cases of tests/test_api.py) -------------


def _cfg(name, cname, labels):
    return {"model_name": name, "class_names": {lab: cname for lab in labels},
            "labels": labels}


def test_combine_panoptic_maps_matches_jax():
    a = np.zeros((4, 4), np.int64)
    a[0, 0], a[1, 1] = 1005, 1007
    b = np.zeros((4, 4), np.int64)
    b[1, 1], b[2, 2] = 1003, 1009
    cases = [([a, b], [_cfg("A", "mito", [1]), _cfg("B", "nuc", [1])], 1000),
             ([np.asarray([[201]]), np.asarray([[104]])],
              [_cfg("A", "x", [1, 2]), _cfg("B", "y", [1])], 100)]
    for maps, cfgs, div in cases:
        got = api.combine_panoptic_maps(maps, cfgs, label_divisor=div)
        want = jax_api.combine_panoptic_maps(maps, cfgs, label_divisor=div)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    assert api.combine_panoptic_maps(*cases[0][:2])[0][2, 2] == 2009
    with pytest.raises(ValueError):
        api.combine_panoptic_maps([np.zeros((2, 2), np.int64), np.zeros((3, 3), np.int64)],
                                  [_cfg("A", "x", [1]), _cfg("B", "y", [1])])


# ---- Engine2d ----------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "tiled", "semantic-only", "scale-2",
                                  "fine-boundaries"])
def test_engine2d_matches_jax(engines2d, case):
    params = {"plain": {}, "tiled": dict(tile_size=64),
              "semantic-only": dict(semantic_only=True),
              "scale-2": dict(inference_scale=2), "fine-boundaries": dict(fine_boundaries=True,
                                                                          tile_size=64)}[case]
    _set(engines2d, **params)
    shape = (150, 170) if "tile_size" in params else (70, 90)
    img = make_blob_image(shape, n_blobs=10, seed=2)
    got, want = (eng.infer(img) for eng in engines2d)
    _same_map(got, want)
    ids = np.unique(got[got > 0])
    if case == "semantic-only":
        assert set(ids.tolist()) <= {1000}
    else:
        assert len(ids) >= 3  # instances, not a blank map
    assert engines2d[0].last_overflow == engines2d[1].last_overflow
    if case == "tiled":  # several tiles, and an instance on both sides of an overlap
        tiler = Tiler(shape, 64, 6)
        assert len(tiler) >= 9
        left = got[:, :tiler.xranges[1][0]]
        right = got[:, tiler.xranges[0][1]:]
        crossing = np.intersect1d(left[left // 1000 == 1], right[right // 1000 == 1])
        assert len(crossing) >= 1


def test_engine2d_update_params_matches_jax(engines2d):
    img = make_blob_image((70, 90), n_blobs=10, seed=4)
    for params in (dict(confidence_thr=0.7, nms_threshold=0.2, nms_kernel=5),
                   dict(label_divisor=500), dict()):
        _set(engines2d, **params)
        _same_map(*(eng.infer(img) for eng in engines2d))
    assert engines2d[0].engine.label_divisor == 1000


def test_force_connected_matches_jax(engines2d):
    _set(engines2d)
    pan = np.zeros((20, 30), np.int64)
    pan[2:6, 2:8] = 1003          # one instance in two parts
    pan[12:15, 20:26] = 1003
    pan[8:10, 10:20] = 1001
    pan[0:3, 25:30] = 2000        # another class stays as it is
    got = engines2d[0].force_connected(pan.copy())
    want = engines2d[1].force_connected(pan.copy())
    _same_map(got, want)
    assert len(np.unique(got[got // 1000 == 1])) == 3


def test_engine2d_spatial_shard_and_device(models):
    """``spatial_shard`` in a world of one (no process group): one block
    with zero halo rows above and below, as JAX's one-device mesh runs it;
    ``update_params`` reaches the spatial engine."""
    from empanada_tpu.parallel.mesh import create_mesh as jax_mesh

    model, variables, tmodel = models
    img = make_blob_image((70, 90), n_blobs=4, seed=5)
    kw = dict(KW2D, spatial_shard=True, spatial_halo=16)
    got = api.Engine2d(CFG, model=tmodel, device="cpu", **kw)
    want = jax_api.Engine2d(CFG, model_and_variables=(model, variables),
                            spatial_mesh=jax_mesh(1, axis_name="spatial"), **kw)
    for thr in (0.5, 0.3):
        _set((got, want), confidence_thr=thr)
        _same_map(got.infer(img), want.infer(img))
    assert got.spatial_engine.confidence_thr == 0.3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            api.Engine2d(CFG, model=models[2])


# ---- Engine3d ----------------------------------------------------------

SHAPE3D = (7, 48, 64)


@pytest.fixture(scope="module")
def engines3d(models):
    model, variables, tmodel = models
    return (api.Engine3d(CFG, model=tmodel, device="cpu", save_panoptic=True, **KW3D),
            jax_api.Engine3d(CFG, model_and_variables=(model, variables),
                             save_panoptic=True, **KW3D))


def test_engine3d_xy_matches_jax_and_the_batched_engine(engines3d, models):
    vol = _volume(SHAPE3D, seed=31)
    got_stack, got = engines3d[0].infer_on_axis(vol, "xy")
    want_stack, want = engines3d[1].infer_on_axis(vol, "xy")
    np.testing.assert_array_equal(got_stack, want_stack)
    assert_same_trackers(got, want)
    assert len(got[0].instances) >= 3
    batched = MultiChipEngine3d(CFG, models[2], device="cpu", batch_size=3,
                                save_panoptic=True, **KW3D)
    b_stack, b_trackers = batched.infer_on_axis(vol, "xy")
    np.testing.assert_array_equal(got_stack, b_stack)
    assert_same_trackers(got, b_trackers)
    assert "backward_matching" in engines3d[0].last_timing


def test_engine3d_filters_match_jax(models):
    model, variables, tmodel = models
    kw = dict(KW3D, label_erosion=1, label_dilation=1, fill_holes_in_segmentation=True)
    vol = _volume(SHAPE3D, seed=32)
    got = api.Engine3d(CFG, model=tmodel, device="cpu", **kw).infer_on_axis(vol, "xy")[1]
    want = jax_api.Engine3d(CFG, model_and_variables=(model, variables),
                            **kw).infer_on_axis(vol, "xy")[1]
    assert_same_trackers(got, want)
    assert len(got[0].instances) >= 2


def test_engine3d_orthoplane_and_consensus_match_jax(engines3d):
    vol = _volume((8, 40, 48), seed=33)
    got = engines3d[0].infer_orthoplane(vol)
    want = engines3d[1].infer_orthoplane(vol)
    for axis in ("xy", "xz", "yz"):
        assert_same_trackers(got[axis], want[axis])
    kw = dict(pixel_vote_thr=2, min_size=10, min_extent=1)
    (gv, gn, gi), = api.tracker_consensus(got, None, CFG, device="cpu", **kw)
    (wv, wn, wi), = jax_api.tracker_consensus(want, None, CFG, **kw)
    np.testing.assert_array_equal(gv, wv)
    assert_same_instances(gi, wi)


def test_engine3d_resume_across_packages(engines3d, models, monkeypatch, tmp_path):
    """A port sweep crashed after 4 slices and resumed equals an
    uninterrupted one; so does the port resuming a JAX checkpoint."""
    vol = _volume(SHAPE3D, seed=34)
    ckw = dict(checkpoint_every=2)
    want = engines3d[0].infer_on_axis(vol, "xy")
    for name, module, eng in (("port", inference, engines3d[0]),
                              ("jax", jax_inference, engines3d[1])):
        cdir = str(tmp_path / name)
        _crash(monkeypatch, module,
               lambda: eng.infer_on_axis(vol, "xy", checkpoint_dir=cdir, **ckw), 4)
        assert any(f.startswith("forward_xy.") for f in os.listdir(cdir))
        got = engines3d[0].infer_on_axis(vol, "xy", checkpoint_dir=cdir, resume=True, **ckw)
        np.testing.assert_array_equal(got[0], want[0])
        assert_same_trackers(got[1], want[1])
        assert not any(f.startswith("forward_xy.") for f in os.listdir(cdir))


def test_engine3d_orthoplane_resume_skips_finished_axes(engines3d, tmp_path):
    vol = _volume((6, 32, 40), seed=35)
    cdir = str(tmp_path / "ortho")
    want = engines3d[0].infer_orthoplane(vol, checkpoint_dir=cdir)
    calls = []
    eng = engines3d[0]
    orig = eng.infer_on_axis
    eng.infer_on_axis = lambda *a, **k: calls.append(a[1]) or orig(*a, **k)
    try:
        got = eng.infer_orthoplane(vol, checkpoint_dir=cdir, resume=True)
    finally:
        del eng.infer_on_axis
    assert calls == []
    for axis in want:
        assert_same_trackers(got[axis], want[axis])


def test_engine3d_progress_lines(engines3d, capsys):
    vol = _volume((4, 32, 32), seed=36)
    engines3d[0].infer_on_axis(vol, "xy", progress=True)
    assert "axis xy: 4/4" in capsys.readouterr().err


def test_engine3d_store(engines3d, tmp_path):
    """``store_url`` writes the panoptic stack into a chunked store equal
    to the numpy stack, and to the JAX engine's store byte for byte."""
    vol = _volume(SHAPE3D, seed=37)
    want = engines3d[0].infer_on_axis(vol, "xy")[0]
    for name, eng in zip(("port", "jax"), engines3d):
        eng.store_url, eng.chunk_size = str(tmp_path / name), (4, 16, 32)
    try:
        got = engines3d[0].infer_on_axis(vol, "xy")[0]
        jgot = engines3d[1].infer_on_axis(vol, "xy")[0]
    finally:
        for eng in engines3d:
            eng.store_url = None
    assert isinstance(got, ChunkedArray)
    np.testing.assert_array_equal(np.asarray(got), want)
    np.testing.assert_array_equal(np.asarray(jgot), want)
    path = tmp_path / "port" / "panoptic_xy"
    jpath = tmp_path / "jax" / "panoptic_xy"
    assert sorted(os.listdir(path)) == sorted(os.listdir(jpath))
    for f in os.listdir(path):
        assert (path / f).read_bytes() == (jpath / f).read_bytes()

