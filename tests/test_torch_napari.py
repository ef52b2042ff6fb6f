"""The port's napari adapters (``empanada_tpu_torch/napari_plugin``) against
the JAX package's (``empanada_tpu/napari_plugin``): the manifest's command
surface, the widget bodies with magicgui stubbed by a pass-through (napari
and magicgui are absent here), each curation widget against JAX's on the
same inputs, the 2D inference widget on the port's real engine on the CPU
against ``Engine2d``, and the informative error without napari."""

import importlib
import os
import sys
import types

import numpy as np
import pytest
import torch
import yaml

import empanada_tpu.napari_plugin as jax_plugin
from _torch_port import SMALL_PR, one_torch_thread  # noqa: F401
from empanada_tpu.napari_plugin import widgets as jax_widgets
from empanada_tpu_torch import napari_plugin as plugin
from empanada_tpu_torch.api import utils as port_utils
from empanada_tpu_torch.napari_plugin import widgets

N_COMMANDS = 24


def _manifest(mod):
    with open(mod.manifest_path()) as f:
        return yaml.safe_load(f)


def _suffixes(manifest):
    return {c["id"].split(".", 1)[1] for c in manifest["contributions"]["commands"]}


class _FakeLayer:
    def __init__(self, data, name="layer"):
        self.data = data
        self.name = name


def _passthrough_magicgui():
    """Stand-in for magicgui: a decorator factory returning the function."""
    def magicgui(**_kwargs):
        return lambda fn: fn
    return magicgui


@pytest.fixture
def both(monkeypatch):
    """(port's widgets, JAX's widgets), magicgui stubbed in both."""
    monkeypatch.setattr(widgets, "_magicgui", _passthrough_magicgui)
    monkeypatch.setattr(jax_widgets, "_magicgui", _passthrough_magicgui)
    return widgets, jax_widgets


# ---- the manifest ---------------------------------------------------------


def test_manifest_has_every_jax_command():
    ours, theirs = _manifest(plugin), _manifest(jax_plugin)
    assert ours["name"] == "empanada-tpu-torch"
    commands = ours["contributions"]["commands"]
    assert len(commands) == N_COMMANDS == len(theirs["contributions"]["commands"])
    assert _suffixes(ours) == _suffixes(theirs)
    assert ({w["command"] for w in ours["contributions"]["widgets"]}
            == {c["id"] for c in commands})
    assert ([w["display_name"] for w in ours["contributions"]["widgets"]]
            == [w["display_name"] for w in theirs["contributions"]["widgets"]])


def test_every_python_name_resolves_in_the_port():
    names = []
    for cmd in _manifest(plugin)["contributions"]["commands"]:
        module_name, attr = cmd["python_name"].split(":")
        assert module_name == "empanada_tpu_torch.napari_plugin.widgets"
        assert callable(getattr(importlib.import_module(module_name), attr))
        names.append(attr)
    assert sorted(names) == sorted(widgets.__all__) == sorted(jax_widgets.__all__)


def test_manifest_ships_with_the_package():
    text = open(os.path.join(os.path.dirname(os.path.dirname(__file__)),
                             "pyproject.toml")).read()
    assert 'empanada-tpu-torch = "empanada_tpu_torch.napari_plugin:napari.yaml"' in text
    assert os.path.isfile(plugin.manifest_path())


# ---- the widget bodies (JAX's TestWidgetBodies, ported) ---------------------


class _Dims:
    current_step = (0, 0, 0)

    def set_point(self, axis, value):
        self.point = (axis, value)


def _viewer():
    return types.SimpleNamespace(dims=_Dims(), camera=types.SimpleNamespace(center=None))


@pytest.mark.parametrize("nd", [2, 3])
def test_jump_sets_the_camera_as_jax_does(both, nd):
    shape = (16, 16) if nd == 2 else (6, 16, 16)
    labels = np.zeros(shape, np.int32)
    labels[..., 4:8, 10:14] = 5
    if nd == 3:
        labels[:2] = 0
    results = []
    for mod in both:
        viewer = _viewer()
        msg = mod.jump_to_label_widget()(viewer, _FakeLayer(labels), 5)
        results.append((msg, viewer.camera.center, getattr(viewer.dims, "point", None)))
    assert results[0] == results[1]
    assert len(results[0][1]) == 3 and results[0][1][1:] == (6.0, 12.0)
    assert both[0].jump_to_label_widget()(_viewer(), _FakeLayer(labels), 9) == \
        "label 9 not found"


@pytest.mark.parametrize("orthoplane", [False, True])
def test_volume_inference_emits_a_layer_per_class(both, monkeypatch, orthoplane):
    from empanada_tpu_torch import api

    seen = {}

    class StubEngine:
        def __init__(self, config, **kwargs):
            seen["config"], seen["kwargs"] = config, kwargs

        def infer_on_axis(self, volume, axis):
            return None, "trackers"

        def infer_orthoplane(self, volume):
            return {"xy": "trackers"}

    def stub_classes(trackers, store_url, config, **kwargs):
        seen["post_kwargs"] = kwargs
        yield np.ones((2, 4, 4), np.int32), "mito", [1]
        yield np.full((2, 4, 4), 2, np.int32), "nuclei", [2]

    monkeypatch.setattr(api, "Engine3d", StubEngine)
    monkeypatch.setattr(api, "stack_postprocessing", stub_classes)
    monkeypatch.setattr(api, "tracker_consensus", stub_classes)
    monkeypatch.setattr(port_utils, "load_config", lambda name: {"name": name})
    out = both[0].volume_inference_widget()(
        _FakeLayer(np.zeros((2, 4, 4), np.float32)), model_name="M", orthoplane=orthoplane)
    assert [meta["name"] for _, meta, _ in out] == ["mito_seg", "nuclei_seg"]
    assert seen["config"] == {"name": "M"}  # the loaded config, not its path
    assert seen["kwargs"]["device"] == "cuda" and seen["post_kwargs"]["device"] == "cuda"


def test_pick_patches_3d_crops_planes_as_jax_does(both):
    vol = np.random.default_rng(0).random((6, 64, 64)).astype(np.float32)
    for points in (None, np.array([[2, 30, 40], [5, 10, 12]])):
        stacks = []
        for mod in both:
            layer = None
            if points is not None:
                layer = _FakeLayer(points)
                layer.ndim = 3
            stacks.append(mod.pick_patches_widget()(_FakeLayer(vol), layer, n_patches=3,
                                                    patch_size=16)[0])
        np.testing.assert_array_equal(*stacks)
        assert stacks[0].shape[1:] == (16, 16)
    assert np.array_equal(stacks[0][0], vol[2, 22:38, 32:48])


@pytest.mark.parametrize("nd", [2, 3])
def test_store_dataset_as_jax_does(both, tmp_path, nd):
    img = np.arange(32 * 48, dtype=np.uint8).reshape(32, 48)
    msk = (np.arange(32 * 48).reshape(32, 48) % 7).astype(np.int32)
    if nd == 3:
        img, msk = np.stack([img, img[::-1]]), np.stack([msk, msk[::-1]])
    listings = []
    for name, mod in zip(("port", "jax"), both):
        mod.store_dataset_widget()(_FakeLayer(img), _FakeLayer(msk), str(tmp_path / name),
                                   "ds")
        listings.append(sorted(os.listdir(tmp_path / name / "ds" / "images")))
    assert listings[0] == listings[1] and len(listings[0]) == (1 if nd == 2 else 2)


# ---- the curation widgets against JAX's ------------------------------------


def _blobs(nd=2, seed=0):
    rng = np.random.default_rng(seed)
    shape = (24, 24) if nd == 2 else (4, 24, 24)
    labels = np.zeros(shape, np.int32)
    for i, (y, x) in enumerate(rng.integers(2, 18, (5, 2))):
        labels[..., y:y + 5, x:x + 5] = 1001 + i
    labels[..., 0:3, 0:3] = 2001
    return labels


def _run_labels_widget(mod, factory, labels, points, **kw):
    layer = _FakeLayer(labels.copy())
    pts = None
    if points is not None:
        pts = _FakeLayer(np.asarray(points))
        pts.ndim = labels.ndim
    out = getattr(mod, factory)()(layer, pts, **kw)
    return layer.data, out, None if pts is None else pts.data


@pytest.mark.parametrize("factory,kw", [
    ("merge_labels_widget", {}),
    ("delete_labels_widget", {}),
    ("split_labels_widget", {"min_distance": 2}),
    ("morph_labels_widget", {"operation": "dilate", "radius": 1}),
    ("morph_labels_widget", {"operation": "erode", "radius": 1}),
    ("morph_labels_widget", {"operation": "fill_holes", "hole_size": 4}),
])
@pytest.mark.parametrize("nd", [2, 3])
def test_label_edit_widgets_match_jax(both, factory, kw, nd):
    labels = _blobs(nd)
    hy, hx = np.argwhere(labels[..., :, :].reshape(-1, *labels.shape[-2:])[0] == 1001)[12]
    labels[..., hy, hx] = 0  # a hole through every plane, for fill_holes
    ids = np.unique(labels[labels > 0])[:2]
    points = [np.argwhere(labels == i)[0] for i in ids]
    got, want = (_run_labels_widget(mod, factory, labels, points, **kw) for mod in both)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])  # merge and delete empty the points
    assert factory == "split_labels_widget" or not np.array_equal(got[0], labels), factory


@pytest.mark.parametrize("filt,mode,area", [("small", "image", 30), ("boundary", "image", 0),
                                            ("small", "volume", 30)])
def test_filter_widget_matches_jax(both, filt, mode, area):
    labels = _blobs(3 if mode == "volume" else 2, seed=1)
    labels[..., 20:22, 20:22] = 3001  # a small one
    outs = []
    for mod in both:
        layer = _FakeLayer(labels.copy())
        msg = mod.filter_small_labels_widget()(layer, minimum_area=area, filter=filt,
                                               mode=mode)
        outs.append((layer.data, msg))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1] and outs[0][1] != "removed 0 labels"


@pytest.mark.parametrize("divisor", [1000, 100])
def test_count_and_next_label_widgets_match_jax(both, divisor):
    labels = _blobs(2, seed=2)
    counts = [mod.label_counter_widget()(_FakeLayer(labels), divisor) for mod in both]
    assert counts[0] == counts[1] and "class" in counts[0]
    layers = [_FakeLayer(labels) for _ in both]
    nxt = [mod.find_next_available_label_widget()(layer, 1, divisor)
           for mod, layer in zip(both, layers)]
    assert nxt[0] == nxt[1] == layers[0].selected_label == layers[1].selected_label


def test_tiles_widgets_match_jax(both, tmp_path):
    img = (np.random.default_rng(3).random((70, 90)) * 255).astype(np.uint8)
    path = str(tmp_path / "img.npy")
    np.save(path, img)
    merged = []
    for name, mod in zip(("port", "jax"), both):
        out = tmp_path / name
        mod.create_tiles_widget()(path, str(out / "tiles"), patch_size=32)
        tiles = sorted(os.listdir(out / "tiles" / "im"))
        mod.merge_tiles_widget()(str(out / "tiles"), str(out / "merged"))
        merged.append((tiles, sorted(os.listdir(out / "merged"))))
    assert merged[0] == merged[1] and merged[0][0]


def test_visualize_patches_matches_jax(both):
    pts = _FakeLayer(np.array([[10.5, 20.25], [40.0, 7.0]]))
    got, want = (mod.visualize_patches_widget()(pts, 16) for mod in both)
    assert got[1:] == want[1:]
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="No points"):
        both[0].visualize_patches_widget()(_FakeLayer(np.zeros((0, 2))), 16)


def test_get_info_matches_jax(both):
    """The same text but for the config's description (the port's copy of
    MitoNet_v1.yaml names the port)."""
    got, want = (mod.get_info_widget()("MitoNet_v1").split("Finetuning instructions:")
                 for mod in both)
    assert got[1] == want[1] and "Classes to annotate" in got[1]
    assert got[0].splitlines()[:3] == want[0].splitlines()[:3]


# ---- the model widgets -------------------------------------------------------


@pytest.fixture
def registry(tmp_path, monkeypatch):
    """A registry of its own holding a tiny seeded model "tiny" (the
    MitoNet_v1 config at SMALL_PR's widths, a port bundle)."""
    monkeypatch.setattr(port_utils, "MODEL_DIR", str(tmp_path / "registry"))
    cfg = port_utils.load_config("MitoNet_v1")
    cfg["model_kwargs"] = dict(SMALL_PR)
    model = port_utils.init_model_from_config(cfg, seed=0, device="cpu")
    cfg["model"] = port_utils.save_model_bundle(str(tmp_path / "tiny"), cfg["arch"],
                                                cfg["model_kwargs"], model)
    port_utils.add_new_model("tiny", cfg)
    return cfg


@pytest.mark.parametrize("nd", [2, 3])
def test_slice_inference_widget_runs_the_engine(both, registry, nd):
    from empanada_tpu_torch.api import Engine2d

    rng = np.random.default_rng(4)
    img = (rng.random((nd - 1, 70, 90) if nd == 3 else (70, 90)) * 255).astype(np.uint8)
    viewer = _viewer()
    viewer.dims.current_step = (1, 0, 0)
    pan, meta, kind = both[0].slice_inference_widget()(viewer, _FakeLayer(img, "em"),
                                                      model_name="tiny", device="cpu")
    want = Engine2d(port_utils.load_config("tiny"), label_divisor=10000, device="cpu").infer(
        img[1] if nd == 3 else img)
    np.testing.assert_array_equal(pan, want)
    assert meta == {"name": "em_panoptic"} and kind == "labels"
    assert len(np.unique(pan)) > 1


def test_jax_slice_widget_passes_a_path_where_a_config_is_needed(both, registry):
    """Reference fault not carried: JAX's 2D widget hands the yaml PATH of
    ``get_configs`` to ``Engine2d``, which indexes it as a config and
    raises; the port's loads the config (the test above)."""
    import empanada_tpu.api.utils as jax_utils

    path = port_utils.get_configs()["tiny"]
    jax_utils.get_configs, real = (lambda: {"tiny": path}), jax_utils.get_configs
    try:
        with pytest.raises(TypeError):
            both[1].slice_inference_widget()(_viewer(), _FakeLayer(np.zeros((8, 8), np.uint8)),
                                             model_name="tiny")
    finally:
        jax_utils.get_configs = real


@pytest.fixture
def napari_threads(monkeypatch):
    """``napari.qt.threading.thread_worker`` stubbed to run on ``start()``
    in this thread."""
    def thread_worker(fn):
        return lambda: types.SimpleNamespace(start=fn)

    mod = types.ModuleType("napari.qt.threading")
    mod.thread_worker = thread_worker
    for name in ("napari", "napari.qt"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.setitem(sys.modules, "napari.qt.threading", mod)


def test_training_widgets_call_the_loops(both, napari_threads, registry, monkeypatch,
                                         tmp_path):
    import empanada_tpu_torch.train as train

    calls = []
    monkeypatch.setattr(train, "main", lambda cfg, device=None: calls.append((cfg, device)))
    monkeypatch.setattr(train, "finetune_main",
                        lambda cfg, device=None: calls.append((cfg, device)))
    both[0].training_widget()(model_name="m", train_dir=str(tmp_path), iterations=300,
                              batch_size=4, device="cpu")
    both[0].finetuning_widget()(model_name="tiny", new_model_name="ft", iterations=200)
    (train_cfg, d0), (ft_cfg, d1) = calls
    assert d0 == "cpu" and d1 == "cuda"
    assert train_cfg["TRAIN"]["epochs"] == 3 and train_cfg["TRAIN"]["batch_size"] == 4
    assert ft_cfg["model_config"]["model"] == registry["model"]
    assert ft_cfg["TRAIN"]["epochs"] == 2


def test_register_and_export_widgets(both, registry, tmp_path):
    cfg_path = tmp_path / "other.yaml"
    cfg_path.write_text(yaml.dump(dict(registry, model=None)))
    both[0].register_model_widget()("other", str(cfg_path), registry["model"])
    assert port_utils.load_config("other")["model"] == registry["model"]
    archive = both[0].export_model_widget()("tiny", str(tmp_path / "exp"))
    name = both[0].import_model_widget()(archive, "imported")
    assert "imported" in port_utils.get_configs() and name
    assert os.path.exists(both[0].archive_model_widget()("tiny", str(tmp_path / "arch")))


def test_inference_widget_defaults_to_the_card(both):
    import inspect

    for factory in ("slice_inference_widget", "volume_inference_widget",
                    "training_widget", "finetuning_widget"):
        sig = inspect.signature(getattr(both[0], factory)())
        assert sig.parameters["device"].default == "cuda", factory


# ---- without napari ----------------------------------------------------------


def test_import_without_napari():
    assert plugin.napari_available() in (True, False)
    assert "magicgui" not in sys.modules or plugin.napari_available()


def test_widget_factory_raises_an_informative_error():
    if plugin.napari_available():
        pytest.skip("napari installed: the widgets build")
    with pytest.raises(ImportError, match="python -m empanada_tpu_torch"):
        widgets.slice_inference_widget()


def test_open_documentation_needs_no_napari(monkeypatch):
    import webbrowser

    opened = []
    monkeypatch.setattr(webbrowser, "open", lambda url: opened.append(url))
    widgets.open_documentation()
    assert opened and "empanada" in opened[0]
