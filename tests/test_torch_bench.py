"""The port's benchmark (``empanada_tpu_torch/bench.py``) on the CPU: each
section at a tiny size, the JSON line's keys against the repository
root's ``bench.py`` (read from its source: it needs a TPU), the refusals,
and the command line forwarding everything after ``bench`` verbatim.  A
CPU run measures the CPU: no number here is a device metric."""

import ast
import json
import os

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401
from empanada_tpu_torch import bench
from empanada_tpu_torch.cli import main as port_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(encoder="resnet18", num_classes=1, decoder_channels=32, low_level_stages=[1],
            low_level_channels_project=[16], ins_decoder=True, subdivision_num_points=256)


@pytest.fixture(scope="module")
def tiny():
    pipe, model = bench.build("cpu", TINY, dtype=torch.float32)
    return pipe, model, bench.blob_images(2, 64, 64, "cpu")


def test_bench_2d_and_stages(tiny):
    pipe, model, images = tiny
    r = bench.bench_2d(pipe, images, iters=1, trials=1)
    assert r["mvox_s"] > 0 and r["flops"] > 0 and r["mfu"] is None  # no card, no mfu
    assert sorted(r["stats"]) == ["jitter", "max_s", "median_s", "s", "valid_trials"]
    stages = bench.bench_stages(model, pipe, images, iters=1, trials=1)
    assert list(stages) == ["encoder", "decoders", "heads+render", "postprocess"]
    assert all(s["ms"] >= 0 and "share" in s for s in stages.values())
    assert stages["encoder"]["flops"] > stages["postprocess"]["flops"]


def test_bench_3d_and_ortho(tiny):
    _, model, _ = tiny
    r3d = bench.bench_3d(model, bench.blob_volume(4, 64, 64, 4), "cpu", runs=1, batch_size=2)
    assert r3d["mvox_s"] > 0 and r3d["batch"] == 2 and r3d["device_s"] is None
    assert {"spread", "host_s", "transfer_s", "matcher_thread_s"} <= set(r3d)
    rortho = bench.bench_ortho(model, bench.blob_volume(4, 32, 32, 3), "cpu", runs=1)
    assert rortho["mvox_s"] > 0 and rortho["consensus_s"] >= 0


def test_bench_spatial_multimodel_train(tiny):
    pipe, model, images = tiny
    image = bench.blob_volume(1, 128, 128, 6)[0]
    sp = bench.bench_spatial(model, image, "cpu", tile_size=64, halo=16, runs=1)
    assert sp["devices"] == 1 and sp["tiled"]["dispatches"] > sp["sharded"]["dispatches"]
    mm = bench.bench_multimodel([pipe, pipe], images, iters=1, trials=1)
    assert mm["mvox_s"] > 0 and mm["combine_ms_per_slice"] >= 0
    tr = bench.bench_train("cpu", batch=2, side=64, kw=TINY, iters=1, trials=1)
    assert tr["imgs_s"] > 0 and tr["mfu"] is None


def _root_keys() -> set:
    """The keys of the root ``bench.py``'s full JSON line: its ``out`` dict
    literal and the ``out[...]`` assignments of its ``main``."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys = set()
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) and any(
                getattr(t, "id", None) == "out" for t in node.targets):
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript):
            t = node.targets[0]
            if getattr(t.value, "id", None) == "out" and isinstance(t.slice, ast.Constant):
                keys.add(t.slice.value)
    return keys


def test_json_line_has_the_root_bench_keys(monkeypatch, capsys, tiny):
    """``main`` with the card faked and every section stubbed: the line
    holds every key of the root script's (and names the device)."""
    pipe, model, images = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "fake")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(bench, "build", lambda *a, **k: (pipe, model))
    monkeypatch.setattr(bench, "blob_images", lambda *a, **k: images)
    monkeypatch.setattr(bench, "blob_volume", lambda *a, **k: np.zeros((2, 2, 2), np.uint8))
    st = {"s": 0.01, "median_s": 0.01, "max_s": 0.01, "valid_trials": 1, "jitter": 0.0}
    monkeypatch.setattr(bench, "bench_2d", lambda *a, **k: {
        "mvox_s": 1.0, "stats": st, "flops": 1, "mfu": 0.1})
    monkeypatch.setattr(bench, "bench_stages", lambda *a, **k: {})
    for name in ("bench_3d", "bench_ortho"):
        monkeypatch.setattr(bench, name, lambda *a, **k: {"mvox_s": 1.0})
    for name in ("bench_spatial", "bench_multimodel"):
        monkeypatch.setattr(bench, name, lambda *a, **k: {})
    monkeypatch.setattr(bench, "bench_train", lambda *a, **k: {
        "imgs_s": 1.0, "mfu": None, "jitter": 0.0})
    bench.main([])
    line = capsys.readouterr().out.strip().splitlines()
    assert len(line) == 1
    out = json.loads(line[0])
    missing = _root_keys() - set(out) - {"train_note"}  # a note on the JAX runs' history
    assert not missing, missing
    assert out["device"] == {"kind": "fake", "count": 1}
    bench.main(["--skip-3d"])
    short = json.loads(capsys.readouterr().out)
    assert "value" in short and "value_3d" not in short


@pytest.mark.parametrize("argv,match", [
    (["--measure-baseline"], "reference"), (["--int8"], "no CUDA device"),
    (["--skip-3d"], "no CUDA device")])
def test_refusals(argv, match):
    if match == "no CUDA device" and torch.cuda.is_available():
        pytest.skip("a GPU is present: the bench runs on it")
    with pytest.raises(SystemExit, match=match) as e:
        bench.main(argv)
    assert e.value.code not in (0, None)


def test_cli_forwards_everything_after_bench(monkeypatch):
    seen = []
    monkeypatch.setattr(bench, "main", seen.append)
    port_main(["bench", "--skip-3d", "--only", "3d", "--device", "x"])
    assert seen == [["--skip-3d", "--only", "3d", "--device", "x"]]


def test_int8_builds_the_headline_with_int8_execution(monkeypatch, capsys, tiny):
    """``--int8`` builds the headline's model (and the stages') with
    ``int8_execution`` and marks the line; the 3D sections get a float
    model, as the root script's do.  ``build`` itself makes an int8 model
    whose FLOP count keeps the int8 convolutions."""
    pipe, model, images = tiny
    built = []

    def build(device, kw=None, **k):
        built.append(dict(kw or {}))
        return pipe, model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "fake")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(bench, "build", build)
    monkeypatch.setattr(bench, "blob_images", lambda *a, **k: images)
    st = {"s": 0.01, "median_s": 0.01, "max_s": 0.01, "valid_trials": 1, "jitter": 0.0}
    monkeypatch.setattr(bench, "bench_2d", lambda *a, **k: {
        "mvox_s": 1.0, "stats": st, "flops": 1, "mfu": 0.1})
    bench.main(["--int8", "--skip-3d"])
    out = json.loads(capsys.readouterr().out)
    assert out["int8_execution"] is True and out["value"] == 1.0
    assert built == [dict(bench.FLAGSHIP_KW, int8_execution=True)]
    monkeypatch.undo()

    int8_pipe, int8_model = bench.build("cpu", dict(TINY, int8_execution=True),
                                        dtype=torch.float32)
    assert bench.flop_count(int8_pipe, images) == bench.flop_count(pipe, images)
    assert sum(getattr(m, "int8", False) for m in int8_model.modules()) == 11
