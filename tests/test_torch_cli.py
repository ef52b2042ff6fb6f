"""The port's command line (``python -m empanada_tpu_torch``) against the JAX
package's (``empanada_tpu.cli``), on the CPU (``--device cpu``) with the same
tiny model (the flax variables carried into the port by the weight bridge)
and the same input files, each package with a registry of its own in a
temporary directory.  Every command must write the same output files
(equal arrays of equal dtypes, as PIL reads them back) and print the same
lines, apart from paths and the packages' own file extensions; metrics are
held to 1e-12.  The commands the port does not have yet exit non-zero and
name their ROADMAP item; a half-given world (a coordinator without its
size and rank, or the reverse) exits too.  Training and finetuning are in
``test_torch_cli_train.py``."""

import json
import os
import re

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import empanada_tpu.api.export as jax_export
import empanada_tpu.api.utils as jax_utils
from _torch_port import SMALL_PR, jax_init, one_torch_thread, port_model  # noqa: F401
from conftest import make_blob_image
from empanada_tpu import api as jax_api
from empanada_tpu.cli import main as jax_main
from empanada_tpu.stitch import pan_seg_to_rle_seg
from empanada_tpu.stitch.tracker import InstanceTracker
from empanada_tpu_torch import api
from empanada_tpu_torch.api import utils as port_utils
from empanada_tpu_torch.cli import main as port_main
from empanada_tpu_torch.core.chunked import open_chunked
from empanada_tpu_torch.eval import default_evaluator

ARCH = "PanopticDeepLabPR"
SIDES = ("jax", "port")


def _pil_read(path):
    im = Image.open(path)
    frames = []
    for i in range(getattr(im, "n_frames", 1)):
        im.seek(i)
        frames.append(np.asarray(im))
    return np.stack(frames) if len(frames) > 1 else frames[0]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """One directory per package, each with the tiny model's bundle (in
    the package's own format), two registry configs naming it, and the
    same input files."""
    root = tmp_path_factory.mktemp("cli")
    model, variables = jax_init(ARCH, SMALL_PR, size=64)
    bundles = {"jax": jax_api.save_model_bundle(str(root / "jax_bundle"), ARCH, SMALL_PR,
                                                variables),
               "port": api.save_model_bundle(str(root / "port_bundle"), ARCH, SMALL_PR,
                                             port_model(ARCH, SMALL_PR, variables))}
    image = make_blob_image((96, 96), n_blobs=4)
    mask = np.zeros((96, 96), np.uint8)
    yy, xx = np.mgrid[0:96, 0:96]
    mask[((yy - 48) ** 2 + (xx - 48) ** 2) < 40 ** 2] = 1
    vol = np.stack([make_blob_image((64, 64), n_blobs=3, seed=s) for s in range(8)])
    seg = np.zeros((32, 32), np.int64)
    seg[2:6, 2:6] = 10001
    seg[10:12, 10:12] = 10002
    seg[0:3, 20:24] = 20001
    for side in SIDES:
        d = root / side
        (d / "home").mkdir(parents=True)
        for name, cls in (("tiny_model", "mito"), ("tiny_model_b", "nuclei")):
            cfg = {"class_names": {1: cls}, "labels": [1], "thing_list": [1],
                   "model": bundles[side], "padding_factor": 16,
                   "norms": {"mean": 0.5, "std": 0.2}}
            (d / f"{name}.yaml").write_text(yaml.dump(cfg))
        (d / "tiny_arch.yaml").write_text(yaml.dump(dict(cfg, arch=ARCH,
                                                         model_kwargs=SMALL_PR)))
        np.save(d / "img.npy", image)
        Image.fromarray(image).save(d / "img.png")
        np.save(d / "mask.npy", mask)
        np.save(d / "vol.npy", vol)
        frames = [Image.fromarray(s) for s in vol]
        frames[0].save(d / "vol.tif", save_all=True, append_images=frames[1:])
        np.save(d / "seg.npy", seg)
        stack = np.stack([seg, seg[::-1]]).astype(np.int32)
        frames = [Image.fromarray(s) for s in stack]
        frames[0].save(d / "seg3.tif", save_all=True, append_images=frames[1:])
        Image.fromarray(make_blob_image((80, 100), n_blobs=4)).save(d / "big.tiff")
        Image.fromarray((make_blob_image((80, 100), n_blobs=4, seed=2) < 90)
                        .astype(np.uint16)).save(d / "big_mask.tiff")
    return root


@pytest.fixture(autouse=True)
def registries(root, monkeypatch):
    """Each package's registry in its own temporary directory."""
    monkeypatch.setattr(jax_utils, "MODEL_DIR", str(root / "jax" / "home"))
    monkeypatch.setattr(jax_export, "MODEL_DIR", str(root / "jax" / "home"))
    monkeypatch.setattr(port_utils, "MODEL_DIR", str(root / "port" / "home"))


def run_both(root, capsys, argv, device=True):
    """Run ``argv`` (``{d}`` is the side's directory) through both command
    lines; returns {side: stdout lines with the directory as ``D``}."""
    out = {}
    for side, main in (("jax", jax_main), ("port", port_main)):
        d = str(root / side)
        args = [a.replace("{d}", d) for a in argv]
        main(args + (["--device", "cpu"] if device and side == "port" else []))
        text = capsys.readouterr().out.replace(d, "D")
        out[side] = text.replace(".eptorch", ".BUNDLE").replace(".eptpu", ".BUNDLE") \
            .replace(".empanada_torch", ".ARCHIVE").replace(".empanada_tpu", ".ARCHIVE") \
            .splitlines()
    return out


def assert_same_files(root, names):
    for name in names:
        paths = [str(root / side / name) for side in SIDES]
        if name.endswith(".npy"):
            got, want = np.load(paths[1]), np.load(paths[0])
        else:
            got, want = _pil_read(paths[1]), _pil_read(paths[0])
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def assert_same_stores(root, name):
    """Every array of two chunked stores equal (the port reads both)."""
    arrays = {}
    for side in SIDES:
        base = root / side / name
        arrays[side] = {os.path.relpath(p, base): np.asarray(open_chunked(p)[:])
                        for p, _, files in os.walk(base) if ".zarray" in files}
    assert sorted(arrays["port"]) == sorted(arrays["jax"]) and arrays["jax"]
    for key, want in arrays["jax"].items():
        got = arrays["port"][key]
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)


INFER2D = {
    "plain": (["{d}/img.npy", "-o", "{d}/pan.npy"], ["pan.npy"]),
    "tiled_tiff": (["{d}/img.npy", "-o", "{d}/pan_tiled.tiff", "--tile-size", "64"],
                   ["pan_tiled.tiff"]),
    "roi_png": (["{d}/img.png", "-o", "{d}/pan_roi.png", "--roi", "16:80,32:96"],
                ["pan_roi.png"]),
    "roi_mask": (["{d}/img.npy", "-o", "{d}/pan_mask.npy", "--roi-mask", "{d}/mask.npy"],
                 ["pan_mask.npy"]),
    "two_models": (["{d}/img.npy", "-o", "{d}/pan_mm.tif", "--model",
                    "{d}/tiny_model_b.yaml"],
                   ["pan_mm.tif", "pan_mm_tiny_model.tif", "pan_mm_tiny_model_b.tif"]),
}


@pytest.mark.parametrize("case", list(INFER2D))
def test_infer2d(case, root, capsys):
    argv, files = INFER2D[case]
    out = run_both(root, capsys, ["infer2d", "--model", "{d}/tiny_model.yaml"] + argv)
    assert out["port"] == out["jax"]
    assert re.search(r"\(96, 96\), \d+ instances", out["port"][-1])
    assert_same_files(root, files)


FLAT3D = ["--model", "{d}/tiny_model.yaml", "--median-slices", "1", "--min-size", "0",
          "--min-extent", "0"]
INFER3D = {
    "stack_tiff": (["{d}/vol.tif", "-o", "{d}/seg_{class}.tiff"], ["seg_mito.tiff"], None),
    "multichip_xz": (["{d}/vol.npy", "-o", "{d}/mc_{class}.npy", "--multichip", "--axis",
                      "xz"],
                  ["mc_mito.npy"], None),
    "ortho_store_resume": (["{d}/vol.npy", "--orthoplane", "--multichip", "--store",
                            "{d}/ortho.zarr", "--save-panoptic", "--allow-one-view",
                            "--checkpoint-dir", "{d}/ckpt", "--checkpoint-every", "2",
                            "--resume"], [], "ortho.zarr"),
    "two_models": (["{d}/vol.npy", "-o", "{d}/mm_{class}.npy", "--model",
                    "{d}/tiny_model_b.yaml", "--multichip"],
                   ["mm_tiny_model_mito.npy", "mm_tiny_model_b_nuclei.npy"], None),
}


@pytest.mark.parametrize("case", list(INFER3D))
def test_infer3d(case, root, capsys):
    argv, files, store = INFER3D[case]
    out = run_both(root, capsys, ["infer3d"] + FLAT3D + argv)
    assert out["port"] == out["jax"]
    assert any(re.match(r"class .*: \d+ instances", line) for line in out["port"])
    assert_same_files(root, files)
    if store:
        assert_same_stores(root, store)


def _dump(path, vol):
    """An xy tracker dump of a (Z, H, W) id volume (the JAX package's)."""
    tracker = InstanceTracker(1, 1000, vol.shape, "xy")
    for z in range(vol.shape[0]):
        tracker.update(pan_seg_to_rle_seg(vol[z], [1], 1000, [1], force_connected=False)[1], z)
    tracker.finish()
    tracker.write_to_json(str(path))


def test_evaluate(root, capsys):
    rng = np.random.default_rng(0)
    vol = np.zeros((6, 40, 40), np.int64)
    for i in range(8):
        z, y, x = rng.integers(0, 4), rng.integers(0, 32), rng.integers(0, 32)
        vol[z:z + 2, y:y + 7, x:x + 6] = 1001 + i
    pred = vol.copy()
    pred[np.isin(pred, [1002, 1005])] = 0
    pred[:, :, 35:] = 1009
    for side in SIDES:
        _dump(root / side / "gt.json", vol)
        _dump(root / side / "pred.json", pred)
    for a, b in (("gt", "gt"), ("gt", "pred")):
        out = run_both(root, capsys, ["evaluate", f"{{d}}/{a}.json", f"{{d}}/{b}.json"],
                       device=False)
        got, want = (json.loads("\n".join(out[s])) for s in ("port", "jax"))
        assert list(got) == list(want)
        direct = default_evaluator()(str(root / "port" / f"{a}.json"),
                                     str(root / "port" / f"{b}.json"))
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-12 and abs(got[k] - float(direct[k])) <= 1e-12
        if a == b:
            assert all(got[k] == 1.0 for k in got if k != "pq")
            assert abs(got["pq"] - 1.0) < 1e-4  # sq's 1e-5 in its denominator
        else:
            assert got["f1_50"] < 1.0


LABELS = {
    "count": (["count", "{d}/seg.npy", "-o", "{d}/counts.csv"], ["counts.csv"]),
    "count_divisor": (["count", "{d}/seg.npy", "--label-divisor", "1000"], []),
    "small": (["small", "{d}/seg.npy", "-o", "{d}/filt.npy", "--min-area", "8"],
              ["filt.npy"]),
    "boundary_png": (["boundary", "{d}/seg.npy", "-o", "{d}/nb.png"], ["nb.png"]),
    "patches_tiff": (["small", "{d}/seg3.tif", "-o", "{d}/filt3.tif", "--mode", "patches",
                      "--min-area", "8"], ["filt3.tif"]),
}


@pytest.mark.parametrize("case", list(LABELS))
def test_labels(case, root, capsys):
    argv, files = LABELS[case]
    out = run_both(root, capsys, ["labels"] + argv, device=False)
    assert out["port"] == out["jax"] and out["port"]
    for name in files:
        if name.endswith(".csv"):
            texts = [(root / side / name).read_text() for side in SIDES]
            assert texts[0] == texts[1]
        else:
            assert_same_files(root, [name])


def test_tiles_chop_merge(root, capsys):
    out = run_both(root, capsys, ["tiles", "chop", "--image", "{d}/big.tiff", "--mask",
                                  "{d}/big_mask.tiff", "--dir", "{d}/tiles", "--patch-size",
                                  "48"], device=False)
    assert out["port"] == out["jax"]
    names = sorted(os.listdir(root / "jax" / "tiles" / "im"))
    assert names == sorted(os.listdir(root / "port" / "tiles" / "im")) and len(names) == 6
    assert_same_files(root, [f"tiles/{sub}/{n}" for sub in ("im", "msk") for n in names])
    out = run_both(root, capsys, ["tiles", "merge", "--dir", "{d}/tiles", "--out",
                                  "{d}/merged"], device=False)
    assert out["port"] == out["jax"]
    assert_same_files(root, ["merged/merged_image.tiff", "merged/merged_mask.tiff"])
    np.testing.assert_array_equal(_pil_read(root / "port" / "merged" / "merged_image.tiff"),
                                  _pil_read(root / "port" / "big.tiff"))


def test_docs(root, capsys):
    out = run_both(root, capsys, ["docs"], device=False)
    assert out["port"] == out["jax"] and len(out["port"]) > 10


# the world flags (tests/test_torch_parallel.py drives them) exit on a
# half-given world before any file is read
UNPORTED = {
    "spatial_shard": (["infer2d", "x.npy", "--spatial-shard", "--spatial-halo", "6"],
                      "multiple of 4"),
    "coordinator": (["infer3d", "x.npy", "--coordinator", "localhost:1234"],
                    "needs --num-processes"),
    "num_processes": (["infer3d", "x.npy", "--num-processes", "2"], "needs --coordinator"),
    "train_multichip": (["train", "x.yaml", "--multichip", "--process-id", "1"],
                        "needs --coordinator"),
    "deploy": (["models", "deploy", "--name", "MitoNet_v1", "--path", "x"], "item 13"),
    "serve": (["serve", "a.bin", "x.npy"], "item 13"),
    "export_quantize": (["models", "export", "--name", "MitoNet_v1", "--path", "x",
                         "--quantize"], "item 13"),
    "port_quantize": (["port", "x.pth", "--quantize"], "item 13"),
    "bench": (["bench", "--skip-3d"], "item 13"),
}


@pytest.mark.parametrize("case", list(UNPORTED))
def test_unported_flags_exit_naming_their_item(case):
    argv, item = UNPORTED[case]
    with pytest.raises(SystemExit, match=item) as e:
        port_main(argv + (["--device", "cpu"] if argv[0] in ("infer2d", "infer3d", "train")
                          else []))
    assert e.value.code not in (0, None)


def test_without_a_gpu_a_command_names_the_device_flag(root):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the command runs on it")
    with pytest.raises(SystemExit, match="--device cpu"):
        port_main(["infer2d", str(root / "port" / "img.npy"), "--model",
                   str(root / "port" / "tiny_model.yaml")])

