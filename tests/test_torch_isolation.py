"""Isolation of the PyTorch port: every module of empanada_tpu_torch, and
chip_smoke.py, imports with jax, flax, empanada_tpu, cv2, networkx, PIL
and zarr blocked (the card's machine has none of the last four), and the
port's native host library builds and loads there too, as the command
line's file and curation commands run; the port's modules
import nothing beyond the standard library, torch, numpy, scipy and yaml;
the entry points default to CUDA and raise, naming device="cpu", when there
is no GPU, and so does ``python -m empanada_tpu_torch``, naming ``--device
cpu``; chip_smoke.py fails without a GPU and without the package beside
it."""

import ast
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from empanada_tpu_torch import resolve_device
from empanada_tpu_torch.api import Engine2d, Engine3d, init_model_from_config, load_config
from empanada_tpu_torch.api.utils import CONFIG_DIR
from empanada_tpu_torch.engine import (
    BCEngine,
    BCEngine3d,
    PanopticDeepLabEngine,
    PanopticDeepLabEngine3d,
    PanopticDeepLabRenderEngine,
    PanopticDeepLabRenderEngine3d,
)
from empanada_tpu_torch.models import create_model
from empanada_tpu_torch.parallel import SpatialEngine2d, create_mesh, initialize_multihost
from empanada_tpu_torch.parallel.data_parallel import MultiChipEngine3d

from _torch_port import SMALL_PR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORTS = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "flax", "empanada_tpu", "cv2", "networkx", "PIL", "zarr")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    for m in list(sys.modules):
        if m.split(".")[0] in BLOCKED:
            del sys.modules[m]

    import empanada_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(empanada_tpu_torch.__path__,
                                                   "empanada_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    from empanada_tpu_torch.core import native
    native.load()  # the host library builds from the port's own source
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    for new in ("api.config", "core.chunked", "stitch.tile", "stitch.filters",
                "models.regnet", "models.panoptic_bifpn", "stitch.watershed", "cli",
                "__main__", "eval.evaluator", "eval.metrics", "curation.ops",
                "curation.tiles", "curation.patches", "curation.export", "api.export",
                "port.torch_port", "data.imwrite", "parallel", "parallel.mesh",
                "parallel.multihost", "parallel.spatial", "parallel.data_parallel"):
        assert f"empanada_tpu_torch.{new}" in names, new
    from empanada_tpu_torch.api import Engine2d, Engine3d
    from empanada_tpu_torch.data.volume import resize_by_factor
    # the command line and the curation layer run with PIL and the rest blocked
    import contextlib, io, os, tempfile
    import numpy as np
    from empanada_tpu_torch.cli import main
    from empanada_tpu_torch.data.imread import imread
    d = tempfile.mkdtemp()
    seg = np.zeros((40, 40), np.int64)
    seg[0:9, 2:9], seg[20:30, 5:15] = 10001, 10002
    np.save(os.path.join(d, "seg.npy"), seg)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        main(["labels", "boundary", os.path.join(d, "seg.npy"), "-o", os.path.join(d, "nb.tif")])
        main(["tiles", "chop", "--image", os.path.join(d, "nb.tif"), "--dir",
              os.path.join(d, "t"), "--patch-size", "16"])
        main(["tiles", "merge", "--dir", os.path.join(d, "t"), "--out", os.path.join(d, "m")])
        main(["models", "list"])
    assert (imread(os.path.join(d, "m", "merged_image.tiff")) == np.where(
        seg == 10002, seg, 0)).all(), out.getvalue()
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("imported", len(names), "modules")
""")


def _run(args, cwd):
    env = dict(os.environ)
    if cwd == REPO:
        env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_port_imports_nothing_of_jax_or_the_jax_package():
    proc = _run(["-c", _BLOCKED_IMPORTS], REPO)
    assert proc.returncode == 0, proc.stderr
    n = int(proc.stdout.split()[1])
    assert n >= 76  # every module of the port, not an empty walk


ALLOWED_IMPORTS = {"torch", "numpy", "scipy", "yaml", "empanada_tpu_torch"}


def test_port_imports_only_torch_numpy_scipy_yaml():
    """Static check of every import statement in the port (and in
    chip_smoke.py): the standard library, torch, numpy, scipy, yaml and the
    port itself."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "empanada_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    allowed = ALLOWED_IMPORTS | set(sys.stdlib_module_names) | {"__future__"}
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = [node.module.split(".")[0]]
            else:
                continue
            bad += [(os.path.relpath(path, REPO), t) for t in tops if t not in allowed]
    assert len(files) >= 35 and not bad, bad


def test_config_is_the_ports_own():
    assert os.path.commonpath([CONFIG_DIR, os.path.join(REPO, "empanada_tpu_torch")]) == \
        os.path.join(REPO, "empanada_tpu_torch")
    cfg = load_config("MitoNet_v1")
    assert cfg["arch"] == "PanopticDeepLabPR"
    assert cfg["model_kwargs"]["encoder"] == "resnet50"
    assert cfg["model_kwargs"]["subdivision_num_points"] == 8192
    mini = load_config("MitoNet_v1_mini")
    assert (mini["arch"], mini["model_kwargs"]["encoder"], mini["padding_factor"]) == (
        "PanopticBiFPNPR", "regnety_6p4gf", 128)
    assert mini["model"].endswith(".eptorch")


def test_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry points run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model("PanopticDeepLabPR", **SMALL_PR)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_model_from_config(load_config("MitoNet_v1"), seed=0)
    model = create_model("PanopticDeepLabPR", device="cpu", **SMALL_PR)
    for engine in (PanopticDeepLabRenderEngine, PanopticDeepLabRenderEngine3d,
                   PanopticDeepLabEngine, PanopticDeepLabEngine3d):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            engine(model, thing_list=[1])
    for engine in (BCEngine, BCEngine3d):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            engine(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model("PanopticBiFPNPR", encoder="regnety_200mf", fpn_dim=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiChipEngine3d(load_config("MitoNet_v1"), model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpatialEngine2d(model, thing_list=[1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        initialize_multihost("127.0.0.1:1234", 2, 0)
    for engine in (Engine2d, Engine3d):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            engine(load_config("MitoNet_v1"), model=model)
    assert resolve_device("cpu") == torch.device("cpu")


def test_cli_without_a_gpu_names_the_device_flag(tmp_path):
    """``python -m empanada_tpu_torch infer2d`` without ``--device`` runs on
    the card; without one it exits non-zero and names ``--device cpu``."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the command runs on it")
    import numpy as np

    np.save(tmp_path / "img.npy", np.zeros((64, 64), np.uint8))
    env = dict(os.environ, HOME=str(tmp_path),
               PYTHONPATH=os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-m", "empanada_tpu_torch", "infer2d",
                           str(tmp_path / "img.npy"), "-o", str(tmp_path / "pan.npy")],
                          cwd=str(tmp_path), env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and "--device cpu" in proc.stderr
    assert not (tmp_path / "pan.npy").exists()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_gpu_or_the_package(alone, tmp_path):
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], str(tmp_path) if alone else REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    if not torch.cuda.is_available():
        assert "torch.cuda.is_available() is false" in proc.stderr
