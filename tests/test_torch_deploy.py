"""Serving artifacts of the port (``api/deploy.py``) and the refine kernel's
registered op (``ops/pointrend_refine.py``), on the CPU.

The JAX package's three cases (``tests/test_deploy.py``): the artifact's
map equals the engine's bit for bit, the shape and the dtype are enforced,
and the command line deploys and serves.  Then the op: ``torch.library``'s
``opcheck``, a program that calls it exported, saved and loaded, and the
bf16 pipeline exported through it, as it is on the card (there the op
launches the kernel; here its CPU implementation is the plain version)."""

import json
import zipfile

import numpy as np
import pytest
import torch
import yaml

from _torch_port import SMALL_PR, jax_init, one_torch_thread, port_model  # noqa: F401
from conftest import make_blob_image
from empanada_tpu_torch import api
from empanada_tpu_torch.api import Preprocessor, deploy
from empanada_tpu_torch.cli import main as port_main
from empanada_tpu_torch.engine import PanopticDeepLabRenderEngine
from empanada_tpu_torch.models import point_rend
from empanada_tpu_torch.ops import pointrend_refine as prr

CFG = {"model_name": "tiny", "class_names": {1: "mito"}, "labels": [1], "thing_list": [1],
       "padding_factor": 16, "norms": {"mean": 0.5, "std": 0.2}}
SHAPE = (64, 80)


@pytest.fixture(scope="module")
def tmodel():
    _, variables = jax_init("PanopticDeepLabPR", SMALL_PR, size=64)
    return port_model("PanopticDeepLabPR", SMALL_PR, variables)


@pytest.fixture(scope="module")
def artifact(tmodel, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("serve") / "tiny.serve")
    deploy.export_serving_artifact(CFG, path, SHAPE, platforms=("cpu",), model=tmodel,
                                   max_centers=32, confidence_thr=0.3)
    return path


def test_roundtrip_matches_engine(artifact, tmodel):
    served = api.load_serving_artifact(artifact)
    assert served.meta["model_name"] == "tiny" and served.meta["platforms"] == ["cpu"]
    assert served.meta["refine_op_calls"] == 0  # float32 on the CPU: the plain steps
    img = make_blob_image(SHAPE, n_blobs=4, seed=5)
    engine = PanopticDeepLabRenderEngine(
        tmodel, thing_list=[1], padding_factor=16, coarse_boundaries=True, max_centers=32,
        confidence_thr=0.3, nms_kernel=3, nms_threshold=0.1, device="cpu")
    want = engine(Preprocessor(**CFG["norms"])(img)["image"], size=img.shape)
    got = served(img)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[got > 0])) >= 2


def test_shape_and_dtype_enforced(artifact):
    served = api.load_serving_artifact(artifact)
    with pytest.raises(ValueError, match="specialized for"):
        served(np.zeros((96, 96), np.uint8))
    for dtype in (np.uint16, np.float32):
        with pytest.raises(ValueError, match="expects uint8"):
            served(np.zeros(SHAPE, dtype))


def test_platforms_refused(tmodel, tmp_path):
    for platforms, match in (("tpu", "JAX package"), (("cpu", "cuda"), "one device"),
                             ("rocm", "expected one of")):
        with pytest.raises(ValueError, match=match):
            deploy.export_serving_artifact(CFG, str(tmp_path / "x"), SHAPE,
                                           platforms=platforms, model=tmodel)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            deploy.export_serving_artifact(CFG, str(tmp_path / "x"), SHAPE, model=tmodel)


def test_cli_deploy_and_serve(tmodel, tmp_path, capsys):
    bundle = api.save_model_bundle(str(tmp_path / "tiny"), "PanopticDeepLabPR", SMALL_PR,
                                   tmodel)
    cfg_path = tmp_path / "tiny_model.yaml"
    cfg_path.write_text(yaml.dump(dict(CFG, model=bundle, arch="PanopticDeepLabPR",
                                       model_kwargs=SMALL_PR)))
    art = str(tmp_path / "tiny.serve")
    port_main(["models", "deploy", "--name", str(cfg_path), "--path", art,
               "--shape", "64x80", "--platforms", "cpu"])
    with zipfile.ZipFile(art) as z:
        assert sorted(z.namelist()) == ["fn.pt2", "meta.json"]
        assert json.loads(z.read("meta.json"))["input_shape"] == list(SHAPE)
    img = make_blob_image(SHAPE, n_blobs=4, seed=5)
    np.save(tmp_path / "img.npy", img)
    port_main(["serve", art, str(tmp_path / "img.npy"), "-o", str(tmp_path / "pan.npy")])
    pan = np.load(tmp_path / "pan.npy")
    assert pan.shape == SHAPE and pan.max() > 0
    assert "labeled segments" in capsys.readouterr().out
    np.testing.assert_array_equal(pan, api.load_serving_artifact(art)(img))


# ---- the registered op ---------------------------------------------------


def _op_inputs(seed=0, fdim=128, dfc=64, side=8):
    """A bf16 step's inputs: (up, thr, features, coarse, packed weights)."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).to(torch.bfloat16)

    layers = [(r(fdim, dfc, s=0.1), r(1, dfc), r(1, dfc))]
    layers += [(r(dfc, dfc, s=0.1), r(1, dfc), r(1, dfc)) for _ in range(2)]
    packed = prr.pack_weights((layers, (r(1, dfc), torch.tensor(0.3), torch.tensor(-0.1))))
    coarse = r(1, side, side, 1)
    up, thr = prr.step_inputs(coarse, 64)
    return up, thr, r(1, side, side, fdim), coarse, packed


def test_refine_op_passes_opcheck():
    up, thr, feat, coarse, packed = _op_inputs()
    args = (up, thr, feat, coarse, packed.buf, packed.in_features, packed.fc_dim,
            packed.num_fc)
    result = torch.library.opcheck(prr.refine_op, args)
    assert all(v == "SUCCESS" for v in result.values()), result
    np.testing.assert_array_equal(
        prr.refine_op(*args).float().numpy(),
        prr.refine_reference(up, thr, feat, coarse, packed).float().numpy())


class _CallsTheOp(torch.nn.Module):
    def __init__(self, packed):
        super().__init__()
        self.register_buffer("weights", packed.buf)
        self.widths = (packed.in_features, packed.fc_dim, packed.num_fc)

    def forward(self, up, thr, features, coarse):
        return prr.refine_op(up, thr, features, coarse, self.weights, *self.widths) * 2


def test_program_calling_the_op_round_trips(tmp_path):
    up, thr, feat, coarse, packed = _op_inputs(seed=1)
    program = torch.export.export(_CallsTheOp(packed), (up, thr, feat, coarse), strict=False)
    targets = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert torch.ops.empanada_tpu_torch.pointrend_refine.default in targets
    torch.export.save(program, str(tmp_path / "op.pt2"))
    loaded = torch.export.load(str(tmp_path / "op.pt2"))
    got = loaded.module()(*_op_inputs(seed=2)[:4])
    up2, thr2, feat2, coarse2, _ = _op_inputs(seed=2)
    want = prr.refine_reference(up2, thr2, feat2, coarse2, packed) * 2
    assert torch.equal(got, want)


def test_bf16_pipeline_exports_through_the_op(monkeypatch, tmp_path):
    """The card's path on the CPU: a bf16 model whose point head the kernel
    takes (F = 128), its refine steps sent to the op as on a CUDA tensor
    (``PointRendSemSegHead.step`` and ``refine`` patched to skip the CPU's
    plain branch).  The export freezes the packed weights, calls the op
    once a step, and serves the eager pipeline's map."""
    kw = dict(SMALL_PR, decoder_channels=128)
    _, variables = jax_init("PanopticDeepLabPR", kw, size=64)
    model = port_model("PanopticDeepLabPR", kw, variables, dtype=torch.bfloat16)

    def step(self, sem, coarse, features):
        h2, w2 = 2 * sem.shape[1], 2 * sem.shape[2]
        assert self._fused_step_ok(h2, w2, features, sem.dtype)
        fdim = features.shape[-1]
        return prr.fused_refine_step(sem, features.contiguous(),
                                     coarse.to(features.dtype).contiguous(),
                                     self.point_head.packed_weights(fdim),
                                     self.subdivision_num_points)

    def refine(up, thr, features, coarse, packed):
        return prr.refine_op(up, thr, features, coarse, packed.buf, packed.in_features,
                             packed.fc_dim, packed.num_fc)

    monkeypatch.setattr(point_rend.PointRendSemSegHead, "step", step)
    monkeypatch.setattr(prr, "refine", refine)
    path = str(tmp_path / "bf16.serve")
    deploy.export_serving_artifact(CFG, path, SHAPE, platforms="cpu", model=model,
                                   max_centers=32, compute_dtype=torch.bfloat16)
    served = api.load_serving_artifact(path)
    assert served.meta["refine_op_calls"] == 2 and served.meta["compute_dtype"] == "bfloat16"
    assert model.semantic_pr.point_head._frozen is None  # the export froze a copy
    img = make_blob_image(SHAPE, n_blobs=4, seed=6)
    engine = PanopticDeepLabRenderEngine(
        model, thing_list=[1], padding_factor=16, coarse_boundaries=True, max_centers=32,
        confidence_thr=0.3, nms_kernel=3, device="cpu")
    want = engine(Preprocessor(**CFG["norms"])(img)["image"], size=img.shape)
    np.testing.assert_array_equal(served(img), want)
