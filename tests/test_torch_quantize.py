"""int8 bundles and the URL cache of the port (``api/utils.py``) against
the JAX package's (``empanada_tpu/api/utils.py``), on the CPU.

The JAX package quantizes each float leaf of ndim >= 2 and >= 4096
elements per channel of its last axis; the port quantizes the same
tensors per output channel of its own layouts (axis 0 of OIHW and (out,
in) weights, axis 1 of a transposed convolution's (in, out, kh, kw)).
The quantized names must map one-to-one through the weight bridge, and
each dequantized tensor must equal the bridge's image of JAX's dequantized
leaf bit for bit, for every architecture of the registry.  The cache is
driven over ``file://`` URLs in temporary directories only."""

import hashlib
import io
import json
import os
import zipfile

import numpy as np
import pytest
import torch
import yaml

from _torch_port import SMALL_PR, jax_init, one_torch_thread, port_model  # noqa: F401
from conftest import make_blob_image
from empanada_tpu import api as jax_api
from empanada_tpu.api import utils as jax_utils
from empanada_tpu_torch import api
from empanada_tpu_torch.api import utils
from empanada_tpu_torch.cli import main as port_main
from empanada_tpu_torch.models import MODEL_REGISTRY, create_model
from empanada_tpu_torch.port.weights import flatten_variables, flax_key, from_flax
from test_torch_bifpn import ALL_ARCHS

CFG = {"model_name": "tiny", "class_names": {1: "mito"}, "labels": [1], "thing_list": [1],
       "padding_factor": 16, "norms": {"mean": 0.57571, "std": 0.12765}}
KW2D = dict(nms_kernel=3, max_centers=32, confidence_thr=0.5)


def _jax_quantized_names(qtree) -> set:
    """State-dict keys of the leaves JAX quantized (a dict with the int8
    marker), through the bridge."""
    out = set()
    for path, _ in flatten_variables(qtree).items():
        if path[-1] == jax_utils._QUANT_KEY:
            out.add(flax_key(path[:-1]))
    return out


@pytest.mark.parametrize("arch", sorted(ALL_ARCHS))
def test_dequantized_tensors_equal_jax_through_the_bridge(arch):
    assert sorted(MODEL_REGISTRY) == sorted(ALL_ARCHS)
    kw, size = ALL_ARCHS[arch]
    _, variables = jax_init(arch, kw, size=size)
    tmodel = create_model(arch, device="cpu", **kw)
    qtree = jax_utils._quantize_variables(variables)
    want = from_flax(_to_numpy(jax_utils._dequantize_tree(qtree, np.float32)), tmodel)

    state = from_flax(variables, tmodel)
    q = utils.quantize_state_dict(state, utils._output_axes(tmodel))
    names = {k for k in q if k + utils.SCALE_SUFFIX in q}
    assert names == _jax_quantized_names(qtree) and names
    for name in names:
        assert q[name].dtype == torch.int8 and q[name].abs().max() <= 127
    got = utils.dequantize_state_dict(q)
    assert sorted(got) == sorted(state)
    for k, v in got.items():
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
    tconvs = [k for k in utils._output_axes(tmodel) if k in names]
    if arch.startswith("PanopticBiFPN"):
        assert tconvs  # a transposed convolution, quantized along axis 1
        for k in tconvs:
            assert q[k + utils.SCALE_SUFFIX].shape == (1, q[k].shape[1], 1, 1)


def _to_numpy(tree):
    if hasattr(tree, "items"):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """(tmp dir, JAX model + variables, port model, float bundle, int8
    bundle) of the small PanopticDeepLabPR."""
    d = tmp_path_factory.mktemp("q")
    model, variables = jax_init("PanopticDeepLabPR", SMALL_PR, size=64)
    tmodel = port_model("PanopticDeepLabPR", SMALL_PR, variables)
    plain = utils.save_model_bundle(str(d / "plain"), "PanopticDeepLabPR", SMALL_PR, tmodel)
    q = utils.save_model_bundle(str(d / "q"), "PanopticDeepLabPR", SMALL_PR, tmodel,
                                quantize=True)
    return d, (model, variables), tmodel, plain, q


def test_bundle_format_and_size(bundles):
    d, _, tmodel, plain, q = bundles
    with zipfile.ZipFile(q) as zf:
        meta = json.loads(zf.read("config.json"))
        assert all(i.compress_type == zipfile.ZIP_STORED for i in zf.infolist())
        state = torch.load(io.BytesIO(zf.read("state_dict.pt")), weights_only=True)
    assert meta["quantized"] is True and meta["format"] == utils.BUNDLE_FORMAT
    int8 = [k for k, v in state.items() if v.dtype == torch.int8]
    assert int8 and all(state[k + utils.SCALE_SUFFIX].dtype == torch.float32 for k in int8)
    ratio = os.path.getsize(plain) / os.path.getsize(q)
    assert ratio > 3.0, ratio
    loaded = utils.load_model_bundle(q, device="cpu", dtype=torch.bfloat16)
    assert next(loaded.parameters()).dtype == torch.bfloat16
    deq = utils.dequantize_state_dict(state)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, deq[k].to(torch.bfloat16)), k


def test_quantized_engine_matches_jax(bundles):
    """The port's engine on its int8 bundle equals JAX's engine on JAX's
    int8 bundle of the same weights."""
    d, (model, variables), _, _, q = bundles
    jq = jax_utils.save_model_bundle(str(d / "jaxq"), "PanopticDeepLabPR", SMALL_PR,
                                     variables, quantize=True)
    img = make_blob_image((96, 112), n_blobs=6, seed=41)
    got = api.Engine2d(dict(CFG, model=q), device="cpu", **KW2D).infer(img)
    want = jax_api.Engine2d(dict(CFG, model=jq), **KW2D).infer(img)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[got > 0])) >= 2


def test_requantize_bundle_is_idempotent(bundles):
    d, _, _, plain, q = bundles
    once = utils.requantize_bundle(plain, str(d / "once.eptorch"))
    twice = utils.requantize_bundle(once, str(d / "twice.eptorch"))
    assert open(once, "rb").read() == open(twice, "rb").read()
    assert utils.requantize_bundle(once, once) == once
    a = utils.load_model_bundle(once, device="cpu").state_dict()
    b = utils.load_model_bundle(q, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def _sha(path) -> str:
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def test_cache_hit_mismatch_and_corrupt_copy(bundles, tmp_path, monkeypatch):
    _, _, _, plain, _ = bundles
    src = tmp_path / "src" / "tiny.eptorch"
    src.parent.mkdir()
    src.write_bytes(open(plain, "rb").read())
    url, cache, sha = f"file://{src}", tmp_path / "cache", _sha(plain)
    monkeypatch.setenv(utils.CACHE_ENV, str(cache))

    # a hit: the second call serves the cached copy, the source gone
    first = utils.cached_model_path(url, sha256=sha)
    assert os.path.dirname(first) == str(cache) and _sha(first) == sha
    os.rename(src, src.with_suffix(".moved"))
    assert utils.cached_model_path(url, sha256=sha) == first
    os.rename(src.with_suffix(".moved"), src)

    # a sha256 mismatch raises and leaves no file
    other = f"file://{tmp_path / 'src'}/../src/tiny.eptorch"
    with pytest.raises(RuntimeError, match="sha256 mismatch"):
        utils.cached_model_path(other, sha256="0" * 64)
    assert sorted(os.listdir(cache)) == [os.path.basename(first)]

    # a corrupt cached copy is fetched again, never served
    with open(first, "r+b") as f:
        f.write(b"corrupt")
    assert _sha(first) != sha
    assert utils.cached_model_path(url, sha256=sha) == first and _sha(first) == sha


def test_config_with_a_url_loads_through_the_cache(bundles, tmp_path, monkeypatch):
    _, _, tmodel, plain, _ = bundles
    monkeypatch.setattr(utils, "MODEL_DIR", str(tmp_path / "home"))
    monkeypatch.delenv(utils.CACHE_ENV, raising=False)
    cfg = dict(CFG, model=f"file://{plain}", model_sha256=_sha(plain))
    loaded = utils.load_model_from_config(cfg, device="cpu")
    assert os.listdir(tmp_path / "home" / "downloads")
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, tmodel.state_dict()[k]), k


def test_cli_exports_and_ports_int8(bundles, tmp_path, monkeypatch, capsys):
    """``models export --quantize`` archives an int8 bundle that imports
    and loads; ``port --quantize`` writes one."""
    _, _, tmodel, plain, q = bundles
    monkeypatch.setattr(utils, "MODEL_DIR", str(tmp_path / "home"))
    utils.add_new_model("tiny", dict(CFG, model=plain, arch="PanopticDeepLabPR",
                                     model_kwargs=SMALL_PR))
    port_main(["models", "export", "--name", "tiny", "--path", str(tmp_path / "arch"),
               "--quantize"])
    archive = capsys.readouterr().out.strip()
    port_main(["models", "import", "--path", archive, "--name", "tiny_q"])
    cfg = yaml.safe_load(open(utils.get_configs()["tiny_q"]))
    want = utils.load_model_bundle(q, device="cpu").state_dict()
    got = utils.load_model_from_config(cfg, device="cpu").state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)

    from empanada_tpu_torch.port.torch_port import reference_state_dict

    torch.save(reference_state_dict(tmodel, "PanopticDeepLabPR", SMALL_PR),
               str(tmp_path / "ref.pth"))
    port_main(["port", str(tmp_path / "ref.pth"), "-o", str(tmp_path / "ported"),
               "--model", "tiny", "--quantize"])
    with zipfile.ZipFile(str(tmp_path / "ported.eptorch")) as zf:
        assert json.loads(zf.read("config.json"))["quantized"] is True
