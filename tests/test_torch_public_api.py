"""The port's public names: every name of every ``__all__`` of the JAX
package imports from the port's module of the same path, except a written
list of names that exist for the TPU alone.  Then the names this slice added are held to the JAX
functions on the same inputs, and ``MultiChipEngine3d`` takes JAX's
arguments (the config's bundle when no model is given, the transfer
knobs, other keywords)."""

import ast
import importlib
import os

import numpy as np
import pytest
import torch

from _torch_port import SMALL_PR, jax_init, one_torch_thread, port_model  # noqa: F401
from conftest import make_blob_image
from empanada_tpu.core import boxes as jax_boxes
from empanada_tpu.ops import interpolate as jax_interp
from empanada_tpu.ops import postprocess as jax_pp
from empanada_tpu.ops import select as jax_select
from empanada_tpu.stitch import matcher as jax_matcher
from empanada_tpu.stitch import patterns as jax_patterns
from empanada_tpu.stitch import rle_seg as jax_rle_seg
from empanada_tpu_torch import api
from empanada_tpu_torch.core import boxes
from empanada_tpu_torch.core.labeling import FlatInstances
from empanada_tpu_torch.ops import interpolate, select
from empanada_tpu_torch.ops import postprocess as pp
from empanada_tpu_torch.parallel.data_parallel import MultiChipEngine3d
from empanada_tpu_torch.stitch import matcher, patterns, rle_seg
from test_torch_ortho import _volume, assert_same_trackers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# names of the JAX package that exist for the TPU alone, each with its reason
TPU_ONLY = {
    "empanada_tpu.models.blocks.s2d_stem_supported":
        "space-to-depth stem: a layout for the TPU's matrix unit; the port's stem is a "
        "plain strided convolution",
    "empanada_tpu.models.blocks.s2d_stride2_conv": "as s2d_stem_supported",
    "empanada_tpu.ops.pallas_pointrend":
        "the Pallas refine kernel's module; its Hopper kernel is ops/pointrend_refine.py",
    "empanada_tpu.ops.select.top_k_neg_bf16_indices":
        "a packed single-operand top-k for the TPU's sort (fault C4 of the port's notes); "
        "the port takes torch.topk",
}


def _jax_exports() -> dict:
    """{module path: its __all__} of every module of the JAX package that
    declares one (read from the sources)."""
    out = {}
    for root, _, files in os.walk(os.path.join(REPO, "empanada_tpu")):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            for node in ast.parse(open(path).read()).body:
                if isinstance(node, ast.Assign) and any(
                        getattr(t, "id", None) == "__all__" for t in node.targets):
                    mod = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
                    out[mod.removesuffix(".__init__")] = ast.literal_eval(node.value)
    return out


EXPORTS = _jax_exports()


def test_the_walk_finds_the_packages():
    assert len(EXPORTS) >= 60
    assert {"empanada_tpu.api", "empanada_tpu.core", "empanada_tpu.stitch",
            "empanada_tpu.data", "empanada_tpu.ops", "empanada_tpu.port",
            "empanada_tpu.utils"} <= set(EXPORTS)


@pytest.mark.parametrize("module", sorted(EXPORTS))
def test_every_jax_name_imports_from_the_port(module):
    if module in TPU_ONLY:
        pytest.skip(TPU_ONLY[module])
    port = importlib.import_module(module.replace("empanada_tpu", "empanada_tpu_torch", 1))
    missing = [n for n in EXPORTS[module]
               if f"{module}.{n}" not in TPU_ONLY and not hasattr(port, n)]
    assert not missing, missing


# ---- the names added, against JAX's functions ---------------------------


def test_box_helpers_match_jax():
    rng = np.random.default_rng(0)
    lo = rng.integers(0, 50, (12, 2))
    b = np.concatenate([lo, lo + rng.integers(1, 20, (12, 2))], axis=1)
    np.testing.assert_array_equal(boxes.box_area(b), jax_boxes.box_area(b))
    np.testing.assert_array_equal(boxes.box_intersection(b, b[:5]),
                                  jax_boxes.box_intersection(b, b[:5]))
    for got, want in zip(boxes.box_iou(b, return_intersection=True),
                         jax_boxes.box_iou(b, return_intersection=True)):
        np.testing.assert_array_equal(got.toarray(), want.toarray())
    assert boxes.box_iou(b[:0], b).shape == (0, 12)


@pytest.mark.parametrize("mode,align", [("bilinear", False), ("bilinear", True),
                                        ("nearest", False)])
def test_grid_sample_matches_jax(mode, align):
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(2, 9, 11, 3)).astype(np.float32)
    coords = rng.uniform(-1.2, 1.2, (2, 40, 2)).astype(np.float32)
    coords[0, :4] = [[-1, -1], [1, 1], [0, 0], [1 / 11, -1 / 9]]
    got = interpolate.grid_sample(torch.from_numpy(feats), torch.from_numpy(coords), mode,
                                  align).numpy()
    want = np.asarray(jax_interp.grid_sample(feats, coords, mode, align))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [5, 100, 256, 300])
def test_top_k_mask_indices_matches_jax(k):
    rng = np.random.default_rng(2)
    x = rng.integers(0, 40, (3, 256)).astype(np.float32)  # many ties
    got = select.top_k_mask_indices(torch.from_numpy(x), k).numpy()
    want = np.asarray(jax_select.top_k_mask_indices(x, k))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _slices(seed):
    img = make_blob_image((48, 64), n_blobs=6, seed=seed).astype(np.int32)
    pan = np.where(img < 110, 1001 + (img // 40), 0).astype(np.int32)
    pan[:, :8] = 2000  # a stuff class
    return pan


def test_rle_helpers_and_matchers_match_jax():
    labels, thing = [1, 2], [1]
    segs = []
    for mod in (rle_seg, jax_rle_seg):
        out = []
        for seed in (3, 4, 5):
            pan = _slices(seed)
            packed = np.asarray(jax_pp.encode_runs_packed(pan[None], 64))[0]
            np.testing.assert_array_equal(
                pp.encode_runs_packed(torch.from_numpy(pan[None]), 64)[0].numpy(), packed)
            out.append(mod.packed_to_rle_seg(packed, pan.shape[1], labels, 1000, thing))
            short = np.asarray(jax_pp.encode_runs_packed(pan[None], 2))[0]
            assert mod.packed_to_rle_seg(short, pan.shape[1], labels, 1000, thing) is None
        segs.append(out)
    for got, want in zip(*segs):
        _same_rle_seg(got, want)
    a, b = sorted(segs[0][0][1].items())[:2]
    got = matcher.merge_attrs(a[1], b[1])
    want = jax_matcher.merge_attrs(a[1], b[1])
    assert got["box"] == want["box"]
    np.testing.assert_array_equal(got["starts"], want["starts"])
    np.testing.assert_array_equal(got["runs"], want["runs"])

    last = []
    for mod in (patterns, jax_patterns):
        matchers = mod.create_matchers(thing, 1000, 0.25, 0.25)
        for seg in [dict(s) for s in segs[0]]:
            mod.apply_matchers(seg, matchers)
        last.append(seg)
    _same_rle_seg(*last)


def _same_rle_seg(got, want):
    assert sorted(got) == sorted(want)
    for c in want:
        assert list(got[c]) == list(want[c])
        for k in want[c]:
            assert tuple(got[c][k]["box"]) == tuple(want[c][k]["box"])
            np.testing.assert_array_equal(got[c][k]["starts"], want[c][k]["starts"])
            np.testing.assert_array_equal(got[c][k]["runs"], want[c][k]["runs"])


def test_axis_trackers_and_filters_match_jax():
    shape = (4, 48, 64)
    out = {}
    for name, mod in (("port", patterns), ("jax", jax_patterns)):
        trackers = mod.create_axis_trackers(["xy", "yz"], [1, 2], 1000, shape)
        assert sorted(trackers) == ["xy", "yz"] and len(trackers["xy"]) == 2
        tracker = trackers["xy"][0]
        for z, seed in enumerate((3, 4, 5, 6)):
            seg = (rle_seg if name == "port" else jax_rle_seg).pan_seg_to_rle_seg(
                _slices(seed), [1], 1000, [1])
            tracker.update(FlatInstances.from_dict(seg[1]) if name == "port" else seg[1], z)
        tracker.finish()
        mod.apply_filters(tracker, [{"name": "remove_small_objects", "min_size": 40},
                                    {"name": "remove_pancakes", "min_span": 2}])
        mod.apply_filters(tracker, None)
        out[name] = [tracker]
    assert_same_trackers(out["port"], out["jax"])


# ---- MultiChipEngine3d ----------------------------------------------------


CFG = {"model_name": "tiny", "class_names": {1: "mito"}, "labels": [1], "thing_list": [1],
       "padding_factor": 16, "norms": {"mean": 0.57571, "std": 0.12765}}
KW3D = dict(median_kernel_size=3, min_size=10, min_extent=1, max_centers=32,
            confidence_thr=0.5, batch_size=2, save_panoptic=True)


def test_multichip_engine_takes_jax_arguments(tmp_path):
    """No model: the config's bundle; ``transfer_compaction=False`` (dense
    maps) and a ``max_runs_per_row`` that overflows (the per-slice
    fallback) give the packed path's result; other keywords are taken."""
    _, variables = jax_init("PanopticDeepLabPR", SMALL_PR, size=64)
    tmodel = port_model("PanopticDeepLabPR", SMALL_PR, variables)
    bundle = api.save_model_bundle(str(tmp_path / "tiny"), "PanopticDeepLabPR", SMALL_PR,
                                   tmodel)
    cfg = dict(CFG, model=bundle)
    vol = _volume((5, 48, 64), seed=8)
    want_stack, want = MultiChipEngine3d(cfg, tmodel, device="cpu",
                                         **KW3D).infer_on_axis(vol, "xy")
    for kw in (dict(), dict(transfer_compaction=False),
               dict(max_runs_per_row=1, sweep_fused=False),
               dict(shape_buckets=True, drain_async=False)):
        eng = MultiChipEngine3d(cfg, device="cpu", **KW3D, **kw)
        assert next(eng.model.parameters()).dtype == torch.float32
        stack, trackers = eng.infer_on_axis(vol, "xy")
        np.testing.assert_array_equal(stack, want_stack)
        assert_same_trackers(trackers, want)
    assert MultiChipEngine3d(cfg, device="cpu", max_runs_per_row=1)._max_runs(64) == 1
    assert MultiChipEngine3d(cfg, device="cpu", transfer_compaction=False)._max_runs(64) == 0
