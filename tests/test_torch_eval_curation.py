"""The port's ``eval/`` and ``curation/`` (and ``stitch/matcher.py``'s
``rle_matcher``) against the JAX package's on the same seeded numpy inputs,
the cases of ``tests/test_eval_curation.py`` and more as parametrised
cases: arrays equal exactly, metrics within 1e-12, written files (CSV,
TIFF) read back equal."""

import csv
import os

import numpy as np
import pytest
from PIL import Image

import empanada_tpu.curation as JC
import empanada_tpu.eval as JE
import empanada_tpu_torch.curation as C
import empanada_tpu_torch.eval as E
from empanada_tpu.stitch import pan_seg_to_rle_seg
from empanada_tpu.stitch.matcher import rle_matcher as jax_rle_matcher
from empanada_tpu.stitch.tracker import InstanceTracker as JaxTracker
from empanada_tpu_torch.core.labeling import FlatInstances
from empanada_tpu_torch.stitch.matcher import rle_matcher, rle_matcher_flat
from empanada_tpu_torch.stitch.rle_seg import pan_seg_to_rle_seg as port_rle_seg
from empanada_tpu_torch.stitch.tracker import InstanceTracker


def same(got, want, tol=1e-12):
    """Recursive equality: arrays exactly (dtype too), floats within tol."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            same(got[k], want[k], tol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w, tol)
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, (float, np.floating)):
        assert abs(float(got) - float(want)) <= tol, (got, want)
    else:
        assert got == want


def _blocks(shape, n, seed, base=1001):
    """A label volume (or image) of n random boxes."""
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.int64)
    for i in range(n):
        lo = [int(rng.integers(0, max(1, s - 4))) for s in shape]
        ext = [int(rng.integers(1, max(2, s // 3))) for s in shape]
        vol[tuple(slice(a, a + e) for a, e in zip(lo, ext))] = base + i
    return vol


def _jax_dump(path, vol):
    tracker = JaxTracker(1, 1000, vol.shape, "xy")
    for z in range(vol.shape[0]):
        tracker.update(pan_seg_to_rle_seg(vol[z], [1], 1000, [1], force_connected=False)[1], z)
    tracker.finish()
    tracker.write_to_json(str(path))


def _port_dump(path, vol):
    tracker = InstanceTracker(1, 1000, vol.shape, "xy")
    for z in range(vol.shape[0]):
        rle = port_rle_seg(vol[z], [1], 1000, [1], force_connected=False).get(1, {})
        tracker.update(FlatInstances.from_dict(rle), z)
    tracker.finish()
    tracker.write_to_json(str(path))


def _pred(vol, case):
    pred = vol.copy()
    if case == "perfect":
        return pred
    if case == "half":
        pred[np.isin(pred, np.unique(pred)[1::2])] = 0
    elif case == "shifted":
        pred = np.roll(pred, 2, axis=2)
    elif case == "merged":
        pred[pred > 0] = 1001
    elif case == "empty":
        pred[:] = 0
    return pred


# ---- eval ------------------------------------------------------------------


@pytest.mark.parametrize("case", ["perfect", "half", "shifted", "merged", "empty"])
def test_evaluator(case, tmp_path):
    vol = np.zeros((4, 20, 20), np.int64)
    vol[:, 2:8, 2:8] = 1001
    vol[:, 12:18, 12:18] = 1002
    vol[1:3, 9:12, 1:19] = 1003
    vol = np.where(vol > 0, vol, _blocks((4, 20, 20), 3, 5, base=1004))
    gt, pred = tmp_path / "gt.json", tmp_path / "pred.json"
    _jax_dump(gt, vol)
    _jax_dump(pred, _pred(vol, case))
    port_gt = tmp_path / "port_gt.json"
    _port_dump(port_gt, vol)
    assert port_gt.read_text() == gt.read_text()  # the port's dumps are JAX's
    got, got_inst = E.default_evaluator()(str(gt), str(pred), return_instances=True)
    want, want_inst = JE.default_evaluator()(str(gt), str(pred), return_instances=True)
    same(got, want)
    same(got_inst, want_inst)
    if case == "perfect":
        assert got["f1_50"] == 1.0 and abs(got["pq"] - 1.0) < 1e-4


def test_evaluator_class_mismatch(tmp_path):
    _jax_dump(tmp_path / "a.json", _blocks((2, 10, 10), 2, 0))
    text = (tmp_path / "a.json").read_text().replace('"class_id": 1', '"class_id": 2')
    (tmp_path / "b.json").write_text(text)
    with pytest.raises(ValueError, match="must match"):
        E.default_evaluator()(str(tmp_path / "a.json"), str(tmp_path / "b.json"))


METRICS = ["f1", "ap", "precision", "recall", "f1_50", "f1_75", "precision_50",
           "precision_75", "recall_50", "recall_75", "panoptic_quality"]


@pytest.mark.parametrize("name", METRICS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_instance_metrics(name, seed):
    rng = np.random.default_rng(seed)
    kw = dict(gt_matched=np.arange(5), pred_matched=np.arange(5),
              gt_unmatched=np.arange(rng.integers(0, 4)),
              pred_unmatched=np.arange(rng.integers(0, 4)),
              matched_ious=rng.uniform(0.3, 1.0, int(rng.integers(0, 6))))
    if seed == 2:  # nothing at all scores 1
        kw = {k: np.array([]) for k in kw}
    same(getattr(E, name)(**kw), getattr(JE, name)(**kw))


@pytest.mark.parametrize("case", ["equal", "overlap", "one_empty", "both_empty"])
def test_semantic_iou(case):
    a = np.array([[0, 5], [10, 3], [20, 7]])
    b = {"equal": a, "overlap": np.array([[2, 5], [12, 10]]),
         "one_empty": np.empty((0, 2), np.int64), "both_empty": np.empty((0, 2), np.int64)}[case]
    if case == "both_empty":
        a = b
    same(E.semantic_iou(a, b), JE.semantic_iou(a, b))


def _rle_instances(img):
    return pan_seg_to_rle_seg(img, [1], 1000, [1], force_connected=False).get(1, {})


@pytest.mark.parametrize("seed", range(4))
def test_rle_matcher(seed):
    a = _blocks((48, 48), 12, seed)
    b = _blocks((48, 48), 10, seed + 10) if seed % 2 else np.roll(a, 3, axis=1)
    ta, tb = _rle_instances(a), _rle_instances(b)
    for kw in (dict(), dict(iou_thr=0.1, return_iou=True, return_ioa=True)):
        want = jax_rle_matcher(ta, tb, **kw)
        same(rle_matcher(ta, tb, **kw), want)
        same(rle_matcher_flat(FlatInstances.from_dict(ta), FlatInstances.from_dict(tb), **kw),
             want)
    same(rle_matcher({}, tb), jax_rle_matcher({}, tb))


# ---- curation ops ----------------------------------------------------------


def _dumbbell():
    labels = np.zeros((9, 24), np.int64)
    labels[1:8, 1:8] = 3
    labels[1:8, 16:23] = 3
    labels[4, 8:16] = 3
    return labels


def _many(shape=(3, 30, 30), n=12, seed=4):
    return _blocks(shape, n, seed, base=1)


OPS = {
    "merge_and_delete": lambda M: M.delete_labels(
        M.merge_labels(_blocks((10, 10), 2, 0, base=5), label_ids=[5, 6]), label_ids=[5]),
    "merge_via_points": lambda M: M.merge_labels(_many(), points=[(0, 5, 5), (1, 20, 20)],
                                                 label_ids=[3]),
    "merge_via_line": lambda M: M.merge_labels(_many((30, 30), 9, 1), lines=[[(2, 2), (27, 27)]]),
    "merge_new_label": lambda M: M.merge_labels(_many(), label_ids=[2, 4], new_label=77),
    "delete_points": lambda M: M.delete_labels(_many(), points=[(0, 3, 3), (2, 15, 15)]),
    "split_two_lobes": lambda M: M.split_labels(_dumbbell(), label_ids=[3], min_distance=3),
    "split_with_points": lambda M: M.split_labels(
        np.where(_dumbbell() > 0, 3, 0), label_ids=[3], points=[(4, 4), (4, 20)],
        points_as_markers=True),
    "split_per_slice": lambda M: M.split_labels(np.stack([_dumbbell()] * 3), label_ids=[3],
                                                min_distance=3),
    "split_3d": lambda M: M.split_labels(np.stack([_dumbbell()] * 3), label_ids=[3],
                                         min_distance=2, apply3d=True, start_label=100),
    "split_by_points": lambda M: M.split_labels(_dumbbell(), points=[(4, 4)], min_distance=3),
    "next_label": lambda M: (M.find_next_available_label(np.array([1001, 1002, 1004, 2001]),
                                                         1, 1000),
                             M.find_next_available_label(np.array([1001]), 3, 1000)),
    "jump_to_label": lambda M: M.jump_to_label(_many(), 5),
    "labels_at_points": lambda M: M.labels_at_points(_many(), [(0, 1, 1), (1, 10, 12),
                                                                (2, 29, 29)]),
    "line_2d": lambda M: M.line_to_indices(np.array([(1, 2), (9, 17)])),
    "line_3d": lambda M: M.line_to_indices(np.array([(4, 1, 2), (4, 9, 17)]), axis=0),
    "line_3d_axis1": lambda M: M.line_to_indices(np.array([(1, 4, 2), (9, 4, 17)]), axis=1),
    "line_4d": lambda M: M.line_to_indices(np.array([(0, 2, 1, 2), (0, 2, 9, 17)])),
}


@pytest.mark.parametrize("case", list(OPS))
def test_curation_ops(case):
    same(OPS[case](C), OPS[case](JC))


MORPH = [(op, nd, apply3d, many) for op in ("dilate", "erode", "close", "open", "fill_holes")
         for nd, apply3d in ((2, False), (3, False), (3, True)) for many in (False, True)]


@pytest.mark.parametrize("op,nd,apply3d,many", MORPH)
def test_morph_labels(op, nd, apply3d, many):
    """Few labels go box by box, more than 8 through one find_objects pass."""
    shape = (24, 24) if nd == 2 else (4, 24, 24)
    labels = _blocks(shape, 12 if many else 3, 7, base=1)
    if op == "fill_holes":
        labels[(slice(None),) * (nd - 2) + (slice(2, 12), slice(2, 12))] = 50
        labels[(slice(None),) * (nd - 2) + (slice(5, 7), slice(5, 7))] = 0
    kw = dict(operation=op, radius=1, hole_size=16, apply3d=apply3d)
    got = C.morph_labels(labels.copy(), **kw)
    same(got, JC.morph_labels(labels.copy(), **kw))
    same(C.morph_labels(labels.copy(), label_ids=[1, 2], **kw),
         JC.morph_labels(labels.copy(), label_ids=[1, 2], **kw))


def test_curation_errors():
    with pytest.raises(KeyError):
        C.jump_to_label(np.zeros((4, 4), np.int64), 55)
    with pytest.raises(ValueError, match="unknown operation"):
        C.morph_labels(np.ones((4, 4), np.int64), operation="grow")
    with pytest.raises(ValueError, match="label_ids or points"):
        C.split_labels(np.ones((4, 4), np.int64))


# ---- filters, counting, accuracy ----------------------------------------------


FILTERS = {
    "small": lambda M, a: M.filter_out_small_label_areas(a, 5),
    "boundary": lambda M, a: M.remove_boundary_labels(a),
    "apply_small_image": lambda M, a: M.apply_label_filter(a, filter="small",
                                                           minimum_area_allowed=12),
    "apply_small_patches": lambda M, a: M.apply_label_filter(a, mode="patches", filter="small",
                                                             minimum_area_allowed=12),
    "apply_boundary_patches": lambda M, a: M.apply_label_filter(a, mode="patches",
                                                                filter="boundary"),
    "apply_boundary_volume": lambda M, a: M.apply_label_filter(a, mode="volume",
                                                               filter="boundary"),
}


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("case", list(FILTERS))
def test_filters(case, nd):
    labels = _blocks((20, 20) if nd == 2 else (3, 20, 20), 10, 8, base=1)
    same(FILTERS[case](C, labels.copy()), FILTERS[case](JC, labels.copy()))


@pytest.mark.parametrize("divisor", [0, 1000, 10000])
def test_count_labels(divisor, tmp_path):
    vals = np.array([0, 1001, 1002, 2001, 2001, 12001, 30002])
    got, want = C.count_labels(vals, divisor), JC.count_labels(vals, divisor)
    same(got, want)
    queue, ids = got
    names = {c: f"class{c}" for c in ids}
    paths = [M.save_label_lists([queue, queue], names, str(tmp_path / f"{i}.csv"))
             for i, M in enumerate((C, JC))]
    rows = [list(csv.reader(open(p))) for p in paths]
    assert rows[0] == rows[1] and len(rows[0]) == 1 + 2 * len(ids)


def test_save_label_lists_xlsx_path_writes_csv(tmp_path):
    path = C.save_label_lists([{1: [1001]}], {1: "mito"}, str(tmp_path / "c.xlsx"))
    assert path.endswith("c.csv") and "mito" in open(path).read()


ACCURACY = {
    "pixel_equal": lambda M, gt, pred: M.compute_pixel_metrics(gt, gt),
    "pixel": lambda M, gt, pred: M.compute_pixel_metrics(gt, pred),
    "pixel_empty": lambda M, gt, pred: M.compute_pixel_metrics(gt * 0, gt * 0),
    "instance_equal": lambda M, gt, pred: M.compute_instance_metrics(gt, gt),
    "instance": lambda M, gt, pred: M.compute_instance_metrics(gt, pred),
    "instance_thr": lambda M, gt, pred: M.compute_instance_metrics(gt, pred, iou_thr=0.2),
    "instance_empty": lambda M, gt, pred: M.compute_instance_metrics(gt * 0, pred * 0),
}


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("case", list(ACCURACY))
def test_accuracy(case, nd):
    shape = (40, 40) if nd == 2 else (4, 30, 30)
    gt = _blocks(shape, 8, 9, base=1)
    pred = np.roll(gt, 2, axis=-1)
    pred[pred == 3] = 0
    same(ACCURACY[case](C, gt, pred), ACCURACY[case](JC, gt, pred))


# ---- export, patches, tiles ----------------------------------------------------


def _read_dir(d):
    out = {}
    for root, _, names in os.walk(d):
        for n in sorted(names):
            p = os.path.join(root, n)
            if n.endswith((".tif", ".tiff")):
                im = Image.open(p)
                frames = []
                for i in range(getattr(im, "n_frames", 1)):
                    im.seek(i)
                    frames.append(np.asarray(im))
                out[os.path.relpath(p, d)] = [f.dtype for f in frames], np.stack(frames)
            else:
                out[os.path.relpath(p, d)] = open(p, "rb").read()
    return out


def assert_same_dirs(a, b):
    got, want = _read_dir(a), _read_dir(b)
    assert sorted(got) == sorted(want) and want
    for k, w in want.items():
        if isinstance(w, tuple):
            assert got[k][0] == w[0], k
            np.testing.assert_array_equal(got[k][1], w[1], err_msg=k)
        else:
            assert got[k] == w, k


EXPORTS = {
    "slices": dict(as_stack=False),
    "stack": dict(as_stack=True),
    "slices_image_names": dict(as_stack=False, image=True, impaths=["a/x.png", "b/y.tif"]),
    "stack_image": dict(as_stack=True, image=True),
    "wide_ids": dict(as_stack=True, wide=True),
    "one_slice": dict(as_stack=False, single=True),
}


@pytest.mark.parametrize("case", list(EXPORTS))
def test_export_segmentations(case, tmp_path):
    kw = dict(EXPORTS[case])
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 5, (3, 16, 16)).astype(np.int64)
    if kw.pop("wide", False):
        labels[1] *= 30000  # this slice past 2^16 (int32), the others uint16
    if kw.pop("single", False):
        labels = labels[0]
    if kw.pop("image", False):
        kw["image"] = rng.integers(0, 255, labels.shape, dtype=np.uint8)
    for side, M in (("port", C), ("jax", JC)):
        paths = M.export_segmentations(labels, str(tmp_path / side), prefix="seg", **kw)
        assert all(p.startswith(str(tmp_path / side)) for p in paths)
    assert_same_dirs(tmp_path / "port", tmp_path / "jax")


PICKS = {
    "patches_random": lambda M, img, lbl: M.pick_patches_2d(img, n_patches=3, patch_size=32,
                                                            labels=lbl),
    "patches_points": lambda M, img, lbl: M.pick_patches_2d(img, points=[(5, 5), (120, 60)],
                                                            patch_size=48, axis_name="xz",
                                                            plane=3),
    "flipbooks": lambda M, img, lbl: M.pick_flipbooks(np.stack([img[:64, :64]] * 8), n_flipbooks=2,
                                                      patch_size=32),
    "flipbooks_isotropic": lambda M, img, lbl: M.pick_flipbooks(
        np.stack([img[:64, :64]] * 64), n_flipbooks=3, patch_size=32, isotropic=True,
        labels=np.stack([lbl[:64, :64]] * 64), seed=3),
    "flipbooks_points": lambda M, img, lbl: M.pick_flipbooks(
        np.stack([img[:64, :64]] * 8), points=[(4, 10, 50)], patch_size=16),
    "boxes_2d": lambda M, img, lbl: M.patch_boxes_from_points([(100, 200)], tile_width=64),
    "boxes_3d": lambda M, img, lbl: M.patch_boxes_from_points([(7, 50, 60), (1, 2, 3)], 20),
}


@pytest.mark.parametrize("case", list(PICKS))
def test_patches(case, tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (128, 128), dtype=np.uint8)
    lbl = rng.integers(0, 5, (128, 128)).astype(np.int32)
    got, want = PICKS[case](C, img, lbl), PICKS[case](JC, img, lbl)
    same(got, want)
    if case.startswith(("patches", "flipbooks")):
        for side, M, recs in (("port", C, got), ("jax", JC, want)):
            assert M.store_dataset(str(tmp_path / side), "src", recs, start_index=2) == len(recs)
        assert_same_dirs(tmp_path / "port", tmp_path / "jax")


def test_flipbook_too_shallow():
    with pytest.raises(ValueError, match="flipbooks"):
        C.pick_flipbooks(np.zeros((3, 16, 16), np.uint8), n_flipbooks=1, patch_size=8)


@pytest.mark.parametrize("case", ["tiff_mask", "npy", "exact_fit"])
def test_tiles_roundtrip(case, tmp_path):
    rng = np.random.default_rng(0)
    shape = (128, 192) if case == "exact_fit" else (100, 130)
    img = rng.integers(0, 255, shape, dtype=np.uint8)
    mask = rng.integers(0, 4, shape).astype(np.uint16)
    for side in ("port", "jax"):
        d = tmp_path / side
        d.mkdir()
        if case == "npy":
            np.save(d / "big.npy", img)
        else:
            Image.fromarray(img).save(d / "big.tiff")
            Image.fromarray(mask).save(d / "mask.tiff")
    for side, M in (("port", C), ("jax", JC)):
        d = tmp_path / side
        src = str(d / ("big.npy" if case == "npy" else "big.tiff"))
        meta = M.chop_into_tiles(src, str(d / "tiles"), patch_size=64,
                                 mask_path=None if case == "npy" else str(d / "mask.tiff"))
        assert meta["padded_image_shape"] == [128, 192]
        out = M.merge_tiles(str(d / "tiles"), str(d / "merged"))
        assert sorted(out) == (["im"] if case == "npy" else ["im", "msk"])
    assert_same_dirs(tmp_path / "port", tmp_path / "jax")
    merged = np.asarray(Image.open(tmp_path / "port" / "merged" / "merged_image.tiff"))
    np.testing.assert_array_equal(merged, img)


def test_tiles_refuse_partial_merges(tmp_path):
    img = np.zeros((100, 130), np.uint8)
    np.save(tmp_path / "big.npy", img)
    C.chop_into_tiles(str(tmp_path / "big.npy"), str(tmp_path / "t"), patch_size=64)
    os.remove(tmp_path / "t" / "im" / "tile_0000_0000.tiff")
    with pytest.raises(ValueError, match="partial merge"):
        C.merge_tiles(str(tmp_path / "t"), str(tmp_path / "m"))
    with pytest.raises(FileNotFoundError, match="does not exist"):
        C.chop_into_tiles(str(tmp_path / "big.npy"), str(tmp_path / "u"), patch_size=64,
                          mask_path=str(tmp_path / "nope.tiff"))
