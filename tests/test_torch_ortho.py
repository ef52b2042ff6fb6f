"""The port's ortho-plane path against the JAX package's, in float32 on the
CPU: the xz and yz sweeps of ``MultiChipEngine3d`` (the JAX engine on a
one-device mesh, streamed path: ``sweep_fused=False``,
``volume_resident=False``, and the port's likewise), ``infer_orthoplane``,
and the finishes ``tracker_consensus`` / ``stack_postprocessing`` on its
trackers.  Ids,
boxes, starts, runs and filled volumes must be identical; the configs are
thing-only (the JAX fused path's fault C1 is not reached) and the
random-weight fixtures hold no PointRend top-k or Hungarian ties (PARITY
"Known divergences" 2 and 8).  Also the yz tracker's finish, which must
not merge runs across instances (the JAX tracker's fault C2)."""

import math
import os

import numpy as np
import pytest

from _torch_port import SMALL_PR, jax_init, port_model
from empanada_tpu import api as jax_api
from empanada_tpu.core.labeling import FlatInstances as JaxFlat
from empanada_tpu.parallel.data_parallel import MultiChipEngine3d as JaxEngine3d
from empanada_tpu.parallel.mesh import create_mesh
from empanada_tpu.stitch.tracker import InstanceTracker as JaxTracker
from empanada_tpu_torch import api
from empanada_tpu_torch.core.labeling import FlatInstances
from empanada_tpu_torch.core.rle import rle_encode
from empanada_tpu_torch.parallel.data_parallel import MultiChipEngine3d
from empanada_tpu_torch.stitch.tracker import InstanceTracker

CFG = {
    "class_names": {1: "mito"},
    "labels": [1],
    "thing_list": [1],
    "model": "unused",
    "padding_factor": 16,
    "norms": {"mean": 0.57571, "std": 0.12765},
}
ENGINE_KW = dict(median_kernel_size=3, min_size=10, min_extent=1, max_centers=64,
                 confidence_thr=0.5, save_panoptic=True, batch_size=24)
# engine options of the sweeps; an 8-row plane holds small semantic
# regions, so semantic-only keeps those of 16 px
OPTIONS = {"default": {}, "fine-boundaries": dict(fine_boundaries=True),
           "semantic-only": dict(semantic_only=True, stuff_area=16)}
SHAPE = (8, 64, 80)


@pytest.fixture(scope="module")
def models():
    model, variables = jax_init("PanopticDeepLabPR", SMALL_PR, size=64)
    return model, variables, port_model("PanopticDeepLabPR", SMALL_PR, variables)


def _volume(shape, seed, n_blobs=16):
    """Seeded uint8 volume of dark 3D Gaussian blobs on noise (objects that
    all three sweeps see)."""
    rng = np.random.default_rng(seed)
    vol = rng.normal(0.5, 0.08, size=shape)
    grids = np.ogrid[tuple(slice(0, s) for s in shape)]
    for _ in range(n_blobs):
        c = [rng.uniform(0, s) for s in shape]
        sig = [rng.uniform(1.5, 3)] + [rng.uniform(3, 7)] * 2
        vol -= 0.4 * np.exp(-sum((g - ci) ** 2 / (2 * si ** 2)
                                 for g, ci, si in zip(grids, c, sig)))
    return (np.clip(vol, 0, 1) * 255).astype(np.uint8)


def _engines(models, **kw):
    model, variables, tmodel = models
    kw = {**ENGINE_KW, **kw}
    jeng = JaxEngine3d(CFG, model_and_variables=(model, variables), sweep_fused=False,
                       volume_resident=False, mesh=create_mesh(1), **kw)
    teng = MultiChipEngine3d(CFG, tmodel, device="cpu", sweep_fused=False,
                             volume_resident=False, **kw)
    return jeng, teng


@pytest.fixture(scope="module")
def engines(models):
    """(JAX, port) engine pair of each ``OPTIONS`` entry, made once: the
    JAX engine compiles once per plane shape."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _engines(models, **OPTIONS[name])
        return cache[name]
    return get


def assert_same_instances(got: dict, want: dict):
    """Two ``{id: {box, starts, runs}}`` dicts equal, ids in the same order."""
    assert list(got) == list(want)
    for k in want:
        assert tuple(int(b) for b in got[k]["box"]) == tuple(int(b) for b in want[k]["box"])
        np.testing.assert_array_equal(np.asarray(got[k]["starts"]), want[k]["starts"])
        np.testing.assert_array_equal(np.asarray(got[k]["runs"]), want[k]["runs"])


def assert_same_trackers(got, want):
    assert [t.axis for t in got] == [t.axis for t in want]
    for g, w in zip(got, want):
        assert (g.class_id, g.shape3d) == (w.class_id, tuple(w.shape3d))
        assert_same_instances(g.instances, w.instances)


@pytest.mark.parametrize("axis", ["xz", "yz"])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_axis_sweep_matches_jax(engines, axis, option):
    """B = 24 leaves a padded tail batch on both axes (64 xz planes, 80 yz
    planes, each 8 rows padded to 16); the padded planes must not reach
    the matcher."""
    jeng, teng = engines(option)
    vol = _volume(SHAPE, seed=60)
    wstack, wtr = jeng.infer_on_axis(vol, axis)
    gstack, gtr = teng.infer_on_axis(vol, axis)
    assert teng.last_batch_size == jeng.last_batch_size == 24
    assert teng.last_overflow == jeng.last_overflow
    assert gstack.dtype == np.int32
    np.testing.assert_array_equal(gstack, wstack)
    assert_same_trackers(gtr, wtr)
    assert sum(len(t.instances) for t in gtr) >= 1
    assert "finish_tracking" in teng.last_timing


@pytest.fixture(scope="module")
def ortho(engines):
    """``infer_orthoplane`` of both packages, thing-only and semantic-only,
    on one volume."""
    vol = _volume(SHAPE, seed=80)
    out = {}
    for name, option in (("thing", "default"), ("semantic", "semantic-only")):
        jeng, teng = engines(option)
        want = jeng.infer_orthoplane(vol)
        got = teng.infer_orthoplane(vol)
        out[name] = (got, want, teng, jeng)
    return out


@pytest.mark.parametrize("shape", [SHAPE, (64, 512, 512), (300, 96, 1000)])
def test_auto_batch_per_axis_matches_jax(models, shape):
    """The auto batch of each axis (no inference runs): MitoNet_v1's
    64 x 512 x 512 volume gives 32 on xy and 256 on xz and yz."""
    jeng, teng = _engines(models, batch_size=None)
    got = [teng._resolve_batch(shape, axis) for axis in range(3)]
    assert got == [jeng._resolve_batch(shape, axis) for axis in range(3)]
    if shape == (64, 512, 512):
        assert got == [32, 256, 256]


def test_orthoplane_matches_jax(ortho):
    for got, want, teng, jeng in ortho.values():
        assert list(got) == list(want) == ["xy", "xz", "yz"]
        for axis in want:
            assert_same_trackers(got[axis], want[axis])
        assert teng.last_overflow == jeng.last_overflow
        assert set(teng.last_axis_stats) == {"xy", "xz", "yz"}
    got = ortho["thing"][0]
    assert all(len(got[a][0].instances) >= 2 for a in got)  # instances, not a blank run


def _consume(gen):
    return [(vol, name, inst) for vol, name, inst in gen]


def _assert_same_outputs(got, want):
    assert len(got) == len(want)
    for (gv, gn, gi), (wv, wn, wi) in zip(got, want):
        assert gn == wn and gv.dtype == wv.dtype
        np.testing.assert_array_equal(gv, wv)
        assert_same_instances(gi, wi)


@pytest.mark.parametrize("vote,one_view", [(1, False), (2, False), (3, False), (2, True),
                                           (3, True)])
def test_tracker_consensus_matches_jax(ortho, vote, one_view):
    got_tr, want_tr = ortho["thing"][:2]
    kw = dict(pixel_vote_thr=vote, cluster_iou_thr=0.75, allow_one_view=one_view,
              min_size=10, min_extent=1)
    got = _consume(api.tracker_consensus(got_tr, None, CFG, device="cpu", **kw))
    want = _consume(jax_api.tracker_consensus(want_tr, None, CFG, **kw))
    _assert_same_outputs(got, want)
    assert got[0][1] == "mito"
    if vote < 3:
        assert len(got[0][2]) >= 1


@pytest.mark.parametrize("vote", [1, 2, 3])
def test_semantic_consensus_matches_jax(ortho, vote):
    """A class that is not a thing: the pixel vote over the three axes."""
    got_tr, want_tr = ortho["semantic"][:2]
    cfg = {**CFG, "thing_list": []}
    got = _consume(api.tracker_consensus(got_tr, None, cfg, pixel_vote_thr=vote,
                                         device="cpu"))
    want = _consume(jax_api.tracker_consensus(want_tr, None, cfg, pixel_vote_thr=vote))
    _assert_same_outputs(got, want)
    assert got[0][0].dtype == np.uint8 and got[0][0].any()


@pytest.mark.parametrize("kind", ["thing", "semantic"])
def test_stack_postprocessing_matches_jax(ortho, kind):
    got_tr, want_tr = ortho[kind][:2]
    cfg = CFG if kind == "thing" else {**CFG, "thing_list": []}
    kw = dict(min_size=10, min_extent=2)
    got = _consume(api.stack_postprocessing(got_tr, None, cfg, device="cpu", **kw))
    want = _consume(jax_api.stack_postprocessing(want_tr, None, cfg, **kw))
    _assert_same_outputs(got, want)


def test_finishes_refuse_stores_and_default_to_cuda(ortho, tmp_path):
    """With ``store_url`` a finish writes its volume into a chunked store
    (item 8, no longer refused) equal to the numpy volume; without a GPU
    the default device raises."""
    got_tr = ortho["thing"][0]
    kw = dict(min_size=10, min_extent=1, device="cpu")
    (store, _, _), = api.tracker_consensus(got_tr, str(tmp_path), CFG, **kw)
    (volume, _, _), = api.tracker_consensus(got_tr, None, CFG, **kw)
    np.testing.assert_array_equal(np.asarray(store), volume)
    assert os.path.isfile(os.path.join(tmp_path, "mito", ".zarray"))
    import torch

    if not torch.cuda.is_available():
        for fn in (api.tracker_consensus, api.stack_postprocessing):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                next(fn(got_tr, None, CFG))


# ---- the yz tracker's finish ------------------------------------------


def _flat(cls, slices):
    """FlatInstances of ``cls`` from ``{label: (box, [flat 2D pixels])}``."""
    labels, boxes, offsets, starts, runs = [], [], [0], [], []
    for label, (box, pixels) in slices.items():
        s, r = rle_encode(np.sort(np.asarray(pixels, np.int64)))
        labels.append(label)
        boxes.append(box)
        starts.append(s)
        runs.append(r)
        offsets.append(offsets[-1] + len(s))
    return cls(np.asarray(labels, np.int64), np.asarray(boxes, np.int64).reshape(-1, 4),
               np.asarray(offsets, np.int64), np.concatenate(starts), np.concatenate(runs))


def _feed(shape, plan):
    """The port's and the JAX yz trackers fed the same slices
    ``[(index2d, {label: (box, pixels)})]``, finished."""
    trackers = []
    for tracker_cls, flat_cls in ((InstanceTracker, FlatInstances), (JaxTracker, JaxFlat)):
        tr = tracker_cls(1, 1000, shape, "yz")
        for index2d, slices in plan:
            tr.update(_flat(flat_cls, slices), index2d)
        tr.finish()
        trackers.append(tr)
    return trackers


def _oracle(shape, plan) -> dict:
    """Per instance: its voxels' 3D flat indices, sorted and encoded."""
    voxels = {}
    for x, slices in plan:
        for label, (_, pixels) in slices.items():
            z, y = np.unravel_index(np.asarray(pixels), (shape[0], shape[1]))
            voxels.setdefault(label, []).append(np.ravel_multi_index((z, y, np.full_like(z, x)),
                                                                     shape))
    return {k: rle_encode(np.sort(np.concatenate(v))) for k, v in voxels.items()}


def test_yz_finish_matches_jax_without_c2():
    """Random instances over 5 yz slices: no instance holds the last voxel,
    so the JAX finish is right and the port's equals it and the oracle."""
    rng = np.random.default_rng(5)
    shape = (7, 9, 5)
    plan = []
    for x in (4, 2, 3, 0, 1):
        slices = {}
        free = rng.permutation(shape[0] * shape[1] - 1)  # never pixel (6, 8)
        for label, chunk in zip((1001, 1002, 1003), np.array_split(free[:36], 3)):
            slices[label] = ((0, 0, shape[0], shape[1]), chunk)
        plan.append((x, slices))
    got, want = _feed(shape, plan)
    assert_same_instances(got.instances, want.instances)
    oracle = _oracle(shape, plan)
    for label, (s, r) in oracle.items():
        np.testing.assert_array_equal(got.instances[label]["starts"], s)
        np.testing.assert_array_equal(got.instances[label]["runs"], r)


def test_yz_finish_c2_regression():
    """Fault C2 of the JAX tracker: instance A (first in the tracker) holds
    voxel prod - 1, instance B voxel 0.  Keyed with stride prod their keys
    are adjacent and the JAX finish gives A one run of 2 (past the volume)
    and drops B's voxel; the port's finish equals the per-instance oracle."""
    shape = (4, 6, 3)
    prod = math.prod(shape)
    h_last = shape[0] * shape[1] - 1
    plan = [(shape[2] - 1, {1001: ((0, 0, 4, 6), [h_last, h_last - 1])}),
            (0, {1002: ((0, 0, 4, 6), [0, 7])})]
    got, want = _feed(shape, plan)
    oracle = _oracle(shape, plan)
    assert list(got.instances) == [1001, 1002]
    for label, (s, r) in oracle.items():
        np.testing.assert_array_equal(got.instances[label]["starts"], s)
        np.testing.assert_array_equal(got.instances[label]["runs"], r)
    assert int(got.instances[1001]["starts"][-1]) == prod - 1
    assert int(got.instances[1002]["starts"][0]) == 0
    # the JAX tracker merges A's last voxel with B's first
    a = want.instances[1001]
    assert int(a["starts"][-1]) == prod - 1 and int(a["runs"][-1]) == 2
    assert int(np.sum(want.instances[1002]["runs"])) == 1
    assert int(np.sum(got.instances[1002]["runs"])) == 2
