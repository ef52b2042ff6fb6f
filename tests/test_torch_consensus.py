"""The port's consensus layer against the JAX package's and networkx: the
native vote bindings and the range algebra built on them, the graph
stand-in (``stitch/graph.py``) against ``networkx.Graph`` (node, neighbour,
component and subgraph order), and ``merge_objects_from_trackers`` against
the JAX function on seeded synthetic trackers whose consensus depends on
that order.  Every comparison is exact."""

from types import SimpleNamespace

import networkx as nx
import numpy as np
import pytest

from empanada_tpu.core import native as jax_native
from empanada_tpu.core import ranges as jax_ranges
from empanada_tpu.stitch import consensus as jax_consensus
from empanada_tpu_torch.core import native, ranges
from empanada_tpu_torch.core.rle import rle_encode
from empanada_tpu_torch.stitch import consensus
from empanada_tpu_torch.stitch.graph import Graph, connected_components

# ---- native vote bindings and the range algebra ------------------------


def _range_set(rng, n, span, sorted_disjoint=True):
    """(n, 2) ranges within [0, span): sorted and disjoint (a valid RLE,
    touching runs allowed), or overlapping in random order."""
    if sorted_disjoint:
        cuts = np.sort(rng.choice(span, size=2 * n, replace=False))
        r = cuts.reshape(-1, 2)
        r[1::3, 0] = r[0:-1:3, 1][: len(r[1::3])]  # some runs touch
        return r[r[:, 1] > r[:, 0]].astype(np.int64)
    s = rng.integers(0, span - 10, size=n)
    return np.stack([s, s + rng.integers(1, 10, size=n)], axis=1).astype(np.int64)


@pytest.mark.parametrize("n_sets,sorted_disjoint", [(3, True), (40, True), (64, True),
                                                     (65, True), (5, False), (70, False)])
@pytest.mark.parametrize("vote", [1, 2, 3, 4])
def test_vote_and_union_match_jax(n_sets, sorted_disjoint, vote):
    """Up to 64 sorted disjoint sets take the k-way merge
    (``vote_sorted_sets``), more or unsorted ones the sorting sweep
    (``vote_ranges``); both packages give the same ranges."""
    rng = np.random.default_rng(100 * n_sets + vote)
    sets = [_range_set(rng, int(rng.integers(0, 30)), 2000, sorted_disjoint)
            for _ in range(n_sets)]
    np.testing.assert_array_equal(ranges.vote_by_ranges(sets, vote),
                                  jax_ranges.vote_by_ranges(sets, vote))
    np.testing.assert_array_equal(ranges.coverage_ranges(sets, vote),
                                  jax_ranges.coverage_ranges(sets, vote))
    np.testing.assert_array_equal(ranges.join_ranges(sets), jax_ranges.join_ranges(sets))
    if vote > 1:
        flat = np.concatenate(sets)
        np.testing.assert_array_equal(ranges.rle_voting(flat, vote),
                                      jax_ranges.rle_voting(flat, vote))


@pytest.mark.parametrize("seed", range(3))
def test_native_bindings_match_jax(seed):
    rng = np.random.default_rng(seed)
    sets = [_range_set(rng, int(rng.integers(1, 50)), 5000) for _ in range(8)]
    flat = np.concatenate(sets)[rng.permutation(sum(map(len, sets)))]
    for vote in (1, 2, 3):
        np.testing.assert_array_equal(native.vote_ranges(flat, vote),
                                      jax_native.vote_ranges(flat, vote))
        np.testing.assert_array_equal(native.vote_sorted_sets(sets, vote),
                                      jax_native.vote_sorted_sets(sets, vote))
        # the k-way merge and the sorting sweep agree on sorted sets
        np.testing.assert_array_equal(native.vote_sorted_sets(sets, vote),
                                      native.vote_ranges(flat, vote))
    assert native.vote_ranges(np.empty((0, 2), np.int64), 1).shape == (0, 2)
    assert native.vote_sorted_sets([], 2).shape == (0, 2)


def test_vote_is_native_only(monkeypatch):
    monkeypatch.setattr(native, "use_native", False)
    with pytest.raises(RuntimeError, match="native"):
        ranges.vote_by_ranges([np.array([[0, 4]])], 1)
    # the union keeps its numpy path for the matcher's numpy formulation
    np.testing.assert_array_equal(ranges.join_ranges([np.array([[0, 4]]), np.array([[4, 6]])]),
                                  [[0, 6]])


# ---- the graph stand-in against networkx ------------------------------


def _random_graphs(seed, n):
    """The same random graph built in both: ints up to 5n inserted in a
    random order (so sets of them wrap their tables), edges added in random
    order with attributes, a sparse density that leaves components of many
    sizes."""
    rng = np.random.default_rng(seed)
    nodes = rng.choice(5 * n, size=n, replace=False).tolist()
    m = int(n * rng.uniform(0.4, 1.2))
    edges = [(nodes[a], nodes[b]) for a, b in rng.integers(0, n, size=(m, 2)) if a != b]
    g, h = Graph(), nx.Graph()
    for v in nodes:
        g.add_node(v, w=v % 7)
        h.add_node(v, w=v % 7)
    for i, (u, v) in enumerate(edges):
        g.add_edge(u, v, iou=i / m, overlap=i)
        h.add_edge(u, v, iou=i / m, overlap=i)
    return g, h, rng


def _assert_same_graph(g: Graph, h):
    assert list(g.nodes) == list(h.nodes)
    for v in h.nodes:
        assert g.nodes[v] == h.nodes[v]
        assert list(g.neighbors(v)) == list(h.neighbors(v))
        assert g.degree(v) == h.degree(v)
    assert [(u, v, dict(d)) for u, v, d in g.edges()] == list(h.edges(data=True))
    assert g.number_of_edges() == h.number_of_edges()


@pytest.mark.parametrize("n", [10, 37, 120, 300, 500])
def test_graph_orders_as_networkx(n):
    g, h, rng = _random_graphs(n, n)
    _assert_same_graph(g, h)
    _assert_same_graph(g.copy(), h.copy())
    comps, want = list(connected_components(g)), list(nx.connected_components(h))
    assert [list(c) for c in comps] == [list(c) for c in want]
    assert any(2 * len(c) < n for c in want)
    for comp in want:  # smaller and larger than half the graph
        _assert_same_graph(g.subgraph(comp), h.subgraph(comp).copy())
        _assert_same_graph(g.subgraph(comp).copy(), h.subgraph(comp).copy().copy())
    # removals, then an edge removed and added again moves to the end
    for u, v, _ in list(h.edges(data=True))[::3]:
        g.remove_edge(u, v)
        h.remove_edge(u, v)
    for v in list(h.nodes)[::5]:
        g.remove_node(v)
        h.remove_node(v)
    for u, v, _ in list(h.edges(data=True))[::2]:
        g.remove_edge(u, v)
        h.remove_edge(u, v)
        g.add_edge(v, u, iou=0.5)
        h.add_edge(v, u, iou=0.5)
    _assert_same_graph(g, h)
    assert [list(c) for c in connected_components(g)] == \
        [list(c) for c in nx.connected_components(h)]
    assert all(g.has_edge(u, v) for u, v in h.edges())


# ---- merge_objects_from_trackers on synthetic trackers ----------------

SHAPE = (40, 48, 48)


def _cuboid(rng, lo, hi, keep=0.9):
    """Box and RLE of a cuboid [lo, hi) with a seeded share of its voxels."""
    grids = np.meshgrid(*[np.arange(a, b) for a, b in zip(lo, hi)], indexing="ij")
    vox = np.ravel_multi_index([g.ravel() for g in grids], SHAPE)
    vox = np.sort(vox[rng.random(len(vox)) < keep])
    starts, runs = rle_encode(vox)
    return {"box": tuple(int(v) for v in (*lo, *hi)), "starts": starts, "runs": runs}


def _synthetic_trackers(seed, n_objects, chain):
    """Three trackers (views) of ``n_objects`` jittered cuboids, plus a
    ``chain`` of overlapping cuboids along x in every view (one component
    of 3 x chain objects)."""
    rng = np.random.default_rng(seed)
    objects = []
    for _ in range(n_objects):
        half = rng.integers(2, 6, size=3)
        c = [int(rng.integers(h, s - h)) for h, s in zip(half, SHAPE)]
        objects.append((c, half))
    trackers = []
    for view in range(3):
        instances = {}
        for k, (c, half) in enumerate(objects):
            if rng.random() < 0.15:
                continue  # this view missed the object
            jit = rng.integers(-1, 2, size=3)
            lo = [max(0, ci - h + j) for ci, h, j in zip(c, half, jit)]
            hi = [min(s, ci + h + j + 1) for ci, h, j, s in zip(c, half, jit, SHAPE)]
            instances[1000 + k] = _cuboid(rng, lo, hi)
        for k in range(chain):
            x0 = min(SHAPE[2] - 4, k + int(rng.integers(0, 2)))
            lo = [2 + view, 30 + (k % 3), x0]
            hi = [9 + view, 38 + (k % 3), x0 + 4]
            instances[2000 + k] = _cuboid(rng, lo, hi, keep=0.95)
        trackers.append(SimpleNamespace(instances=instances))
    return trackers


def _assert_same(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        assert got[k]["box"] == want[k]["box"]
        np.testing.assert_array_equal(got[k]["starts"], want[k]["starts"])
        np.testing.assert_array_equal(got[k]["runs"], want[k]["runs"])


@pytest.mark.parametrize("scene", [(30, 0), (10, 40), (60, 25)],
                         ids=["objects", "chain-over-half", "chain-under-half"])
@pytest.mark.parametrize("vote,iou_thr,bypass", [(2, 0.75, False), (2, 0.3, False),
                                                 (1, 0.75, False), (3, 0.5, False),
                                                 (2, 0.75, True)])
def test_merge_objects_matches_jax(scene, vote, iou_thr, bypass):
    """A chain component of more than 64 objects (its vote takes the
    sorting sweep at vote 1, where every edge clusters), larger or smaller
    than half the object graph (its subgraph then iterates the graph's or
    the component set's order), and random cuboids whose cluster graphs
    hold ties of neighbour counts."""
    n_objects, chain = scene
    trackers = _synthetic_trackers(7 * n_objects + chain, n_objects, chain)
    got = consensus.merge_objects_from_trackers(trackers, vote, iou_thr, bypass)
    want = jax_consensus.merge_objects_from_trackers(trackers, vote, iou_thr, bypass)
    _assert_same(got, want)
    assert len(got) >= 1


def test_merge_semantic_matches_jax():
    rng = np.random.default_rng(3)
    trackers = [SimpleNamespace(instances={1: _cuboid(rng, (2 + v, 3, 4), (20, 30 - v, 33))})
                for v in range(3)]
    for vote in (1, 2, 3, 4):
        _assert_same(consensus.merge_semantic_from_trackers(trackers, vote),
                     jax_consensus.merge_semantic_from_trackers(trackers, vote))
    assert consensus.merge_semantic_from_trackers([SimpleNamespace(instances={})]) == {}
