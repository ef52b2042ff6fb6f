"""Instance and semantic consensus across the trackers of the three
ortho-plane sweeps, and the merges of ``Engine2d``'s tiles (counterpart of
``empanada_tpu/stitch/consensus.py``).

Instances: box screening -> RLE-IoU weighted object graph -> connected
components (those smaller than the majority cluster size dropped) -> per
component, clusters of IoU above ``cluster_iou_thr`` -> iterative cluster
merging by connectivity -> per-cluster k-of-n pixel vote -> merging of
overlapping survivors.  The graphs are ``stitch.graph.Graph``, which keeps
networkx's node, neighbour and component order, so the instance ids and
the ties of ``merge_clusters`` come out as the JAX package's do.  The
intersections and votes run on the native library.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from itertools import combinations

import numpy as np

from empanada_tpu_torch.core.boxes import merge_boxes, overlapping_box_pairs
from empanada_tpu_torch.core.ranges import join_ranges, ranges_to_rle, vote_by_ranges
from empanada_tpu_torch.core.rle import rle_ioa
from empanada_tpu_torch.stitch.graph import Graph, connected_components
from empanada_tpu_torch.stitch.matcher import _batch_intersections, _instance_areas

MIN_OVERLAP = 100
MIN_IOU = 1e-2

__all__ = [
    "merge_objects_from_trackers",
    "merge_semantic_from_trackers",
    "merge_objects_from_tiles",
    "merge_semantic_from_tiles",
    "bounding_box_screening",
    "object_iou_graph",
]


def create_graph_of_clusters(G: Graph, cluster_iou_thr: float) -> Graph:
    """Group the nodes joined by edges of IoU above ``cluster_iou_thr``;
    an edge between two groups carries the mean iou/overlap over all their
    member pairs (absent pairs count 0), when it clears MIN_IOU or
    MIN_OVERLAP."""
    H = G.copy()
    for u, v, d in G.edges():
        if d["iou"] <= cluster_iou_thr:
            H.remove_edge(u, v)

    cluster_graph = Graph()
    node2cluster = {}
    sizes = {}
    for i, cluster in enumerate(connected_components(H)):
        cluster_graph.add_node(i, cluster=cluster)
        sizes[i] = len(cluster)
        for n in cluster:
            node2cluster[n] = i

    pair_sums = {}
    for u, v, d in G.edges():
        cu, cv = node2cluster[u], node2cluster[v]
        if cu == cv:
            continue
        acc = pair_sums.setdefault((cu, cv) if cu < cv else (cv, cu), [0.0, 0.0])
        acc[0] += d["iou"]
        acc[1] += d["overlap"]

    for (i, j), (siou, sov) in pair_sums.items():
        denom = sizes[i] * sizes[j]
        iou_w, ov_w = siou / denom, sov / denom
        if iou_w > MIN_IOU or ov_w > MIN_OVERLAP:
            cluster_graph.add_edge(i, j, iou=iou_w, overlap=ov_w)
    return cluster_graph


def push_cluster(G: Graph, src, dst) -> Graph:
    G.nodes[dst]["cluster"] = G.nodes[dst]["cluster"].union(G.nodes[src]["cluster"])
    G.remove_edge(src, dst)
    return G


def merge_clusters(G: Graph) -> Graph:
    """Resolve the cluster graph: the most-connected node (the first in node
    order on ties) absorbs its neighbours, or, when a neighbour's cluster is
    larger, is pushed into every neighbour."""
    H = G.copy()
    while H.number_of_edges() > 0:
        most_connected = max(H.nodes, key=H.degree)
        neighbors = sorted(H.neighbors(most_connected),
                           key=lambda x: len(H.nodes[x]["cluster"]), reverse=True)
        mc_cluster = H.nodes[most_connected]["cluster"]
        if len(H.nodes[neighbors[0]]["cluster"]) > len(mc_cluster):
            for neighbor in neighbors:
                push_cluster(H, most_connected, neighbor)
            H.remove_node(most_connected)
        else:
            for neighbor in neighbors:
                push_cluster(H, neighbor, most_connected)
                # the JAX package (after the reference) re-adds the edge to
                # the neighbour it removes next, not to the neighbour's
                # neighbour: kept, the neighbour's other edges are dropped
                for sn in list(H.neighbors(neighbor)):
                    if not H.has_edge(most_connected, sn):
                        H.add_edge(most_connected, neighbor, iou=H[neighbor][sn]["iou"])
                H.remove_node(neighbor)
    return H


def _ranges_of(starts, runs) -> np.ndarray:
    starts = np.asarray(starts)
    return np.stack([starts, starts + np.asarray(runs)], axis=1)


def merge_instances(instances_dict: dict) -> dict:
    """Union of the instances' boxes and RLEs (one k-way union)."""
    attrs_list = list(instances_dict.values())
    if len(attrs_list) < 2:
        return attrs_list[0]
    merged_box = attrs_list[0]["box"]
    for attrs in attrs_list[1:]:
        merged_box = merge_boxes(merged_box, attrs["box"])
    joined = join_ranges([_ranges_of(a["starts"], a["runs"]) for a in attrs_list])
    return dict(box=merged_box, starts=joined[:, 0], runs=joined[:, 1] - joined[:, 0])


def merge_overlapping(cluster_instances: dict) -> list:
    """Merge surviving instances whose IoU clears MIN_IOU or whose overlap
    clears MIN_OVERLAP (components of that relation)."""
    if len(cluster_instances) < 2:
        return list(cluster_instances.values())
    instance_ids = list(cluster_instances)
    merge_graph = Graph()
    merge_graph.add_nodes_from(instance_ids)
    pairs = np.asarray(list(combinations(range(len(instance_ids)), 2)), np.int64)
    starts_list = [cluster_instances[k]["starts"] for k in instance_ids]
    runs_list = [cluster_instances[k]["runs"] for k in instance_ids]
    # called from the per-component thread pool: no native threads
    inters = _batch_intersections(starts_list, runs_list, starts_list, runs_list, pairs,
                                  max_threads=1)
    areas = _instance_areas(runs_list)
    unions = areas[pairs[:, 0]] + areas[pairs[:, 1]] - inters
    ious = np.where(unions > 0, inters / np.maximum(unions, 1), 0.0)
    for (i, j), iou, inter in zip(pairs, ious, inters):
        if iou > MIN_IOU or inter > MIN_OVERLAP:
            merge_graph.add_edge(instance_ids[i], instance_ids[j])
    return [merge_instances({k: v for k, v in cluster_instances.items() if k in comp})
            for comp in connected_components(merge_graph)]


def bounding_box_screening(boxes: np.ndarray, source_indices: np.ndarray) -> np.ndarray:
    """Unique (i < j) pairs of overlapping boxes from different sources."""
    box_matches = overlapping_box_pairs(boxes)
    box_matches = box_matches[source_indices[box_matches[:, 0]]
                              != source_indices[box_matches[:, 1]]]
    return np.unique(np.sort(box_matches, axis=-1), axis=0)


def object_iou_graph(source_indices, object_labels, object_boxes, object_starts,
                     object_runs) -> Graph:
    """Nodes 0..N-1 = objects (box, starts, runs); an edge (iou, overlap)
    between box-screened objects of different sources that intersect."""
    box_matches = bounding_box_screening(object_boxes, source_indices)
    graph = Graph()
    for node_id in range(len(object_labels)):
        graph.add_node(node_id, box=object_boxes[node_id], starts=object_starts[node_id],
                       runs=object_runs[node_id])
    if len(box_matches):
        inters = _batch_intersections(object_starts, object_runs, object_starts,
                                      object_runs, box_matches)
        areas = _instance_areas(object_runs)
        r1, r2 = box_matches[:, 0], box_matches[:, 1]
        unions = areas[r1] + areas[r2] - inters
        for a, b, inter, union in zip(r1, r2, inters, unions):
            if union > 0 and inter > 0:
                graph.add_edge(int(a), int(b), iou=inter / union, overlap=int(inter))
    return graph


def merge_semantic_from_trackers(semantic_trackers, pixel_vote_thr: int = 2) -> dict:
    """Pixel vote across the trackers of a semantic (stuff) class: one
    record (key 1), with an empty RLE when no voxel wins the vote."""
    boxes, ranges = [], []
    for tr in semantic_trackers:
        if len(tr.instances) > 1:
            raise ValueError("a semantic class's tracker holds one label, not "
                             f"{len(tr.instances)}")
        for attrs in tr.instances.values():
            boxes.append(attrs["box"])
            ranges.append(_ranges_of(attrs["starts"], attrs["runs"]))
    if not boxes:
        return {}
    merged_box = boxes[0]
    for box in boxes[1:]:
        merged_box = merge_boxes(merged_box, box)
    seg = vote_by_ranges(ranges, pixel_vote_thr).reshape(-1, 2)
    return {1: {"box": merged_box, "starts": seg[:, 0], "runs": seg[:, 1] - seg[:, 0]}}


def merge_objects_from_trackers(object_trackers, pixel_vote_thr: int = 2,
                                cluster_iou_thr: float = 0.75,
                                bypass: bool = False) -> dict:
    """Instance consensus across the ortho-plane trackers of one class:
    ``{1..n: {"box", "starts", "runs"}}``, numbered in component order."""
    min_cluster_size = 1 if bypass else len(object_trackers) // 2 + 1
    if pixel_vote_thr < min_cluster_size:
        cluster_iou_thr = 0

    tracker_indices, object_labels = [], []
    object_boxes, object_starts, object_runs = [], [], []
    for tr_index, tr in enumerate(object_trackers):
        for instance_id, attrs in tr.instances.items():
            tracker_indices.append(tr_index)
            object_labels.append(int(instance_id))
            object_boxes.append(attrs["box"])
            object_starts.append(attrs["starts"])
            object_runs.append(attrs["runs"])
    if not object_boxes:
        return {}
    graph = object_iou_graph(np.array(tracker_indices), np.array(object_labels),
                             np.array(object_boxes), object_starts, object_runs)

    def resolve_component(comp):
        cluster_graph = merge_clusters(
            create_graph_of_clusters(graph.subgraph(comp), cluster_iou_thr))
        cluster_instances = {}
        for node in cluster_graph.nodes:
            cluster = list(cluster_graph.nodes[node]["cluster"])
            if len(cluster) < min_cluster_size:
                continue
            merged_box = graph.nodes[cluster[0]]["box"]
            for node_id in cluster[1:]:
                merged_box = merge_boxes(merged_box, graph.nodes[node_id]["box"])
            voted = vote_by_ranges([_ranges_of(graph.nodes[n]["starts"],
                                               graph.nodes[n]["runs"]) for n in cluster],
                                   pixel_vote_thr)
            if len(voted) > 0:
                cluster_instances[len(cluster_instances) + 1] = {
                    "box": tuple(int(b) for b in merged_box),
                    "starts": voted[:, 0],
                    "runs": voted[:, 1] - voted[:, 0],
                }
        return merge_overlapping(cluster_instances)

    components = [c for c in connected_components(graph) if len(c) >= min_cluster_size]
    # components are independent and the native calls release the GIL; the
    # results are numbered in component order either way
    if len(components) > 3:
        with ThreadPoolExecutor(max_workers=min(8, len(components))) as pool:
            resolved = list(pool.map(resolve_component, components))
    else:
        resolved = [resolve_component(c) for c in components]
    merged = [attrs for group in resolved for attrs in group]
    return {i + 1: attrs for i, attrs in enumerate(merged)}


def merge_semantic_from_tiles(tiles) -> dict:
    """Union of one semantic class's records across tiles: one record,
    keyed by the first tile record's id, or ``{}``."""
    records = [(instance_id, attrs) for tile in tiles for instance_id, attrs in tile.items()]
    if not records:
        return {}
    merged_box = records[0][1]["box"]
    for _, attrs in records[1:]:
        merged_box = merge_boxes(merged_box, attrs["box"])
    seg = join_ranges([_ranges_of(a["starts"], a["runs"]) for _, a in records])
    return {records[0][0]: {"box": merged_box, "starts": seg[:, 0],
                            "runs": seg[:, 1] - seg[:, 0]}}


def merge_objects_from_tiles(tiles, overlap_rle=None) -> dict:
    """Union of one thing class's instances across tiles: the components
    of the object graph (``object_iou_graph``, tiles as sources), numbered
    from the smallest tile instance id in component order.  A component of
    one object whose RLE lies more than 10 % inside ``overlap_rle`` (the
    tiles' shared pixels) is dropped: the neighbouring tile saw no such
    object."""
    tile_indices, object_labels = [], []
    object_boxes, object_starts, object_runs = [], [], []
    for tile_idx, tile in enumerate(tiles):
        for instance_id, attrs in tile.items():
            tile_indices.append(tile_idx)
            object_labels.append(int(instance_id))
            object_boxes.append(attrs["box"])
            object_starts.append(attrs["starts"])
            object_runs.append(attrs["runs"])
    if not object_boxes:
        return {}
    graph = object_iou_graph(np.array(tile_indices), np.array(object_labels),
                             np.array(object_boxes), object_starts, object_runs)
    instance_id = int(np.min(object_labels))
    instances = {}
    for cluster in connected_components(graph):
        cluster = list(cluster)
        merged_box = graph.nodes[cluster[0]]["box"]
        for node_id in cluster[1:]:
            merged_box = merge_boxes(merged_box, graph.nodes[node_id]["box"])
        voted = join_ranges([_ranges_of(graph.nodes[n]["starts"], graph.nodes[n]["runs"])
                             for n in cluster])
        if overlap_rle is not None and len(cluster) < 2 and np.any(voted):
            rle = ranges_to_rle(voted)
            if rle_ioa(*overlap_rle, rle[:, 0], rle[:, 1]) > 0.1:
                continue
        if np.any(voted):
            instances[instance_id] = {"box": tuple(int(b) for b in merged_box),
                                      "starts": voted[:, 0],
                                      "runs": voted[:, 1] - voted[:, 0]}
            instance_id += 1
    return instances
