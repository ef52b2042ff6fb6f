"""A small undirected graph for the ortho-plane consensus: the part of
``networkx.Graph`` that ``stitch/consensus.py`` uses, in plain Python (the
port does not depend on networkx).

The consensus's instance ids, and through ``merge_clusters``' ties which
clusters merge at all, follow the order in which networkx (3.x) hands out
nodes, neighbours and components, so this class keeps that order exactly:

- nodes and each node's neighbours are dicts in insertion order; an edge
  that is removed and added again goes to the end of both ends' dicts;
- ``connected_components`` walks the nodes in order and grows each
  component as a Python ``set`` by breadth-first search over the
  neighbour dicts, inserting in the order networkx's ``_plain_bfs`` does,
  so a component's own iteration order (which depends on that insertion
  order once its ints exceed the set's table) is networkx's too;
- ``subgraph(nodes)`` returns what networkx's ``G.subgraph(nodes).copy()``
  returns: the nodes in the order of the set ``set(nodes)`` when that set
  holds less than half the graph, in the graph's order otherwise
  (``FilterAtlas.__iter__``), and each node's neighbours in the order that
  copy inserts them.
"""

from __future__ import annotations

from types import MappingProxyType

__all__ = ["Graph", "connected_components"]


class Graph:
    """Undirected graph with node and edge attribute dicts."""

    def __init__(self):
        self._node = {}   # node -> attribute dict
        self._adj = {}    # node -> {neighbour: edge attribute dict}

    def __len__(self) -> int:
        return len(self._node)

    def __iter__(self):
        return iter(self._node)

    def __getitem__(self, n):
        """``G[u][v]`` is the edge attribute dict of (u, v)."""
        return MappingProxyType(self._adj[n])

    @property
    def nodes(self):
        """Read-only mapping node -> attribute dict, in insertion order."""
        return MappingProxyType(self._node)

    def add_node(self, n, **attr):
        if n not in self._node:
            self._adj[n] = {}
            self._node[n] = {}
        self._node[n].update(attr)

    def add_nodes_from(self, nodes):
        for n in nodes:
            self.add_node(n)

    def add_edge(self, u, v, **attr):
        self._add_edge(u, v, attr)

    def _add_edge(self, u, v, attr):
        for n in (u, v):
            if n not in self._node:
                self._adj[n] = {}
                self._node[n] = {}
        data = self._adj[u].get(v, {})
        data.update(attr)
        self._adj[u][v] = data
        self._adj[v][u] = data

    def remove_edge(self, u, v):
        del self._adj[u][v]
        if u != v:
            del self._adj[v][u]

    def remove_node(self, n):
        nbrs = list(self._adj[n])
        del self._node[n]
        for u in nbrs:
            del self._adj[u][n]
        del self._adj[n]

    def has_edge(self, u, v) -> bool:
        return u in self._adj and v in self._adj[u]

    def neighbors(self, n):
        return iter(self._adj[n])

    def degree(self, n) -> int:
        return len(self._adj[n])

    def edges(self):
        """(u, v, attribute dict) of each edge once, from the first of its
        ends in node order."""
        seen = set()
        for n, nbrs in self._adj.items():
            for nbr, data in nbrs.items():
                if nbr not in seen:
                    yield n, nbr, data
            seen.add(n)

    def number_of_edges(self) -> int:
        return sum(len(nbrs) + (n in nbrs) for n, nbrs in self._adj.items()) // 2

    def copy(self) -> "Graph":
        """Independent copy with shallow-copied attribute dicts."""
        return self._copy(list(self._node), None)

    def subgraph(self, nodes) -> "Graph":
        """Independent copy of the subgraph induced on ``nodes``."""
        keep = set(n for n in nodes if n in self._node)
        if 2 * len(keep) < len(self._node):
            order = list(keep)
        else:
            order = [n for n in self._node if n in keep]
        return self._copy(order, keep)

    def _copy(self, order, keep):
        g = Graph()
        for n in order:
            g._adj[n] = {}
            g._node[n] = dict(self._node[n])
        for u in order:
            for v, data in self._adj[u].items():
                if keep is None or v in keep:
                    g._add_edge(u, v, dict(data))
        return g


def _bfs(g: Graph, n_left: int, source) -> set:
    """One component, grown as networkx's ``_plain_bfs`` grows it."""
    adj = g._adj
    seen = {source}
    nextlevel = [source]
    while nextlevel:
        thislevel = nextlevel
        nextlevel = []
        for v in thislevel:
            for w in adj[v]:
                if w not in seen:
                    seen.add(w)
                    nextlevel.append(w)
            if len(seen) == n_left:
                return seen
    return seen


def connected_components(g: Graph):
    """Yield each connected component as a set, in node order of its first
    node."""
    seen = set()
    n = len(g)
    for v in g:
        if v not in seen:
            comp = _bfs(g, n - len(seen), v)
            seen.update(comp)
            yield comp
