"""A configuration's graph, made on the device from the seed, as GAP constructs it.

A generator (``graphbench/generators/<name>.py``) yields the directed edge
list in chunks; this module turns it into what GAP benchmarks: the graph
made undirected (both directions stored), self-loops and duplicate edges
removed, sorted row-major.  Each generated edge draws one integer weight,
uniform on ``[low, high]`` (GAP: 1 to 255), and both of its directions
carry it; where an edge was generated more than once the smallest of its
weights stays, the same in both directions.

The whole edge set is one int64 key an entry, ``row | col | weight``, so one
sort and one pass make the graph.  The result is three plain tensors, the
benchmark's own; the program gets them and builds from them what it needs.
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass

import torch

from .spec import load_module

WEIGHT_BITS = 8
CHUNK = 1 << 26  # generated edges a chunk


@dataclass
class Graph:
    n: int
    rows: torch.Tensor  # int32 [nnz], sorted row-major
    cols: torch.Tensor  # int32 [nnz]
    weights: torch.Tensor  # f32 [nnz], whole numbers
    checksum: int  # of the sorted keys: the same seed gives the same graph

    @property
    def nnz(self) -> int:
        return self.rows.shape[0]

    @property
    def device(self) -> torch.device:
        return self.rows.device

    def degrees(self) -> torch.Tensor:
        """Stored entries of each row (int64 [n]): the degree, as the graph is symmetric."""
        bounds = torch.arange(self.n + 1, dtype=torch.int32, device=self.device)
        ptr = torch.searchsorted(self.rows, bounds)
        return ptr[1:] - ptr[:-1]


def sub_seed(seed: int, what: str) -> int:
    """A 63-bit seed for one purpose, drawn from the run's ``--seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{what}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, what: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, what))
    return g


def graph_seed(config: dict, seed: int) -> int:
    """The seed the configuration's graph is made from: its own ``graph_seed``
    where it states one (as GAP makes one graph for every trial), else the run's."""
    return int(config.get("graph_seed", seed))


def build(config: dict, seed: int, device, rehearse_scale: int | None = None) -> Graph:
    """The configuration's graph from ``seed`` on ``device``; callers pass
    ``graph_seed(config, run_seed)``."""
    scale = int(config["scale"] if rehearse_scale is None else rehearse_scale)
    n = 1 << scale
    if 2 * scale + WEIGHT_BITS > 62:
        raise ValueError(f"scale {scale} leaves no room for the packed keys")
    low, high = (int(v) for v in (config["weights"]["low"], config["weights"]["high"]))
    if not 1 <= low <= high < 1 << WEIGHT_BITS:
        raise ValueError(f"weights [{low}, {high}] do not fit {WEIGHT_BITS} bits")
    gen = load_module("generators", config["generator"])
    g = generator(seed, "graph", device)
    edges = int(config["edge_factor"]) << scale
    sentinel = torch.iinfo(torch.int64).max
    keys = torch.empty(2 * edges, dtype=torch.int64, device=device)
    at = 0
    for src, dst in gen.edges(config, scale, g, device, CHUNK):
        m = src.shape[0]
        w = torch.randint(low, high + 1, (m,), generator=g, device=device, dtype=torch.int64)
        loop = src == dst
        for a, b, out in ((src, dst, keys[at:at + m]), (dst, src, keys[at + m:at + 2 * m])):
            torch.mul(a, n, out=out)
            out.add_(b).mul_(1 << WEIGHT_BITS).add_(w)
            out.masked_fill_(loop, sentinel)
        at += 2 * m
        del src, dst, w, loop
    if at != 2 * edges:
        raise ValueError(f"generator {config['generator']!r} gave {at // 2} edges, want {edges}")
    keys = torch.unique(keys)  # sorted; drops exact repeats
    keys = keys[:int(torch.searchsorted(keys, torch.tensor(sentinel, device=device)))]
    pair = keys >> WEIGHT_BITS
    first = torch.ones_like(pair, dtype=torch.bool)
    torch.ne(pair[1:], pair[:-1], out=first[1:])  # the smallest weight of each edge stays
    del pair
    keys = keys[first]
    del first
    checksum = int(keys.sum())
    rows = (keys >> (scale + WEIGHT_BITS)).to(torch.int32)
    cols = ((keys >> WEIGHT_BITS) & (n - 1)).to(torch.int32)
    weights = (keys & ((1 << WEIGHT_BITS) - 1)).to(torch.float32)
    return Graph(n=n, rows=rows, cols=cols, weights=weights, checksum=checksum)


def sources(graph: Graph, seed: int, count: int) -> tuple:
    """``count`` query sources drawn uniformly from ``seed`` among the vertices
    of non-zero degree (GAP's source picker), and a vertex of the largest
    degree, which the warm-up starts from."""
    deg = graph.degrees()
    live = torch.nonzero(deg > 0).flatten()
    if live.numel() == 0:
        raise ValueError("the graph has no edge")
    g = generator(seed, "sources", graph.device)
    pick = torch.randint(0, live.numel(), (count,), generator=g, device=graph.device)
    return live[pick].tolist(), int(torch.argmax(deg))


def window_sources(graph: Graph, config: dict, mix: dict, seed: int, count: int) -> tuple:
    """The window's ``count`` sources and the warm-up's vertex.  A mix with
    ``trials`` runs GAP's fixed trials: that many sources drawn once from the
    graph's own seed, cycled, each cycle in an order drawn from ``seed``, so
    that every seed does the same work.  Without it, ``count`` sources drawn
    from ``seed``."""
    if "trials" not in mix:
        return sources(graph, seed, count)
    pool, hub = sources(graph, graph_seed(config, seed), int(mix["trials"]))
    rng = random.Random(sub_seed(seed, "order"))
    order = []
    while len(order) < count:
        order += rng.sample(pool, len(pool))
    return order[:count], hub
