"""The generators and ``graph.build``: deterministic by seed, symmetric, no
self-loops, no duplicate entries, sorted, one weight for both directions."""

import pytest
import torch

from graphbench.core import graph as G
from graphbench.core.spec import find_cell


def _config(cell):
    return find_cell(cell).config


@pytest.mark.parametrize("cell", ["kron-bfs", "urand-bfs"])
def test_same_seed_same_graph_other_seed_other_graph(cell):
    cfg = _config(cell)
    a = G.build(cfg, 2**31 + 12345, torch.device("cpu"), rehearse_scale=9)
    b = G.build(cfg, 2**31 + 12345, torch.device("cpu"), rehearse_scale=9)
    c = G.build(cfg, 2**31 + 12346, torch.device("cpu"), rehearse_scale=9)
    assert a.checksum == b.checksum
    for f in ("rows", "cols", "weights"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    assert a.checksum != c.checksum


@pytest.mark.parametrize("cell", ["kron-bfs", "urand-bfs"])
@pytest.mark.parametrize("seed", [0, 7, 4_000_000_001])
def test_graph_is_symmetric_sorted_and_simple(cell, seed):
    g = G.build(_config(cell), seed, torch.device("cpu"), rehearse_scale=8)
    r, c, w = g.rows.long(), g.cols.long(), g.weights
    assert g.rows.dtype == g.cols.dtype == torch.int32 and w.dtype == torch.float32
    assert bool((r != c).all()), "self-loop"
    key = r * g.n + c
    assert bool((key[1:] > key[:-1]).all()), "not sorted, or a duplicate entry"
    back = torch.sort(c * g.n + r)
    assert torch.equal(back.values, key), "not symmetric"
    assert torch.equal(w[back.indices], w), "the two directions differ in weight"
    assert bool(((w >= 1) & (w <= 255) & (w == w.round())).all())


def test_generated_edges_are_what_the_graph_keeps():
    """The graph keeps every generated edge but self-loops, once, both ways."""
    cfg = _config("urand-bfs")
    scale = 7
    g = G.generator(99, "graph", torch.device("cpu"))
    gen = G.load_module("generators", "urand")
    src, dst = next(gen.edges(cfg, scale, g, torch.device("cpu"), G.CHUNK))
    keep = src != dst
    want = torch.unique(torch.cat([src[keep] * 128 + dst[keep], dst[keep] * 128 + src[keep]]))
    got = G.build(cfg, 99, torch.device("cpu"), rehearse_scale=scale)
    assert torch.equal(got.rows.long() * 128 + got.cols.long(), want)


def test_kron_is_skewed_and_urand_is_not():
    kron = G.build(_config("kron-bfs"), 5, torch.device("cpu"), rehearse_scale=12)
    urand = G.build(_config("urand-bfs"), 5, torch.device("cpu"), rehearse_scale=12)
    dk, du = kron.degrees().float(), urand.degrees().float()
    assert dk.max() > 20 * dk.mean()
    assert du.max() < 3 * du.mean()
    assert float((dk == 0).float().mean()) > 0.1  # kron leaves many vertices isolated
    assert abs(float(du.mean()) - 32) < 1.0  # edge factor 16, both directions stored


def test_sources_are_live_vertices_drawn_from_the_seed():
    g = G.build(_config("kron-bfs"), 3, torch.device("cpu"), rehearse_scale=9)
    deg = g.degrees()
    s1, hub1 = G.sources(g, 11, 500)
    s2, hub2 = G.sources(g, 11, 500)
    s3, _ = G.sources(g, 12, 500)
    assert s1 == s2 and hub1 == hub2 and s1 != s3
    assert all(int(deg[s]) > 0 for s in s1)
    assert int(deg[hub1]) == int(deg.max())


def test_a_graph_seed_makes_one_graph_for_every_run():
    cfg = _config("urand-sssp")
    assert "graph_seed" in cfg
    assert G.graph_seed(cfg, 5) == G.graph_seed(cfg, 2**31 + 6) == cfg["graph_seed"]
    assert G.graph_seed(_config("kron-bfs"), 5) == 5  # without one, the run's seed
    a = G.build(cfg, G.graph_seed(cfg, 5), torch.device("cpu"), rehearse_scale=9)
    b = G.build(cfg, G.graph_seed(cfg, 2**31 + 6), torch.device("cpu"), rehearse_scale=9)
    assert a.checksum == b.checksum and torch.equal(a.cols, b.cols)


def test_trials_run_one_set_of_sources_for_every_seed_in_another_order():
    cell = find_cell("urand-sssp")
    cfg, mix = cell.config, cell.mix
    k = int(mix["trials"])
    g = G.build(cfg, G.graph_seed(cfg, 1), torch.device("cpu"), rehearse_scale=9)
    deg = g.degrees()
    s1, hub1 = G.window_sources(g, cfg, mix, 2**31 + 21, 5 * k + 7)
    s2, hub2 = G.window_sources(g, cfg, mix, 2**31 + 22, 5 * k + 7)
    again, _ = G.window_sources(g, cfg, mix, 2**31 + 21, 5 * k + 7)
    assert s1 == again and hub1 == hub2 and len(s1) == 5 * k + 7
    assert s1 != s2 and s1[:k] != s2[:k]
    for c in range(5):  # every full cycle holds each trial once
        assert sorted(s1[c * k:(c + 1) * k]) == sorted(s2[c * k:(c + 1) * k]) == sorted(s1[:k])
    assert all(int(deg[s]) > 0 for s in s1)
    plain, _ = G.window_sources(g, cfg, {"query": "sssp"}, 2**31 + 21, 50)  # no trials: drawn from the seed
    assert plain == G.sources(g, 2**31 + 21, 50)[0]
