"""``tc_walk_share``'s reading of the program's counters: the share of the full
walk's B elements that the walk ``algorithms.tc`` chose read over the window."""

from types import SimpleNamespace

import pytest

from graphbench.core.spec import load_module


@pytest.mark.parametrize("stats,share", [({}, None), ({"tc_products": 900}, None),
                                         ({"tc_products": 0, "tc_walked": 0}, None),
                                         ({"tc_products": 900, "tc_walked": 900}, 100.0),
                                         ({"tc_products": 900, "tc_walked": 144}, 16.0)],
                         ids=["no-counters", "no-walked", "none-counted", "full", "ordered"])
def test_tc_walk_share_reads_the_walked_share_of_the_products(stats, share):
    """None where the program has no ``tc_walked`` counter (the parent) or
    counted no products; else 100 x walked / products."""
    read = load_module("metrics", "tc_walk_share").read
    got = read(SimpleNamespace(counters={"stats": stats}, queries=3))
    assert got == (None if share is None else pytest.approx(share, rel=1e-12))
