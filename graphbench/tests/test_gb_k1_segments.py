"""``k1_segments_per_pull``'s reading of the program's counters: the segments
of x kernel 1's launches walked in turn, a launch."""

from types import SimpleNamespace

import pytest

from graphbench.core.spec import load_module


@pytest.mark.parametrize("launches,segments", [
    ({}, None), ({"spmv_pull": 7}, None), ({"pull_segments": 0, "spmv_pull": 0}, None),
    ({"pull_segments": 42, "spmv_pull": 7}, 6.0), ({"pull_segments": 14, "spmv_pull": 14}, 1.0),
    ({"pull_segments": 9, "spmv_pull": 1, "spmv_pull_generic": 2}, 3.0),
], ids=["no-counters", "no-segments", "no-pulls", "six", "one", "both-families"])
def test_k1_segments_per_pull_reads_the_segments_a_launch(launches, segments):
    """None where the program has no ``pull_segments`` counter (the parent)
    or launched no pull; else the segments over the templated and generic
    launches."""
    read = load_module("metrics", "k1_segments_per_pull").read
    got = read(SimpleNamespace(counters={"stats": {}, "launches": launches}, queries=3))
    assert got == (None if segments is None else pytest.approx(segments, rel=1e-12))
