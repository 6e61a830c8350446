"""The shared arithmetic: operation counts, the idle union, percentiles."""

from __future__ import annotations

import json

import pytest

from benchmark.common import flops, timeline
from benchmark.reference import model as rm

from .tiny import BENCH


@pytest.mark.parametrize("n,want", [(1, 3.1257e11), (64, 2.0004e13)])
def test_fused_flops_at_beat(n, want):
    got = flops.fused_flops(n, 40, 32, 256, 123, 1024, 4, 1000)
    assert got == pytest.approx(want, rel=1e-4)


def test_fused_flops_hoisting_counts_memory_once():
    def count(nm, steps):
        return flops.fused_flops(1, 40, nm, 256, 123, 1024, 4, steps)

    # every memory row's keys and values once a call ...
    assert count(32, 0) == 4 * 2 * 32 * 256 * 2 * 256
    # ... and a step more adds, per memory row, only its cross-attention
    # scores and values, not its projection
    assert ((count(33, 11) - count(33, 10)) - (count(32, 11) - count(32, 10))
            == 4 * 2 * 2 * 40 * 256)


def test_beat_shapes_from_the_reference():
    cfg = json.loads((BENCH / "configs" / "beat-ours.json").read_text())
    ref = rm.build(cfg, "meta")
    assert flops.memory_rows(ref, 32000) == 31
    eager = flops.denoise_flops(ref, 1, 40, 123, 31, 256)
    fused = flops.fused_flops(1, 40, 32, 256, 123, 1024, 4, 1)
    # a one-step call counts two memory rows' keys and values twice; the
    # eager step adds what the fused count leaves out, more than that:
    # the memory's and the token's embeddings and the step MLP
    assert fused < eager < 1.02 * fused


def test_union_counts_overlap_once():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert timeline.union(iv) == [(0.0, 3.0), (5.0, 6.0)]
    assert timeline.busy(iv, 0.0, 10.0) == pytest.approx(4.0)
    assert timeline.busy(iv, 2.5, 5.5) == pytest.approx(1.0)
    assert timeline.gaps(iv, -1.0, 7.0) == [(-1.0, 0.0), (3.0, 5.0),
                                            (6.0, 7.0)]


def test_p90_leaves_ten_beyond_it_in_a_hundred():
    vals = list(range(100, 0, -1))
    assert timeline.percentile(vals, 90) == 90
    assert sum(v > 90 for v in vals) == 10
    assert timeline.percentile([3.0], 90) == 3.0
    assert timeline.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], 90) == 10
    with pytest.raises(ValueError):
        timeline.percentile([], 90)


def test_gap_labels_take_the_innermost_host_event():
    host = [("outer", 0.0, 10.0), ("inner", 2.0, 4.0), ("later", 6.0, 6.5)]
    got = timeline.label_gaps([(2.5, 3.5), (7.0, 9.0), (11.0, 12.0)], host)
    assert got == [["outer", 2.0], ["inner", 1.0], ["host: none", 1.0]]


def test_gap_labels_fall_back_to_the_enclosing_range():
    n = timeline.SCAN + 50
    host = [("bench/request", 0.0, 1.0)] + [
        (f"op{i}", 0.1 + i * 1e-7, 0.1 + i * 1e-7 + 1e-8) for i in range(n)]
    got = timeline.label_gaps([(0.5, 0.6)], host)
    assert got == [["bench/request", pytest.approx(0.1)]]
