"""The metrics that read the program's spans: their arithmetic
(``common/spans.py``) on records with known idle inside and outside the
spans, and each reader on a tiny traced run of its cell on the CPU, where
it reads a number, and without its span, where it reads None."""

from __future__ import annotations

import math

import pytest

from benchmark.common import harness, spans

from . import tiny


def record(host, device, window=(0.0, 100.0)):
    return {"host": host, "device": [(n, a, b, "kernel") for n, a, b in device],
            "window": window, "requests": [{}, {}], "work": {"windows": 2}}


# two windows [10, 30] and [50, 60]: the device busy 12-14 and 13-16 (the
# two overlap: 4 s in all), and 55-70 (5 s of the second); 40-45 and 80-90
# lie outside both
REC = record(
    host=[("bench/window", 0.0, 100.0), ("generate/window", 10.0, 30.0),
          ("generate/sample", 11.0, 20.0), ("generate/to_host", 20.0, 29.0),
          ("generate/window", 50.0, 60.0), ("generate/sample", 50.0, 52.0),
          ("generate/to_host", 52.0, 53.0), ("generate/window", 95.0, 101.0)],
    device=[("k", 12.0, 14.0), ("k", 13.0, 16.0), ("k", 40.0, 45.0),
            ("k", 55.0, 70.0), ("k", 80.0, 90.0)])


def test_intervals_are_the_named_spans_inside_the_window():
    assert spans.intervals(REC, "generate/window") == [(10.0, 30.0),
                                                       (50.0, 60.0)]
    assert spans.intervals(REC, "generate/stitch") == []


def test_idle_counts_only_the_idle_inside_the_spans():
    windows = spans.intervals(REC, "generate/window")
    assert spans.idle_s(REC, windows) == pytest.approx((20 - 4) + (10 - 5))
    assert spans.idle_s(REC, [(80.0, 90.0)]) == 0.0
    assert spans.idle_s(REC, []) == 0.0


def test_self_time_leaves_out_the_children():
    assert spans.self_s(REC, "generate/window",
                        ("generate/sample", "generate/to_host")) == \
        pytest.approx((20 - 9 - 9) + (10 - 2 - 1))
    assert spans.self_s(REC, "generate/window", ()) == pytest.approx(30.0)
    # overlapping children count once
    nested = record(host=[("p", 0.0, 10.0), ("c", 1.0, 4.0), ("c", 2.0, 5.0),
                          ("d", 6.0, 7.0), ("c", 11.0, 12.0)], device=[])
    assert spans.self_s(nested, "p", ("c", "d")) == pytest.approx(10 - 4 - 1)


def test_window_gap_reads_the_idle_a_window():
    read = harness.metric_reader("window_gap_ms.sequence")
    assert read(REC) == pytest.approx(1e3 * 21 / 2)


CASES = [("sample_idle_ms.window", "beat-interactive", "generate/sample"),
         ("window_gap_ms.sequence", "beat-offline", "generate/window"),
         ("step_host_ms.sequence", "tedexp-offline", "sampler/step")]


@pytest.mark.parametrize("metric,cell,span", CASES, ids=[c[0] for c in CASES])
def test_reader_on_a_tiny_traced_run(metric, cell, span, monkeypatch):
    seen = {}
    real = harness.metric_reader

    def spy(name):
        read = real(name)

        def kept(rec):
            seen[name] = rec
            return read(rec)
        return kept

    monkeypatch.setattr(harness, "metric_reader", spy)
    res = tiny.run(cell, trace=True)
    assert math.isfinite(res["metrics"][metric]["value"])
    assert res["metrics"][metric]["value"] > 0
    rec = seen[metric]
    assert spans.intervals(rec, span)
    absent = dict(rec, host=[h for h in rec["host"] if h[0] != span])
    assert real(metric)(absent) is None
