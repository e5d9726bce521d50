"""The joins of the program's spans with a traced slice
(``yardstick/spans.py``) and the five readings on synthetic traces, then a
CPU rehearsal of ``span_readings.py`` in every cell: the spans each slice
records and the readings a CPU run gives (none of the device's)."""

import contextlib
import json
import math
import threading
import types

import numpy as np
import pytest
import torch

from h100_bench import harness
from h100_bench import span_readings as R
from h100_bench.tests.tiny import tiny_cell
from h100_bench.yardstick import spans as S
from h100_bench.yardstick.trace import Trace

from distillation_trajectories_torch.utils.profiling import Span

CELLS = [w["name"] for w in harness.manifest()["workloads"]]
SEED = 2 ** 31 + 2 ** 20 + 17


def _span(name, a, b, id, parent=None, call=None, **attrs):
    return Span(name, a, b, threading.get_ident(), id, parent, call or id, attrs)


def _synthetic():
    """A sweep call (0–1000 ns) holding a teacher build (100–300), a replay
    (300–400) and the metric suite (400–700); kernels launched by runtime
    calls in each, one by a call on no program span, one by another thread."""
    spans = S.nested([
        _span("sweep.call", 0, 1000, 1),
        _span("draws", 10, 90, 2, 1, 1, n=4),
        _span("graph.warmup", 100, 200, 3, 1, 1, key=b"k"),
        _span("graph.capture", 200, 300, 4, 1, 1, key=b"k"),
        _span("graph.replay", 300, 400, 5, 1, 1, key=b"k"),
        _span("sweep.metrics", 400, 700, 6, 1, 1, sf=0.1, gs=1.0),
        Span("draws", 0, 1000, -1, 7, None, 7, {"n": 1}),  # another thread's
    ])
    host_names = ["cudaLaunchKernel", "cudaGraphLaunch", "cudaLaunchKernel",
                  "cudaLaunchKernel", "cudaMemcpyAsync"]
    host = np.array([[20, 30], [310, 320], [450, 460], [460, 470], [1100, 1110]], np.int64)
    host_corr = np.array([11, 12, 13, 14, 15])
    # kernels: draw (corr 11), two graph kernels (12), two suite kernels, one unknown.
    kernels = np.array([[40, 60], [500, 600], [600, 650], [700, 800], [800, 850], [900, 950]],
                       np.int64)
    kernel_corr = np.array([11, 12, 12, 13, 14, 99])
    mems = np.array([[1120, 1130]], np.int64)
    trace = Trace((0, 1200), ["draw", "g1", "g2", "m1", "m2", "x"], kernels, mems, host_names,
                  host, {})
    return S.SpanTrace(trace, spans, kernel_corr, ["Memcpy DtoH"], np.array([15]), host_corr)


def test_innermost_takes_the_deepest_open_span():
    st = _synthetic()
    got = S.innermost(st.spans, np.array([-5, 5, 50, 150, 350, 699, 700, 999, 1000]))
    names = [S._name(st.spans, i) for i in got.tolist()]
    assert names == [S.OUTSIDE, "sweep.call", "draws", "graph.warmup", "graph.replay",
                     "sweep.metrics", "sweep.call", "sweep.call", S.OUTSIDE]
    assert all(s.thread == threading.get_ident() for s in st.spans) and len(st.spans) == 6


def test_kernels_and_idle_gaps_join_their_spans():
    st = _synthetic()
    owners = [S._name(st.spans, i) for i in S.owners(st, st.kernel_corr).tolist()]
    assert owners == ["draws", "graph.replay", "graph.replay", "sweep.metrics",
                      "sweep.metrics", S.OUTSIDE]
    assert S.device_by_span(st) == pytest.approx({
        "graph.replay": 150e-9, "sweep.metrics": 150e-9, "draws": 20e-9, S.OUTSIDE: 60e-9})
    # Idle gaps 0-40, 60-500, 650-700, 850-900, 950-1120 and 1130-1200, each
    # charged to the span open when it began (the first to the call: draws
    # begins at 10).
    assert S.idle_by_span(st) == pytest.approx({
        "draws": 440e-9, "sweep.call": 260e-9, S.OUTSIDE: 70e-9, "sweep.metrics": 50e-9})
    assert sum(S.idle_by_span(st).values()) == pytest.approx(
        st.trace.window_s - st.trace.busy_s())


def test_the_five_readings_on_a_synthetic_slice():
    st = _synthetic()
    assert S.graph_rebuild_share(st) == pytest.approx(100 * 200 / 1200)
    assert S.graph_builds_per_call(st) == 2
    assert S.draw_share(st) == pytest.approx(100 * 80 / 1200)
    assert S.metric_suite_ms(st) == pytest.approx(150e-6)
    assert S.setup_graph_s(st.spans) == pytest.approx(200e-9)
    clock = S.clock_check(st, "cudaGraphLaunch", ("graph.replay",))
    assert clock == {"calls": 1, "outside": 0, "widest_outside_us": 0.0,
                     "narrowest_margin_us": pytest.approx(0.01)}
    # The copy back ran after every span: it is outside, by 1100 - 1000 ns.
    to_host = S.clock_check(st, "cudaMemcpyAsync", ("sweep.call",), "DtoH")
    assert to_host["calls"] == 1 and to_host["outside"] == 1
    assert to_host["widest_outside_us"] == pytest.approx(0.11)
    # With no span to hold them, every call is outside.
    assert S.clock_check(st, "cudaGraphLaunch", ("epoch.replay",))["outside"] == 1


def test_readings_are_none_without_the_spans_they_read():
    st = _synthetic()
    bare = S.SpanTrace(st.trace, [], st.kernel_corr, st.mem_names, st.mem_corr, st.host_corr)
    assert [f(bare) for f in (S.graph_rebuild_share, S.graph_builds_per_call, S.draw_share,
                              S.metric_suite_ms)] == [None] * 4
    assert S.setup_graph_s([]) is None
    assert S.device_by_span(bare) == pytest.approx({S.OUTSIDE: 380e-9})


def test_chain_labels_name_each_replays_chain():
    pair = [_span("pairs.call", 0, 100, 1), _span("draws", 1, 2, 2, 1, 1),
            _span("graph.replay", 3, 4, 3, 1, 1), _span("graph.replay", 5, 6, 4, 1, 1),
            _span("pairs.to_host", 7, 8, 5, 1, 1)]
    sweep = [_span("sweep.call", 200, 300, 11), _span("graph.replay", 201, 202, 12, 11, 11),
             _span("graph.replay", 203, 204, 13, 11, 11),
             _span("sweep.metrics", 205, 206, 14, 11, 11, sf=0.5, gs=3.0)]
    assert R.chain_labels(S.nested(pair + sweep)) == {3: "teacher", 4: "student", 12: "teacher",
                                                      13: "student sf 0.5"}


SLICE_SPANS = {"sweep": {"sweep.call", "draws", "sweep.metrics"},
               "pairs": {"pairs.call", "draws", "pairs.to_host"},
               "train": {"train.epoch", "train.loss_fetch"}}


@pytest.mark.parametrize("name", CELLS)
def test_trace_rehearsal(name):
    cell = tiny_cell(name)
    r = R.trace_cell(cell, SEED, 0.3, torch.device("cpu"))
    assert r["window"]["calls"] >= 1 and r["slice"]["kernels"] == 0
    assert set(r["slice"]["spans"]) == SLICE_SPANS[cell.traffic["driver"]]
    readings = r["readings"]
    samples = cell.traffic["driver"] != "train"
    # The CPU captures nothing and has no device: no graph, no kernel read.
    assert readings["graph_rebuild_share"] is None and readings["metric_suite_ms"] is None
    assert readings["setup_graph_s"] is None
    assert (readings["draw_share.sample"] is not None) == samples
    if samples:
        assert 0 < readings["draw_share.sample"] < 100
    assert (readings["graph_builds_per_call"] == 0) == (cell.traffic["driver"] == "sweep")
    assert sum(r["slice"]["idle_by_span"].values()) == pytest.approx(
        r["slice"]["window_s"], rel=1e-9)
    assert r["clock"]["graph_launch"]["calls"] == r["clock"]["graph_launch"]["outside"] == 0


def test_calls_rehearsal_records_each_call(tmp_path):
    out = tmp_path / "calls.jsonl"
    r = R.calls_cell(tiny_cell("cifar10-32.pairs-b1"), SEED, [(False, 0.2), (True, 0.2)],
                     torch.device("cpu"), str(out))
    assert [w["recording"] for w in r["windows"]] == [False, True]
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert len(lines) == sum(w["calls"] for w in r["windows"])
    on = [x for x in lines if x["recording"]]
    assert on and all(set(x["spans"]) == {"draws", "pairs.to_host"} for x in on)
    assert all(0 < sum(x["spans"].values()) < x["s"] for x in on)
    assert [x["k"] for x in lines] == list(range(len(lines)))
    assert all(x["spans"] == {} for x in lines if not x["recording"])
    assert all(math.isfinite(w["rate"]) for w in r["windows"])


def test_a_program_without_spans_reads_nothing(monkeypatch):
    none = lambda: contextlib.nullcontext(types.SimpleNamespace(spans=[]))  # noqa: E731
    monkeypatch.setattr(S, "recording", none)
    r = R.trace_cell(tiny_cell("cifar10-32.sweep"), SEED, 0.3, torch.device("cpu"))
    assert set(r["readings"].values()) == {None} and r["slice"]["spans"] == {}
