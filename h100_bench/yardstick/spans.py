"""The program's own spans beside the device trace of a traced slice.

The program records spans (``distillation_trajectories_torch.utils.profiling``:
``span``, ``recording``) on the Unix clock in ns, the clock of the
profiler's host events and of ``trace.py``'s window, and never in the
profiler's event stream.  :func:`trace_spans` runs a slice under both, as
``trace.py::trace_slice`` does (device activity and runtime calls), and
keeps besides each kernel's, memory operation's and runtime call's
correlation id (a graph's kernels carry their ``cudaGraphLaunch``'s).  The
joins:

* each kernel and memory operation to the innermost program span open when
  the runtime call that launched it began (:func:`device_by_span`);
* each idle gap of the window (``Trace._idle_gaps``: the profiler's own
  buffer handling left out) to the innermost program span open when the gap
  began (:func:`idle_by_span`).

The readings (each ``None`` where the slice holds no span it reads, as in
a program without spans): :func:`graph_rebuild_share`,
:func:`graph_builds_per_call`, :func:`draw_share`, :func:`metric_suite_ms`
and :func:`setup_graph_s`.  The benchmark's runs do not read them yet:
``span_readings.py`` does.
"""

from __future__ import annotations

import contextlib
import threading
import time
import types
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .trace import Trace

MARK = "h100_bench.span_slice"
GRAPH_BUILDS = ("graph.warmup", "graph.capture")
SETUP_GRAPH = ("graph.warmup", "graph.capture", "epoch.warmup", "epoch.capture")
OUTSIDE = "outside the program's spans"


def recording():
    """The program's span recorder; for a program without one, a recording
    that keeps nothing."""
    try:
        from distillation_trajectories_torch.utils.profiling import recording as program_recording
    except ImportError:
        return contextlib.nullcontext(types.SimpleNamespace(spans=[]))
    return program_recording()


def nested(spans: Sequence) -> list:
    """``spans`` of the calling thread, by start and the longest first, so
    that each span's enclosing spans come before it."""
    me = threading.get_ident()
    return sorted((s for s in spans if s.thread == me), key=lambda s: (s.start_ns, -s.end_ns))


def innermost(spans: Sequence, times: np.ndarray) -> np.ndarray:
    """For each time (ns), the index into ``spans`` (:func:`nested`'s order)
    of the innermost span open at it (start <= t < end); -1 where none is."""
    times = np.asarray(times, dtype=np.int64)
    if not len(spans):
        return np.full(len(times), -1)
    starts = np.array([s.start_ns for s in spans], dtype=np.int64)
    ends = np.array([s.end_ns for s in spans], dtype=np.int64)
    parent, stack = np.full(len(spans), -1), []
    for i in range(len(spans)):
        while stack and ends[stack[-1]] <= starts[i]:
            stack.pop()
        parent[i] = stack[-1] if stack else -1
        stack.append(i)
    idx = np.searchsorted(starts, times, side="right") - 1
    while True:
        shut = (idx >= 0) & (ends[np.maximum(idx, 0)] <= times)
        if not shut.any():
            return idx
        idx[shut] = parent[idx[shut]]


@dataclass
class SpanTrace:
    """A traced slice: the trace as ``trace.py`` reads it, the program's
    spans of the calling thread (:func:`nested`), and the correlation ids
    of the trace's kernels, memory operations and host events, row for row."""

    trace: Trace
    spans: list
    kernel_corr: np.ndarray
    mem_names: List[str]
    mem_corr: np.ndarray
    host_corr: np.ndarray

    @property
    def host_window_s(self) -> float:
        """The slice's seconds on the host clock, the profiler's own
        buffer handling included, as in the spans' own seconds."""
        return (self.trace.window[1] - self.trace.window[0]) / 1e9

    def launch_ns(self, corr: np.ndarray) -> np.ndarray:
        """The start of the runtime call of each correlation id; -1 where
        no call of the calling thread has it."""
        start = dict(zip(self.host_corr.tolist(), self.trace.host[:, 0].tolist()))
        start.pop(0, None)
        return np.array([start.get(c, -1) for c in corr.tolist()], dtype=np.int64)


def trace_spans(fn: Callable[[], Dict[str, float]], device: torch.device) -> SpanTrace:
    """Run ``fn`` under the profiler (device activity and runtime calls, as
    ``trace_slice``) and the program's span recorder; the window is the
    host clock around ``fn`` and a synchronise."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [] if device.type == "cuda" else [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        with record_function(MARK), recording() as rec:
            t0 = time.time_ns()
            info = fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t1 = time.time_ns()
    events = prof.profiler.kineto_results.events()
    cpu = torch.autograd.DeviceType.CPU
    thread = next((e.start_thread_id() for e in events
                   if e.name() == MARK and e.device_type() == cpu), None)
    kernels, mems, host = [], [], []
    for e in events:
        row = (e.name(), e.start_ns(), e.end_ns(), e.correlation_id())
        if e.device_type() == cpu:
            if (thread is None or e.start_thread_id() == thread) and e.name() != MARK:
                host.append(row)
        elif not e.is_user_annotation():
            (mems if e.name().startswith(("Memcpy", "Memset")) else kernels).append(row)
    host.sort(key=lambda r: (r[1], -r[2]))
    spans = lambda rows: np.asarray([r[1:3] for r in rows], dtype=np.int64).reshape(-1, 2)
    corr = lambda rows: np.asarray([r[3] for r in rows], dtype=np.int64)
    trace = Trace((t0, t1), [r[0] for r in kernels], spans(kernels), spans(mems),
                  [r[0] for r in host], spans(host), dict(info or {}))
    return SpanTrace(trace, nested(rec.spans), corr(kernels), [r[0] for r in mems], corr(mems),
                     corr(host))


def _name(spans: Sequence, i: int) -> str:
    return spans[i].name if i >= 0 else OUTSIDE


def _sum_by(names: List[str], seconds: np.ndarray) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for n, s in zip(names, seconds.tolist()):
        out[n] = out.get(n, 0.0) + s
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def owners(st: SpanTrace, corr: np.ndarray) -> np.ndarray:
    """The innermost program span (index into ``st.spans``) open when the
    runtime call of each correlation id began; -1 where none was or no
    runtime call of the calling thread has the id."""
    launch = st.launch_ns(corr)
    owner = innermost(st.spans, launch)
    owner[launch < 0] = -1
    return owner


def device_by(st: SpanTrace, label: Callable[[Optional[object]], str]) -> Dict[str, float]:
    """Device seconds of the slice's kernels and memory operations by
    ``label`` of the innermost program span open at their launch (``None``
    where none was)."""
    rows = np.concatenate([st.trace.kernels, st.trace.memops])
    owner = owners(st, np.concatenate([st.kernel_corr, st.mem_corr]))
    names = [label(st.spans[o] if o >= 0 else None) for o in owner.tolist()]
    return _sum_by(names, (rows[:, 1] - rows[:, 0]) / 1e9)


def device_by_span(st: SpanTrace) -> Dict[str, float]:
    """Device seconds by the name of the innermost program span open at
    each launch."""
    return device_by(st, lambda s: OUTSIDE if s is None else s.name)


def idle_by_span(st: SpanTrace) -> Dict[str, float]:
    """Idle seconds of the window by the innermost program span open when
    each gap began."""
    gaps = st.trace._idle_gaps()
    owner = innermost(st.spans, gaps[:, 0])
    return _sum_by([_name(st.spans, o) for o in owner.tolist()], (gaps[:, 1] - gaps[:, 0]) / 1e9)


def seconds_in(spans: Sequence, names: Sequence[str]) -> float:
    return sum(s.end_ns - s.start_ns for s in spans if s.name in names) / 1e9


def clock_check(st: SpanTrace, runtime: str, span_names: Sequence[str],
                device_name: str = "") -> dict:
    """Whether every runtime call named ``runtime`` (whose device work, where
    ``device_name`` is given, has that substring: ``DtoH``) lies inside a
    program span named one of ``span_names``: the calls, those outside, and
    the widest distance (µs) by which a call sticks out of its nearest such
    span and the narrowest margin of one inside."""
    rows = [i for i, n in enumerate(st.trace.host_names) if n == runtime]
    if device_name:
        keep = {c for n, c in zip(st.mem_names + st.trace.kernel_names,
                                  np.concatenate([st.mem_corr, st.kernel_corr]).tolist())
                if device_name in n}
        rows = [i for i in rows if int(st.host_corr[i]) in keep]
    boxes = np.array([(s.start_ns, s.end_ns) for s in st.spans if s.name in span_names],
                     dtype=np.int64).reshape(-1, 2)
    if not len(boxes):
        return {"calls": len(rows), "outside": len(rows), "widest_outside_us": None,
                "narrowest_margin_us": None}
    outside, out_us, margin_us = 0, 0.0, None
    for a, b in st.trace.host[rows].tolist():
        stick = np.maximum(boxes[:, 0] - a, 0) + np.maximum(b - boxes[:, 1], 0)
        j = int(np.argmin(stick))
        if stick[j] > 0:
            outside += 1
            out_us = max(out_us, stick[j] / 1e3)
        else:
            m = min(a - boxes[j, 0], boxes[j, 1] - b) / 1e3
            margin_us = m if margin_us is None else min(margin_us, m)
    return {"calls": len(rows), "outside": outside, "widest_outside_us": out_us,
            "narrowest_margin_us": margin_us}


# -- the five readings ------------------------------------------------------------


def graph_rebuild_share(st: SpanTrace) -> Optional[float]:
    """% of the slice's host seconds inside ``graph.warmup`` and
    ``graph.capture`` spans."""
    if not any(s.name in GRAPH_BUILDS for s in st.spans):
        return None
    return 100.0 * seconds_in(st.spans, GRAPH_BUILDS) / st.host_window_s


def graph_builds_per_call(st: SpanTrace) -> Optional[float]:
    """``graph.warmup`` and ``graph.capture`` spans a ``sweep.call`` span."""
    calls = sum(s.name == "sweep.call" for s in st.spans)
    if not calls:
        return None
    return sum(s.name in GRAPH_BUILDS for s in st.spans) / calls


def draw_share(st: SpanTrace) -> Optional[float]:
    """% of the slice's host seconds inside ``draws`` spans."""
    if not any(s.name == "draws" for s in st.spans):
        return None
    return 100.0 * seconds_in(st.spans, ("draws",)) / st.host_window_s


def metric_suite_ms(st: SpanTrace) -> Optional[float]:
    """Device ms of the kernels launched inside ``sweep.metrics`` spans, a
    ``sweep.call`` span."""
    calls = sum(s.name == "sweep.call" for s in st.spans)
    by_id = {s.id: s for s in st.spans}

    def inside_metrics(i: int) -> bool:
        s = st.spans[i] if i >= 0 else None
        while s is not None:
            if s.name == "sweep.metrics":
                return True
            s = by_id.get(s.parent)
        return False

    owner = owners(st, st.kernel_corr)
    picked = np.array([inside_metrics(o) for o in owner.tolist()], dtype=bool)
    if not calls or not picked.any():
        return None
    k = st.trace.kernels[picked]
    return float((k[:, 1] - k[:, 0]).sum()) / 1e6 / calls


def setup_graph_s(setup_spans: Sequence) -> Optional[float]:
    """Set-up's seconds inside the warm-up and capture spans of the sampler
    graphs and the epoch lane."""
    if not any(s.name in SETUP_GRAPH for s in setup_spans):
        return None
    return seconds_in(setup_spans, SETUP_GRAPH)
