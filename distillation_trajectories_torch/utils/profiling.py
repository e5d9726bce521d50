"""The program's span recorder, phase timers, anomaly checks and the
structured metrics log (port of the JAX package's ``utils/profiling.py``),
and the one reading of a profile its tools share.

``span(name, **attrs)`` marks a piece of the program's work.  Nothing is
kept unless a :func:`recording` is open: then each span keeps its name, its
start and end (``time.perf_counter_ns`` read at its edges and exported on
the Unix clock in ns, the clock of ``torch.profiler``'s host events, by one
offset taken when the recording starts), its thread, its parent (the span
open on the same thread when it began), the id of its call (its root span:
``sweep.call``, ``pairs.call``, ``train.epoch``) and its attributes.  Spans
never enter the profiler's event stream.  With no recording open,
``span`` reads one module-level flag and returns a shared no-op context.
Like ``phase_timer`` they time the host: work a span launches on the GPU
runs inside it only where the span synchronises.

``phase_timer`` is a span that also adds its seconds to the process-wide
phase registry, recording or not (``phase_times``, ``dump_phase_times``);
``enable_nan_checks`` is autograd's anomaly detection where the JAX package
sets ``jax_debug_nans``.  ``busy_and_window``, ``tally`` and
``trace_summary`` are the one reading of a profile that the sampler
profiler (``scripts/profile_sampler.py``) and ``chip_smoke.py`` share;
``conv_flops`` is the one FLOP count of a forward that they and the step
ablation (``scripts/bench_r2.py``) use.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

_PHASE_TIMES: Dict[str, list] = defaultdict(list)


class Span(NamedTuple):
    """One recorded span; times in Unix ns."""

    name: str
    start_ns: int
    end_ns: int
    thread: int
    id: int
    parent: Optional[int]
    call: int  # the id of the outermost span open on its thread, its own where none was
    attrs: dict


class Recording:
    """What one :func:`recording` kept: ``spans`` in the order they ended."""

    def __init__(self):
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.spans: List[Span] = []


_RECORDING: Optional[Recording] = None  # the flag: None while nothing records
_IDS = itertools.count(1)
_OPEN = threading.local()  # .stack: the spans open on this thread, outermost first
_NOOP = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "attrs", "rec", "phase", "log", "t0", "id", "parent", "call")

    def __init__(self, name: str, attrs: dict, rec: Optional[Recording], phase: bool = False,
                 log: bool = False):
        self.name, self.attrs, self.rec, self.phase, self.log = name, attrs, rec, phase, log

    def __enter__(self):
        if self.rec is not None:
            stack = getattr(_OPEN, "stack", None)
            if stack is None:
                stack = _OPEN.stack = []
            self.id = next(_IDS)
            self.parent = stack[-1].id if stack else None
            self.call = stack[0].call if stack else self.id
            stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        rec = self.rec
        if rec is not None:
            _OPEN.stack.remove(self)
            rec.spans.append(Span(self.name, self.t0 + rec.offset_ns, t1 + rec.offset_ns,
                                  threading.get_ident(), self.id, self.parent, self.call,
                                  self.attrs))
        if self.phase:
            dt = (t1 - self.t0) / 1e9
            _PHASE_TIMES[self.name].append(dt)
            if self.log:
                print(f"[timer] {self.name}: {dt:.3f}s")
        return False


def span(name: str, **attrs):
    """A context marking ``name``: recorded, with ``attrs``, inside a
    :func:`recording`; else the shared no-op context."""
    rec = _RECORDING
    if rec is None:
        return _NOOP
    return _Span(name, attrs, rec)


@contextlib.contextmanager
def recording():
    """Keep every span that ends in the block, from any thread; yields the
    :class:`Recording` whose ``spans`` the caller reads when the block ends.
    An inner recording keeps the spans that begin inside it, the outer one
    the rest."""
    global _RECORDING
    outer, rec = _RECORDING, Recording()
    _RECORDING = rec
    try:
        yield rec
    finally:
        _RECORDING = outer


def phase_timer(name: str, log: bool = False):
    """Time a phase into the process-wide registry (every time), as a
    :func:`span` (recorded inside a :func:`recording`)."""
    return _Span(name, {}, _RECORDING, phase=True, log=log)


def phase_times() -> Dict[str, Dict[str, float]]:
    """Count / total / mean seconds of every recorded phase."""
    return {
        name: {"count": len(v), "total_s": sum(v), "mean_s": sum(v) / len(v)}
        for name, v in _PHASE_TIMES.items()
    }


def dump_phase_times(path: str) -> None:
    with open(path, "w") as f:
        json.dump(phase_times(), f, indent=2)


def reset_phase_times() -> None:
    _PHASE_TIMES.clear()


KERNEL_KINDS = (  # first match wins
    ("cfg_engine_update (Triton)", ("cfg_engine_update",)),
    ("upsample", ("upsample",)),
    ("max pool", ("max_pool",)),
    ("batch norm", ("batch_norm",)),
    ("concat", ("CatArray", "cat_")),
    ("random normal", ("normal", "philox")),
    ("copy / cast", ("copy",)),
    ("convolution", ("conv", "xmma", "implicit_gemm", "cudnn")),
    ("matmul", ("gemm", "cutlass", "cublas")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "Functor")),
)

# Chrome-trace categories of the device's own activity.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_kind(name: str, kinds=KERNEL_KINDS) -> str:
    """The first kind of ``kinds`` one of whose substrings is in ``name``."""
    return next((kind for kind, keys in kinds if any(s in name for s in keys)), "other")


def busy_and_window(spans: Iterable[Tuple[float, float]]) -> Tuple[float, float]:
    """Busy time (the union of the ``(start, end)`` intervals) and the span
    from the first start to the last end, in the spans' unit."""
    spans = sorted(spans)
    busy, cur_start, cur_end = 0.0, *spans[0]
    window_end = cur_end
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
        window_end = max(window_end, end)
    busy += cur_end - cur_start
    return busy, window_end - spans[0][0]


def tally(events: Iterable[Tuple[str, float]], kinds=KERNEL_KINDS):
    """``(by_kind, by_name)`` of ``(name, duration)`` events, each mapping a
    key to ``(launches, total duration)``."""
    by_kind: Dict[str, Tuple[int, float]] = {}
    by_name: Dict[str, Tuple[int, float]] = {}
    for name, dur in events:
        for table, key in ((by_kind, kernel_kind(name, kinds)), (by_name, name)):
            n, t = table.get(key, (0, 0.0))
            table[key] = (n + 1, t + dur)
    return by_kind, by_name


class TraceSummary(NamedTuple):
    """What ``trace_summary`` reads from one Chrome trace (times in µs)."""

    path: str
    on_device: bool  # rows are device kernels (self times), else CPU operators (inclusive)
    rows: List[Tuple[str, int, float]]  # (name, launches, total), longest first
    busy_us: float
    window_us: float

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_us / self.window_us if self.window_us > 0 else 0.0

    def launches(self, substring: str) -> int:
        return sum(n for name, n, _ in self.rows if substring in name)


def trace_summary(path: str) -> TraceSummary:
    """One row per name of a ``torch.profiler`` Chrome trace: its device
    kernels and memory operations where it holds any, else its CPU
    operators; with the busy time (the union of their intervals) over the
    window from the first one's start to the last one's end."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    picked = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    on_device = bool(picked)
    if not on_device:
        picked = [e for e in events if e.get("cat") == "cpu_op"]
    if not picked:
        raise ValueError(f"{path} holds neither device activity nor CPU operators")
    spans = [(e["name"], float(e["ts"]), float(e["dur"])) for e in picked]
    busy, window = busy_and_window((ts, ts + dur) for _, ts, dur in spans)
    _, by_name = tally((name, dur) for name, _, dur in spans)
    rows = sorted(((name, n, t) for name, (n, t) in by_name.items()), key=lambda r: -r[2])
    return TraceSummary(path, on_device, rows, busy, window)


def conv_flops(model, *inputs, **kwargs) -> int:
    """2 x the multiply-adds of every ``Conv2d`` in one forward
    ``model(*inputs, **kwargs)`` (run under ``no_grad``).  Linear layers,
    pooling, upsampling and elementwise work are not counted."""
    import torch

    total = [0]

    def hook(module, args, output):
        total[0] += 2 * output.numel() * module.weight[0].numel()  # in/groups x kernel area

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.no_grad():
            model(*inputs, **kwargs)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def enable_nan_checks(enable: bool = True) -> None:
    """Autograd anomaly detection: a backward that makes a NaN raises at the
    forward op that caused it."""
    import torch

    torch.autograd.set_detect_anomaly(enable)


class MetricsLogger:
    """Structured JSONL metrics stream for a run (one record per event),
    written by rank 0 of a process group alone."""

    def __init__(self, path: str):
        from ..parallel.distributed import is_main_process

        self.path = path
        self._f = None
        if is_main_process():
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")

    def log(self, event: str, **fields) -> None:
        if self._f is None:
            return
        record = {"event": event, "time": time.time(), **fields}
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
