"""Phase timers, a profiler trace, anomaly checks and the structured
metrics log (port of the JAX package's ``utils/profiling.py``).

``phase_timer`` times the calling thread's wall clock; work it launches on
the GPU is inside the time only where the phase synchronizes.
``profile_trace`` is ``torch.profiler`` where the JAX package runs
``jax.profiler``; ``enable_nan_checks`` is autograd's anomaly detection
where it sets ``jax_debug_nans``.  ``busy_and_window``, ``tally`` and
``trace_summary`` are the one reading of a profile that the sampler
profiler (``scripts/profile_sampler.py``) and ``chip_smoke.py`` share;
``conv_flops`` is the one FLOP count of a forward that they and the step
ablation (``scripts/bench_r2.py``) use.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

_PHASE_TIMES: Dict[str, list] = defaultdict(list)


@contextlib.contextmanager
def phase_timer(name: str, log: bool = False):
    """Time a phase; accumulate into the process-wide registry."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _PHASE_TIMES[name].append(dt)
        if log:
            print(f"[timer] {name}: {dt:.3f}s")


def phase_times() -> Dict[str, Dict[str, float]]:
    """Count / total / mean seconds of every recorded phase."""
    return {
        name: {"count": len(v), "total_s": sum(v), "mean_s": sum(v) / len(v)}
        for name, v in _PHASE_TIMES.items()
    }


def add_phase_time(name: str, seconds: float) -> None:
    """Record a duration measured elsewhere (e.g. on a background thread)."""
    _PHASE_TIMES[name].append(seconds)


def dump_phase_times(path: str) -> None:
    with open(path, "w") as f:
        json.dump(phase_times(), f, indent=2)


def reset_phase_times() -> None:
    _PHASE_TIMES.clear()


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str] = None):
    """``torch.profiler`` over the block (CPU and, where there is one, CUDA
    activity), written as a Chrome trace into ``trace_dir`` or
    ``DTT_PROFILE_DIR``; a no-op when neither is given."""
    trace_dir = trace_dir or os.environ.get("DTT_PROFILE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    print(f"[profiler] trace written to {path}")


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
