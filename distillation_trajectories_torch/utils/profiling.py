"""Phase timers, a profiler trace, anomaly checks and the structured
metrics log (port of the JAX package's ``utils/profiling.py``).

``phase_timer`` times the calling thread's wall clock; work it launches on
the GPU is inside the time only where the phase synchronizes.
``profile_trace`` is ``torch.profiler`` where the JAX package runs
``jax.profiler``; ``enable_nan_checks`` is autograd's anomaly detection
where it sets ``jax_debug_nans``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional

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


def enable_nan_checks(enable: bool = True) -> None:
    """Autograd anomaly detection: a backward that makes a NaN raises at the
    forward op that caused it."""
    import torch

    torch.autograd.set_detect_anomaly(enable)


class MetricsLogger:
    """Structured JSONL metrics stream for a run (one record per event)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def log(self, event: str, **fields) -> None:
        record = {"event": event, "time": time.time(), **fields}
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
