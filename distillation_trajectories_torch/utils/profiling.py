"""Phase timers and the structured metrics log (port of the JAX package's
``utils/profiling.py``, less its ``jax.profiler`` and NaN-check helpers).

``phase_timer`` times the calling thread's wall clock; work it launches on
the GPU is inside the time only where the phase synchronizes.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict

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
