"""One traced slice under ``torch.profiler``, read from the raw Kineto events.

No Chrome trace is written and no event tree is built: a sweep call makes
hundreds of thousands of device events.  The traced window is the
host clock around the slice and its closing synchronise, so idle time
before the first kernel and after the last one counts.
Device busy time is the union of kernel, memcpy and memset spans clipped to
that window.  Idle time while the profiler handles its own buffers on the
calling thread (``PROFILER_OWN``) is the tracing's, not the program's: it
is taken out of the window, so the idle share and ``window_s`` leave it
out (``profiler_idle_s`` keeps it).  Each other idle gap is
charged to the innermost host event running when the gap began (a runtime
call), and to "host: between operations" where none was: the framework's
own Python and C++.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

WINDOW = "h100_bench.traced_slice"
NAME_CHARS = 160
# Host events of the profiler's own buffer handling on the traced thread.
PROFILER_OWN = ("Buffer Flush", "Activity Buffer Request")


@dataclass
class Trace:
    window: Tuple[int, int]  # ns, host clock of the trace
    kernel_names: List[str]
    kernels: np.ndarray  # [n, 2] int64 start, end ns
    memops: np.ndarray  # [m, 2]
    host_names: List[str]
    host: np.ndarray  # [k, 2] the calling thread's operations
    info: Dict[str, float] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        """The traced window's seconds, less the idle the profiler's own
        buffer handling holds: busy time plus the idle gaps."""
        gaps = self._idle_gaps()
        return self.busy_s() + float((gaps[:, 1] - gaps[:, 0]).sum()) / 1e9

    def profiler_idle_s(self) -> float:
        """The idle seconds inside the profiler's own host events."""
        return (self.window[1] - self.window[0]) / 1e9 - self.window_s

    def _merged(self) -> np.ndarray:
        spans = np.concatenate([self.kernels, self.memops]) if len(self.memops) else self.kernels
        return _union(np.clip(spans, *self.window))

    def _idle_gaps(self) -> np.ndarray:
        """``[g, 2]`` start, end ns of each span of the window in which the
        device is idle and the profiler is not handling its buffers."""
        sel = [i for i, n in enumerate(self.host_names) if n in PROFILER_OWN]
        own = np.clip(self.host[sel], *self.window) if sel else np.zeros((0, 2), np.int64)
        covered = _union(np.concatenate([self._merged(), own]))
        lo, hi = self.window
        gaps = np.stack([np.concatenate([[lo], covered[:, 1]]),
                         np.concatenate([covered[:, 0], [hi]])], axis=1)
        return gaps[gaps[:, 1] > gaps[:, 0]]

    def busy_s(self) -> float:
        merged = self._merged()
        return float((merged[:, 1] - merged[:, 0]).sum()) / 1e9

    def kernel_count(self) -> int:
        return len(self.kernel_names)

    def kernel_durations_ns(self, substring: str) -> np.ndarray:
        sel = [i for i, n in enumerate(self.kernel_names) if substring in n]
        return (self.kernels[sel, 1] - self.kernels[sel, 0]) if sel else np.zeros(0, np.int64)

    def top_device_ops(self, k: int = 10) -> List[list]:
        totals: Dict[str, int] = {}
        for name, (a, b) in zip(self.kernel_names, self.kernels.tolist()):
            totals[name] = totals.get(name, 0) + (b - a)
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:NAME_CHARS], v / 1e9] for n, v in top]

    def top_idle_gaps(self, k: int = 10) -> List[list]:
        """Idle seconds inside the window by the host operation running when
        each gap began (``"host: between operations"`` where none was); the
        profiler's own buffer handling is left out, as the window leaves it."""
        gaps = self._idle_gaps()
        owner = self._innermost(gaps[:, 0])
        totals: Dict[str, int] = {}
        names = self.host_names
        for o, (a, b) in zip(owner.tolist(), gaps.tolist()):
            name = names[o] if o >= 0 else "host: between operations"
            totals[name] = totals.get(name, 0) + (b - a)
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:NAME_CHARS], v / 1e9] for n, v in top]

    def _innermost(self, times: np.ndarray) -> np.ndarray:
        if not len(self.host):
            return np.full(len(times), -1)
        starts, ends = self.host[:, 0], self.host[:, 1]
        parent = np.full(len(starts), -1)
        stack: List[int] = []
        for i, (a, b) in enumerate(self.host.tolist()):
            while stack and ends[stack[-1]] < a:
                stack.pop()
            parent[i] = stack[-1] if stack else -1
            stack.append(i)
        idx = np.searchsorted(starts, times, side="right") - 1
        for _ in range(64):
            bad = (idx >= 0) & (ends[np.maximum(idx, 0)] <= times)
            if not bad.any():
                break
            idx[bad] = parent[idx[bad]]
        return idx


def _union(spans: np.ndarray) -> np.ndarray:
    """The union of ``[n, 2]`` spans as sorted, disjoint ``[m, 2]`` spans."""
    spans = spans[spans[:, 1] > spans[:, 0]] if len(spans) else np.zeros((0, 2), np.int64)
    if not len(spans):
        return spans
    spans = spans[np.argsort(spans[:, 0], kind="stable")]
    ends = np.maximum.accumulate(spans[:, 1])
    new = np.ones(len(spans), bool)
    new[1:] = spans[1:, 0] > ends[:-1]
    last = np.append(np.flatnonzero(new)[1:] - 1, len(spans) - 1)
    return np.stack([spans[new, 0], ends[last]], axis=1)


def trace_slice(fn: Callable[[], Dict[str, float]], device: torch.device) -> Trace:
    """Run ``fn`` (returns what the slice did: pairs, steps, FLOPs ...)
    under the profiler and read its events: the device's activity and the
    runtime calls (launches, copies, synchronisations), not the host's
    operators, which slow a host-bound slice by a third or more.  The window
    is the host clock (Unix time in ns, the profiler's clock) around ``fn``
    and a synchronise."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [] if device.type == "cuda" else [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            t0 = time.time_ns()
            info = fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t1 = time.time_ns()
    events = prof.profiler.kineto_results.events()
    cpu = torch.autograd.DeviceType.CPU
    thread = next((e.start_thread_id() for e in events
                   if e.name() == WINDOW and e.device_type() == cpu), None)
    k_names, k_spans, m_spans, h_names, h_spans = [], [], [], [], []
    for e in events:
        if e.device_type() == cpu:
            if (thread is None or e.start_thread_id() == thread) and e.name() != WINDOW:
                h_names.append(e.name())
                h_spans.append((e.start_ns(), e.end_ns()))
        elif not e.is_user_annotation():
            name = e.name()
            if name.startswith(("Memcpy", "Memset")):
                m_spans.append((e.start_ns(), e.end_ns()))
            else:
                k_names.append(name)
                k_spans.append((e.start_ns(), e.end_ns()))
    order = sorted(range(len(h_spans)), key=lambda i: (h_spans[i][0], -h_spans[i][1]))
    as_array = lambda s: np.asarray(s, dtype=np.int64).reshape(-1, 2)
    traced = Trace((t0, t1), k_names, as_array(k_spans), as_array(m_spans),
                   [h_names[i] for i in order], as_array([h_spans[i] for i in order]),
                   dict(info or {}))
    traced.info["profiler_idle_s"] = traced.profiler_idle_s()
    return traced
