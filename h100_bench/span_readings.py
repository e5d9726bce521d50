"""The program's spans in a cell, read beside the device trace: where the
five span readings of ``yardstick/spans.py`` come from until the harness
reads them itself.  Not run by the benchmark's own runs.

    python3 h100_bench/span_readings.py trace --workload <cell> --seed <n> --seconds <s>
    python3 h100_bench/span_readings.py calls --workload <cell> --seed <n> \
        --windows on:50,off:20,on:20 [--out FILE]

``trace`` makes the cell's set-up under the span recorder, its window as
``run.py`` makes it (untraced), then its traced slice under the profiler and
the recorder, and prints one JSON line: set-up's seconds by span, the
slice's idle and device seconds by span and by sampler chain, the five
readings, and the clock check (every ``cudaGraphLaunch`` inside a
``graph.replay`` or ``epoch.replay`` span, every device-to-host
``cudaMemcpyAsync`` inside a ``pairs.to_host`` span).  ``calls`` makes set-up, then windows of calls
back to back with the recorder on or off, and prints each window's calls,
rate and median call; with ``--out`` it appends one line a call (its host
seconds and, recorded, the seconds of its spans by name).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from h100_bench import harness  # noqa: E402
from h100_bench.yardstick import spans as S  # noqa: E402


@contextlib.contextmanager
def _set_up(cell, seed: int, seconds: float, device: torch.device, record: bool):
    """``(run, set-up seconds from process start, set-up's spans)`` of a cell."""
    driver = harness.load_file(os.path.join(cell.here, "drivers", f"{cell.traffic['driver']}.py"),
                               f"h100_bench_driver_{cell.traffic['driver']}")
    workdir = tempfile.mkdtemp(prefix="h100_bench_")
    try:
        ctx = harness.Context(cell, int(seed), float(seconds), device, workdir)
        with (S.recording() if record else contextlib.nullcontext(None)) as rec:
            run = driver.setup(ctx)
            harness._sync(device)
        yield run, time.perf_counter() - T_START, S.nested(rec.spans) if rec else []
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _window(run, seconds: float, device, start_k: int = 0):
    """Calls back to back for ``seconds``: ``[(k, units, seconds)]``."""
    out, start, k = [], time.perf_counter(), start_k
    while time.perf_counter() - start < seconds:
        t0 = time.perf_counter()
        n, _ = run.call(k)
        harness._sync(device)
        out.append((k, int(n), time.perf_counter() - t0))
        k += 1
    return out


def _by_name(spans):
    out = {}
    for s in spans:
        n, t = out.get(s.name, (0, 0.0))
        out[s.name] = (n + 1, t + (s.end_ns - s.start_ns) / 1e9)
    return {k: [n, t] for k, (n, t) in sorted(out.items(), key=lambda kv: -kv[1][1])}


def chain_labels(spans):
    """The sampler chain each ``graph.replay`` span ran, by span id: in a
    paired call the teacher's then the student's; in a sweep call a
    student's where the metric suite scores it next, else the teacher's."""
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    labels = {}
    for call in (s for s in spans if s.parent is None):
        row = kids.get(call.id, [])
        replays = [i for i, s in enumerate(row) if s.name == "graph.replay"]
        for n, i in enumerate(replays):
            nxt = row[i + 1] if i + 1 < len(row) else None
            if call.name == "pairs.call":
                labels[row[i].id] = ("teacher", "student")[n % 2]
            elif nxt is not None and nxt.name == "sweep.metrics":
                labels[row[i].id] = f"student sf {nxt.attrs['sf']}"
            else:
                labels[row[i].id] = "teacher"
    return labels


def trace_cell(cell, seed: int, seconds: float, device) -> dict:
    with _set_up(cell, seed, seconds, device, record=True) as (run, setup_s, setup):
        calls = _window(run, seconds, device)
        st = S.trace_spans(run.slice, device)
    labels = chain_labels(st.spans)
    chain = lambda s: (labels.get(s.id) or s.name) if s is not None else S.OUTSIDE  # noqa: E731
    tr = st.trace
    return {
        "workload": cell.name, "seed": seed,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "setup_s": setup_s, "setup_by_span": _by_name(setup),
        "window": {"calls": len(calls), "units": sum(u for _, u, _ in calls),
                   "seconds": sum(t for *_, t in calls)},
        "slice": {"host_window_s": st.host_window_s, "window_s": tr.window_s,
                  "busy_s": tr.busy_s(), "kernels": tr.kernel_count(),
                  "kernels_unjoined": int((st.launch_ns(st.kernel_corr) < 0).sum()),
                  "spans": _by_name(st.spans), "idle_by_span": S.idle_by_span(st),
                  "device_by_span": S.device_by_span(st), "device_by_chain": S.device_by(st, chain),
                  "idle_gaps": tr.top_idle_gaps()},
        "readings": {"graph_rebuild_share": S.graph_rebuild_share(st),
                     "graph_builds_per_call": S.graph_builds_per_call(st),
                     "draw_share.sample": S.draw_share(st),
                     "metric_suite_ms": S.metric_suite_ms(st),
                     "setup_graph_s": S.setup_graph_s(setup)},
        "clock": {"graph_launch": S.clock_check(st, "cudaGraphLaunch",
                                                ("graph.replay", "epoch.replay")),
                  "to_host": S.clock_check(st, "cudaMemcpyAsync", ("pairs.to_host",), "DtoH")},
    }


def calls_cell(cell, seed: int, windows, device, out=None) -> dict:
    """``windows``: ``[(on, seconds)]`` made one after another."""
    summary = []
    with _set_up(cell, seed, 0.0, device, record=False) as (run, setup_s, _):
        k = 0
        for w, (on, seconds) in enumerate(windows):
            with (S.recording() if on else contextlib.nullcontext(None)) as rec:
                calls = _window(run, seconds, device, k)
            k += len(calls)
            roots = [s for s in S.nested(rec.spans) if s.parent is None] if on else []
            per_call = [{} for _ in calls]
            if on:
                if len(roots) != len(calls):
                    raise RuntimeError(f"{len(roots)} call spans for {len(calls)} calls")
                index = {r.id: i for i, r in enumerate(roots)}
                for s in S.nested(rec.spans):
                    if s.parent is not None:
                        d = per_call[index[s.call]]
                        d[s.name] = d.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e9
            if out:
                with open(out, "a") as f:
                    for (kk, n, t), sp in zip(calls, per_call):
                        f.write(json.dumps({"workload": cell.name, "seed": seed, "window": w,
                                            "recording": on, "k": kk, "units": n, "s": t,
                                            "spans": sp}) + "\n")
            secs = [t for *_, t in calls]
            summary.append({"window": w, "recording": on, "calls": len(calls),
                            "rate": sum(n for _, n, _ in calls) / sum(secs),
                            "median_call_s": statistics.median(secs)})
    return {"workload": cell.name, "seed": seed, "setup_s": setup_s, "windows": summary}


def _windows(text: str):
    out = []
    for part in text.split(","):
        mode, seconds = part.split(":")
        if mode not in ("on", "off"):
            raise ValueError(f"a window is on:<s> or off:<s>, not {part!r}")
        out.append((mode == "on", float(seconds)))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=("trace", "calls"))
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--windows", default="on:50")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = harness.find_cell(harness.manifest(ROOT), args.workload)
    harness.check_cards(cell.chips)
    device = torch.device("cuda", 0)
    if args.mode == "trace":
        result = trace_cell(cell, args.seed, args.seconds, device)
    else:
        result = calls_cell(cell, args.seed, _windows(args.windows), device, args.out)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
