"""Run a function on a few local ranks without a launcher.

``spawn_ranks(world, fn, args)`` starts ``world`` processes (the ``spawn``
method), joins them in a process group on ``localhost`` through
:func:`.distributed.initialize_distributed`, calls ``fn(rank, *args)`` in
each and returns the results by rank.  ``fn`` must be importable by name
(a module-level function).  A rank that raises fails the whole run with
its traceback; ranks still running then are stopped.  ``torchrun`` does
the same for the CLIs.
"""

from __future__ import annotations

import os
import shutil
import socket
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, backend, fn, args, outdir, threads):
    import torch.distributed as dist

    from .distributed import initialize_distributed

    if threads:
        torch.set_num_threads(threads)
    try:
        initialize_distributed(f"tcp://localhost:{port}", world, rank, backend)
        result = fn(rank, *args)
        dist.barrier()
        torch.save(result, os.path.join(outdir, f"{rank}.pt"))
    except BaseException:
        with open(os.path.join(outdir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(world: int, fn: Callable, args: Sequence = (), backend: Optional[str] = None,
                timeout: float = 600.0, threads: int = 1) -> List[object]:
    """``[fn(0, *args), …, fn(world-1, *args)]``, each in its own process
    of one process group (``backend``: see :func:`.distributed.choose_backend`).
    ``threads`` sets each rank's ``torch.set_num_threads`` (0 leaves it)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    outdir = tempfile.mkdtemp(prefix="dtt_ranks_")
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, backend, fn, tuple(args), outdir, threads))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            if any(p.exitcode not in (None, 0) for p in procs):
                break  # a failed rank leaves the others waiting in a collective
            time.sleep(0.05)
        alive = [p for p in procs if p.is_alive()]
        timed_out = bool(alive) and not any(p.exitcode not in (None, 0) for p in procs)
        for p in alive:
            p.terminate()
        for p in procs:
            p.join(timeout=30)
        errors = [open(os.path.join(outdir, f"{r}.err")).read()
                  for r in range(world) if os.path.exists(os.path.join(outdir, f"{r}.err"))]
        if errors or alive or any(p.exitcode != 0 for p in procs):
            reason = f"timed out after {timeout} s" if timed_out else "failed"
            raise RuntimeError(f"{world} ranks of {getattr(fn, '__name__', fn)} {reason}:\n"
                               + "\n".join(errors))
        return [torch.load(os.path.join(outdir, f"{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        shutil.rmtree(outdir, ignore_errors=True)
