"""The batch driver: one client piping one job after another into the
port's CLI, in this process (a closed loop).

Set-up makes the cell's pool of distinct jobs from the seed (stdin text
in memory, never a file), then runs ``warm_jobs`` of them, which builds
or loads the kernels and warms every launch shape of the pool.  The
window runs the pool in order, again and again, until ``--seconds`` have
passed; the job in flight at that moment finishes and counts, and the
window ends with it.  A job is one call of ``io.cli.run`` with the job's
text on ``sys.stdin`` and fd 1 on an in-memory file, timed from the call
to its return, when its stdout is complete.

The device is profiled in every run, from before the warm jobs, and the
window's share of it read (:mod:`seqbench.devtrace`): the end-to-end
``batch_device_cells_per_s`` reads the card's busy time.  With ``--trace
1`` the CLI's phase spans (``parse``, ``setup``, ``score``, ``print``)
are also read, through a listener on its ``PhaseTimer``'s recorder, and
label the device's idle gaps.

Afterwards the card's peak memory is read, then the sample of pool jobs
drawn from the seed is scored by the plain reference on the host and
compared with what the window printed.
"""

from __future__ import annotations

import io
import os
import statistics
import sys
import time

from seqbench import generate, harness, judge
from seqbench.devtrace import DeviceTrace, span_sink, tap_phases


class StdoutFile:
    """fd 1 on an anonymous in-memory file for the length of a ``with``."""

    def __init__(self):
        self.fd = os.memfd_create("seqbench-stdout")
        self.saved = os.dup(1)

    def __enter__(self):
        sys.stdout.flush()
        os.dup2(self.fd, 1)
        return self

    def __exit__(self, *exc):
        sys.stdout.flush()
        os.dup2(self.saved, 1)

    def take(self) -> str:
        """What was written since the last take."""
        size = os.lseek(self.fd, 0, os.SEEK_END)
        data = os.pread(self.fd, size, 0)
        os.ftruncate(self.fd, 0)
        os.lseek(self.fd, 0, os.SEEK_SET)
        return data.decode("ascii", "replace")

    def close(self) -> None:
        os.close(self.fd)
        os.close(self.saved)


def run(ctx) -> harness.Run:
    import torch
    from mpi_openmp_cuda_tpu_torch.io import cli
    from mpi_openmp_cuda_tpu_torch.ops import cuda_scorer

    traffic = ctx.traffic
    argv = list(ctx.config.get("cli_args", [])) + ["--device", ctx.device]
    pool = generate.jobs(ctx.seed, ctx.config, traffic)
    out = StdoutFile()
    stdin = sys.stdin
    phases: dict[str, float] = {}
    trace = DeviceTrace()
    to_trace = span_sink(trace) if ctx.trace else None

    def on_span(path, start, dur):
        phases[path] = phases.get(path, 0.0) + dur
        if to_trace is not None:
            to_trace(path, start, dur)

    if ctx.trace:
        tap_phases(cli, on_span)

    def job(j: int) -> tuple[float, int, str]:
        sys.stdin = io.StringIO(pool[j].text)
        try:
            with out:
                t0 = time.perf_counter()
                rc = cli.run(argv)
                t1 = time.perf_counter()
        finally:
            sys.stdin = stdin
        if ctx.trace:
            trace.span("cli.run", t0, t1 - t0, 0)
        return t1 - t0, rc, out.take()

    try:
        trace.start()
        for j in range(min(int(traffic["warm_jobs"]), len(pool))):
            job(j)
        first: dict[int, str] = {}
        odd: list[tuple[int, str]] = []  # outputs unlike their pool job's first
        walls, spans, failed_rc = [], [], 0
        launches0 = dict(cuda_scorer.launch_counts)
        trace.open()
        t_start = time.monotonic()
        setup_s = t_start - ctx.started
        j = 0
        while time.monotonic() - t_start < ctx.seconds:
            phases.clear()
            wall, rc, text = job(j)
            walls.append((j, wall, time.monotonic() - t_start))
            if ctx.trace:
                spans.append(dict(phases))
            if rc != 0:
                failed_rc += 1
            elif first.setdefault(j, text) != text:
                odd.append((j, text))
            j = (j + 1) % len(pool)
        window_s = time.monotonic() - t_start
        trace.close()
        trace.stop()
        launches = {k: v - launches0.get(k, 0) for k, v in cuda_scorer.launch_counts.items()}
    finally:
        out.close()
    on_card = ctx.device == "cuda"
    device = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": 1,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if on_card else 0,
    }
    jobs = [{"wall_s": w, "cells": pool[i].cells, "bytes": pool[i].bytes} for i, w, _ in walls]
    summary = trace.summary(outside="harness")
    summary["cells"] = sum(x["cells"] for x in jobs)
    summary["bytes"] = sum(x["bytes"] for x in jobs)
    # Each output is checked for its form once: a pool job's first, and
    # any later one unlike it (which is unstable as well).
    misshapen = {i for i, t in first.items() if not judge.well_formed(t.splitlines(), pool[i].rows)}
    bad = failed_rc + len(misshapen) + sum(
        not judge.well_formed(t.splitlines(), pool[i].rows) for i, t in odd)
    checked = judge.sample(ctx.seed, first, int(traffic["check_jobs"]))
    checks, wrong = judge.judge_batch({i: pool[i].text for i in checked},
                                      {i: first[i] for i in checked}, bad, len(odd))
    q = statistics.quantiles([w for _, w, _ in walls], n=4) if len(walls) > 1 else [0.0] * 3
    slices: dict[int, int] = {}
    for i, _, t in walls:
        slices[int(t // 10)] = slices.get(int(t // 10), 0) + pool[i].cells
    notes = [f"seqbench: {len(walls)} jobs, walls q1 {q[0] * 1e3:.3f} median {q[1] * 1e3:.3f}"
             f" q3 {q[2] * 1e3:.3f} ms; Gcells/s by 10 s of window: "
             + " ".join(f"{c / 1e10:.2f}" for _, c in sorted(slices.items()))]
    return harness.Run("batch", setup_s, window_s, attempted=len(walls),
               failed=failed_rc + len(odd) + sum(i in misshapen | wrong for i, *_ in walls),
               checks=checks, device=device, jobs=jobs, spans=spans,
               launches=launches, trace=summary, notes=notes)
