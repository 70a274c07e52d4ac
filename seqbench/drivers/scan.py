"""The scan driver: ``drivers/batch.py``'s closed loop over a database scan,
one ``--stream`` job after another.

The loop, the profiler and the notes are the batch driver's own (its
:func:`run`, called as it is).  Three things are swapped for the length of
its run (module globals of ``drivers/batch.py``, as ``drivers/batch_mesh.py``
swaps them):

* ``generate``: :mod:`seqbench.scanjobs`, whose ``jobs`` makes the pool
  with lengths from the traffic's law;
* ``DeviceTrace``: a trace that also reads the port's stream counters
  (``io/pipeline.py::stream_counts``) and its launched cells
  (``ops/dispatch.py::dispatch_counts``) at the window's open and close
  into ``telemetry``'s ``start`` and ``end`` (none where the program has
  no such counters);
* ``judge``: ``check_jobs`` pool jobs are checked, one always of the
  widest weight tuple (only such a job's scores pass 2**15, as in
  ``drivers/batch_mesh.py``), each against the plain PyTorch reference
  (:mod:`seqbench.reference_torch`) computed on the run's device after the
  window, in blocks of rows, line for line.

A window in which the port streamed no chunk (its ``stream_chunks``
counter did not rise) is no measurement of the cell: the run exits 1,
prints no result line, and says so on stderr.
"""

from __future__ import annotations

import sys

from seqbench import generate, judge, reference_torch, scanjobs
from seqbench.devtrace import DeviceTrace
from seqbench.drivers import batch
from seqbench.drivers.batch_mesh import WideChecks


def port_counters() -> dict:
    """The port's stream counters and launched cells now, each left out
    where the program has no such counter."""
    from mpi_openmp_cuda_tpu_torch.io import pipeline
    from mpi_openmp_cuda_tpu_torch.ops import dispatch

    return {**getattr(pipeline, "stream_counts", {}), **getattr(dispatch, "dispatch_counts", {})}


class ScanTrace(DeviceTrace):
    """A :class:`DeviceTrace` that snapshots the port's counters at the
    window's edges."""

    def __init__(self):
        super().__init__()
        self.counters: dict = {}

    def open(self) -> None:
        self.counters["start"] = port_counters()
        super().open()

    def close(self) -> None:
        super().close()
        self.counters["end"] = port_counters()


class ScanChecks(WideChecks):
    """The widest tuple always among the checked jobs, each judged against
    :mod:`seqbench.reference_torch` on ``device``."""

    def __init__(self, weights, device: str):
        super().__init__(weights)
        self.device = device

    def judge_batch(self, texts: dict, outputs: dict, malformed: int, unstable: int):
        keys = sorted(texts)
        want = [reference_torch.stdout(texts[i], self.device) for i in keys]
        wrong = {i: judge.wrong_lines(outputs[i], w) for i, w in zip(keys, want)}
        checks = judge.limits({"wrong_lines": sum(wrong.values()), "malformed_jobs": malformed,
                               "unstable_jobs": unstable})
        return checks, {i for i, n in wrong.items() if n}


def run(ctx):
    trace = ScanTrace()
    checks = ScanChecks(ctx.config["weights"], ctx.device)
    batch.DeviceTrace, batch.judge, batch.generate = (lambda: trace), checks, scanjobs
    try:
        result = batch.run(ctx)
    finally:
        batch.DeviceTrace, batch.judge, batch.generate = DeviceTrace, judge, generate
    result.telemetry = dict(trace.counters)
    start, end = trace.counters.get("start", {}), trace.counters.get("end", {})
    if "stream_chunks" in end and end["stream_chunks"] <= start.get("stream_chunks", 0):
        print(f"seqbench: error: cell {ctx.cell['name']!r} streams its jobs, but the port "
              "streamed no chunk in the window (stream_chunks did not rise)",
              file=sys.stderr, flush=True)
        raise SystemExit(1)
    return result
