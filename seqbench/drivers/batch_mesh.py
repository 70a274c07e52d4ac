"""The batch driver over a mesh of cards: ``drivers/batch.py``'s closed loop,
with the device read from what the window did on each card.

The loop, the checks and the notes are the batch driver's own (its
:func:`run`, called as it is).  Three things are added around it:

* the profiler's CUDA events are split by the card that ran them, so the
  trace summary gains ``cards``, ``{index: {"kernels", "kernel_s",
  "tile_kernel_s", "busy_s", "peak_bytes"}}`` over the window
  (``tile_kernel_s`` the scorers' tile kernels, ``busy_s`` the union of
  that card's activity), and a note line prints them;
* the port's mesh counters (``parallel/sharding.py::mesh_counts``) are
  read at the window's open and close into ``telemetry``'s ``start`` and
  ``end`` (none where the program has no such counters);
* one of the ``check_jobs`` pool jobs checked against the reference is
  always one of the widest weight tuple (the largest ``|w|``; pool job
  ``j`` has tuple ``j`` mod their count, :func:`seqbench.generate.jobs`),
  drawn from the seed, the others as the batch driver draws them: only
  such a job's
  scores pass 2**15, so a run that accumulated in 16 bits is caught
  whichever jobs the seed draws, as serve cells always check their
  longest request.

On a card the result's ``device.count`` is the number of cards that ran
kernels in the window, and ``memory_peak_bytes`` the largest card's peak.
A window that ran kernels on fewer cards than the cell's ``chips`` is no
measurement of the cell: the run exits 1, prints no result line, and
says on stderr which cards ran.
"""

from __future__ import annotations

import sys

from seqbench import judge
from seqbench.devtrace import DeviceTrace, union_length
from seqbench.drivers import batch


def mesh_counters() -> dict:
    """The port's mesh counters now, or ``{}`` where it has none."""
    try:
        from mpi_openmp_cuda_tpu_torch.parallel import sharding
    except ImportError:
        return {}
    return dict(getattr(sharding, "mesh_counts", {}))


class MeshTrace(DeviceTrace):
    """A :class:`DeviceTrace` that also splits the window's device activity
    by card, and snapshots the mesh counters at the window's edges."""

    def __init__(self):
        super().__init__()
        self.counters: dict = {}

    def open(self) -> None:
        self.counters["start"] = mesh_counters()
        super().open()

    def close(self) -> None:
        super().close()
        self.counters["end"] = mesh_counters()

    def card_events(self):
        """``(card, name, start, end, kind)`` of each device activity,
        epoch seconds, ``kind`` as :meth:`DeviceTrace.device_events` gives
        it."""
        out = []
        for ev in self._prof.profiler.kineto_results.events():
            if str(ev.device_type()).endswith("CUDA"):
                name = ev.name()
                kind = "copy" if name.startswith(("Memcpy", "Memset")) else "kernel"
                s = ev.start_ns() / 1e9
                out.append((int(ev.device_index()), name, s, s + ev.duration_ns() / 1e9, kind))
        return out

    def summary(self, outside: str = "no span") -> dict:
        out = super().summary(outside)
        lo, hi = self.t0, self.t1
        spans: dict[int, list] = {}
        cards: dict[str, dict] = {}
        for card, name, s, e, kind in self.card_events():
            if e <= lo or s >= hi:
                continue
            s, e = max(s, lo), min(e, hi)
            spans.setdefault(card, []).append((s, e))
            c = cards.setdefault(str(card), {"kernels": 0, "kernel_s": 0.0, "tile_kernel_s": 0.0})
            if kind == "kernel":
                c["kernels"] += 1
                c["kernel_s"] += e - s
                if "tile_kernel" in name:
                    c["tile_kernel_s"] += e - s
        for card, c in cards.items():
            c["busy_s"] = union_length(spans[int(card)])
        out["cards"] = dict(sorted(cards.items(), key=lambda kv: int(kv[0])))
        return out


class WideChecks:
    """:mod:`seqbench.judge` as the batch driver calls it, with one of the
    jobs :meth:`sample` draws always of the widest weight tuple."""

    def __init__(self, weights):
        widest = max(max(abs(int(w)) for w in ws) for ws in weights)
        self.wide = {i for i, ws in enumerate(weights) if max(abs(int(w)) for w in ws) == widest}
        self.tuples = len(weights)

    def __getattr__(self, name):
        return getattr(judge, name)

    def sample(self, seed: int, candidates, count: int, always=()) -> list:
        wide = [j for j in candidates if j % self.tuples in self.wide]
        if count < 1 or not wide:
            return judge.sample(seed, candidates, count, always)
        pick = judge.sample(seed, wide, 1)
        return judge.sample(seed, candidates, count - 1, always=(*always, *pick))


def run(ctx):
    import torch

    # The batch driver makes one trace a run and checks its jobs through
    # ``judge``: both are swapped for the length of its run.
    trace = MeshTrace()
    batch.DeviceTrace, batch.judge = (lambda: trace), WideChecks(ctx.config["weights"])
    try:
        result = batch.run(ctx)
    finally:
        batch.DeviceTrace, batch.judge = DeviceTrace, judge
    result.telemetry = dict(trace.counters)
    if ctx.device != "cuda":
        return result
    cards = result.trace["cards"]
    for k in cards:
        cards[k]["peak_bytes"] = int(torch.cuda.max_memory_allocated(int(k)))
    working = [k for k, c in cards.items() if c["kernels"] > 0]
    need = int(ctx.cell["chips"])
    ran = ", ".join(f"cuda:{k} ({cards[k]['kernels']} kernels)" for k in working) or "none"
    if len(working) < need:
        print(f"seqbench: error: cell {ctx.cell['name']!r} asks for {need} cards, but only "
              f"{len(working)} ran kernels in the window: {ran}", file=sys.stderr, flush=True)
        raise SystemExit(1)
    peaks = [int(torch.cuda.max_memory_allocated(i)) for i in range(torch.cuda.device_count())]
    result.device = {**result.device, "count": len(working), "memory_peak_bytes": max(peaks)}
    result.notes.append("seqbench: cards " + "; ".join(
        f"cuda:{k} kernels {c['kernels']} kernel {c['kernel_s']:.6f} s tile_kernel"
        f" {c['tile_kernel_s']:.6f} s busy {c['busy_s']:.6f} s peak {c['peak_bytes']} B"
        for k, c in cards.items()))
    return result
