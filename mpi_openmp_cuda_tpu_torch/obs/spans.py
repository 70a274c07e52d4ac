"""Nested wall-clock spans: the phase timer generalised (the port of
``mpi_openmp_cuda_tpu/obs/spans.py``).

:class:`SpanRecorder` is the engine under ``utils/profiling.PhaseTimer``:
top-level spans ARE the profile phases (parse / setup / score / print,
the byte-compatible ``[profile]`` report), and spans opened while another
is live record under a dotted path (``score.chunk_gather``) — the
per-dispatch spans ``ops/dispatch.py`` opens nest under whatever phase
the CLI has open.

**Phases.** :meth:`SpanRecorder.phases` keeps the top-level spans whose
path holds no dot.  The CLI's own plumbing (``run.args``: argument
parsing and the checks after it; ``run.arm``: the obs plane, faults, the
watchdog, the drain guard and the stdout guard; ``run.flush``: the
stdout guard's close; ``run.teardown``: the run's ``finally``) opens
top-level spans named under ``run.``, so the dot keeps them out of the
phases, the ``[profile]`` report and the run report's ``spans.phases``;
they still count in :meth:`totals` and reach every listener.

**Detail spans** (``span(name, detail=True)``) break a phase or a serve
tick down: ``setup.scorer``, ``setup.stage``, ``chunk_prefetch``,
``score.chunk_gather.device_wait``, and the serve loop's ``serve.wait``,
``serve.linger``, ``serve.plan`` and the rest of a tick.  A ``--stream``
run's ``stream.parse``, ``stream.stage``, ``stream.submit``,
``stream.window_wait`` and ``stream.finish`` (:func:`span_beside`) lie
beside the dispatch's spans they enclose, which keep their paths.  They
record and reach every listener like any span.  The trace (``obs/trace.py``) files
them under the category ``detail`` and leaves the ``run.`` plumbing out,
so its ``span`` category keeps the JAX package's set of spans.

**One recorder a run, recording only when read.**  ``io.cli.run``
builds the run's recorder (through its ``PhaseTimer``) before it parses
its arguments, and arms it as the active recorder of :func:`span` only
when something reads it: ``--profile``, the obs plane (which adopts it,
``obs.arm_observability(recorder=...)``) or a close listener.  Otherwise
:func:`span` and ``PhaseTimer.phase`` return the shared ``nullcontext``:
one attribute check, no allocation.

**Bounded, with live totals.**  The recorder keeps running
``{path: [count, seconds]}`` totals of every closed span, and lists the
first :data:`MAX_SPANS` spans in ``spans`` (the JAX package's
``(path, seconds)`` shape); past the cap a span is counted in
``dropped`` instead of listed, so :meth:`totals` stays exact for a
server's whole life, and :meth:`phases` (a few a run) are kept apart.  :meth:`snapshot` is the ``metrics`` telemetry
verb's ``spans`` section.

**One clock.**  The recorder reads its clock (``time.perf_counter`` by
default) and, back to back, ``time.time_ns()`` when it is made, and
keeps that pair as its anchor (:meth:`anchor`): a reading ``t`` of its
clock lies at ``unix_ns + (t - clock_s) * 1e9`` on the Unix-epoch clock
that ``torch.profiler`` (``--trace DIR``) stamps device events with.  The
trace takes its zero from the same recorder, and the ``--trace-out``
envelope and the run report carry the anchor.

Honest device time: a CUDA launch is asynchronous, so a span around a
dispatch measures enqueue, not compute.  The wait on the card is the
``device_wait`` span ``dispatch.BucketedPending.result`` opens around
its block on the result copy's event, inside ``chunk_gather``; the rest
of the gather is the host's copy enqueue.  The wait is
``dispatch.wait_event``'s poll, never ``torch.cuda.synchronize()``, so
an armed deadline can still interrupt it.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time

#: Cap on the spans a recorder lists (``spans``), like the trace's
#: ``MAX_EVENTS``: a long-lived server must not grow it without bound.
#: Past the cap spans are counted in ``dropped``; the totals stay exact.
MAX_SPANS = 200_000

#: The prefix of the CLI's plumbing spans: top-level, never phases.
PLUMBING = "run."

NULL_SPAN = contextlib.nullcontext()


class SpanRecorder:
    """Records ``(dotted.path, seconds)`` spans in completion order.

    The main thread owns dispatch, gather and every CLI phase; the nesting
    stack is still kept per thread, so the scoring threads of an
    in-process fleet (``serve/fleet.py``'s workers beside the serve loop)
    each nest under their own spans.  The list and the totals change
    under one lock, so a telemetry thread's :meth:`snapshot` is exact.
    """

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self.clock_s = clock()
        self.unix_ns = time.time_ns()
        self.spans: list[tuple[str, float]] = []
        self.dropped = 0
        self._phases: list[tuple[str, float]] = []
        self._totals: dict[str, list] = {}
        self._detail: set[str] = set()
        self._lock = threading.Lock()
        self._local = threading.local()
        # Close listeners: ``fn(path, start, dur)`` per finished span, in
        # the recorder's own clock domain (the trace and the flight
        # recorder subscribe here).
        self.listeners: list = []

    def now(self) -> float:
        """A reading of the recorder's clock."""
        return self._clock()

    def anchor(self) -> dict:
        """The clock anchor: the recorder's clock (``clock_s``) and the
        Unix epoch in ns (``unix_ns``), read back to back at creation."""
        return {"clock_s": self.clock_s, "unix_ns": self.unix_ns}

    @property
    def _stack(self) -> list[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextlib.contextmanager
    def span(self, name: str, detail: bool = False):
        self._stack.append(name)
        path = ".".join(self._stack)
        start = self._clock()
        try:
            yield
        finally:
            dur = self._clock() - start
            self._stack.pop()
            self._close(path, start, dur, detail)

    def add(self, name: str, start: float, end: float | None = None,
            detail: bool = False) -> None:
        """Record a span that opened at ``start`` and closed at ``end``
        (readings of this recorder's clock; None: now), under the spans
        open on this thread."""
        path = ".".join([*self._stack, name])
        self._close(path, start, (self._clock() if end is None else end) - start, detail)

    @contextlib.contextmanager
    def beside(self, name: str):
        """A detail span over the block, recorded at its close beside the
        spans opened inside it rather than above them: theirs keep the
        paths they have without it."""
        start = self._clock()
        try:
            yield
        finally:
            self.add(name, start, detail=True)

    def _close(self, path: str, start: float, dur: float, detail: bool) -> None:
        with self._lock:
            if detail:
                self._detail.add(path)
            if "." not in path:
                self._phases.append((path, dur))
            if len(self.spans) < MAX_SPANS:
                self.spans.append((path, dur))
            else:
                self.dropped += 1
            total = self._totals.get(path)
            if total is None:
                self._totals[path] = [1, dur]
            else:
                total[0] += 1
                total[1] += dur
        for fn in self.listeners:
            try:
                fn(path, start, dur)
            except Exception:
                # advisory: a broken observer must never fail the
                # timed work.
                pass

    def is_detail(self, path: str) -> bool:
        """Whether ``path`` was recorded as a detail span."""
        return path in self._detail

    def phases(self) -> list[tuple[str, float]]:
        """Top-level spans in completion order."""
        return list(self._phases)

    def totals(self) -> dict[str, float]:
        """Total seconds per dotted path (repeated spans accumulate),
        exact past the list's cap."""
        with self._lock:
            return {p: t[1] for p, t in self._totals.items()}

    def snapshot(self) -> dict:
        """``{path: {"count": n, "seconds": s}}`` of every closed span."""
        with self._lock:
            return {p: {"count": t[0], "seconds": t[1]} for p, t in self._totals.items()}

    def report(self, out=None) -> None:
        """The ``--profile`` report (top-level phases + total), byte for
        byte the JAX package's format."""
        out = out or sys.stderr
        phases = self.phases()
        total = sum(d for _, d in phases)
        for name, dur in phases:
            print(f"[profile] {name:>16}: {dur * 1e3:10.2f} ms", file=out)
        print(f"[profile] {'total':>16}: {total * 1e3:10.2f} ms", file=out)


_active: SpanRecorder | None = None


def activate_spans(clock=None, *, recorder: SpanRecorder | None = None) -> SpanRecorder:
    """Arm ``recorder`` (a fresh one on ``clock`` when None) as the
    active recorder of :func:`span`; returns it."""
    global _active
    if recorder is None:
        recorder = SpanRecorder(clock if clock is not None else time.perf_counter)
    _active = recorder
    return recorder


def deactivate_spans() -> None:
    global _active
    _active = None


def active_spans() -> SpanRecorder | None:
    return _active


def span(name: str, detail: bool = False):
    """A span on the armed recorder, else the shared no-op context."""
    rec = _active
    if rec is None:
        return NULL_SPAN
    return rec.span(name, detail)


def span_beside(name: str):
    """:meth:`SpanRecorder.beside` on the armed recorder, else the shared
    no-op context."""
    rec = _active
    if rec is None:
        return NULL_SPAN
    return rec.beside(name)
