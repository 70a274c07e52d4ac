"""Request queue with deterministic admission control (the port of
``mpi_openmp_cuda_tpu/serve/queue.py``).

Reader threads (socket connections, the stdin ingest) call
:meth:`RequestQueue.submit`; the serve loop's main thread calls
:meth:`RequestQueue.pop_ready`.  Admission is deterministic: it decides on
the queue depth against ``max_depth`` and on the admission controller's
token bucket of modelled superblock wall (:mod:`.slo`: host arithmetic
over the request's lengths, refilled by completions, never a clock), so
the same submissions with the same completion order admit and reject
alike.  The admit timestamp is recorded (the latency histogram, the shed
machine's wait percentile) but decides no admission.

Requests are held as raw parsed dicts: validation happens on the main
loop thread (:mod:`.session`), so reader threads only ``json.loads`` and
enqueue, and never touch a tensor.

``pop_ready`` is the continuous-batching seam: it waits (through the
injectable :class:`.clock.ServeClock`) for a queued request, then lingers
one gather window so a concurrent burst lands in one superblock plan.
The window is skipped once every input source has closed.  The two
blocks are the detail spans ``serve.wait`` (no work in hand) and
``serve.linger`` (work in hand, coalescing): the serve loop's idle time.
"""

from __future__ import annotations

import dataclasses
import threading

from ..obs.events import publish
from ..obs.spans import active_spans

#: Admission verdicts (strings so responders can embed them in errors).
ADMIT_OK = "ok"
ADMIT_FULL = "full"
ADMIT_CLOSED = "closed"
ADMIT_OVERLOADED = "overloaded"


@dataclasses.dataclass
class QueuedRequest:
    """One admitted raw request awaiting the loop: the unvalidated dict,
    the responder that owns its result lines, the admit time (histogram
    input only), a process-unique sequence number (the default request
    id), and the modelled wall charged against the admission bucket
    (released when the session retires)."""

    raw: dict
    responder: object
    admitted_t: float
    seq: int
    cost_s: float = 0.0
    # Per-request trace id, minted at admission from the queue's own
    # sequence counter (no clock) and carried on every bus event this
    # request causes (obs/trace.py).
    trace_id: str = ""


class RequestQueue:
    """Bounded FIFO of :class:`QueuedRequest` under one condition.

    ``max_depth`` is the backpressure contract: a submit past it is
    rejected with :data:`ADMIT_FULL` (the client resubmits) instead of
    growing the queue without bound.  ``close()`` stops admission for
    the drain; ``drain_pending()`` hands the leftovers to the journal.
    """

    def __init__(self, max_depth: int, clock, controller=None):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.max_depth = int(max_depth)
        self._clock = clock
        # Optional slo.AdmissionController; lock order is strictly
        # queue -> controller (the controller never calls back here).
        self._controller = controller
        self._cond = threading.Condition()
        self._items: list[QueuedRequest] = []
        self._closed = False
        self._sources = 0
        self._seq = 0

    # -- source bookkeeping ------------------------------------------------

    def open_source(self) -> None:
        """A producer (socket listener, stdin ingest) came up."""
        with self._cond:
            self._sources += 1

    def close_source(self) -> None:
        """A producer finished; with zero sources and an empty queue the
        loop knows the run is complete (stdin/file mode)."""
        with self._cond:
            self._sources = max(0, self._sources - 1)
            self._cond.notify_all()

    # -- admission ---------------------------------------------------------

    def submit(self, raw: dict, responder) -> str:
        """Admit one raw request; returns an ADMIT_* verdict.

        The bus event is published after ``_cond`` is released: publish
        fans out synchronously to the obs recorders (each behind its own
        lock, the flight recorder with file I/O on trigger events), which
        must not nest beneath the lock every reader thread contends."""
        with self._cond:
            rejection = None
            cost = 0.0
            if not self._closed and self._controller is not None:
                rejection, cost = self._controller.admit(raw)
            if self._closed:
                verdict, event, fields = ADMIT_CLOSED, "serve.request.rejected", {
                    "reason": "closed", "depth": len(self._items),
                }
            elif rejection is not None:
                verdict, event, fields = ADMIT_OVERLOADED, "serve.request.shed", {
                    "reason": rejection, "depth": len(self._items),
                }
            elif len(self._items) >= self.max_depth:
                if self._controller is not None:
                    # The bucket admitted it; the depth backstop did not.
                    self._controller.release(cost)
                verdict, event, fields = ADMIT_FULL, "serve.request.rejected", {
                    "reason": "full", "depth": len(self._items),
                }
            else:
                self._seq += 1
                trace_id = f"t{self._seq}"
                rid = raw.get("id")
                self._items.append(
                    QueuedRequest(
                        raw,
                        responder,
                        self._clock.now(),
                        self._seq,
                        cost,
                        trace_id,
                    )
                )
                self._cond.notify_all()
                verdict, event, fields = ADMIT_OK, "serve.request.admitted", {
                    "depth": len(self._items),
                    "id": f"req-{self._seq}" if rid is None else str(rid),
                    "trace": trace_id,
                }
        publish(event, **fields)
        return verdict

    def close(self) -> None:
        """Stop admission (drain); waiters wake immediately."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # -- the loop side -----------------------------------------------------

    def depth(self) -> int:
        with self._cond:
            return len(self._items)

    def idle(self) -> bool:
        """Nothing queued and no producer left to queue more."""
        with self._cond:
            return not self._items and self._sources == 0

    def pop_ready(
        self,
        timeout_s: float,
        window_s: float,
        limit: int = 0,
        wake=None,
    ) -> list[QueuedRequest]:
        """Pop up to ``limit`` requests (0 = all), coalescing a burst.

        Phase 1 waits up to ``timeout_s`` for work (or ``wake()``, the
        drain flag: the wait is bounded so a signal is noticed within
        one tick).  Phase 2 lingers ``window_s`` with work in hand while
        sources are still open, so concurrently-arriving requests land
        in the SAME pop — that is what turns per-request dispatches into
        shared superblocks.
        """

        def wake_up() -> bool:
            return bool(wake is not None and wake())

        # The blocks' spans are recorded once ``_cond`` is released: span
        # listeners take the obs recorders' locks, as ``publish`` does.
        rec = active_spans()
        marks = []  # the recorder's clock before, between and after the blocks
        with self._cond:
            if rec is not None:
                marks.append(rec.now())
            self._clock.block_until(
                self._cond,
                lambda: bool(self._items)
                or self._closed
                or self._sources == 0
                or wake_up(),
                timeout_s,
            )
            if rec is not None:
                marks.append(rec.now())
            if self._items and self._sources > 0 and not wake_up():
                self._clock.block_until(
                    self._cond,
                    lambda: self._closed
                    or wake_up()
                    or (0 < limit <= len(self._items)),
                    window_s,
                )
                if rec is not None:
                    marks.append(rec.now())
            take = len(self._items) if limit <= 0 else min(limit, len(self._items))
            popped, self._items[:take] = self._items[:take], []
        for name, start, end in zip(("serve.wait", "serve.linger"), marks, marks[1:]):
            rec.add(name, start, end, detail=True)
        return popped

    def snapshot_raws(self) -> list[dict]:
        """Copy of the queued raw dicts in admission order, WITHOUT
        popping (the serve loop's live journal rewrite — the queue keeps
        ownership of every item)."""
        with self._cond:
            return [it.raw for it in self._items]

    def drain_pending(self) -> list[QueuedRequest]:
        """Remove and return everything still queued (drain journaling)."""
        with self._cond:
            popped, self._items[:] = list(self._items), []
            return popped
