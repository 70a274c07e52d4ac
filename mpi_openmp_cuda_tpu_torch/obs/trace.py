"""Request-scoped tracing: the third obs tier (counters < spans < traces),
the port of ``mpi_openmp_cuda_tpu/obs/trace.py``.

The metrics registry says *how much*; the span recorder says *where the
wall went by phase*; the trace says which launch (and, under a serve
plane, which request) paid for it:

* trace ids ride the bus fields of every per-request event (the serve
  plane mints them; the batch CLI has none);
* each launch group ``ops/dispatch.py`` queues is recorded as a
  *launch*, from its dispatch to its rows on the host, with the list of
  linked request ids;
* every finished launch is priced by the port's Hopper launch model
  (``ops/schedule.py::launch_us`` at the launch's L2P — the one number
  that differs from the JAX package, whose model is the TPU's), giving a
  parallel *modelled* track and a ``measured - modelled`` gap row.

Export is Chrome-trace / Perfetto JSON (``traceEvents``) wrapped in the
versioned run-report envelope as ``kind="trace"``; Perfetto ignores the
extra envelope keys, so the report file loads directly in the UI.

Armed by the CLI, the trace is made from the run's span recorder
(``obs/spans.py``): it reads the recorder's clock, takes its zero from
the recorder's anchor and carries the anchor as ``clock_anchor``, so an
event's ``ts`` (microseconds) lies at ``unix_ns + ts * 1000`` on the
Unix-epoch clock ``torch.profiler`` stamps device events with.  Host
spans land on the ``spans`` track under the category ``span``, the
recorder's detail spans under ``detail``; the CLI's ``run.`` plumbing,
outside every phase, stays off the trace.  The
fleet methods (board phases, clock offsets, worker tracks) come along
unchanged for the serve plane.

Thread contract: ``record_event`` runs on whatever thread publishes
(the watchdog monitor included), ``span_closed`` and the launch hooks on
the main thread, ``export`` on exit — every mutation crosses the
recorder's own lock.
"""

from __future__ import annotations

import threading
import time

from .metrics import wrap_report
from .spans import PLUMBING

#: Hard cap on buffered trace events: a long-lived server must not grow
#: its trace without bound.  Beyond the cap new events are counted in
#: ``dropped_events`` instead of buffered.
MAX_EVENTS = 200_000

# Perfetto track layout.  Two synthetic "processes": the host plane
# (spans / per-request rows / raw bus events) and the launch plane
# (measured dispatch walls with the cost model's modelled walls as the
# parallel track directly beneath them).
_PID_HOST = 1
_PID_LAUNCH = 2
_TID_SPANS = 1
_TID_REQUESTS = 2
_TID_EVENTS = 3
_TID_MEASURED = 1
_TID_MODELLED = 2

#: Perfetto metadata events naming the tracks (prepended at export).
_METADATA = (
    {"ph": "M", "pid": _PID_HOST, "tid": 0, "name": "process_name",
     "args": {"name": "seqalign-host"}},
    {"ph": "M", "pid": _PID_HOST, "tid": _TID_SPANS, "name": "thread_name",
     "args": {"name": "spans"}},
    {"ph": "M", "pid": _PID_HOST, "tid": _TID_REQUESTS,
     "name": "thread_name", "args": {"name": "requests"}},
    {"ph": "M", "pid": _PID_HOST, "tid": _TID_EVENTS, "name": "thread_name",
     "args": {"name": "events"}},
    {"ph": "M", "pid": _PID_LAUNCH, "tid": 0, "name": "process_name",
     "args": {"name": "seqalign-launches"}},
    {"ph": "M", "pid": _PID_LAUNCH, "tid": _TID_MEASURED,
     "name": "thread_name", "args": {"name": "measured"}},
    {"ph": "M", "pid": _PID_LAUNCH, "tid": _TID_MODELLED,
     "name": "thread_name", "args": {"name": "modelled (cost model)"}},
)

#: Bus events that open / close one request's row on the requests track.
_REQUEST_OPEN = "serve.request.admitted"
_REQUEST_CLOSE = {
    "serve.request.done": "done",
    "serve.request.failed": "failed",
    "serve.request.abandoned": "abandoned",
}

#: First pid handed to merged fleet-worker tracks (the coordinator's own
#: planes own pids 1 and 2; workers get 3, 4, ... in sorted-wid order so
#: the merged export is deterministic for the golden).
_PID_WORKER_BASE = 3

#: Merged worker events keep their within-worker track identity through
#: a (pid, tid) -> merged-tid fold; unknown shapes land on a catch-all.
_WORKER_TID_NAMES = {
    (_PID_HOST, _TID_SPANS): "spans",
    (_PID_HOST, _TID_REQUESTS): "requests",
    (_PID_HOST, _TID_EVENTS): "events",
    (_PID_LAUNCH, _TID_MEASURED): "measured",
    (_PID_LAUNCH, _TID_MODELLED): "modelled (cost model)",
}

#: Bound on buffered board-phase rows (one per fleet-scored superblock;
#: beyond it new rows are counted in ``dropped_events``).
MAX_BOARD_PHASES = 50_000

#: The five board-phase names, offer-posted -> demuxed, in wire order.
#: ``total`` is defined as the SUM of the four intervals, so the smoke
#: gates' totals==sums invariant holds by construction and any clamping
#: of a skewed interval stays visible as a shrunk total.
BOARD_PHASES = (
    "offer_to_claim",
    "claim_to_score",
    "score_to_post",
    "post_to_demux",
    "total",
)

_BLK = 128


def modelled_launch_wall_s(len1: int, lens) -> float:
    """Modelled device wall of ONE launch of rows of lengths ``lens``, in
    seconds: the Hopper launch model (``ops/schedule.py::launch_us``) at
    the launch's L2P, the widest live row rounded up to 128.  0.0 when
    no row is live, and on any failure: tracing must never be able to
    fail a dispatch."""
    try:
        from ..ops.schedule import launch_us
        from ..utils.constants import BUF_SIZE_SEQ2

        live = [min(int(x), BUF_SIZE_SEQ2) for x in lens if int(x) > 0]
        if not live:
            return 0.0
        l2p = -(-max(live) // _BLK) * _BLK
        return launch_us(int(len1), live, l2p) * 1e-6
    except Exception:
        # advisory: the modelled-wall column is a model estimate — 0.0
        # drops the column, the measured trace stands on its own.
        return 0.0


class TraceRecorder:
    """Bounded in-memory Chrome-trace builder for one run.

    Subscribes to the event bus (instant events + request rows), to the
    span recorder's close listener (host spans), and to the pipeline's
    launch hooks (measured/modelled launch tracks + gap rows).
    """

    def __init__(self, clock=time.perf_counter, *, spans=None):
        # ``spans``: the run's span recorder, whose clock and zero the
        # trace shares (its anchor rides the export).
        self._spans = spans
        self._clock = clock if spans is None else spans.now
        self._lock = threading.Lock()
        self._t0 = self._clock() if spans is None else spans.clock_s
        self._events: list[dict] = []
        self._gaps: list[dict] = []
        self._launches: dict = {}
        self._open_requests: dict = {}
        self._dropped = 0
        # Fleet plane (coordinator side): per-superblock board-phase
        # rows, per-worker clock-offset estimates, and the gathered
        # worker trace snapshots merged into the export as offset-
        # aligned per-worker tracks.
        self._board_phases: list[dict] = []
        self._clock_offsets: dict[str, dict] = {}
        self._worker_tracks: dict[str, tuple[float, list[dict]]] = {}

    def _us(self, t: float) -> float:
        return round((t - self._t0) * 1e6, 3)

    def now_us(self) -> float:
        """The current trace-timeline timestamp (microseconds since the
        trace's zero) — the clock-bridge sample a fleet worker posts
        next to its board-clock reading so the coordinator can map the
        worker's trace timeline onto its own."""
        return self._us(self._clock())

    # -- bus subscriber ----------------------------------------------------

    def record_event(self, event: str, fields: dict) -> None:
        """Every bus event becomes an instant; admitted→done/failed/
        abandoned pairs (matched by trace id) additionally close one
        complete row on the requests track."""
        t = self._clock()
        ev = {
            "name": event,
            "cat": "bus",
            "ph": "i",
            "ts": self._us(t),
            "pid": _PID_HOST,
            "tid": _TID_EVENTS,
            "s": "t",
            "args": dict(fields),
        }
        trace = fields.get("trace")
        outcome = _REQUEST_CLOSE.get(event) if trace is not None else None
        with self._lock:
            if len(self._events) >= MAX_EVENTS:
                self._dropped += 1
                return
            self._events.append(ev)
            if event == _REQUEST_OPEN and trace is not None:
                self._open_requests[trace] = (
                    str(fields.get("id", trace)), t,
                )
            elif outcome is not None:
                opened = self._open_requests.pop(trace, None)
                if opened is not None:
                    rid, t_open = opened
                    self._events.append({
                        "name": rid,
                        "cat": "request",
                        "ph": "X",
                        "ts": self._us(t_open),
                        "dur": round((t - t_open) * 1e6, 3),
                        "pid": _PID_HOST,
                        "tid": _TID_REQUESTS,
                        "args": {"trace": trace, "outcome": outcome},
                    })

    # -- span-recorder listener --------------------------------------------

    def span_closed(self, path: str, start: float, dur: float) -> None:
        if path.startswith(PLUMBING):
            return
        spans = self._spans
        ev = {
            "name": path,
            "cat": "detail" if spans is not None and spans.is_detail(path) else "span",
            "ph": "X",
            "ts": self._us(start),
            "dur": round(dur * 1e6, 3),
            "pid": _PID_HOST,
            "tid": _TID_SPANS,
            "args": {},
        }
        with self._lock:
            if len(self._events) >= MAX_EVENTS:
                self._dropped += 1
                return
            self._events.append(ev)

    # -- launch hooks (io/pipeline.py) -------------------------------------

    def launch_begin(self, key, *, links=(), len1=0, lens=(), ctx=None) -> None:
        """Arm one dispatch.  ``key`` is any hashable unique while the
        launch is in flight (the pipeline uses ``id(promise)``; the
        entry is popped at ``launch_end``, so id reuse after retirement
        is harmless).  ``links`` is the list of request ids whose rows
        ride this launch.  ``ctx`` (fleet workers only) stamps the
        originating trace ids, worker id, and lease epoch onto the
        launch row and its trace events."""
        entry = (
            tuple(links),
            int(len1),
            tuple(int(x) for x in lens),
            self._clock(),
            dict(ctx) if ctx else None,
        )
        with self._lock:
            self._launches[key] = entry

    def launch_end(self, key) -> None:
        """Close one dispatch: measured wall (dispatch → host rows,
        device-fenced by materialisation itself), modelled wall from
        the cost model, and the gap row.  Unknown keys are ignored —
        a launch that failed mid-flight stays counted as unfinished."""
        t = self._clock()
        with self._lock:
            entry = self._launches.pop(key, None)
        if entry is None:
            return
        links, len1, lens, t_begin, ctx = entry
        measured = t - t_begin
        modelled = modelled_launch_wall_s(len1, lens)
        request_ids = list(links)
        measured_ev = {
            "name": "dispatch",
            "cat": "launch",
            "ph": "X",
            "ts": self._us(t_begin),
            "dur": round(measured * 1e6, 3),
            "pid": _PID_LAUNCH,
            "tid": _TID_MEASURED,
            "args": {
                "request_ids": request_ids,
                "rows": len(lens),
                "len1": len1,
            },
        }
        modelled_ev = {
            "name": "modelled",
            "cat": "model",
            "ph": "X",
            "ts": self._us(t_begin),
            "dur": round(modelled * 1e6, 3),
            "pid": _PID_LAUNCH,
            "tid": _TID_MODELLED,
            "args": {"request_ids": request_ids},
        }
        row = {
            "request_ids": request_ids,
            "rows": len(lens),
            "len1": len1,
            "measured_s": round(measured, 9),
            "modelled_s": round(modelled, 9),
            "gap_s": round(measured - modelled, 9),
        }
        if ctx:
            # Fleet-worker stamp: the propagated admission trace ids,
            # this worker's id, and the claim's lease epoch — absent on
            # local launches so batch/serve rows (and their goldens)
            # stay byte-identical.
            measured_ev["args"].update(ctx)
            row.update(ctx)
        with self._lock:
            if len(self._events) + 2 > MAX_EVENTS:
                self._dropped += 2
            else:
                self._events.append(measured_ev)
                self._events.append(modelled_ev)
            self._gaps.append(row)

    # -- fleet plane (coordinator side) ------------------------------------

    def board_phase(self, row: dict) -> None:
        """Record one fleet-scored superblock's board-phase breakdown
        (serve/fleet.py builds the row: bid, worker, epoch, propagated
        trace ids, clock offset, and the five phase durations)."""
        with self._lock:
            if len(self._board_phases) >= MAX_BOARD_PHASES:
                self._dropped += 1
                return
            self._board_phases.append(dict(row))

    def set_clock_offsets(self, offsets: dict) -> None:
        """Publish the coordinator's current per-worker clock-offset
        estimates (ClockOffsetEstimator.snapshot())."""
        with self._lock:
            self._clock_offsets = dict(offsets)

    def set_worker_track(self, wid: str, events, shift_us: float) -> None:
        """Install (or refresh) one worker's gathered trace snapshot.
        ``events`` is the worker recorder's bounded event list;
        ``shift_us`` maps its timestamps onto THIS recorder's timeline
        (worker-trace -> worker-board -> coordinator-board ->
        coordinator-trace, all deterministic arithmetic).  Snapshots
        overwrite in place: the newest gather wins."""
        evs = [dict(e) for e in events if isinstance(e, dict)]
        with self._lock:
            self._worker_tracks[str(wid)] = (float(shift_us), evs)

    def snapshot_events(self, limit: int = 2000) -> list[dict]:
        """The newest ``limit`` buffered events, detached — the bounded
        payload a fleet worker posts over the board."""
        with self._lock:
            tail = self._events[-int(limit):] if limit else []
        return [dict(e) for e in tail]

    def _merged_worker_events(self) -> list[dict]:
        """Per-worker Perfetto tracks: each gathered worker snapshot on
        its own pid (sorted-wid order from ``_PID_WORKER_BASE``), with
        generated metadata events and timestamps shifted onto this
        recorder's timeline."""
        with self._lock:
            tracks = {
                wid: (shift, list(evs))
                for wid, (shift, evs) in self._worker_tracks.items()
            }
        out: list[dict] = []
        for i, wid in enumerate(sorted(tracks)):
            shift, evs = tracks[wid]
            pid = _PID_WORKER_BASE + i
            out.append({
                "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                "args": {"name": f"seqalign-worker {wid}"},
            })
            named: set[int] = set()
            for ev in evs:
                old = (ev.get("pid", _PID_HOST), ev.get("tid", _TID_EVENTS))
                tid = old[0] * 4 + old[1]
                if tid not in named:
                    named.add(tid)
                    out.append({
                        "ph": "M", "pid": pid, "tid": tid,
                        "name": "thread_name",
                        "args": {
                            "name": _WORKER_TID_NAMES.get(
                                old, f"p{old[0]}t{old[1]}"
                            )
                        },
                    })
                merged = dict(ev)
                merged["pid"] = pid
                merged["tid"] = tid
                ts = merged.get("ts")
                if isinstance(ts, (int, float)):
                    merged["ts"] = round(float(ts) + shift, 3)
                out.append(merged)
        return out

    # -- export ------------------------------------------------------------

    def gap_attribution(self) -> dict:
        """The per-launch ``measured - modelled`` table plus its totals
        (the run report's ``gap_attribution`` section).  With fleet
        data recorded, the section additionally carries the per-
        superblock ``board_phases`` rows, their per-phase totals, and
        the per-worker ``clock_offsets`` — absent otherwise, so local
        runs' reports are byte-identical to before."""
        with self._lock:
            launches = [dict(g) for g in self._gaps]
            unfinished = len(self._launches)
            phases = [dict(p) for p in self._board_phases]
            offsets = dict(self._clock_offsets)
        total_measured = sum(g["measured_s"] for g in launches)
        total_modelled = sum(g["modelled_s"] for g in launches)
        out = {
            "launches": launches,
            "launch_count": len(launches),
            "unfinished_launches": unfinished,
            "total_measured_s": round(total_measured, 9),
            "total_modelled_s": round(total_modelled, 9),
            "total_gap_s": round(total_measured - total_modelled, 9),
        }
        if phases:
            out["board_phases"] = phases
            out["board_phase_totals"] = {
                name: round(
                    sum(
                        float(p.get("phases", {}).get(name, 0.0))
                        for p in phases
                    ),
                    9,
                )
                for name in BOARD_PHASES
            }
        if offsets:
            out["clock_offsets"] = offsets
        return out

    def export(self, *, exit_code=None, meta=None) -> dict:
        """The full ``kind="trace"`` envelope.  ``traceEvents`` is the
        Chrome-trace payload (Perfetto ignores the sibling keys);
        gathered fleet-worker snapshots ride as additional per-worker
        tracks, offset-aligned to this recorder's timeline."""
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
        body = {
            "traceEvents": (
                list(_METADATA) + events + self._merged_worker_events()
            ),
            "displayTimeUnit": "ms",
            "gap_attribution": self.gap_attribution(),
            "dropped_events": dropped,
        }
        if self._spans is not None:
            body["clock_anchor"] = self._spans.anchor()
        if exit_code is not None:
            body["exit_code"] = int(exit_code)
        return wrap_report("trace", body, meta=meta)


# -- module plane (mirrors obs.metrics / obs.events arming) ----------------

_active: TraceRecorder | None = None


def activate_trace(clock=None, *, spans=None) -> TraceRecorder:
    """Arm a fresh trace; with ``spans`` (the run's span recorder) on its
    clock and zero, else on ``clock``."""
    global _active
    _active = TraceRecorder(clock or time.perf_counter, spans=spans)
    return _active


def deactivate_trace() -> None:
    global _active
    _active = None


def active_trace() -> TraceRecorder | None:
    return _active


def trace_launch_begin(key, *, links=(), len1=0, lens=(), ctx=None) -> None:
    """No-op unless the trace plane is armed (one attribute check)."""
    rec = _active
    if rec is not None:
        rec.launch_begin(key, links=links, len1=len1, lens=lens, ctx=ctx)


def trace_launch_end(key) -> None:
    rec = _active
    if rec is not None:
        rec.launch_end(key)


def trace_board_phase(row: dict) -> None:
    """Record one fleet board-phase breakdown row (no-op unarmed)."""
    rec = _active
    if rec is not None:
        rec.board_phase(row)


def trace_clock_offsets(offsets: dict) -> None:
    """Publish per-worker clock-offset estimates (no-op unarmed)."""
    rec = _active
    if rec is not None:
        rec.set_clock_offsets(offsets)


def trace_worker_track(wid: str, events, shift_us: float) -> None:
    """Install a gathered worker trace snapshot (no-op unarmed)."""
    rec = _active
    if rec is not None:
        rec.set_worker_track(wid, events, shift_us)
