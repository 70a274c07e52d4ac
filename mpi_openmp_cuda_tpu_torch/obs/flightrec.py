"""Flight recorder: a bounded ring of the last N bus events and span
closures, dumped atomically on the ways a run dies (the port of
``mpi_openmp_cuda_tpu/obs/flightrec.py``).

The ring costs a deque append per bus event and is written out only
when something goes wrong:

* watchdog expiry (``watchdog.expiry`` — published from the monitor
  thread, so recording and dumping are lock-guarded);
* circuit-breaker open and the fleet events (``DUMP_TRIGGERS``), for the
  serve plane;
* fatal exit (the CLI dumps on exit 65 in its teardown);
* operator request (SIGUSR2, wired in ``io/cli.py``).

Dumps are ``kind="flightrec"`` envelopes written atomically to
``<cache_home>/flightrec/`` (``utils/env.py::cache_home``), never
raising: a failing dump must not turn an incident into a crash.

Thread contract: ``record_event`` runs on the main thread and the watchdog
monitor thread; every mutation of the ring crosses the recorder's own
lock, and ``dump`` snapshots under the lock but writes the file outside
it.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import threading
import time

from .events import log_line
from .metrics import wrap_report

#: Ring depth when ``SEQALIGN_FLIGHTREC_DEPTH`` is unset (0 disables).
DEFAULT_DEPTH = 256

#: Bus events that trigger an immediate dump, and the dump reason each
#: one stamps into the artifact (and its filename).
DUMP_TRIGGERS = {
    "watchdog.expiry": "watchdog-expiry",
    "breaker.open": "breaker-open",
    "worker.dead": "worker-dead",
    # Failover events: a standby taking over or a deposed leader being
    # fenced is exactly the moment the pre-incident tape matters.
    "leader.takeover": "leader-takeover",
    "leader.fenced": "leader-fenced",
}


class FlightRecorder:
    """Lock-guarded bounded ring of bus events and span closures."""

    def __init__(self, depth: int = DEFAULT_DEPTH, clock=time.monotonic):
        self.depth = int(depth)
        self._clock = clock
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(
            maxlen=max(1, self.depth)
        )
        self._seq = 0
        self._dropped = 0
        self._dumps = 0
        self.dump_paths: list[str] = []

    # -- recording ---------------------------------------------------------

    def record_event(self, event: str, fields: dict) -> None:
        """Bus subscriber: append one event; dump when it is a trigger.
        The dump runs OUTSIDE the lock (it re-enters for its snapshot)."""
        t = self._clock()
        with self._lock:
            self._seq += 1
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append({
                "kind": "event",
                "seq": self._seq,
                "t": round(t, 6),
                "name": event,
                "fields": dict(fields),
            })
        reason = DUMP_TRIGGERS.get(event)
        if reason is not None:
            self.dump(reason)

    def span_closed(self, path: str, start: float, dur: float) -> None:
        """Span-recorder listener: append one span closure."""
        t = self._clock()
        with self._lock:
            self._seq += 1
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append({
                "kind": "span",
                "seq": self._seq,
                "t": round(t, 6),
                "name": path,
                "dur_s": round(dur, 9),
            })

    def snapshot_tape(self, limit: int | None = None) -> list[dict]:
        """The newest ``limit`` ring entries, detached — the bounded
        tape a fleet worker posts with its observability snapshot so
        the coordinator can collect it post-mortem."""
        with self._lock:
            tape = list(self._events)
        if limit is not None:
            tape = tape[-int(limit):]
        return [dict(e) for e in tape]

    # -- dumping -----------------------------------------------------------

    def _dump_dir(self) -> str:
        from ..utils.env import cache_home

        home = cache_home()
        if home is None:
            # Cache plane disabled: a post-mortem is still worth having.
            home = os.path.join(
                tempfile.gettempdir(), "mpi_openmp_cuda_tpu_torch"
            )
        return os.path.join(home, "flightrec")

    def dump(self, reason: str) -> str | None:
        """Write the ring as one ``kind="flightrec"`` envelope.  Returns
        the path, or None on any failure — dumping happens while the
        process is already in trouble and must never add to it."""
        try:
            with self._lock:
                events = list(self._events)
                dropped = self._dropped
                self._dumps += 1
                n = self._dumps
            rec = wrap_report("flightrec", {
                "reason": str(reason),
                "depth": self.depth,
                "dropped": dropped,
                "events": events,
            })
            dump_dir = self._dump_dir()
            os.makedirs(dump_dir, exist_ok=True)
            path = os.path.join(
                dump_dir, f"flightrec-{os.getpid()}-{n}-{reason}.json"
            )
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(json.dumps(rec, indent=2, sort_keys=True) + "\n")
            os.replace(tmp, path)
            with self._lock:
                self.dump_paths.append(path)
            log_line(
                f"mpi_openmp_cuda_tpu_torch: flight recorder dumped "
                f"{len(events)} events to {path} ({reason})"
            )
            return path
        except Exception:
            # advisory: the dump is post-mortem best-effort — failing to
            # write it must not mask the fault that triggered it.
            return None


# -- module plane (mirrors obs.metrics / obs.events arming) ----------------

_active: FlightRecorder | None = None


def activate_flightrec(
    depth: int = DEFAULT_DEPTH, clock=None
) -> FlightRecorder:
    global _active
    _active = FlightRecorder(depth, clock or time.monotonic)
    return _active


def deactivate_flightrec() -> None:
    global _active
    _active = None


def active_flightrec() -> FlightRecorder | None:
    return _active


def dump_active(reason: str) -> str | None:
    """Dump the armed recorder, if any (one attribute check when off)."""
    rec = _active
    if rec is not None:
        return rec.dump(reason)
    return None


def dump_fleet_tape(wid: str, events, reason: str) -> str | None:
    """Write a tape COLLECTED from a fleet worker (its last posted
    observability snapshot) as a ``kind="flightrec"`` envelope in the
    same dump directory — the coordinator calls this when it declares
    the worker dead, so the worker's final seconds survive its own
    inability to dump.  Never raises; returns the path or None."""
    try:
        evs = [
            dict(e) for e in events
            if isinstance(e, dict)
            and e.get("kind") in ("event", "span")
            and e.get("name")
        ]
        rec = FlightRecorder(depth=max(1, len(evs)))
        rec_body = wrap_report("flightrec", {
            "reason": f"{reason}:{wid}",
            "depth": rec.depth,
            "dropped": 0,
            "events": evs,
            "worker": str(wid),
        })
        dump_dir = rec._dump_dir()
        os.makedirs(dump_dir, exist_ok=True)
        path = os.path.join(
            dump_dir, f"fleet-tape-{wid}-{os.getpid()}-{reason}.json"
        )
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(json.dumps(rec_body, indent=2, sort_keys=True) + "\n")
        os.replace(tmp, path)
        log_line(
            f"mpi_openmp_cuda_tpu_torch: collected fleet tape "
            f"({len(evs)} events) from {wid} to {path} ({reason})"
        )
        return path
    except Exception:
        # advisory: post-mortem best-effort, same contract as dump().
        return None
