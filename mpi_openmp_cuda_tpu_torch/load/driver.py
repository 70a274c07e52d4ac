"""The open-loop client driver: schedules onto sockets, replies into
typed outcomes (the port of ``mpi_openmp_cuda_tpu/load/driver.py``).

This is the load plane's one wall-clock module: it
paces a prebuilt schedule onto real ndjson connections with
``time.monotonic`` and classifies what comes back.  Open-loop means the
pacing never waits for the server — a request is sent at its scheduled
offset whether or not earlier requests have been answered, which is
exactly how production traffic behaves and exactly what closed-loop
smokes cannot test.

Concurrency model: ``clients`` connections, schedule entries assigned
round-robin; each connection runs one writer thread (paced sends) and
one reader thread (terminal-record collection).  Threads share nothing
across connections and the per-connection state is joined before
anyone reads it, so the driver needs no locks.

Every scheduled request ends in exactly one typed
:class:`Outcome`:

``done``      the full result streamed and the ``done`` record landed;
``rejected``  a typed ``overloaded`` rejection (the admission plane's
              shed path, ``retry_after_s`` captured);
``failed``    any other typed ``{"id", "error"}`` reply (deadline,
              queue full, invalid, draining — answered, just not
              scored);
``missing``   no terminal record before the grace deadline — a SILENT
              DROP, which the survival gates treat as fatal;
``reset``     the connection died under us (ECONNRESET, timeout,
              refused) — equally fatal to the gates.
"""

from __future__ import annotations

import dataclasses
import json
import socket
import threading
import time


@dataclasses.dataclass
class Outcome:
    """One scheduled request's classified fate."""

    id: str
    kind: str  # done | rejected | failed | missing | reset
    error: str | None = None
    retry_after_s: float | None = None
    latency_s: float | None = None
    sent_t_s: float | None = None  # measured send offset from drive t0
    lines: int = 0  # streamed result rows seen before the terminal

    @property
    def answered(self) -> bool:
        """Did the server hold its one promise: a result or a TYPED
        rejection (never silence, never a reset)?"""
        return self.kind in ("done", "rejected", "failed")


@dataclasses.dataclass
class LoadResult:
    """One drive's classified outcomes + measured envelope."""

    outcomes: list
    offered: int  # scheduled requests
    duration_s: float  # first send -> last terminal (wall)
    send_span_s: float  # first send -> last send (wall)

    def counts(self) -> dict:
        c = {"done": 0, "rejected": 0, "failed": 0, "missing": 0, "reset": 0}
        for o in self.outcomes:
            c[o.kind] = c.get(o.kind, 0) + 1
        return c

    @property
    def goodput_rps(self) -> float:
        done = sum(1 for o in self.outcomes if o.kind == "done")
        return done / self.duration_s if self.duration_s > 0 else 0.0

    def latencies_s(self, *, kind: str = "done") -> list:
        return [
            o.latency_s
            for o in self.outcomes
            if o.kind == kind and o.latency_s is not None
        ]


class _Client:
    """One connection's writer+reader pair; owns all its own state."""

    def __init__(self, host, port, entries, timeout_s):
        self.host = host
        self.port = int(port)
        self.entries = entries  # [(offset_s, raw)]
        self.timeout_s = timeout_s
        self.sent: dict = {}  # id -> monotonic send time
        self.sent_offsets: dict = {}  # id -> offset from drive t0
        self.terminal: dict = {}  # id -> (record, monotonic recv time)
        self.lines: dict = {}  # id -> streamed row count
        self.dead: str | None = None  # socket-level failure, if any
        self._sock = None
        self._reader = None
        self.last_terminal_t = 0.0

    def _read_loop(self, rfile):
        try:
            for line in rfile:
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                rid = rec.get("id")
                if rid is None:
                    continue
                rid = str(rid)
                if (
                    rec.get("done")
                    or rec.get("error") is not None
                    or rec.get("duplicate")
                ):
                    t = time.monotonic()
                    self.terminal.setdefault(rid, (rec, t))
                    self.last_terminal_t = max(self.last_terminal_t, t)
                else:
                    self.lines[rid] = self.lines.get(rid, 0) + 1
        except (OSError, ValueError):
            # advisory: socket death is classified from the writer side
            # (self.dead) and by missing terminals — the reader just
            # stops.
            pass

    def run(self, t0: float) -> None:
        try:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout_s
            )
            self._sock.settimeout(self.timeout_s)
            rfile = self._sock.makefile("r", encoding="utf-8")
        except OSError as e:
            self.dead = f"connect: {e}"
            return
        self._reader = threading.Thread(
            target=self._read_loop, args=(rfile,), daemon=True
        )
        self._reader.start()
        try:
            for offset, raw in self.entries:
                delay = (t0 + offset) - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                payload = (json.dumps(raw) + "\n").encode("utf-8")
                self._sock.sendall(payload)
                now = time.monotonic()
                rid = str(raw.get("id"))
                self.sent[rid] = now
                self.sent_offsets[rid] = now - t0
        except OSError as e:
            self.dead = f"send: {e}"

    def await_terminals(self, deadline: float) -> None:
        """Block (bounded) until every sent id has a terminal record."""
        while time.monotonic() < deadline:
            if all(rid in self.terminal for rid in self.sent):
                break
            time.sleep(0.02)

    def close(self) -> None:
        if self._sock is not None:
            try:
                # Wakes the reader's blocked recv at once: close() alone
                # leaves the descriptor open under the reader's file
                # object, so the join below would wait out its timeout.
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
        if self._reader is not None:
            self._reader.join(timeout=2.0)


def _classify(raw, client) -> Outcome:
    rid = str(raw.get("id"))
    sent_t = client.sent.get(rid)
    out = Outcome(
        id=rid,
        kind="missing",
        sent_t_s=client.sent_offsets.get(rid),
        lines=client.lines.get(rid, 0),
    )
    term = client.terminal.get(rid)
    if term is not None:
        rec, recv_t = term
        if sent_t is not None:
            out.latency_s = max(0.0, recv_t - sent_t)
        err = rec.get("error")
        if rec.get("done") or rec.get("duplicate"):
            out.kind = "done"
        elif err == "overloaded":
            out.kind = "rejected"
            out.error = str(err)
            ra = rec.get("retry_after_s")
            if isinstance(ra, (int, float)):
                out.retry_after_s = float(ra)
        elif isinstance(err, str):
            out.kind = "failed"
            out.error = err
        return out
    if client.dead is not None:
        out.kind = "reset"
        out.error = client.dead
    elif sent_t is None:
        # Never sent and the socket is healthy: the drive gave up
        # before this offset — still a reset for gate purposes (the
        # harness, not the server, must explain it).
        out.kind = "reset"
        out.error = "never sent"
    return out


def drive(
    host: str,
    port: int,
    schedule,
    *,
    clients: int = 32,
    grace_s: float = 30.0,
    timeout_s: float = 30.0,
) -> LoadResult:
    """Replay ``schedule`` open-loop over ``clients`` connections and
    classify every request.  Returns when every request has a terminal
    record or the grace deadline past the last scheduled send expires.
    """
    schedule = list(schedule)
    n_clients = max(1, min(int(clients), max(1, len(schedule))))
    pools: list[list] = [[] for _ in range(n_clients)]
    for i, entry in enumerate(schedule):
        pools[i % n_clients].append(entry)
    conns = [
        _Client(host, port, pool, timeout_s) for pool in pools if pool
    ]
    t0 = time.monotonic() + 0.05  # small runway so client 0 isn't late
    writers = [
        threading.Thread(target=c.run, args=(t0,), daemon=True)
        for c in conns
    ]
    for w in writers:
        w.start()
    for w in writers:
        w.join()
    last_offset = schedule[-1][0] if schedule else 0.0
    deadline = t0 + last_offset + float(grace_s)
    for c in conns:
        c.await_terminals(deadline)
    for c in conns:
        c.close()

    by_id = {}
    for c in conns:
        for _, raw in c.entries:
            by_id[str(raw.get("id"))] = _classify(raw, c)
    outcomes = [by_id[str(raw.get("id"))] for _, raw in schedule]

    send_times = [t for c in conns for t in c.sent.values()]
    term_times = [
        c.last_terminal_t for c in conns if c.last_terminal_t > 0.0
    ]
    first_send = min(send_times) if send_times else t0
    last_event = max(term_times) if term_times else first_send
    send_span = (max(send_times) - first_send) if send_times else 0.0
    return LoadResult(
        outcomes=outcomes,
        offered=len(schedule),
        duration_s=max(1e-9, last_event - first_send),
        send_span_s=max(0.0, send_span),
    )
