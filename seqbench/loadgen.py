"""The open-loop client: a schedule paced onto ndjson sockets, replies into
typed outcomes (adapted from the port's ``load/driver.py``).

Two changes from the original.  Latency is timed from each request's
**due** time (``t0`` plus its offset), not from its send, so a stall of
the server or of the generator counts against every request it delays.
And the generator's own lateness (send minus due) is kept per request, so
a run can say how late it offered its load.

Concurrency: ``clients`` connections, schedule entries dealt round-robin;
each connection has a writer thread (paced sends) and a reader thread
(records in).  Per-connection state is joined before it is read.

Every request ends as one outcome kind: ``done`` (its ``done`` record
arrived), ``refused`` (a typed ``overloaded`` or queue-full answer: the
server's designed answer to overload), ``failed`` (any other typed
error), ``missing`` (no terminal record within the grace time) or
``reset`` (its connection failed).
"""

from __future__ import annotations

import json
import socket
import threading
import time
from dataclasses import dataclass, field


@dataclass
class Outcome:
    """One scheduled request's fate; times in seconds from ``t0``."""

    id: str
    kind: str
    due_s: float
    sent_s: float | None = None
    end_s: float | None = None
    lines: list = field(default_factory=list)
    done_n: int | None = None
    error: str | None = None

    @property
    def latency_s(self) -> float | None:
        """Due time to the terminal record."""
        return None if self.end_s is None else self.end_s - self.due_s


def refusal(error: str) -> bool:
    """The server's typed refusals under load (``serve/loop.py::ingest``)."""
    return error == "overloaded" or error.startswith("queue full")


def _records(sock, patient: bool = True):
    """Yield each JSON record read from ``sock`` until it closes; a read
    that times out is retried when ``patient``, else ends the stream."""
    buf = b""
    while True:
        try:
            chunk = sock.recv(1 << 16)
        except socket.timeout:
            if patient:
                continue
            return
        except OSError:
            return
        if not chunk:
            return
        buf += chunk
        *lines, buf = buf.split(b"\n")
        for raw in lines:
            if raw.strip():
                try:
                    yield json.loads(raw)
                except json.JSONDecodeError:
                    continue


class _Conn:
    """One connection's writer and reader; owns its own state."""

    def __init__(self, host: str, port: int, entries, timeout_s: float):
        self.entries = entries  # [(offset_s, id, payload)]
        self.sent: dict = {}
        self.terminal: dict = {}
        self.lines: dict = {}
        self.dead: str | None = None
        self.sock = socket.create_connection((host, port), timeout=timeout_s)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self) -> None:
        for rec in _records(self.sock):
            rid = rec.get("id")
            if rid is None:
                continue
            rid = str(rid)
            if rec.get("done") or rec.get("error") is not None or rec.get("duplicate"):
                self.terminal.setdefault(rid, (rec, time.monotonic()))
            elif "line" in rec:
                self.lines.setdefault(rid, []).append(rec["line"])

    def write(self, t0: float) -> None:
        try:
            for offset, rid, payload in self.entries:
                delay = t0 + offset - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                self.sock.sendall(payload)
                self.sent[rid] = time.monotonic()
        except OSError as e:
            self.dead = f"send: {e}"

    def settled(self) -> bool:
        return self.dead is not None or all(rid in self.terminal for rid in self.sent)

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()
        self.reader.join(timeout=5.0)


def _outcome(offset: float, rid: str, conn: _Conn, t0: float) -> Outcome:
    out = Outcome(rid, "missing", offset, lines=conn.lines.get(rid, []))
    sent = conn.sent.get(rid)
    if sent is not None:
        out.sent_s = sent - t0
    term = conn.terminal.get(rid)
    if term is not None:
        rec, t = term
        out.end_s = t - t0
        err = rec.get("error")
        if rec.get("done"):
            out.kind, out.done_n = "done", rec.get("n")
        elif isinstance(err, str) and refusal(err):
            out.kind, out.error = "refused", err
        else:
            out.kind, out.error = "failed", str(err)
    elif conn.dead is not None or sent is None:
        out.kind, out.error = "reset", conn.dead or "never sent"
    return out


class OpenLoop:
    """One drive of ``entries`` (``(offset_s, id, payload)``, sorted) over
    ``clients`` connections, opened at construction."""

    def __init__(self, host: str, port: int, entries, *, clients: int, timeout_s: float = 30.0):
        self.entries = list(entries)
        n = max(1, min(int(clients), len(self.entries)))
        pools = [self.entries[i::n] for i in range(n)]
        self.conns = []
        try:
            for pool in pools:
                self.conns.append(_Conn(host, port, pool, timeout_s))
        except OSError:
            self.close()
            raise

    def run(self, t0: float, grace_s: float) -> list[Outcome]:
        """Send every entry at ``t0`` plus its offset, wait until each has
        a terminal record or ``grace_s`` past the last offset, and return
        the outcomes in schedule order."""
        writers = [threading.Thread(target=c.write, args=(t0,), daemon=True) for c in self.conns]
        for w in writers:
            w.start()
        for w in writers:
            w.join()
        last = self.entries[-1][0] if self.entries else 0.0
        deadline = t0 + last + grace_s
        while time.monotonic() < deadline and not all(c.settled() for c in self.conns):
            time.sleep(0.01)
        self.close()
        outs = [_outcome(off, rid, c, t0) for c in self.conns for off, rid, _ in c.entries]
        return sorted(outs, key=lambda o: o.due_s)

    def close(self) -> None:
        for c in self.conns:
            c.close()


def command(host: str, port: int, cmd: str, timeout_s: float = 10.0) -> dict:
    """One telemetry verb (``metrics``, ``healthz``) on its own connection."""
    with socket.create_connection((host, port), timeout=timeout_s) as sock:
        sock.sendall((json.dumps({"cmd": cmd}) + "\n").encode())
        for rec in _records(sock, patient=False):
            return rec
    raise ConnectionError(f"no answer to the telemetry verb {cmd!r}")
