"""Live telemetry: serve-socket verbs and a plain-HTTP Prometheus scrape
(the port of ``mpi_openmp_cuda_tpu/obs/telemetry.py``).

The run report (:mod:`.export`) is written when the process exits; a
server is meant never to exit, so this module exposes the same live
registry two ways while the loop runs:

* socket verbs: a client of the ndjson serve socket sends
  ``{"cmd": "metrics"}`` / ``{"cmd": "healthz"}`` / ``{"cmd": "trace"}``
  and gets one JSON record back on the same connection
  (:func:`answer_cmd`, called inline from ``ServeLoop.ingest``: never
  queued, never priced against the admission bucket);
* HTTP scrape: ``--telemetry-port N`` (0 = OS-assigned; env
  ``SEQALIGN_TELEMETRY_PORT``) binds a loopback :class:`TelemetryServer`
  whose ``GET /metrics`` renders the live registry through
  :func:`.metrics.to_prometheus` (the text of ``--metrics-out``'s
  sidecar, live), plus ``/healthz`` and ``/trace`` JSON endpoints.

The ``metrics`` verb's record also carries the span recorder's live
totals (``spans``: each path's count and seconds), so an operator can
difference two readings, e.g. the serve loop's ``serve.wait`` and
``serve.linger`` seconds against ``uptime_s`` for its busy share.

Readers snapshot the registry without pausing the serve loop.  Registry
mutation is plain dict arithmetic under the GIL, so a concurrent copy can
only fail transiently (``RuntimeError: dictionary changed size during
iteration``); the snapshot helper retries a few times instead of taking a
lock the hot path would share.  The scrape reads host-side state only: it
never touches a tensor nor synchronizes the device.
"""

from __future__ import annotations

import http.server
import json
import threading

from .metrics import active_metrics, fleet_to_prometheus, to_prometheus
from .spans import active_spans
from .trace import active_trace

#: Transient-retry budget for lock-free registry snapshots (see module
#: docstring — each attempt is a fresh dict copy, so one quiet moment
#: in the mutator suffices).
_SNAPSHOT_TRIES = 8


def live_snapshot() -> dict:
    """A JSON-ready copy of the armed registry (empty dict when the
    metrics plane is off), retried across concurrent mutation, with a
    ``spans`` section when a span recorder is armed: each closed span
    path's ``count`` and ``seconds`` since the recorder was made."""
    reg = active_metrics()
    if reg is None:
        return {}
    snap = _retried(reg.snapshot)
    rec = active_spans()
    if rec is not None:
        snap["spans"] = rec.snapshot()
    return snap


def live_fleet() -> dict:
    """A detached copy of the gathered per-worker snapshots
    (``registry.fleet`` — empty when unarmed or no fleet), retried
    across concurrent mutation like :func:`live_snapshot`."""
    reg = active_metrics()
    if reg is None or not reg.fleet:
        return {}
    return _retried(lambda: dict(reg.fleet))


def _retried(read):
    """``read()``, retried while a concurrent mutation makes it raise."""
    for _ in range(_SNAPSHOT_TRIES - 1):
        try:
            return read()
        except RuntimeError:
            continue
    return read()


def render_metrics() -> str:
    """The full ``/metrics`` body: the local registry's exposition plus
    the federated per-worker families (``worker="wid"`` labels) when
    the coordinator has gathered fleet snapshots.  Fleet HELP/TYPE
    heads are suppressed for families the local section already
    declared — one declaration per family, samples per origin."""
    local = to_prometheus(live_snapshot())
    fleet = live_fleet()
    if not fleet:
        return local
    heads = {
        ln.split()[2]
        for ln in local.splitlines()
        if ln.startswith("# TYPE ")
    }
    return local + fleet_to_prometheus(fleet, skip_heads=heads)


def answer_cmd(cmd: str, status: dict | None = None) -> dict:
    """One telemetry verb → one JSON-ready response record.

    Shared by the socket verbs and (indirectly, shape-wise) the HTTP
    endpoints so both planes answer identically.  Unknown verbs get a
    typed error record, not an exception — a bad verb must not kill the
    connection's reader thread.
    """
    if cmd == "metrics":
        return {"telemetry": "metrics", "metrics": live_snapshot()}
    if cmd == "healthz":
        return {"telemetry": "healthz", "status": dict(status or {"ok": True})}
    if cmd == "trace":
        tracer = active_trace()
        if tracer is None:
            return {
                "telemetry": "trace",
                "error": "trace plane not armed "
                "(--trace-out / SEQALIGN_TRACE)",
            }
        return {"telemetry": "trace", "trace": tracer.export()}
    return {
        "telemetry": cmd,
        "error": f"unknown telemetry cmd {cmd!r} "
        "(expected metrics | healthz | trace)",
    }


class TelemetryServer:
    """Loopback HTTP scrape endpoint over the live observability plane.

    ``start()`` binds 127.0.0.1 and serves from a daemon thread (request
    handling is also daemon-threaded, so a stalled scraper cannot wedge
    shutdown); ``close()`` is idempotent.  The server holds NO serve-loop
    state beyond the injected ``status`` callable — everything else it
    renders comes from the module-global armed planes.
    """

    def __init__(self, port: int, *, status=None):
        self.port = int(port)
        self.status = status
        self._httpd: http.server.ThreadingHTTPServer | None = None

    def start(self) -> int:
        """Bind and serve; returns the bound port (port 0 → assigned)."""
        status = self.status

        class Handler(http.server.BaseHTTPRequestHandler):
            # Scrapers poll; access logs on stderr would swamp the
            # heartbeat stream.
            def log_message(self, fmt, *fmt_args):
                pass

            def _reply(self, code: int, ctype: str, body: str) -> None:
                payload = body.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def _reply_json(self, record: dict, code: int = 200) -> None:
                self._reply(
                    code,
                    "application/json",
                    json.dumps(record, sort_keys=True) + "\n",
                )

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    self._reply(
                        200,
                        "text/plain; version=0.0.4; charset=utf-8",
                        render_metrics(),
                    )
                elif path == "/healthz":
                    self._reply_json(
                        answer_cmd(
                            "healthz",
                            status=status() if status is not None else None,
                        )
                    )
                elif path == "/trace":
                    self._reply_json(answer_cmd("trace"))
                else:
                    self._reply_json(
                        {
                            "error": f"unknown path {path!r} (expected "
                            "/metrics | /healthz | /trace)"
                        },
                        code=404,
                    )

        self._httpd = http.server.ThreadingHTTPServer(
            ("127.0.0.1", self.port), Handler
        )
        self._httpd.daemon_threads = True
        threading.Thread(
            target=self._httpd.serve_forever,
            name="seqalign-telemetry",
            daemon=True,
        ).start()
        return self._httpd.server_address[1]

    def close(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        try:
            httpd.shutdown()
            httpd.server_close()
        except OSError:  # pragma: no cover - teardown best-effort
            pass
