"""Report writing, the heartbeat line and the fleet's snapshot plane (the
port of ``mpi_openmp_cuda_tpu/obs/export.py``).

* :func:`flush_run_report` — the CLI's exit hook: writes the JSON run
  report at ``--metrics-out`` plus a Prometheus text sidecar at
  ``<out>.prom``.  Called from the run's ``finally``, so a failed run
  (exit 65) and a drained run (exit 75) still flush their reports.
* :func:`flush_trace` — the same for the ``--trace-out`` timeline.
* :func:`heartbeat_callback` — the periodic ``[obs] ...`` stderr line
  the watchdog monitor thread emits between operations
  (``--heartbeat`` / ``SEQALIGN_HEARTBEAT_S``).
* :func:`post_host_snapshot` / :func:`gather_fleet` — under
  ``--distributed`` with the rescue tier, per-host snapshots ride the
  rescue board (:mod:`..resilience.rescue`): each rank posts its snapshot
  next to its rows and the coordinator folds them into the ``hosts``
  section of its report.  A rank that died has no snapshot key.
* :func:`post_worker_snapshot` / :func:`collect_worker_snapshot` — the
  serve fleet's per-worker snapshot (metrics, recent trace events, the
  flight-recorder tape) on the fleet board.
"""

from __future__ import annotations

import json
import os

from . import metrics as _metrics
from .events import log_line


def flush_run_report(
    registry,
    spans,
    path: str | None,
    *,
    exit_code: int | None = None,
    meta: dict | None = None,
    extra: dict | None = None,
) -> dict | None:
    """Write the run report (and ``.prom`` sidecar) for one finished
    run; no-op without a path or registry.  Returns the report dict.
    ``extra`` merges additional top-level body sections (the trace
    plane's ``gap_attribution``) into the report.

    Writes are tmp-file + rename so a preemption mid-flush leaves the
    previous report intact, never a torn JSON document (the journal's
    torn-tail lesson applied to reports)."""
    if registry is None or path is None:
        return None
    rec = _metrics.run_report(
        registry, spans=spans, exit_code=exit_code, meta=meta, extra=extra
    )
    _atomic_write(path, json.dumps(rec, indent=2, sort_keys=True) + "\n")
    _atomic_write(path + ".prom", _metrics.to_prometheus(registry.snapshot()))
    return rec


def _atomic_write(path: str, text: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def flush_trace(
    tracer,
    path: str | None,
    *,
    exit_code: int | None = None,
    meta: dict | None = None,
) -> dict | None:
    """Write the Perfetto/Chrome-trace envelope for one finished run
    (``--trace-out`` / ``SEQALIGN_TRACE``); no-op without a path or an
    armed tracer.  Same atomic-write stance as the run report — and the
    same every-exit-path contract: a crashed run's trace is often the
    only timeline of what wedged."""
    if tracer is None or path is None:
        return None
    rec = tracer.export(exit_code=exit_code, meta=meta)
    _atomic_write(path, json.dumps(rec, indent=2, sort_keys=True) + "\n")
    return rec


# -- heartbeat -------------------------------------------------------------


def heartbeat_line(snapshot: dict) -> str:
    """One ``[obs]`` status line from a registry snapshot (the format in
    the README's observability walkthrough)."""
    c = snapshot.get("counters", {})
    g = snapshot.get("gauges", {})
    total = g.get("chunks_total", "?")
    degraded = "yes" if c.get("degrade_transitions") else "no"
    line = (
        f"[obs] chunk {c.get('chunks_dispatched', 0)}/{total} "
        f"retries={c.get('retry_attempts', 0)} degraded={degraded}"
    )
    if "queue_depth" in g:
        # Serve mode only (the gauge exists only there): the batch-mode
        # heartbeat golden stays byte-identical.
        line += f" queue={g['queue_depth']}"
    if "shed_state" in g:
        line += f" shed={g['shed_state']}"
    if "breaker_state" in g:
        line += f" breaker={g['breaker_state']}"
    if "fleet_workers" in g:
        # Fleet coordinator only (the gauge exists only under
        # --fleet-board): batch AND plain-serve heartbeats unchanged.
        line += f" fleet={g['fleet_workers']}"
    return line


def heartbeat_callback(log=None):
    """The zero-argument emitter the watchdog's monitor thread calls on
    each quiet heartbeat interval."""
    emit = log or log_line

    def beat() -> None:
        reg = _metrics.active_metrics()
        if reg is not None:
            emit(heartbeat_line(reg.snapshot()))

    return beat


# -- the multi-host metrics plane ------------------------------------------


def _metrics_key(run_tag: str, pid: int) -> str:
    return f"seqalign/{run_tag}/metrics/{int(pid)}"


def post_host_snapshot(board, run_tag: str, pid: int) -> None:
    """Rank side: post this host's registry snapshot to the board (no-op
    with the obs plane off)."""
    reg = _metrics.active_metrics()
    if reg is None:
        return
    board.post(_metrics_key(run_tag, pid), json.dumps(reg.snapshot()))


def gather_fleet(board, run_tag: str, num_processes: int, *, skip=(),
                 timeout_s: float | None = None) -> None:
    """Coordinator side: fold every posted host snapshot into the armed
    registry's fleet section.  ``skip`` lists ranks already known lost (no
    point waiting out their timeout twice); a missing or torn snapshot is
    left out, as :func:`..resilience.rescue.fetch_shard` leaves out a
    missing shard."""
    reg = _metrics.active_metrics()
    if reg is None:
        return
    for w in range(int(num_processes)):
        if w in skip:
            continue
        raw = board.get(_metrics_key(run_tag, w), timeout_s)
        if raw is None:
            continue
        try:
            snap = json.loads(raw)
        except json.JSONDecodeError:
            continue
        if isinstance(snap, dict):
            reg.record_fleet(w, snap)


# -- the fleet observability plane (serve/fleet.py) ------------------------


def post_worker_snapshot(board, wid: str, t_board: float, *, beat: int = 0,
                         trace_limit: int = 2000) -> None:
    """Fleet-worker side: post one bounded observability snapshot to
    ``obs_snapshot_key(wid)``, overwritten in place each cadence.  It
    bundles the registry snapshot (metrics federation), the newest trace
    events (timeline merge), the flight-recorder tape (collected when the
    worker is declared dead) and the clock-bridge pair: ``t_board`` (the
    worker's serve-clock reading, sampled by the caller just before) next
    to ``t_trace_us`` (its trace clock, sampled here), which the
    coordinator subtracts to map trace timestamps onto board time.  Planes
    that are not armed leave their key out."""
    from ..resilience.membership import obs_snapshot_key
    from .flightrec import active_flightrec
    from .trace import active_trace

    snap: dict = {
        "wid": str(wid),
        "pid": os.getpid(),
        "beat": int(beat),
        "t_board": float(t_board),
    }
    reg = _metrics.active_metrics()
    if reg is not None:
        snap["metrics"] = reg.snapshot()
    tracer = active_trace()
    if tracer is not None:
        snap["t_trace_us"] = tracer.now_us()
        snap["trace"] = {"events": tracer.snapshot_events(trace_limit)}
    rec = active_flightrec()
    if rec is not None:
        snap["tape"] = rec.snapshot_tape()
    board.post(obs_snapshot_key(str(wid)), json.dumps(snap))


def collect_worker_snapshot(board, wid: str) -> dict | None:
    """Coordinator side: the newest snapshot a worker posted, or None when
    it is missing, torn or alien."""
    from ..resilience.membership import read_obs_snapshot

    return read_obs_snapshot(board, str(wid))
