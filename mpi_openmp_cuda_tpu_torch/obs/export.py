"""Report writing and the heartbeat line (the port of the batch half of
``mpi_openmp_cuda_tpu/obs/export.py``; its fleet snapshot functions
arrive with the serve plane).

* :func:`flush_run_report` — the CLI's exit hook: writes the JSON run
  report at ``--metrics-out`` plus a Prometheus text sidecar at
  ``<out>.prom``.  Called from the run's ``finally``, so a failed run
  (exit 65) and a drained run (exit 75) still flush their reports.
* :func:`flush_trace` — the same for the ``--trace-out`` timeline.
* :func:`heartbeat_callback` — the periodic ``[obs] ...`` stderr line
  the watchdog monitor thread emits between operations
  (``--heartbeat`` / ``SEQALIGN_HEARTBEAT_S``).
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
