"""The run-report envelope (counterpart of ``mpi_openmp_cuda_tpu/obs/
metrics.py``'s report serializer).

Ported so far: :func:`wrap_report`, the envelope and ``kind="bench"``
checks of :func:`validate_report`, and :func:`drain_snapshot`, which the
journal's drain record reads.  The schema name and version are the JAX
package's, so one validator reads the records of both packages.
"""

from __future__ import annotations

#: The one report envelope (run reports AND bench records).
RUN_REPORT_SCHEMA = "mpi_openmp_cuda_tpu.run-report"
RUN_REPORT_VERSION = 1

# The armed metrics registry (anything with ``snapshot() -> dict``), or
# None.  The registry itself arrives with the port's obs plane; until then
# nothing arms one and the journal's drain record carries no snapshot.
_active = None


def drain_snapshot() -> dict | None:
    """The extra payload of the journal's ``{"event": "drain"}`` record:
    ``{"metrics": snapshot}`` when a registry is armed, else None."""
    if _active is None:
        return None
    return {"metrics": _active.snapshot()}


def wrap_report(kind: str, body: dict, *, meta: dict | None = None) -> dict:
    """``{"schema", "schema_version", "kind"[, "meta"], **body}``; the
    bench wraps its record with ``kind="bench"``."""
    rec: dict = {
        "schema": RUN_REPORT_SCHEMA,
        "schema_version": RUN_REPORT_VERSION,
        "kind": kind,
    }
    if meta:
        rec["meta"] = dict(meta)
    rec.update(body)
    return rec


def validate_report(rec) -> None:
    """Schema gate for a wrapped report; raises one ValueError naming
    every problem."""
    problems: list[str] = []
    if not isinstance(rec, dict):
        raise ValueError(f"report must be a JSON object, got {type(rec).__name__}")
    if rec.get("schema") != RUN_REPORT_SCHEMA:
        problems.append(f"schema: want {RUN_REPORT_SCHEMA!r}, got {rec.get('schema')!r}")
    ver = rec.get("schema_version")
    if not isinstance(ver, int) or ver < 1:
        problems.append(f"schema_version: want int >= 1, got {ver!r}")
    kind = rec.get("kind")
    if not isinstance(kind, str) or not kind:
        problems.append(f"kind: want a nonempty string, got {kind!r}")
    if kind == "bench" and ("metric" not in rec or "value" not in rec):
        problems.append("bench report: want metric and value fields")
    if problems:
        raise ValueError("invalid run report: " + "; ".join(problems))
