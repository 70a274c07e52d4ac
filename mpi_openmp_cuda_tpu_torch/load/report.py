"""The ``formulation="serve-load"`` bench record (the port of
``mpi_openmp_cuda_tpu/load/report.py``).

Kernel bench records carry batch throughput rows; this module gives the
serve plane a record of its own: one wrapped ``kind="bench"`` record
whose headline value is GOODPUT (completed requests per second under a
known open-loop offered rate), with the SLO surface — latency and
queue-wait percentiles, shed/deadline-miss rates, batch fill, breaker
transition counts — riding alongside.  The record marries
the two measurement sides:

* client-side truth from the driver's :class:`~.driver.LoadResult`
  (what the wire actually delivered, classified);
* server-side truth from the ``--metrics-out`` run report (queue-wait
  histograms, fill gauge, transition counters — what the serve plane
  believes it did).

``validate_report`` (obs/metrics.py) enforces the serve-load field
contract whenever ``formulation == "serve-load"``, so a malformed
record fails schema validation exactly like a malformed run report.

Percentiles here are :func:`obs.metrics.percentile` — the ONE rank
implementation the shed machine and the report histograms already
share, so client latency, server queue-wait, and shed thresholds are
directly comparable numbers.
"""

from __future__ import annotations

from ..obs.metrics import percentile, wrap_report


def _pctls(samples) -> dict:
    xs = [float(x) for x in samples]
    return {
        "p50": round(percentile(xs, 0.50), 6),
        "p90": round(percentile(xs, 0.90), 6),
        "p99": round(percentile(xs, 0.99), 6),
    }


def _report_pctls(server_report: dict | None, name: str) -> dict:
    hist = ((server_report or {}).get("histograms") or {}).get(name) or {}
    return {
        "p50": float(hist.get("p50", 0.0)),
        "p90": float(hist.get("p90", 0.0)),
        "p99": float(hist.get("p99", 0.0)),
    }


def serve_load_record(
    result,
    server_report: dict | None,
    *,
    process: str,
    rate_rps: float,
    seed: int,
    clients: int,
    speedup_k: float = 1.0,
    plateau_rps: float | None = None,
    meta: dict | None = None,
) -> dict:
    """Assemble + wrap one serve-load bench record (validate with
    :func:`obs.metrics.validate_report` like every other envelope)."""
    counts = result.counts()
    offered = max(1, result.offered)
    counters = (server_report or {}).get("counters") or {}
    gauges = (server_report or {}).get("gauges") or {}
    deadline_failed = sum(
        1 for o in result.outcomes if o.kind == "failed"
        and o.error == "deadline"
    )
    goodput = round(result.goodput_rps, 6)
    body = {
        "metric": (
            f"serve goodput, open-loop {process} @ {rate_rps:.1f} req/s"
        ),
        "value": goodput,
        "unit": "req/s",
        "formulation": "serve-load",
        "arrival": {
            "process": str(process),
            "rate_rps": round(float(rate_rps), 6),
            "seed": int(seed),
            "speedup_k": round(float(speedup_k), 6),
            "clients": int(clients),
        },
        "offered_rps": round(
            offered / result.send_span_s, 6
        ) if result.send_span_s > 0 else round(float(rate_rps), 6),
        "duration_s": round(result.duration_s, 6),
        "requests": {
            "offered": offered,
            "done": counts["done"],
            "rejected": counts["rejected"],
            "failed": counts["failed"],
            "missing": counts["missing"],
            "reset": counts["reset"],
        },
        "goodput_rps": goodput,
        "latency_s": _pctls(result.latencies_s()),
        "queue_wait_s": _report_pctls(server_report, "queue_wait_s"),
        "shed_rate": round(
            (counts["rejected"] + counts["failed"]) / offered, 6
        ),
        "deadline_miss_rate": round(deadline_failed / offered, 6),
        "batch_fill_ratio": float(gauges.get("batch_fill_ratio", 0.0)),
        "shed_transitions": int(counters.get("serve_shed_transitions", 0)),
        "breaker": {
            "opens": int(counters.get("breaker_opens", 0)),
            "half_opens": int(counters.get("breaker_half_opens", 0)),
            "closes": int(counters.get("breaker_closes", 0)),
        },
        "fleet": {
            "redispatches": int(counters.get("fleet_redispatches", 0)),
            "deaths": int(counters.get("fleet_deaths", 0)),
        },
    }
    if plateau_rps is not None and plateau_rps > 0:
        body["plateau_rps"] = round(float(plateau_rps), 6)
        body["goodput_retention"] = round(goodput / float(plateau_rps), 6)
    return wrap_report("bench", body, meta=meta)
