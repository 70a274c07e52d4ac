"""Process-wide metrics: counters, gauges, histograms, run reports (the
port of ``mpi_openmp_cuda_tpu/obs/metrics.py``, pure Python, copied
whole so one schema reads the records of both packages).

:class:`MetricsRegistry` is the run's single numeric sink.  It takes an
injectable monotonic clock, so tests use a fake clock and stay
byte-deterministic, and every wall-clock read of the obs plane lives in
this file and :mod:`.spans`, never in ``resilience/`` or
``utils/journal.py`` (those modules hand over events, not times).
:meth:`MetricsRegistry.record_event` keeps the JAX package's whole event
catalogue, the serve and fleet events included.

Two export formats share one serializer:

* the versioned JSON run report (``--metrics-out``), shape
  ``{"schema": ..., "schema_version": N, "kind": ..., ...}`` — the same
  envelope the bench wraps its record in, so bench records and run
  reports validate against the one :func:`validate_report`;
* a Prometheus text-format sidecar (``<out>.prom``), counters as
  ``seqalign_<name>_total``, histograms as summaries.

The module hooks (:func:`inc` / :func:`gauge` / :func:`observe`) are a
single attribute check when no registry is armed.
"""

from __future__ import annotations

import collections
import math
import time

#: The one report envelope (run reports AND bench blobs).
RUN_REPORT_SCHEMA = "mpi_openmp_cuda_tpu.run-report"
RUN_REPORT_VERSION = 1

# The event -> counter mapping.  Events not listed here carry their own
# handling in record_event.
_EVENT_COUNTERS = {
    "retry.attempt": "retry_attempts",
    "degrade.transition": "degrade_transitions",
    "watchdog.expiry": "deadline_expiries",
    "drain.request": "drain_requests",
    "fault.injected": "faults_injected",
    "recompile": "recompiles",
    "log": "log_lines",
}


def percentile(values, q: float) -> float:
    """Nearest-rank percentile over any sized collection (0.0 when
    empty).  THE one percentile in the package: the SLO shed machine's
    internal p90 (``serve/slo.py``) and every histogram's p50/p90/p99
    summary field are this exact function, so report numbers and
    shedding decisions can never disagree on rank arithmetic."""
    if not values:
        return 0.0
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(q * len(ordered)))]


#: Explicit bucket boundaries (seconds) for the latency-shaped
#: histograms.  A histogram created with bounds additionally maintains
#: cumulative ``buckets`` counts and p50/p90/p99 summary fields — the
#: run-report envelope and the Prometheus rendering both follow.
HISTOGRAM_BUCKETS: dict[str, tuple[float, ...]] = {
    "queue_wait_s": (0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0, 60.0),
    "request_latency_s": (0.005, 0.02, 0.1, 0.5, 2.0, 10.0, 60.0, 300.0),
    "backoff_delay_s": (0.01, 0.05, 0.25, 1.0, 5.0, 30.0),
}

#: Recent-observation window the percentile summary fields are computed
#: over (bounded: a serve process observes forever).
_SAMPLE_WINDOW = 512


def _bucket_label(bound: float) -> str:
    return f"{bound:g}"


class Histogram(dict):
    """One count/sum/min/max summary, generalised out of the registry so
    any caller (serve latency, backoff delays) shares the exact shape
    :func:`validate_report` checks.  Subclassing ``dict`` keeps snapshots
    and report serialisation plain-JSON for free.

    With explicit ``bounds`` the histogram additionally keeps cumulative
    per-bucket counts (Prometheus ``le`` semantics, ``+Inf`` included)
    and p50/p90/p99 fields over a bounded window of recent observations.
    """

    __slots__ = ("_bounds", "_samples")

    def __init__(self, bounds=None):
        super().__init__()
        self._bounds = tuple(float(b) for b in bounds) if bounds else ()
        self._samples = (
            collections.deque(maxlen=_SAMPLE_WINDOW) if self._bounds else None
        )

    def observe(self, value: float) -> None:
        if not self:
            self["count"] = 1
            self["sum"] = value
            self["min"] = value
            self["max"] = value
        else:
            self["count"] += 1
            self["sum"] += value
            self["min"] = min(self["min"], value)
            self["max"] = max(self["max"], value)
        if self._bounds:
            buckets = self.get("buckets")
            if buckets is None:
                buckets = self["buckets"] = {
                    _bucket_label(b): 0 for b in self._bounds
                }
                buckets["+Inf"] = 0
            for b in self._bounds:
                if value <= b:
                    buckets[_bucket_label(b)] += 1
            buckets["+Inf"] += 1
            self._samples.append(value)
            self["p50"] = percentile(self._samples, 0.50)
            self["p90"] = percentile(self._samples, 0.90)
            self["p99"] = percentile(self._samples, 0.99)

    def snapshot(self) -> dict:
        """A detached plain-dict copy (nested buckets included) — live
        telemetry scrapes must not alias the mutating registry."""
        out = dict(self)
        if "buckets" in out:
            out["buckets"] = dict(out["buckets"])
        return out


class MetricsRegistry:
    """One run's counters/gauges/histograms behind an injectable clock.

    ``clock`` must be monotonic (``time.monotonic`` by default); tests
    pass a fake.  All mutation is plain dict arithmetic under the GIL —
    the only off-thread writer is the watchdog monitor's expiry event,
    for which per-key increments are atomic enough.
    """

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._start = clock()
        self.counters: dict[str, int | float] = {}
        self.gauges: dict[str, int | float | str] = {}
        self.histograms: dict[str, Histogram] = {}
        # Per-host snapshots gathered by the coordinator under
        # --distributed (obs/export.py): process id -> snapshot dict.
        self.fleet: dict[str, dict] = {}

    def inc(self, name: str, n: int | float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value) -> None:
        self.gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(
                HISTOGRAM_BUCKETS.get(name)
            )
        h.observe(value)

    def uptime_s(self) -> float:
        return self._clock() - self._start

    # -- the bus subscriber ------------------------------------------------
    def record_event(self, event: str, fields: dict) -> None:
        """Turn one bus event into counters (subscribed by the CLI)."""
        name = _EVENT_COUNTERS.get(event)
        if name is not None:
            self.inc(name)
            return
        if event == "retry.backoff":
            self.inc("backoff_waits")
            self.observe("backoff_delay_s", float(fields["delay"]))
        elif event == "watchdog.guard":
            self.inc(
                "guard_arms"
                if fields.get("state") == "armed"
                else "guard_disarms"
            )
        elif event == "rescue.beacon_miss":
            self.inc("beacon_misses")
        elif event == "rescue.orphans":
            self.inc("rescued_sequences", int(fields.get("count", 0)))
        elif event == "serve.request.admitted":
            self.inc("serve_requests")
            self.gauge("queue_depth", int(fields.get("depth", 0)))
        elif event == "serve.request.rejected":
            self.inc("serve_rejections")
        elif event == "serve.request.done":
            self.inc("serve_completed")
            self.observe(
                "request_latency_s", float(fields.get("latency_s", 0.0))
            )
        elif event == "serve.batch.dispatch":
            self.inc("serve_batches")
            if "rows" in fields:
                # Real rows beside the block count: any window's mean
                # fill is Δserve_block_rows / Δserve_batches.
                self.inc("serve_block_rows", int(fields["rows"]))
            self.gauge("batch_fill_ratio", float(fields.get("fill", 0.0)))
            self.gauge("queue_depth", int(fields.get("depth", 0)))
        elif event == "serve.request.failed":
            # Deadline misses get their own SLO counter; every other
            # typed failure (poison isolation, ...) shares one.
            if fields.get("error") == "deadline":
                self.inc("serve_deadline_rejections")
            else:
                self.inc("serve_failures")
        elif event == "serve.request.shed":
            self.inc("serve_shed")
        elif event == "serve.shed.state":
            self.inc("serve_shed_transitions")
            self.gauge("shed_state", str(fields.get("state", "")))
        elif event == "serve.queue.wait":
            self.observe("queue_wait_s", float(fields.get("wait_s", 0.0)))
        elif event == "serve.request.abandoned":
            self.inc("serve_abandoned")
        elif event == "serve.request.poisoned":
            self.inc("serve_poisoned")
        elif event == "serve.block.failed":
            self.inc("serve_block_failures")
        elif event == "serve.client.lost":
            self.inc("serve_clients_lost")
        elif event == "worker.join":
            self.inc("fleet_joins")
            self.gauge("fleet_workers", int(fields.get("workers", 0)))
        elif event == "worker.dead":
            self.inc("fleet_deaths")
            self.gauge("fleet_workers", int(fields.get("workers", 0)))
        elif event == "lease.expired":
            self.inc("fleet_lease_expiries")
        elif event == "lease.fenced":
            self.inc("fleet_fenced_posts")
        elif event == "fleet.redispatch":
            self.inc("fleet_redispatches")
        elif event == "fleet.deadletter":
            self.inc("fleet_deadletter")
        elif event == "leader.elected":
            self.inc("fleet_elections")
            self.gauge("fleet_leader_epoch", int(fields.get("gen", 0)))
        elif event == "leader.takeover":
            self.inc("fleet_takeovers")
            self.gauge("fleet_leader_epoch", int(fields.get("gen", 0)))
        elif event == "leader.fenced":
            self.inc("fleet_leader_fenced")
        elif event == "leader.deposed":
            self.inc("fleet_depositions")
        elif event == "board.gc":
            self.inc("fleet_gc_swept", int(fields.get("count", 0)))
        elif event == "fleet.score.start":
            self.inc("fleet_scores_started")
        elif event == "fleet.score.failed":
            self.inc("fleet_score_failures")
        elif event == "fleet.tape.collected":
            self.inc("fleet_tapes_collected")
        elif event == "serve.request.duplicate":
            self.inc("serve_duplicates")
        elif event.startswith("breaker."):
            # breaker.open / breaker.half_open / breaker.close -> one
            # counter each, plus the current-state gauge the chaos tier
            # reads back out of the run report.
            what = event.partition(".")[2]
            self.inc(f"breaker_{what}s")
            self.gauge(
                "breaker_state", "closed" if what == "close" else what
            )
        else:
            # Forward-compatible: an unmapped event still leaves a trace.
            self.inc(f"events.{event}")

    # -- snapshots ---------------------------------------------------------
    def record_fleet(self, host, snapshot: dict) -> None:
        self.fleet[str(host)] = snapshot

    def snapshot(self) -> dict:
        """A JSON-ready copy of the registry (no fleet: snapshots are
        what the fleet section is MADE of)."""
        return {
            "uptime_s": round(self.uptime_s(), 6),
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {
                k: v.snapshot() if isinstance(v, Histogram) else dict(v)
                for k, v in self.histograms.items()
            },
        }


# The armed registry (same lifecycle as the fault registry).
_active: MetricsRegistry | None = None


def activate_metrics(clock=None) -> MetricsRegistry:
    """Arm a fresh registry for one run; returns it for inspection."""
    global _active
    _active = MetricsRegistry(clock if clock is not None else time.monotonic)
    return _active


def deactivate_metrics() -> None:
    global _active
    _active = None


def active_metrics() -> MetricsRegistry | None:
    return _active


def inc(name: str, n: int | float = 1) -> None:
    """Instrumentation hook: count on the armed registry, else no-op."""
    if _active is not None:
        _active.inc(name, n)


def gauge(name: str, value) -> None:
    if _active is not None:
        _active.gauge(name, value)


def observe(name: str, value: float) -> None:
    if _active is not None:
        _active.observe(name, value)


def drain_snapshot() -> dict | None:
    """The extra payload the journal's ``{"event": "drain"}`` record
    carries when metrics are armed (None otherwise) — the journal itself
    never reads a clock; the uptime inside comes from here."""
    if _active is None:
        return None
    return {"metrics": _active.snapshot()}


# -- the shared report serializer ------------------------------------------


def wrap_report(kind: str, body: dict, *, meta: dict | None = None) -> dict:
    """The one report envelope: ``bench.py`` wraps its blob with
    ``kind="bench"``, the CLI's run report uses ``kind="run"``, and the
    static schedule auditor emits ``kind="schedule-audit"`` — all
    validate against :func:`validate_report`."""
    rec: dict = {
        "schema": RUN_REPORT_SCHEMA,
        "schema_version": RUN_REPORT_VERSION,
        "kind": kind,
    }
    if meta:
        rec["meta"] = dict(meta)
    rec.update(body)
    return rec


def run_report(
    registry: MetricsRegistry,
    *,
    spans=None,
    exit_code: int | None = None,
    meta: dict | None = None,
    extra: dict | None = None,
) -> dict:
    """The ``--metrics-out`` JSON document for one finished run.
    ``extra`` merges additional top-level sections (the trace plane's
    ``gap_attribution``) into the body."""
    body = registry.snapshot()
    if extra:
        body.update(extra)
    if spans is not None:
        body["spans"] = {
            "phases": [[name, round(dur, 6)] for name, dur in spans.phases()],
            "totals": {
                path: round(total, 6)
                for path, total in sorted(spans.totals().items())
            },
        }
    if exit_code is not None:
        body["exit_code"] = int(exit_code)
    if registry.fleet:
        body["hosts"] = dict(registry.fleet)
    return wrap_report("run", body, meta=meta)


_HISTOGRAM_REQUIRED = ("count", "sum", "min", "max")
_HISTOGRAM_OPTIONAL = ("buckets", "p50", "p90", "p99")


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _is_finite_num(v) -> bool:
    return _is_num(v) and math.isfinite(v)


def _histogram_problems(name: str, h) -> list[str]:
    if (
        not isinstance(h, dict)
        or not set(_HISTOGRAM_REQUIRED) <= set(h)
        or not set(h) <= set(_HISTOGRAM_REQUIRED + _HISTOGRAM_OPTIONAL)
    ):
        return [
            f"histograms[{name!r}]: want count/sum/min/max "
            f"(+ optional buckets/p50/p90/p99), got {h!r}"
        ]
    out = []
    for k in ("count", "sum", "min", "max", "p50", "p90", "p99"):
        if k in h and not _is_num(h[k]):
            out.append(
                f"histograms[{name!r}].{k}: want a number, got {h[k]!r}"
            )
    buckets = h.get("buckets")
    if buckets is not None and (
        not isinstance(buckets, dict)
        or "+Inf" not in buckets
        or not all(isinstance(n, int) for n in buckets.values())
    ):
        out.append(
            f"histograms[{name!r}].buckets: want cumulative int counts "
            f"ending in +Inf, got {buckets!r}"
        )
    return out


def validate_report(rec) -> None:
    """Schema gate for any wrapped report (every kind the JAX package
    writes); raises one ValueError naming every problem."""
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
    if kind == "run":
        for section in ("counters", "gauges", "histograms"):
            if not isinstance(rec.get(section), dict):
                problems.append(f"{section}: want an object, got {rec.get(section)!r}")
        for name, v in (rec.get("counters") or {}).items():
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                problems.append(f"counters[{name!r}]: want a number, got {v!r}")
        for name, h in (rec.get("histograms") or {}).items():
            problems.extend(_histogram_problems(name, h))
        if not isinstance(rec.get("uptime_s"), (int, float)):
            problems.append(f"uptime_s: want a number, got {rec.get('uptime_s')!r}")
        if "exit_code" in rec and not isinstance(rec["exit_code"], int):
            problems.append(f"exit_code: want an int, got {rec['exit_code']!r}")
        spans = rec.get("spans")
        if spans is not None:
            if not isinstance(spans, dict) or not isinstance(
                spans.get("phases"), list
            ) or not isinstance(spans.get("totals"), dict):
                problems.append(f"spans: want {{phases: [], totals: {{}}}}, got {spans!r}")
    elif kind == "bench":
        if "metric" not in rec or "value" not in rec:
            problems.append("bench report: want metric and value fields")
        if rec.get("formulation") == "serve-load":
            # The load harness's official record (load/report.py):
            # goodput + the SLO surface are schema, not convention.
            for field in ("goodput_rps", "offered_rps", "duration_s"):
                if not _is_finite_num(rec.get(field)):
                    problems.append(
                        f"serve-load report: {field}: want a finite "
                        f"number, got {rec.get(field)!r}"
                    )
            reqs = rec.get("requests")
            req_fields = (
                "offered", "done", "rejected", "failed", "missing",
                "reset",
            )
            if not isinstance(reqs, dict) or not all(
                isinstance(reqs.get(k), int) for k in req_fields
            ):
                problems.append(
                    f"serve-load report: requests: want int "
                    f"{'/'.join(req_fields)}, got {reqs!r}"
                )
            for section in ("latency_s", "queue_wait_s"):
                pct = rec.get(section)
                if not isinstance(pct, dict) or not all(
                    _is_finite_num(pct.get(k))
                    for k in ("p50", "p90", "p99")
                ):
                    problems.append(
                        f"serve-load report: {section}: want p50/p90/"
                        f"p99 numbers, got {pct!r}"
                    )
            for field in ("shed_rate", "deadline_miss_rate"):
                v = rec.get(field)
                if not _is_finite_num(v) or not 0.0 <= float(v) <= 1.0:
                    problems.append(
                        f"serve-load report: {field}: want a rate in "
                        f"[0, 1], got {v!r}"
                    )
            arr = rec.get("arrival")
            if not isinstance(arr, dict) or not isinstance(
                arr.get("process"), str
            ) or not _is_finite_num(arr.get("rate_rps")):
                problems.append(
                    f"serve-load report: arrival: want an object with "
                    f"process + rate_rps, got {arr!r}"
                )
    elif kind == "schedule-audit":
        # scripts/schedule_audit.py's cost-sheet + trace-audit report.
        sheet = rec.get("cost_sheet")
        if not isinstance(sheet, dict):
            problems.append(
                f"cost_sheet: want an object, got {sheet!r}"
            )
        else:
            if not isinstance(sheet.get("buckets"), list):
                problems.append("cost_sheet.buckets: want a list")
            totals = sheet.get("totals")
            if totals is not None and (
                not isinstance(totals, dict)
                or not isinstance(totals.get("launches"), int)
                or not isinstance(totals.get("executables"), int)
            ):
                problems.append(
                    "cost_sheet.totals: want launches/executables ints, "
                    f"got {totals!r}"
                )
            pred = sheet.get("predicted_mfu_vs_feed_roofline")
            if pred is not None and not isinstance(pred, (int, float)):
                problems.append(
                    "cost_sheet.predicted_mfu_vs_feed_roofline: want a "
                    f"number or null, got {pred!r}"
                )
        audit = rec.get("trace_audit")
        if not isinstance(audit, dict):
            problems.append(f"trace_audit: want an object, got {audit!r}")
        else:
            if not isinstance(audit.get("buckets"), list):
                problems.append("trace_audit.buckets: want a list")
            don = audit.get("donation")
            if (
                not isinstance(don, dict)
                or "undonated_large_buffers" not in don
                or not isinstance(don.get("pinned_live"), list)
            ):
                problems.append(
                    "trace_audit.donation: want an object with "
                    "undonated_large_buffers and a pinned_live list, "
                    f"got {don!r}"
                )
        if not isinstance(rec.get("entry_points"), list):
            problems.append(
                f"entry_points: want a list, got {rec.get('entry_points')!r}"
            )
    elif kind == "trace":
        # obs/trace.py's Chrome-trace/Perfetto export + gap attribution.
        tev = rec.get("traceEvents")
        if not isinstance(tev, list):
            problems.append(f"traceEvents: want a list, got {tev!r}")
        else:
            for i, ev in enumerate(tev):
                if not isinstance(ev, dict) or "ph" not in ev or "name" not in ev:
                    problems.append(
                        f"traceEvents[{i}]: want objects with ph/name, got {ev!r}"
                    )
                    break
        gap = rec.get("gap_attribution")
        if not isinstance(gap, dict) or not isinstance(
            gap.get("launches"), list
        ):
            problems.append(
                f"gap_attribution: want an object with a launches list, got {gap!r}"
            )
        else:
            for i, row in enumerate(gap["launches"]):
                if (
                    not isinstance(row, dict)
                    or not isinstance(row.get("request_ids"), list)
                    or not _is_finite_num(row.get("measured_s"))
                    or not _is_finite_num(row.get("modelled_s"))
                    or not _is_finite_num(row.get("gap_s"))
                ):
                    problems.append(
                        f"gap_attribution.launches[{i}]: want request_ids "
                        f"plus finite measured_s/modelled_s/gap_s, got {row!r}"
                    )
            for k in ("total_measured_s", "total_modelled_s", "total_gap_s"):
                if not _is_finite_num(gap.get(k)):
                    problems.append(
                        f"gap_attribution.{k}: want a finite number, "
                        f"got {gap.get(k)!r}"
                    )
    elif kind == "flightrec":
        # obs/flightrec.py's incident dump.
        if not isinstance(rec.get("reason"), str) or not rec.get("reason"):
            problems.append(
                f"reason: want a nonempty string, got {rec.get('reason')!r}"
            )
        if not isinstance(rec.get("depth"), int):
            problems.append(f"depth: want an int, got {rec.get('depth')!r}")
        evs = rec.get("events")
        if not isinstance(evs, list):
            problems.append(f"events: want a list, got {evs!r}")
        else:
            for i, e in enumerate(evs):
                if (
                    not isinstance(e, dict)
                    or e.get("kind") not in ("event", "span")
                    or "name" not in e
                ):
                    problems.append(
                        f"events[{i}]: want event/span entries with a name, "
                        f"got {e!r}"
                    )
                    break
    elif kind == "concurrency-audit":
        # scripts/concurrency_audit.py's lock-graph + interleave report.
        lg = rec.get("lockgraph")
        if not isinstance(lg, dict):
            problems.append(f"lockgraph: want an object, got {lg!r}")
        else:
            if not isinstance(lg.get("locks"), list):
                problems.append("lockgraph.locks: want a list of lock ids")
            if not isinstance(lg.get("edges"), list):
                problems.append("lockgraph.edges: want a list")
            if not isinstance(lg.get("findings"), list):
                problems.append("lockgraph.findings: want a list")
            counts = lg.get("counts")
            if not isinstance(counts, dict) or not all(
                isinstance(counts.get(k), int)
                for k in ("locks", "edges", "findings")
            ):
                problems.append(
                    "lockgraph.counts: want locks/edges/findings ints, "
                    f"got {counts!r}"
                )
        il = rec.get("interleave")
        if not isinstance(il, dict):
            problems.append(f"interleave: want an object, got {il!r}")
        else:
            rows = il.get("scenarios")
            if not isinstance(rows, list):
                problems.append(f"interleave.scenarios: want a list, got {rows!r}")
            else:
                for i, row in enumerate(rows):
                    if (
                        not isinstance(row, dict)
                        or not isinstance(row.get("name"), str)
                        or not isinstance(row.get("schedules"), int)
                        or not isinstance(row.get("violations"), list)
                    ):
                        problems.append(
                            f"interleave.scenarios[{i}]: want name plus "
                            f"schedules int plus violations list, got {row!r}"
                        )
            if not isinstance(il.get("total_schedules"), int):
                problems.append(
                    "interleave.total_schedules: want an int, got "
                    f"{il.get('total_schedules')!r}"
                )
    elif kind == "donation-audit":
        # scripts/donation_audit.py's donation-safety dataflow report.
        plan = rec.get("plan")
        if not isinstance(plan, dict) or not isinstance(
            plan.get("entries"), list
        ):
            problems.append(
                f"plan: want an object with an entries list, got {plan!r}"
            )
        else:
            for i, e in enumerate(plan["entries"]):
                if (
                    not isinstance(e, dict)
                    or not isinstance(e.get("wrapper"), str)
                    or not isinstance(e.get("donate"), list)
                    or not isinstance(e.get("pinned"), list)
                ):
                    problems.append(
                        f"plan.entries[{i}]: want wrapper str plus "
                        f"donate/pinned lists, got {e!r}"
                    )
        if not isinstance(rec.get("findings"), list):
            problems.append(
                f"findings: want a list, got {rec.get('findings')!r}"
            )
        if not isinstance(rec.get("restage_paths"), list):
            problems.append(
                "restage_paths: want a list, got "
                f"{rec.get('restage_paths')!r}"
            )
        audit = rec.get("trace_audit")
        if not isinstance(audit, dict):
            problems.append(f"trace_audit: want an object, got {audit!r}")
        else:
            don = audit.get("donation")
            if (
                not isinstance(don, dict)
                or "undonated_large_buffers" not in don
                or not isinstance(don.get("pinned_live"), list)
            ):
                problems.append(
                    "trace_audit.donation: want an object with "
                    "undonated_large_buffers and a pinned_live list, "
                    f"got {don!r}"
                )
    elif kind == "ranges-audit":
        # scripts/ranges_audit.py's value-range certification report.
        consts = rec.get("derived_constants")
        if not isinstance(consts, list) or not consts:
            problems.append(
                f"derived_constants: want a non-empty list, got {consts!r}"
            )
        else:
            for i, c in enumerate(consts):
                if (
                    not isinstance(c, dict)
                    or not isinstance(c.get("name"), str)
                    or not isinstance(c.get("relation"), str)
                    or not isinstance(c.get("ok"), bool)
                ):
                    problems.append(
                        f"derived_constants[{i}]: want name/relation strs "
                        f"plus an ok bool, got {c!r}"
                    )
        entries = rec.get("entries")
        if not isinstance(entries, list) or not entries:
            problems.append(
                f"entries: want a non-empty list, got {entries!r}"
            )
        else:
            for i, e in enumerate(entries):
                if (
                    not isinstance(e, dict)
                    or not isinstance(e.get("entry"), str)
                    or e.get("verdict")
                    not in ("exact", "representable", "unproven")
                    or not isinstance(e.get("findings"), list)
                ):
                    problems.append(
                        f"entries[{i}]: want entry str, verdict in "
                        "exact/representable/unproven, a findings list, "
                        f"got {e!r}"
                    )
        if not isinstance(rec.get("production"), list):
            problems.append(
                f"production: want a list, got {rec.get('production')!r}"
            )
        signed = rec.get("signed_weights")
        if (
            not isinstance(signed, dict)
            or not isinstance(signed.get("entries"), list)
            or not isinstance(signed.get("paths"), list)
        ):
            problems.append(
                "signed_weights: want an object with entries/paths "
                f"lists, got {signed!r}"
            )
        if not isinstance(rec.get("findings"), list):
            problems.append(
                f"findings: want a list, got {rec.get('findings')!r}"
            )
        counts = rec.get("counts")
        if not isinstance(counts, dict) or not all(
            isinstance(counts.get(k), int)
            for k in (
                "constants",
                "constants_ok",
                "entries",
                "entries_exact",
                "production_buckets",
                "signed_survivors",
                "findings",
            )
        ):
            problems.append(
                "counts: want constants/constants_ok/entries/"
                "entries_exact/production_buckets/signed_survivors/"
                f"findings ints, got {counts!r}"
            )
    elif kind == "bounds-cert":
        # scripts/torch_ranges_audit.py's constant certification
        # (analysis/ranges.py, the port's bounds-only certifier).
        consts = rec.get("derived_constants")
        if not isinstance(consts, list) or not consts or not all(
            isinstance(c, dict) and isinstance(c.get("name"), str)
            and isinstance(c.get("ok"), bool) and "derived" in c and "wired" in c
            for c in consts
        ):
            problems.append(
                "derived_constants: want a non-empty list of name/derived/"
                f"wired/ok rows, got {consts!r}"
            )
        if not isinstance(rec.get("findings"), list):
            problems.append(f"findings: want a list, got {rec.get('findings')!r}")
        counts = rec.get("counts")
        if not isinstance(counts, dict) or not all(
            isinstance(counts.get(k), int)
            for k in ("constants", "constants_ok", "findings")
        ):
            problems.append(
                f"counts: want constants/constants_ok/findings ints, got {counts!r}"
            )
    elif kind == "exitpath-audit":
        # scripts/exitpath_audit.py's exception-flow certification
        # report (analysis/exitflow.py).
        sinks = rec.get("sinks")
        if not isinstance(sinks, dict) or not all(
            isinstance(k, str) and isinstance(v, int)
            for k, v in (sinks or {}).items()
        ):
            problems.append(
                f"sinks: want a str->int sink inventory, got {sinks!r}"
            )
        modules = rec.get("raise_modules")
        if not isinstance(modules, dict) or not all(
            isinstance(k, str) and isinstance(v, int)
            for k, v in (modules or {}).items()
        ):
            problems.append(
                "raise_modules: want a str->int per-module raise map, "
                f"got {modules!r}"
            )
        advisory = rec.get("advisory")
        if not isinstance(advisory, list) or not all(
            isinstance(a, str) for a in advisory or []
        ):
            problems.append(
                f"advisory: want a list of marker strs, got {advisory!r}"
            )
        flush = rec.get("flush")
        if not isinstance(flush, dict):
            problems.append(f"flush: want an object, got {flush!r}")
        else:
            for mod, f in flush.items():
                if (
                    not isinstance(f, dict)
                    or not isinstance(f.get("function"), str)
                    or not isinstance(f.get("flush_try"), list)
                    or not isinstance(f.get("flush_calls"), list)
                    or not isinstance(f.get("protected_returns"), int)
                ):
                    problems.append(
                        f"flush[{mod}]: want function str, flush_try/"
                        "flush_calls lists, protected_returns int, "
                        f"got {f!r}"
                    )
        faults = rec.get("fault_sites")
        if not isinstance(faults, dict) or not all(
            isinstance(faults.get(k), int)
            for k in faults or {}
        ):
            problems.append(
                f"fault_sites: want a str->int summary, got {faults!r}"
            )
        if not isinstance(rec.get("findings"), list):
            problems.append(
                f"findings: want a list, got {rec.get('findings')!r}"
            )
        counts = rec.get("counts")
        if not isinstance(counts, dict) or not all(
            isinstance(counts.get(k), int)
            for k in (
                "raise_sites",
                "production_raises",
                "production_functions",
                "broad_handlers",
                "wire_reply_handlers",
                "advisory_markers",
                "findings",
            )
        ):
            problems.append(
                "counts: want raise_sites/production_raises/"
                "production_functions/broad_handlers/wire_reply_handlers/"
                f"advisory_markers/findings ints, got {counts!r}"
            )
    elif kind == "comms-audit":
        # scripts/comms_audit.py's collective-safety & comms-cost report.
        entries = rec.get("entries")
        if not isinstance(entries, list) or not entries:
            problems.append(
                f"entries: want a non-empty list, got {entries!r}"
            )
        else:
            for i, e in enumerate(entries):
                if (
                    not isinstance(e, dict)
                    or not isinstance(e.get("spec"), str)
                    or not isinstance(e.get("collectives"), list)
                    or not isinstance(e.get("signature"), str)
                    or not isinstance(e.get("consistent"), bool)
                    or not isinstance(e.get("positions"), int)
                ):
                    problems.append(
                        f"entries[{i}]: want spec/signature strs, a "
                        "collectives list, consistent bool, positions "
                        f"int, got {e!r}"
                    )
        if not isinstance(rec.get("findings"), list):
            problems.append(
                f"findings: want a list, got {rec.get('findings')!r}"
            )
        counts = rec.get("counts")
        if not isinstance(counts, dict) or not all(
            isinstance(counts.get(k), int)
            for k in ("entries", "collectives", "payload_bytes", "findings")
        ):
            problems.append(
                "counts: want entries/collectives/payload_bytes/findings "
                f"ints, got {counts!r}"
            )
        comms = rec.get("comms")
        if not isinstance(comms, dict) or not isinstance(
            comms.get("scaling"), list
        ):
            problems.append(
                f"comms: want an object with a scaling list, got {comms!r}"
            )
        else:
            for i, row in enumerate(comms["scaling"]):
                if (
                    not isinstance(row, dict)
                    or not isinstance(row.get("mesh"), int)
                    or not isinstance(row.get("axis"), str)
                    or not _is_finite_num(row.get("comms_wall_us"))
                    or not _is_finite_num(row.get("predicted_wall_us"))
                    or not _is_finite_num(
                        row.get("predicted_scaling_efficiency")
                    )
                ):
                    problems.append(
                        f"comms.scaling[{i}]: want mesh int, axis str, "
                        "finite comms_wall_us/predicted_wall_us/"
                        f"predicted_scaling_efficiency, got {row!r}"
                    )
    elif kind == "aot-manifest":
        # aot/manifest.py's warm-set manifest.
        fp = rec.get("fingerprint")
        if not isinstance(fp, dict) or not isinstance(fp.get("digest"), str):
            problems.append(
                f"fingerprint: want an object with a digest string, got {fp!r}"
            )
        entries = rec.get("entries")
        if not isinstance(entries, list):
            problems.append(f"entries: want a list, got {entries!r}")
        else:
            for i, e in enumerate(entries):
                if not isinstance(e, dict):
                    problems.append(f"entries[{i}]: want an object, got {e!r}")
                    continue
                if not isinstance(e.get("cache_key"), list):
                    problems.append(f"entries[{i}].cache_key: want a list")
                if not isinstance(e.get("fingerprint"), str):
                    problems.append(f"entries[{i}].fingerprint: want a string")
                if not isinstance(e.get("compile_wall_s"), (int, float)):
                    problems.append(
                        f"entries[{i}].compile_wall_s: want a number"
                    )
        if not isinstance(rec.get("stale"), list):
            problems.append(f"stale: want a list, got {rec.get('stale')!r}")
        totals = rec.get("totals")
        if not isinstance(totals, dict) or not isinstance(
            totals.get("entries"), int
        ):
            problems.append(
                f"totals: want an object with an int entry count, got {totals!r}"
            )
    if problems:
        raise ValueError(
            "invalid run report: " + "; ".join(problems)
        )


def _fmt_num(v) -> str:
    return repr(v) if isinstance(v, float) else str(v)


#: HELP text for the metrics worth explaining; everything else gets a
#: mechanical fallback so every family still carries a HELP line.
_METRIC_HELP = {
    "queue_wait_s": "Seconds a request waited in the admission queue",
    "request_latency_s": "Admission-to-done latency of one served request",
    "backoff_delay_s": "Scheduled retry backoff delay",
    "queue_depth": "Requests currently queued for batching",
    "shed_state": "Admission shed state (accept/shed-new/drain-only)",
    "breaker_state": "Circuit breaker state (closed/open/half_open)",
    "batch_fill_ratio": "Real-row fraction of the last dispatched superblock",
    "serve_block_rows": "Real rows of every dispatched superblock",
    "uptime_seconds": "Seconds since the metrics registry was armed",
}


def _help_line(m: str, name: str, fallback: str) -> str:
    return f"# HELP {m} {_METRIC_HELP.get(name, fallback)}"


def to_prometheus(snapshot: dict, *, prefix: str = "seqalign") -> str:
    """Prometheus text exposition of one registry snapshot: counters as
    ``_total``, numeric gauges verbatim, string gauges as ``_info``
    labels, bucketed histograms as native ``histogram`` families
    (cumulative ``le`` buckets), summary-only histograms as summaries;
    min/max/percentile fields ride as gauges.  Every family carries
    HELP and TYPE lines."""
    lines: list[str] = []
    for name in sorted(snapshot.get("counters", ())):
        m = f"{prefix}_{name.replace('.', '_')}_total"
        lines.append(_help_line(m, name, f"Total {name.replace('_', ' ')}"))
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {_fmt_num(snapshot['counters'][name])}")
    for name in sorted(snapshot.get("gauges", ())):
        v = snapshot["gauges"][name]
        m = f"{prefix}_{name.replace('.', '_')}"
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            lines.append(
                _help_line(m, name, f"Current {name.replace('_', ' ')}")
            )
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {_fmt_num(v)}")
        else:
            lines.append(
                _help_line(
                    f"{m}_info", name, f"Current {name.replace('_', ' ')}"
                )
            )
            lines.append(f"# TYPE {m}_info gauge")
            lines.append(f'{m}_info{{value="{v}"}} 1')
    for name in sorted(snapshot.get("histograms", ())):
        h = snapshot["histograms"][name]
        m = f"{prefix}_{name.replace('.', '_')}"
        buckets = h.get("buckets")
        lines.append(
            _help_line(m, name, f"Distribution of {name.replace('_', ' ')}")
        )
        if buckets:
            lines.append(f"# TYPE {m} histogram")
            for label, n in buckets.items():
                lines.append(f'{m}_bucket{{le="{label}"}} {_fmt_num(n)}')
        else:
            lines.append(f"# TYPE {m} summary")
        lines.append(f"{m}_count {_fmt_num(h['count'])}")
        lines.append(f"{m}_sum {_fmt_num(h['sum'])}")
        for field in ("min", "max", "p50", "p90", "p99"):
            if field in h:
                lines.append(f"# TYPE {m}_{field} gauge")
                lines.append(f"{m}_{field} {_fmt_num(h[field])}")
    up = snapshot.get("uptime_s")
    if up is not None:
        m = f"{prefix}_uptime_seconds"
        lines.append(_help_line(m, "uptime_seconds", "Uptime in seconds"))
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m} {_fmt_num(up)}")
    return "\n".join(lines) + "\n"


def fleet_to_prometheus(
    fleet: dict, *, prefix: str = "seqalign", skip_heads=()
) -> str:
    """Federated exposition of gathered per-worker registry snapshots
    (``registry.fleet``): the same families :func:`to_prometheus`
    renders for the local process, each sample labelled with its
    ``worker="wid"`` origin so one coordinator scrape covers the whole
    fleet.  HELP/TYPE lines are emitted once per family (Prometheus
    rejects duplicates) and suppressed for families in ``skip_heads``
    (the ones the local exposition already declared), samples once per
    worker.  Histograms federate as their count/sum plus
    min/max/percentile gauges — per-worker cumulative buckets would
    multiply the payload for little signal."""
    lines: list[str] = []
    seen: set[str] = set(skip_heads)

    def _head(m: str, name: str, mtype: str, fallback: str) -> None:
        if m not in seen:
            seen.add(m)
            lines.append(_help_line(m, name, fallback))
            lines.append(f"# TYPE {m} {mtype}")

    for wid in sorted(fleet):
        snap = fleet[wid]
        if not isinstance(snap, dict):
            continue
        lab = f'worker="{wid}"'
        counters = snap.get("counters") or {}
        for name in sorted(counters):
            m = f"{prefix}_{name.replace('.', '_')}_total"
            _head(m, name, "counter", f"Total {name.replace('_', ' ')}")
            lines.append(f"{m}{{{lab}}} {_fmt_num(counters[name])}")
        gauges = snap.get("gauges") or {}
        for name in sorted(gauges):
            v = gauges[name]
            m = f"{prefix}_{name.replace('.', '_')}"
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                _head(m, name, "gauge", f"Current {name.replace('_', ' ')}")
                lines.append(f"{m}{{{lab}}} {_fmt_num(v)}")
            else:
                _head(
                    f"{m}_info", name, "gauge",
                    f"Current {name.replace('_', ' ')}",
                )
                lines.append(f'{m}_info{{{lab},value="{v}"}} 1')
        hists = snap.get("histograms") or {}
        for name in sorted(hists):
            h = hists[name]
            if not isinstance(h, dict) or "count" not in h:
                continue
            m = f"{prefix}_{name.replace('.', '_')}"
            _head(
                m, name, "summary",
                f"Distribution of {name.replace('_', ' ')}",
            )
            lines.append(f"{m}_count{{{lab}}} {_fmt_num(h['count'])}")
            lines.append(f"{m}_sum{{{lab}}} {_fmt_num(h.get('sum', 0))}")
            for field in ("min", "max", "p50", "p90", "p99"):
                if field in h:
                    mf = f"{m}_{field}"
                    _head(mf, name, "gauge", f"{field} of {name}")
                    lines.append(f"{mf}{{{lab}}} {_fmt_num(h[field])}")
        up = snap.get("uptime_s")
        if up is not None:
            m = f"{prefix}_uptime_seconds"
            _head(m, "uptime_seconds", "gauge", "Uptime in seconds")
            lines.append(f"{m}{{{lab}}} {_fmt_num(up)}")
    if not lines:
        return ""
    return "\n".join(lines) + "\n"
