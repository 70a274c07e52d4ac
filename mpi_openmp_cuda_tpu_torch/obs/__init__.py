"""Observability plane: metrics, spans, events, trace, flight recorder,
exports (the port of ``mpi_openmp_cuda_tpu/obs``).

The resilience stack publishes events onto :mod:`.events`,
:mod:`.metrics` folds them into counters, :mod:`.spans` times the run's
phases and per-dispatch work, :mod:`.trace` keeps the launch timeline,
:mod:`.flightrec` the last events before an incident, and :mod:`.export`
writes the run report, the Prometheus sidecar, the trace and the
heartbeat line.

Everything is disabled by default: until :func:`arm_observability` runs
(the CLI arms per run under ``--metrics``/``--metrics-out``/
``--heartbeat``/``--trace-out``), every hook in the package is a single
attribute check and allocates nothing.
"""

from __future__ import annotations

from . import (  # noqa: F401  (re-exports)
    events,
    export,
    flightrec,
    metrics,
    spans,
    trace,
)


def arm_observability(clock=None, span_clock=None, *, with_trace=False, flightrec_depth=0,
                      recorder=None):
    """Arm the plane for one run: a fresh registry subscribed to a fresh
    bus, plus the run's span recorder (``recorder``, the CLI's, adopted;
    a fresh one on ``span_clock`` when None); returns ``(registry,
    recorder)``.  ``with_trace`` also arms the trace recorder (bus +
    span-close subscriber, on the span recorder's clock and zero);
    ``flightrec_depth > 0`` arms the flight recorder's ring at that
    depth.  Kernel builds reach the registry as ``recompile`` events,
    which ``ops/_build.py`` publishes once per nvcc build."""
    registry = metrics.activate_metrics(clock)
    bus = events.activate_bus()
    bus.subscribe(registry.record_event)
    recorder = spans.activate_spans(span_clock, recorder=recorder)
    if with_trace:
        tracer = trace.activate_trace(spans=recorder)
        bus.subscribe(tracer.record_event)
        recorder.listeners.append(tracer.span_closed)
    if flightrec_depth and flightrec_depth > 0:
        frec = flightrec.activate_flightrec(flightrec_depth, clock)
        bus.subscribe(frec.record_event)
        recorder.listeners.append(frec.span_closed)
    return registry, recorder


def disarm_observability() -> None:
    """Tear the plane down (the CLI's finally; idempotent)."""
    flightrec.deactivate_flightrec()
    trace.deactivate_trace()
    spans.deactivate_spans()
    events.deactivate_bus()
    metrics.deactivate_metrics()
