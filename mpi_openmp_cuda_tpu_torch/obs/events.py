"""The run-scoped event bus and the one stderr diagnostic line (the port
of ``mpi_openmp_cuda_tpu/obs/events.py``).

Module-global, armed per run, and a single attribute check when off.
Publishers in this package (failure paths only, never per-element work):

=========================  ==============================================
``retry.attempt``          every caught transient failure (policy.py)
``retry.backoff``          each nonzero backoff sleep (``delay``)
``degrade.transition``     each fall down the backend chain (degrade.py)
``watchdog.expiry``        a guarded operation outlived the deadline
``watchdog.guard``         guard arm/disarm (``state``)
``drain.request``          the first drain signal of a run
``fault.injected``         each injected fault (faults.py)
``log``                    every :func:`log_line` diagnostic (``line``)
=========================  ==============================================

Subscribers are synchronous and must not raise.  The metrics registry
that subscribes in the JAX package arrives with the port's obs plane;
events are in addition to the stderr lines, never instead of them.
"""

from __future__ import annotations

import sys


class EventBus:
    """A synchronous fan-out of ``(event, fields)`` to subscribers."""

    __slots__ = ("_subscribers",)

    def __init__(self):
        self._subscribers: list = []

    def subscribe(self, fn) -> None:
        """Register ``fn(event: str, fields: dict)``."""
        self._subscribers.append(fn)

    def publish(self, event: str, fields: dict) -> None:
        for fn in self._subscribers:
            fn(event, fields)


_active: EventBus | None = None


def activate_bus() -> EventBus:
    """Arm a fresh bus for one run; returns it for subscriptions."""
    global _active
    _active = EventBus()
    return _active


def deactivate_bus() -> None:
    global _active
    _active = None


def publish(event: str, **fields) -> None:
    """Fan out to the armed bus, else no-op."""
    if _active is not None:
        _active.publish(event, fields)


def log_line(msg: str) -> None:
    """Print ``msg`` to stderr, mirroring it onto the armed bus first."""
    if _active is not None:
        _active.publish("log", {"line": msg})
    print(msg, file=sys.stderr)
