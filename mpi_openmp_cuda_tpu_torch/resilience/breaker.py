"""Circuit breaker over the backend degrade chain (the port of
``mpi_openmp_cuda_tpu/resilience/breaker.py``; serve-plane SLO armor).

The degrade chain reacts per chunk: every exhausted retry budget walks
``cuda -> mm -> gather`` and re-verifies the degraded backend against the
oracle before trusting it.  A server facing a systemic failure of the
primary backend (a wedged card, a bad build) would pay the whole
retry-then-degrade ladder on every superblock.  The breaker watches the
dispatch path's transient failures and, after ``threshold`` of them
inside a ``window_ticks`` window, OPENS: the degraded backend is pinned
(:meth:`~.degrade.BackendDegrader.pin`) and dispatch bypasses the primary
(``io/pipeline.py``); the degrader's ``verified`` flag is sticky, so the
oracle check is not repeated.  After ``cooldown_ticks`` the breaker goes
HALF-OPEN and lets one probe through on the restored primary: success
closes it, failure opens it for another cooldown.

Windows and cooldowns count serve-loop ticks, never wall clock: the same
failure sequence at the same ticks transitions identically on every run.

State machine::

    closed --(threshold transient failures in window)--> open
    open   --(cooldown_ticks elapsed)-----------------> half_open
    half_open --(probe succeeds)----------------------> closed
    half_open --(probe fails)-------------------------> open

Every transition publishes ``breaker.open`` / ``breaker.half_open`` /
``breaker.close`` (``obs/metrics.py`` folds them into the ``breaker_*``
counters and the ``breaker_state`` gauge) and logs one line on stderr.
"""

from __future__ import annotations

import collections

from ..obs.events import log_line, publish

STATE_CLOSED = "closed"
STATE_OPEN = "open"
STATE_HALF_OPEN = "half_open"

#: Transient dispatch failures inside the window that open the breaker.
DEFAULT_THRESHOLD = 3
#: Failure-memory horizon, in serve-loop ticks.
DEFAULT_WINDOW_TICKS = 16
#: Ticks an open breaker waits before probing half-open.
DEFAULT_COOLDOWN_TICKS = 8

_PROG = "mpi_openmp_cuda_tpu_torch"


class CircuitBreaker:
    """Tick-counted breaker pinning the degrade chain while open.

    Owned and ticked by the serve loop's main thread only, so it takes no
    lock: ``record_failure``/``record_success`` come from the dispatch
    path, which runs on that thread too.
    """

    def __init__(
        self,
        degrader,
        *,
        threshold: int = DEFAULT_THRESHOLD,
        window_ticks: int = DEFAULT_WINDOW_TICKS,
        cooldown_ticks: int = DEFAULT_COOLDOWN_TICKS,
        log=log_line,
    ):
        if threshold < 1:
            raise ValueError(f"breaker threshold must be >= 1, got {threshold}")
        if window_ticks < 1:
            raise ValueError(f"breaker window must be >= 1 tick, got {window_ticks}")
        if cooldown_ticks < 1:
            raise ValueError(f"breaker cooldown must be >= 1 tick, got {cooldown_ticks}")
        self.degrader = degrader
        self.threshold = int(threshold)
        self.window_ticks = int(window_ticks)
        self.cooldown_ticks = int(cooldown_ticks)
        self.state = STATE_CLOSED
        self.opens = 0
        self._log = log
        self._ticks = 0
        self._opened_at = 0
        self._failures: collections.deque[int] = collections.deque()

    def tick(self) -> None:
        """One serve-loop iteration: age the failure window; an open
        breaker whose cooldown has elapsed goes half-open and restores the
        primary backend for the probe."""
        self._ticks += 1
        self._trim()
        if self.state == STATE_OPEN and self._ticks - self._opened_at >= self.cooldown_ticks:
            self._half_open()

    def bypass_primary(self) -> bool:
        """True while open: dispatch goes straight to the pinned degraded
        backend, skipping the primary attempt and its retry ladder."""
        return self.state == STATE_OPEN

    def record_failure(self) -> None:
        """A transient (retryable) failure on the primary dispatch path;
        fatal errors never get here (``io/pipeline.py`` filters them)."""
        if self.state == STATE_OPEN:
            return
        if self.state == STATE_HALF_OPEN:
            self._open(reason="probe-failed")
            return
        if not (self.degrader.enabled and self.degrader.can_degrade()):
            # Nothing to pin: without --degrade, or from the chain's last
            # backend, an open breaker would bypass onto the same backend.
            return
        self._failures.append(self._ticks)
        self._trim()
        if len(self._failures) >= self.threshold:
            self._open(reason="threshold")

    def record_success(self) -> None:
        """A primary dispatch completed: a half-open probe that succeeds
        closes the breaker."""
        if self.state == STATE_HALF_OPEN:
            self._close()

    def _trim(self) -> None:
        horizon = self._ticks - self.window_ticks
        while self._failures and self._failures[0] < horizon:
            self._failures.popleft()

    def _open(self, reason: str) -> None:
        pinned = self.degrader.pin() or self.degrader.scorer.backend
        self.state = STATE_OPEN
        self.opens += 1
        self._opened_at = self._ticks
        self._failures.clear()
        publish("breaker.open", backend=pinned, reason=reason, tick=self._ticks)
        self._log(
            f"{_PROG}: breaker OPEN ({reason}): backend {pinned!r} pinned; "
            f"probing the primary in {self.cooldown_ticks} tick(s)"
        )

    def _half_open(self) -> None:
        self.state = STATE_HALF_OPEN
        self.degrader.reset()
        publish("breaker.half_open", backend=self.degrader.scorer.backend, tick=self._ticks)
        self._log(
            f"{_PROG}: breaker HALF-OPEN: probing primary backend "
            f"{self.degrader.scorer.backend!r}"
        )

    def _close(self) -> None:
        self.state = STATE_CLOSED
        self._failures.clear()
        publish("breaker.close", backend=self.degrader.scorer.backend, tick=self._ticks)
        self._log(f"{_PROG}: breaker CLOSED: primary backend healthy")
