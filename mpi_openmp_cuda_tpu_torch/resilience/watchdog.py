"""Wall-clock deadlines around device work, and the obs plane's
heartbeat (the port of ``mpi_openmp_cuda_tpu/resilience/watchdog.py``).

One monitor thread per run (``--deadline`` / ``SEQALIGN_DEADLINE_S``,
and/or ``--heartbeat`` / ``SEQALIGN_HEARTBEAT_S``).
Each blocking boundary — the dispatch and the result materialisation in
``ops/dispatch.py`` — arms :meth:`Watchdog.guard` around itself.  The
monitor waits on a ``threading.Condition`` with the deadline as timeout
and, when the armed operation is still armed then, sets its expiry
event and logs a warning.  Expiry is transient:
:class:`DeadlineExpiredError` is a ``RuntimeError``, so the retry policy
absorbs it and the degrade chain sits behind that.

``torch.cuda.synchronize()`` and a blocking device-to-host copy cannot be
interrupted, so the port never blocks in them under a guard: the result
wait polls a CUDA event (``event.query()``) and, between polls, the
armed guard's expiry, raising :class:`DeadlineExpiredError` once it is
set (:func:`check_expired`).  An injected ``hang:*`` fault blocks on the
same expiry event, so it expires deterministically.

With a heartbeat interval the monitor also calls the heartbeat callback
(``obs.export.heartbeat_callback``: one ``[obs]`` line) after every
quiet interval; heartbeat-only mode (no deadline) enforces nothing.  The
callback and every bus publish run outside the monitor's condition:
they take the obs recorders' own locks, which must never nest under a
watchdog lock (a stalled subscriber would stall every ``guard()``).
"""

from __future__ import annotations

import contextlib
import threading

from ..obs.events import log_line, publish

#: The monitor thread's name (tests check none survives a run).
THREAD_NAME = "seqalign-watchdog"


class DeadlineExpiredError(RuntimeError):
    """A guarded operation outlived the deadline (transient)."""


class HangWithoutDeadlineError(ValueError):
    """A ``hang:*`` fault fired with no deadline armed (fatal: the run
    would otherwise block forever)."""


class _Arm:
    """One armed guard: what it covers and its expiry event."""

    __slots__ = ("describe", "expired")

    def __init__(self, describe: str):
        self.describe = describe
        self.expired = threading.Event()


class Watchdog:
    """One monitor thread watching one armed operation at a time (the
    guarded boundaries all run on the calling thread; nested guards are
    no-ops under the outer deadline).  ``stop()`` joins the thread."""

    def __init__(self, deadline_s: float | None, *, log=None,
                 heartbeat_s: float | None = None, heartbeat=None):
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"watchdog deadline must be > 0 seconds, got {deadline_s}")
        if deadline_s is None and heartbeat_s is None:
            raise ValueError("watchdog needs a deadline, a heartbeat interval, or both")
        if heartbeat_s is not None and heartbeat_s <= 0:
            raise ValueError(f"heartbeat interval must be > 0 seconds, got {heartbeat_s}")
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.heartbeat_s = None if heartbeat_s is None else float(heartbeat_s)
        self._heartbeat = heartbeat
        self.expiries = 0
        self._log = log or log_line
        self._cond = threading.Condition()
        self._arm: _Arm | None = None
        self._stopped = False
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        if self._thread is None:
            self._stopped = False
            self._thread = threading.Thread(target=self._monitor, name=THREAD_NAME, daemon=True)
            self._thread.start()

    def stop(self) -> None:
        """Stop and join the monitor (idempotent)."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()

    def _monitor(self) -> None:
        hb = self.heartbeat_s
        while True:
            beat = False
            expired = None
            with self._cond:
                if self._stopped:
                    return
                if self._arm is None or self.deadline_s is None:
                    # Idle, or heartbeat-only (guards carry no deadline):
                    # sleep a heartbeat interval (forever without one) and
                    # beat on each quiet timeout.
                    notified = self._cond.wait(timeout=hb)
                    beat = not notified and not self._stopped
                else:
                    cur = self._arm
                    disarmed = self._cond.wait_for(
                        lambda: self._stopped or self._arm is not cur,
                        timeout=self.deadline_s,
                    )
                    if not disarmed:
                        self.expiries += 1
                        cur.expired.set()
                        expired = cur
            if beat and self._heartbeat is not None:
                self._heartbeat()
            if expired is not None:
                # Published outside the condition: a subscriber must never
                # stall guard() or stop() callers.
                publish("watchdog.expiry", site=expired.describe)
                self._log(
                    f"mpi_openmp_cuda_tpu_torch: warning: {expired.describe} "
                    f"exceeded the {self.deadline_s:g}s watchdog deadline; "
                    "the wait is abandoned as a transient fault (SIGTERM "
                    "drains with journalled progress; see --resume)"
                )
                with self._cond:
                    self._cond.wait_for(lambda: self._stopped or self._arm is not expired)

    @contextlib.contextmanager
    def guard(self, describe: str):
        """Arm the monitor around one blocking operation (a nested guard
        is a no-op)."""
        with self._cond:
            token = None
            if self._arm is None:
                token = self._arm = _Arm(describe)
                self._cond.notify_all()
        if token is not None:
            publish("watchdog.guard", state="armed", site=describe)
        try:
            yield
        finally:
            if token is not None:
                with self._cond:
                    self._arm = None
                    self._cond.notify_all()
                publish("watchdog.guard", state="disarmed", site=describe)

    def current(self) -> _Arm | None:
        with self._cond:
            return self._arm

    def hang_until_expiry(self, site: str) -> None:
        """An injected hang: block on the armed guard's expiry, then raise
        :class:`DeadlineExpiredError`; with no guard armed, fail fast."""
        token = self.current()
        if token is None or self.deadline_s is None:
            raise HangWithoutDeadlineError(
                f"injected hang at {site!r} outside any deadline-armed "
                "watchdog guard; refusing to block forever (a heartbeat-only "
                "watchdog enforces no deadline)"
            )
        token.expired.wait()
        raise DeadlineExpiredError(
            f"injected hang at {site!r}: {token.describe} exceeded the "
            f"{self.deadline_s:g}s watchdog deadline"
        )


_active: Watchdog | None = None


def activate_watchdog(deadline_s: float | None, *, log=None,
                      heartbeat_s: float | None = None, heartbeat=None) -> Watchdog:
    """Arm and start a fresh watchdog for one run; ``deadline_s=None``
    with a heartbeat runs it in heartbeat-only mode."""
    global _active
    deactivate_watchdog()
    _active = Watchdog(deadline_s, log=log, heartbeat_s=heartbeat_s, heartbeat=heartbeat)
    _active.start()
    return _active


def deactivate_watchdog() -> None:
    """Stop and join the run's watchdog (no-op when none is armed)."""
    global _active
    wd, _active = _active, None
    if wd is not None:
        wd.stop()


def active_watchdog() -> Watchdog | None:
    return _active


def guard(describe: str):
    """A context manager arming the run's watchdog, or a no-op."""
    wd = _active
    if wd is None:
        return contextlib.nullcontext()
    return wd.guard(describe)


def check_expired(what: str) -> None:
    """Raise :class:`DeadlineExpiredError` when the armed guard's deadline
    has passed (the polled result wait's exit)."""
    wd = _active
    token = wd.current() if wd is not None else None
    if token is not None and token.expired.is_set():
        raise DeadlineExpiredError(
            f"{what} exceeded the {_active.deadline_s:g}s watchdog deadline"
        )


def hang_until_deadline(site: str) -> None:
    """Entry point of the ``hang:*`` fault sites."""
    wd = _active
    if wd is None:
        raise HangWithoutDeadlineError(
            f"injected hang at {site!r} with no watchdog armed; hang faults "
            "need --deadline (or SEQALIGN_DEADLINE_S) so the run can classify "
            "the hang instead of blocking forever"
        )
    wd.hang_until_expiry(site)
