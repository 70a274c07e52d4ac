"""Graceful preemption drain (the port of ``mpi_openmp_cuda_tpu/
resilience/drain.py``): SIGTERM/SIGINT -> flush -> exit 75.

:class:`drain_guard` installs SIGTERM/SIGINT handlers for one CLI run
(main thread only; the previous handlers come back on exit).  The first
signal sets a flag that :func:`drain_requested` reads at every chunk
boundary (the batch journal loop and the ``--stream`` submit loop);
``SEQALIGN_DRAIN=1`` pre-arms it.  The boundary raises
:class:`DrainInterrupt` after the in-flight results are journalled; the
CLI exits 75 (``EX_TEMPFAIL``: rerun with ``--resume``).  A second
signal exits at once (``os._exit(128 + signum)``).

:class:`DrainInterrupt` is a ``BaseException``: the retry policy's
``except Exception`` must not retry a preemption.
"""

from __future__ import annotations

import os
import signal
import threading

from ..obs.events import log_line, publish


class DrainInterrupt(BaseException):
    """A drain request reached a chunk boundary: stop cleanly, exit 75."""


_requested = False
_signals = 0


def drain_requested() -> bool:
    """The chunk-boundary check: one global read."""
    return _requested


def request_drain(why: str, log=None) -> None:
    """Set the drain flag (idempotent), logged once."""
    global _requested
    if not _requested:
        _requested = True
        publish("drain.request", why=why)
        (log or log_line)(
            f"mpi_openmp_cuda_tpu_torch: drain requested ({why}); finishing "
            "in-flight chunks, flushing the journal, then exiting 75 "
            "(resumable) — a second signal force-exits"
        )


class drain_guard:
    """Install the drain handlers for one run; ``prearm=None`` reads
    ``SEQALIGN_DRAIN``.  The flag is reset on entry and exit."""

    def __init__(self, *, prearm: bool | None = None, log=None):
        self._prearm = prearm
        self._log = log or log_line
        self._saved: list[tuple[int, object]] = []

    def __enter__(self):
        global _requested, _signals
        prearm = self._prearm
        if prearm is None:
            from ..utils.env import env_flag

            prearm = env_flag("SEQALIGN_DRAIN")
        _requested = bool(prearm)
        _signals = 0
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._saved.append((sig, signal.signal(sig, self._on_signal)))
                except (ValueError, OSError):
                    continue
        return self

    def __exit__(self, *exc):
        global _requested, _signals
        saved, self._saved = self._saved, []
        for sig, old in saved:
            try:
                signal.signal(sig, old)
            except (ValueError, OSError):
                continue
        _requested = False
        _signals = 0
        return False

    def _on_signal(self, signum, frame) -> None:
        global _signals
        _signals += 1
        if _signals > 1:
            # A second signal: exit now; flushed journal chunks are fsync'd.
            os._exit(128 + signum)
        try:
            name = signal.Signals(signum).name
        except ValueError:
            name = f"signal {signum}"
        request_drain(name, self._log)
