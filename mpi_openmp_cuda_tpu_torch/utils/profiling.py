"""Per-phase timing and the device profiler (the port of
``mpi_openmp_cuda_tpu/utils/profiling.py``).

:class:`PhaseTimer` is a thin shim over :class:`~..obs.spans.SpanRecorder`
keeping the ``--profile`` contract (the ``[profile]`` stderr report, byte
for byte the JAX package's, and a ``phases`` list of ``(name, seconds)``).
The CLI builds its timer, and with it the run's one recorder, before
anything else; the obs plane adopts that recorder, so profile phases and
the run report's span section are one measurement.  A phase records only
while something reads the recorder (``--profile``, a close listener, or
the recorder armed as the active one); otherwise it is the shared no-op
context.

:func:`device_trace` is ``--trace DIR``: ``torch.profiler`` over the
scoring phase (CPU activities, and CUDA ones when a card is present),
written as a Chrome trace into ``DIR``.  :func:`block_until_ready` is
the CUDA-event wait that closes it.
"""

from __future__ import annotations

import contextlib
import os
import sys

from ..obs.spans import NULL_SPAN, SpanRecorder, active_spans


class PhaseTimer:
    """Accumulates named wall-clock phases; reports to stderr when enabled.
    Pass ``recorder=`` to time into a given recorder."""

    def __init__(self, enabled: bool = False, recorder: SpanRecorder | None = None):
        self.enabled = bool(enabled)
        self._recorder = recorder if recorder is not None else SpanRecorder()

    @property
    def recorder(self) -> SpanRecorder:
        return self._recorder

    @property
    def read(self) -> bool:
        """Whether anything reads the recorder: the ``[profile]`` report,
        a close listener, or the recorder armed as the active one."""
        rec = self._recorder
        return self.enabled or bool(rec.listeners) or active_spans() is rec

    @property
    def phases(self) -> list[tuple[str, float]]:
        return self._recorder.phases()

    def phase(self, name: str):
        return self._recorder.span(name) if self.read else NULL_SPAN

    def report(self, out=None) -> None:
        if not self.enabled:
            return
        self._recorder.report(out or sys.stderr)


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """``torch.profiler`` over the block, its Chrome trace written to
    ``<log_dir>/trace-<pid>.json`` on exit; a no-op when ``log_dir`` is
    None.  The trace is written even when the block raises."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        block_until_ready()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}.json"))


def block_until_ready(value=None):
    """Wait until the work queued so far on the current CUDA stream is
    done — an event recorded there, polled by ``dispatch.wait_event``, so
    an armed deadline can interrupt the wait — and return ``value``.  A
    no-op without an initialised CUDA context."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        from ..ops.dispatch import wait_event

        event = torch.cuda.Event()
        event.record()
        wait_event(event)
    return value
