"""Nested wall-clock spans: the phase timer generalised (the port of
``mpi_openmp_cuda_tpu/obs/spans.py``).

:class:`SpanRecorder` is the engine under ``utils/profiling.PhaseTimer``:
top-level spans ARE the profile phases (parse / setup / score / print,
the byte-compatible ``[profile]`` report), and spans opened while another
is live record under a dotted path (``score.chunk_gather``) — the
per-dispatch spans ``ops/dispatch.py`` opens nest under whatever phase
the CLI has open.

Honest device time: a CUDA launch is asynchronous, so a span around a
dispatch measures enqueue, not compute.  The result wait of
``dispatch.BucketedPending`` sits inside its ``chunk_gather`` span, and
:func:`fence` waits for CUDA tensors (an event recorded after them on
the current stream) *when a recorder is armed*, so a gather span
brackets the device wait.  Both waits are ``dispatch.wait_event``'s poll,
never ``torch.cuda.synchronize()``, so an armed deadline can still
interrupt it.

The clock is injectable (``time.perf_counter`` by default).  :func:`span`
returns a shared ``nullcontext`` when no recorder is armed (no
allocation on the per-dispatch path), and the CLI arms/disarms per run.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time


class SpanRecorder:
    """Records ``(dotted.path, seconds)`` spans in completion order.

    The main thread owns dispatch, gather and every CLI phase; the nesting
    stack is still kept per thread, so the scoring threads of an
    in-process fleet (``serve/fleet.py``'s workers beside the serve loop)
    each nest under their own spans.
    """

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self.spans: list[tuple[str, float]] = []
        self._local = threading.local()
        # Close listeners: ``fn(path, start, dur)`` per finished span, in
        # the recorder's own clock domain (the trace and the flight
        # recorder subscribe here).
        self.listeners: list = []

    @property
    def _stack(self) -> list[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextlib.contextmanager
    def span(self, name: str):
        self._stack.append(name)
        path = ".".join(self._stack)
        start = self._clock()
        try:
            yield
        finally:
            dur = self._clock() - start
            self._stack.pop()
            self.spans.append((path, dur))
            for fn in self.listeners:
                try:
                    fn(path, start, dur)
                except Exception:
                    # advisory: a broken observer must never fail the
                    # timed work.
                    pass

    def phases(self) -> list[tuple[str, float]]:
        """Top-level spans in completion order."""
        return [(p, d) for p, d in self.spans if "." not in p]

    def totals(self) -> dict[str, float]:
        """Total seconds per dotted path (repeated spans accumulate)."""
        out: dict[str, float] = {}
        for p, d in self.spans:
            out[p] = out.get(p, 0.0) + d
        return out

    def report(self, out=None) -> None:
        """The ``--profile`` report (top-level phases + total), byte for
        byte the JAX package's format."""
        out = out or sys.stderr
        phases = self.phases()
        total = sum(d for _, d in phases)
        for name, dur in phases:
            print(f"[profile] {name:>16}: {dur * 1e3:10.2f} ms", file=out)
        print(f"[profile] {'total':>16}: {total * 1e3:10.2f} ms", file=out)


_active: SpanRecorder | None = None
_NULL = contextlib.nullcontext()


def activate_spans(clock=None) -> SpanRecorder:
    """Arm a fresh recorder for one run; returns it."""
    global _active
    _active = SpanRecorder(clock if clock is not None else time.perf_counter)
    return _active


def deactivate_spans() -> None:
    global _active
    _active = None


def active_spans() -> SpanRecorder | None:
    return _active


def span(name: str):
    """A span on the armed recorder, else the shared no-op context."""
    rec = _active
    if rec is None:
        return _NULL
    return rec.span(name)


def fence(tensors) -> None:
    """When a recorder is armed and ``tensors`` (a tensor or a sequence
    of them) holds a CUDA tensor, wait for the current stream
    (``utils.profiling.block_until_ready``: a CUDA event recorded after
    them, polled); otherwise nothing, and no event is recorded."""
    if _active is None:
        return
    import torch

    items = tensors if isinstance(tensors, (list, tuple)) else (tensors,)
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in items):
        from ..utils.profiling import block_until_ready

        block_until_ready()
