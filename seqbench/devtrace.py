"""Device time from ``torch.profiler``, and host spans to label its gaps.

:class:`DeviceTrace` profiles CUDA activity only (kernels, copies,
memsets): no host operator is recorded, so the host path runs at nearly
its untraced speed.  The profiler stamps events in Unix-epoch
nanoseconds; host spans arrive in ``time.perf_counter`` seconds (the
program's span clock) and are shifted by the offset between the two
clocks read at :meth:`start`.

:meth:`summary` reduces one traced window to plain numbers: device busy
seconds (the union of activity intervals, clipped to the window), the
summed kernel time, the device operations by total time, and the idle
time split by the deepest host span open over each stretch of it.
"""

from __future__ import annotations

import time

TOP = 10


def union_length(intervals) -> float:
    """Total length covered by ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float):
    """The idle ``(start, end)`` stretches of ``[lo, hi]`` outside ``intervals``."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def label_gaps(idle, spans, outside: str = "no span") -> list[list]:
    """Idle seconds by what the host was doing: each stretch of each gap
    goes to the deepest span ``(label, start, end, depth)`` open over it
    (``outside`` where none is); the labels largest first."""
    edges = sorted([(s, 1, i) for i, (_, s, _, _) in enumerate(spans)]
                   + [(e, -1, i) for i, (_, _, e, _) in enumerate(spans)]
                   + [(s, 2, -1) for s, _ in idle] + [(e, -2, -1) for _, e in idle],
                   key=lambda ev: (ev[0], ev[1]))
    open_: dict[int, tuple] = {}
    by_label: dict[str, float] = {}
    in_gap, at = 0, None
    for t, kind, i in edges:
        if in_gap and at is not None and t > at:
            top = max(open_.values(), key=lambda sp: (sp[3], sp[1]), default=None)
            label = outside if top is None else top[0]
            by_label[label] = by_label.get(label, 0.0) + (t - at)
        at = t
        if kind == 1:
            open_[i] = spans[i]
        elif kind == -1:
            open_.pop(i, None)
        else:
            in_gap += 1 if kind == 2 else -1
    return sorted(([k, v] for k, v in by_label.items()), key=lambda kv: -kv[1])[:TOP]


class DeviceTrace:
    """One traced window: :meth:`start` the profiler (its first start takes
    seconds, so before the window), :meth:`open` and :meth:`close` the
    window around the work, :meth:`stop`, then :meth:`summary`.  Host
    spans are added with :meth:`span`."""

    def __init__(self):
        self.spans: list[tuple[str, float, float, int]] = []
        self._prof = None
        self._offset = 0.0
        self.t0 = self.t1 = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        # Without a card (the CPU tests) there is no device activity to
        # record; the host's keeps the profiler's life cycle the same.
        cuda = torch.cuda.is_available()
        self._prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
        self._prof.start()
        self._offset = time.time() - time.perf_counter()

    def open(self) -> None:
        self.t0 = time.time()

    def close(self) -> None:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.t1 = time.time()

    def stop(self) -> None:
        self._prof.stop()

    def span(self, label: str, start_perf: float, dur: float, depth: int) -> None:
        """A host span in ``time.perf_counter`` seconds."""
        s = start_perf + self._offset
        self.spans.append((label, s, s + dur, depth))

    def device_events(self):
        """``(name, start, end, kind)`` of each device activity, epoch
        seconds; ``kind`` is ``copy`` for a memcpy or memset, else
        ``kernel``."""
        out = []
        for ev in self._prof.profiler.kineto_results.events():
            if str(ev.device_type()).endswith("CUDA"):
                name = ev.name()
                kind = "copy" if name.startswith(("Memcpy", "Memset")) else "kernel"
                s = ev.start_ns() / 1e9
                out.append((name, s, s + ev.duration_ns() / 1e9, kind))
        return out

    def summary(self, outside: str = "no span") -> dict:
        """Busy and window seconds, kernel seconds, and the breakdown;
        idle time under no host span is labelled ``outside``."""
        lo, hi = self.t0, self.t1
        events = [(n, max(s, lo), min(e, hi), k) for n, s, e, k in self.device_events()
                  if e > lo and s < hi]
        busy = [(s, e) for _, s, e, _ in events]
        by_op: dict[str, float] = {}
        kernel_s = 0.0
        for name, s, e, kind in events:
            by_op[name] = by_op.get(name, 0.0) + (e - s)
            if kind == "kernel":
                kernel_s += e - s
        ops = sorted(([n[:160], v] for n, v in by_op.items()), key=lambda kv: -kv[1])[:TOP]
        return {
            "busy_s": union_length(busy),
            "window_s": hi - lo,
            "kernel_s": kernel_s,
            "device_ops": ops,
            "idle_gaps": label_gaps(gaps(busy, lo, hi), self.spans, outside),
        }


def span_sink(trace: DeviceTrace, depth0: int = 0):
    """A ``SpanRecorder`` listener that hands each closed span to
    ``trace``, nested by its dotted path."""

    def sink(path: str, start: float, dur: float) -> None:
        trace.span(path, start, dur, depth0 + path.count(".") + 1)

    return sink


def tap_phases(cli, sink) -> None:
    """Hand every span of the port CLI's phase recorder to ``sink``: its
    ``PhaseTimer`` is replaced by one whose recorder (the obs plane's
    when armed) has ``sink`` among its listeners."""
    from mpi_openmp_cuda_tpu_torch.obs.spans import SpanRecorder

    base = cli.PhaseTimer

    class Tapped(base):
        def __init__(self, enabled=False, recorder=None):
            recorder = recorder if recorder is not None else SpanRecorder()
            recorder.listeners.append(sink)
            super().__init__(enabled, recorder=recorder)

    cli.PhaseTimer = Tapped
