"""Open-loop arrival schedules: when each request is due (adapted from the
port's ``load/arrival.py``).

A schedule is a sorted list of ``count`` send offsets in ``[0, seconds)``,
made up front from a seed, so the server's behaviour cannot slow the
arrivals.  The count is fixed by the caller (rate times window), so every
seed offers the same load.  ``poisson`` is ``count`` uniform offsets,
sorted: a Poisson process given its count (exponential gaps, memoryless
arrivals).  Another process comes with the first cell that needs it.
"""

from __future__ import annotations

import random

PROCESSES = ("poisson",)


def arrival_times(process: str, count: int, seconds: float, *, seed: int = 0) -> list[float]:
    """One schedule by process name; the same inputs give the same offsets."""
    count, seconds = int(count), float(seconds)
    if count < 0 or seconds <= 0:
        raise ValueError(f"want count >= 0 and seconds > 0, got {count}, {seconds}")
    if process == "poisson":
        rng = random.Random(seed)
        return sorted(rng.random() * seconds for _ in range(count))
    raise ValueError(f"unknown arrival process {process!r}: want one of {', '.join(PROCESSES)}")
