"""Open-loop arrival schedules: WHEN each request hits the wire (the port
of ``mpi_openmp_cuda_tpu/load/arrival.py``).

A schedule is a sorted list of non-negative send offsets (seconds from
the run's t0).  It is computed entirely up front from a seeded RNG —
the defining property of open-loop load: the server's behaviour cannot
slow the arrivals down, because the arrivals were decided before the
server saw anything.  No wall-clock reads here; the driver owns the one
wall-clock loop that paces these offsets onto real sockets.

Four processes, selected by name through :func:`arrival_times`:

``constant``   evenly spaced at the target rate — the baseline shape;
``poisson``    exponential inter-arrival gaps (memoryless arrivals, the
               classic open-loop model) at the same mean rate;
``burst``      groups of ``burst_size`` requests land simultaneously,
               groups spaced so the AVERAGE rate holds — the shape that
               stresses admission hysteresis hardest;
``ramp``       rate climbs linearly from ``ramp_from_rps`` to the
               target across the schedule — the shape that finds the
               saturation knee.
"""

from __future__ import annotations

import random

PROCESSES = ("constant", "poisson", "burst", "ramp")


def _validated(n: int, rate_rps: float) -> tuple[int, float]:
    n = int(n)
    rate = float(rate_rps)
    if n < 0:
        raise ValueError(f"arrival count must be >= 0, got {n}")
    if rate <= 0.0:
        raise ValueError(f"arrival rate_rps must be > 0, got {rate_rps}")
    return n, rate


def constant_times(n: int, rate_rps: float) -> list[float]:
    n, rate = _validated(n, rate_rps)
    return [i / rate for i in range(n)]


def poisson_times(n: int, rate_rps: float, *, seed: int) -> list[float]:
    n, rate = _validated(n, rate_rps)
    rng = random.Random(int(seed))
    t = 0.0
    out = []
    for _ in range(n):
        t += rng.expovariate(rate)
        out.append(t)
    return out


def burst_times(
    n: int, rate_rps: float, *, burst_size: int = 8
) -> list[float]:
    n, rate = _validated(n, rate_rps)
    size = max(1, int(burst_size))
    gap = size / rate  # group spacing preserving the average rate
    return [(i // size) * gap for i in range(n)]


def ramp_times(
    n: int, rate_rps: float, *, ramp_from_rps: float | None = None
) -> list[float]:
    n, rate = _validated(n, rate_rps)
    r0 = float(ramp_from_rps) if ramp_from_rps is not None else rate / 4.0
    if r0 <= 0.0:
        raise ValueError(f"ramp_from_rps must be > 0, got {ramp_from_rps}")
    t = 0.0
    out = []
    for i in range(n):
        out.append(t)
        frac = i / max(1, n - 1)
        t += 1.0 / (r0 + (rate - r0) * frac)
    return out


def arrival_times(
    process: str,
    n: int,
    rate_rps: float,
    *,
    seed: int = 0,
    burst_size: int = 8,
    ramp_from_rps: float | None = None,
) -> list[float]:
    """One schedule by process name; same inputs → same offsets, on
    every host, every run."""
    if process == "constant":
        return constant_times(n, rate_rps)
    if process == "poisson":
        return poisson_times(n, rate_rps, seed=seed)
    if process == "burst":
        return burst_times(n, rate_rps, burst_size=burst_size)
    if process == "ramp":
        return ramp_times(n, rate_rps, ramp_from_rps=ramp_from_rps)
    raise ValueError(
        f"unknown arrival process {process!r}: want one of "
        f"{', '.join(PROCESSES)}"
    )
