"""Device timing and the card's identity line.

:func:`time_ms` times the card, not the host: the timed calls are queued
behind a sleeping kernel long enough for the host to queue all of them,
so they run back to back on the device whatever the host's launch rate,
and CUDA events bracket them.  Only for CUDA work.
"""

from __future__ import annotations

import functools
import subprocess
import time

import torch

# Least cycles of torch.cuda._sleep (about 10 ms) that keep the card busy
# while the host queues a timed loop; the most (about 2 s).
SLEEP_CYCLES = 20_000_000
MAX_SLEEP_CYCLES = 4_000_000_000


@functools.cache
def _sleep_cycles_per_ms(index: int) -> float:
    """``torch.cuda._sleep`` cycles per device ms on card ``index``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(index):
        start.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        end.record()
        end.synchronize()
    return SLEEP_CYCLES / start.elapsed_time(end)


def time_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn`` (which must not synchronise): two warm
    calls, the second timing the host's cost of queueing one; then
    ``reps`` calls queued behind a sleeping kernel that lasts twice the
    host's queueing time of them (at least :data:`SLEEP_CYCLES`), timed by
    CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = 2 * reps * host_ms * _sleep_cycles_per_ms(torch.cuda.current_device())
    cycles = int(min(max(cycles, SLEEP_CYCLES), MAX_SLEEP_CYCLES))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (first card)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi exit {smi.returncode}: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def power_limit_w(line: str) -> float:
    """The power limit in watts from a :func:`card_line` line
    (``"NVIDIA H100 80GB HBM3, 700.00 W"`` -> 700.0)."""
    return float(line.rsplit(",", 1)[1].strip().split()[0])
