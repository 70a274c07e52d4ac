"""Request-trace record/replay: a captured schedule as an artifact (the
port of ``mpi_openmp_cuda_tpu/load/replay.py``).

A *schedule* is the load plane's unit of reproducibility: a list of
``(send_offset_s, raw_request)`` pairs, offsets sorted ascending.  The
generator builds one (:func:`build_schedule`), the driver replays one,
and this module round-trips one through a JSONL file — so "re-run the
same traffic with different knobs" is a file replay, not a hope that
two seeded runs stayed in sync.  :func:`scale_schedule` replays a
capture at k× speed (k>1 compresses the gaps: 2× the arrival rate from
the identical request bodies — the saturation dial for refit A/Bs).

File format (one JSON object per line, schema guarded on load)::

    {"t_s": 0.125, "raw": {"id": "q00003", "weights": [...], ...}}

Offsets come in from the schedule, never from a clock.
"""

from __future__ import annotations

import json

Schedule = list  # list[tuple[float, dict]]


def build_schedule(times: list[float], requests: list[dict]) -> Schedule:
    """Zip arrival offsets onto request bodies (lengths must match)."""
    if len(times) != len(requests):
        raise ValueError(
            f"schedule shape mismatch: {len(times)} arrival times vs "
            f"{len(requests)} requests"
        )
    sched = sorted(
        ((float(t), raw) for t, raw in zip(times, requests)),
        key=lambda p: p[0],
    )
    if sched and sched[0][0] < 0.0:
        raise ValueError(
            f"arrival offsets must be >= 0, got {sched[0][0]}"
        )
    return sched


def scale_schedule(schedule: Schedule, k: float) -> Schedule:
    """The same requests at k× speed: offsets divided by ``k`` (k=2
    doubles the offered rate; k=0.5 halves it)."""
    k = float(k)
    if k <= 0.0:
        raise ValueError(f"replay speed k must be > 0, got {k}")
    return [(t / k, raw) for t, raw in schedule]


def save_schedule(path: str, schedule: Schedule) -> None:
    """One request per line, offsets first — diff-able and grep-able."""
    with open(path, "w", encoding="utf-8") as fh:
        for t, raw in schedule:
            fh.write(
                json.dumps({"t_s": round(float(t), 9), "raw": raw}) + "\n"
            )


def load_schedule(path: str) -> Schedule:
    """Load + validate a captured schedule; raises ValueError naming the
    first bad line so a torn capture cannot silently replay as a
    shorter run."""
    sched: Schedule = []
    with open(path, encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"{path}:{lineno}: not JSON ({e.msg})"
                ) from None
            t = row.get("t_s") if isinstance(row, dict) else None
            raw = row.get("raw") if isinstance(row, dict) else None
            if not isinstance(t, (int, float)) or t < 0 or not isinstance(
                raw, dict
            ):
                raise ValueError(
                    f"{path}:{lineno}: want {{'t_s': <seconds>=0>, "
                    f"'raw': {{...}}}}, got {line[:120]!r}"
                )
            sched.append((float(t), raw))
    sched.sort(key=lambda p: p[0])
    return sched
