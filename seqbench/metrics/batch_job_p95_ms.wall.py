"""batch_job_p95_ms.wall: 95th percentile of the window's job walls, from the
call into the port's CLI to its return with stdout complete (host clock).
Per-layer: on a shared host its runs spread too widely for any bound
(PERF.md section 2)."""

import statistics


def read(run):
    walls = [j["wall_s"] for j in run.jobs]
    if len(walls) < 2:
        return None
    return statistics.quantiles(walls, n=20, method="inclusive")[18] * 1e3
