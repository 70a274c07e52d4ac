"""serve_p95_ms.steady: 95th percentile, over every request due in the
window, of the time from its due time to its done record; a request
refused, failed or never answered counts as the window's length (host
clock).  Per-layer: on a shared host its runs spread too widely for any
bound (PERF.md section 2)."""

import statistics


def read(run):
    if len(run.outcomes) < 2:
        return None
    lat = [o.latency_s if o.kind == "done" else run.window_s for o in run.outcomes]
    return statistics.quantiles(lat, n=20, method="inclusive")[18] * 1e3
