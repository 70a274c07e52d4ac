"""serve_queue_wait_ms.steady: the mean of the server's ``queue_wait_s``
histogram over the window (its sum and count read by the ``metrics``
telemetry verb at the window's start and end), in ms (program_counter)."""


def _hist(snap):
    h = (snap or {}).get("histograms", {}).get("queue_wait_s") or {}
    return h.get("sum", 0.0), h.get("count", 0)


def read(run):
    if "start" not in run.telemetry or "end" not in run.telemetry:
        return None
    s0, n0 = _hist(run.telemetry["start"])
    s1, n1 = _hist(run.telemetry["end"])
    return (s1 - s0) / (n1 - n0) * 1e3 if n1 > n0 else None
