"""serve_loop_busy_share.steady: the share of the window the server's loop
was not blocked in its queue, 100 * (1 - (serve.wait + serve.linger seconds)
/ uptime seconds), both differenced between the ``metrics`` telemetry verb's
readings at the window's start and end (its ``spans`` section and
``uptime_s``), in percent (program_counter).  A span still open at a
reading counts at its close.  Nothing where the server reports no spans."""

IDLE = ("serve.wait", "serve.linger")


def _idle_s(snap):
    spans = (snap or {}).get("spans")
    if spans is None:
        return None
    return sum(v["seconds"] for p, v in spans.items()
               if any(p == n or p.endswith("." + n) for n in IDLE))


def read(run):
    start, end = run.telemetry.get("start"), run.telemetry.get("end")
    i0, i1 = _idle_s(start), _idle_s(end)
    if i0 is None or i1 is None:
        return None
    up = end.get("uptime_s", 0.0) - start.get("uptime_s", 0.0)
    if up <= 0.0:
        return None
    return 100.0 * (1.0 - (i1 - i0) / up)
