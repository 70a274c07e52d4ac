"""dispatch_stage_ms: mean a job of the port CLI's ``setup.stage`` span, the
pinned staging of the batch's copies (``FeedStager.stage``: planning, host
buffers, the host-to-device enqueue), in ms (program_span).

It prices a card deployment's host work, so it reads nothing where the
window saw no device activity (no device trace, or no busy time), as on a
CPU, and nothing where the program opens no such span."""

PATH = "setup.stage"


def read(run):
    t = run.trace
    if not run.spans or not t or t.get("busy_s", 0.0) <= 0.0:
        return None
    if not any(PATH in s for s in run.spans):
        return None
    return sum(s.get(PATH, 0.0) for s in run.spans) / len(run.spans) * 1e3
