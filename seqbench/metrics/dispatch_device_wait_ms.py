"""dispatch_device_wait_ms: mean a job of the ``score.chunk_gather.device_wait``
span, the host's block on the result copy's CUDA event inside the gather, in
ms (program_span).

It prices a card deployment's wait, so it reads nothing where the window saw
no device activity (no device trace, or no busy time), as on a CPU, where no
event is waited on, and nothing where the program opens no such span."""

PATH = "score.chunk_gather.device_wait"


def read(run):
    t = run.trace
    if not run.spans or not t or t.get("busy_s", 0.0) <= 0.0:
        return None
    if not any(PATH in s for s in run.spans):
        return None
    return sum(s.get(PATH, 0.0) for s in run.spans) / len(run.spans) * 1e3
