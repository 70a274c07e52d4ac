"""dispatch_setup_ms: mean a job of the port CLI's `setup` span over the traced
window (program_span)."""


def read(run):
    if not run.spans:
        return None
    return sum(s.get("setup", 0.0) for s in run.spans) / len(run.spans) * 1e3
