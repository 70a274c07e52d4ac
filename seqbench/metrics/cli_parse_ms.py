"""cli_parse_ms: mean a job of the port CLI's `parse` span over the traced
window (program_span)."""


def read(run):
    if not run.spans:
        return None
    return sum(s.get("parse", 0.0) for s in run.spans) / len(run.spans) * 1e3
