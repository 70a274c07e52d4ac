"""cli_plumbing_ms: mean a job of the port CLI's run plumbing, its top-level
``run.*`` spans (argument parsing and checks, arming the planes and guards,
the stdout guard's close, the teardown), in ms (program_span).

It prices a card deployment's host work, so it reads nothing where the
window saw no device activity (no device trace, or no busy time), as on a
CPU, and nothing where the program opens no such span."""


def read(run):
    t = run.trace
    if not run.spans or not t or t.get("busy_s", 0.0) <= 0.0:
        return None
    per_job = [[v for p, v in s.items() if p.startswith("run.") and p.count(".") == 1]
               for s in run.spans]
    if not any(per_job):
        return None
    return sum(sum(v) for v in per_job) / len(per_job) * 1e3
