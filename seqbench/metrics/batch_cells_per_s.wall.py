"""batch_cells_per_s.wall: needed cells of the jobs done in the window, in
billions a second of the window (host clock).  Per-layer: on a shared host
its runs spread too widely for any bound (PERF.md section 2)."""


def read(run):
    if not run.jobs:
        return None
    return sum(j["cells"] for j in run.jobs) / run.window_s / 1e9
