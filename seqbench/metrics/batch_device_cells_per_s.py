"""batch_device_cells_per_s: needed cells of the jobs done in the window, in
billions a second that the card was busy with them (the union of its
kernels, copies and memsets in the window, from the profiler's trace):
the rate one card gives this traffic, which bounds what it serves however
many hosts feed it (device_trace)."""


def read(run):
    t = run.trace
    if run.kind != "batch" or not t or not t.get("cells") or t["busy_s"] <= 0:
        return None
    return t["cells"] / t["busy_s"] / 1e9
