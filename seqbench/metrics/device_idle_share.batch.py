"""device_idle_share.batch: the share of the traced window in which no
device activity ran (kernels, copies, memsets), in percent (device_trace)."""


def read(run):
    t = run.trace
    if run.kind != "batch" or not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
