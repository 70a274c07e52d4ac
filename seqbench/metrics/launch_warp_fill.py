"""launch_warp_fill: the share of the chars the kernels handed their warps in
the window that some Seq2's cells needed, 100 * needed / (128 * handed), in
percent (program_counter).  Needed: the window's jobs' cells
(``seqbench/roofline.py``); a warp spans 128 offsets, so a char handed to it
is 128 cells.  Handed: the rise of the port's
``dispatch_launched_warp_chars`` (each launch's live (pair, tile) clusters
times their warps times each row's segment, as the kernels' loop bounds set
them) between the window's edges, as the scan driver snapshots it into
``telemetry``.

Nothing where no kernel launched in the window (``run.launches``), or where
the run holds no such snapshot (the other drivers, or a program without the
counter)."""

KEY = "dispatch_launched_warp_chars"


def read(run):
    start, end = run.telemetry.get("start", {}), run.telemetry.get("end", {})
    if not run.jobs or sum(run.launches.values()) <= 0 or KEY not in end:
        return None
    handed = end[KEY] - start.get(KEY, 0)
    if handed <= 0:
        return None
    return 100.0 * sum(j["cells"] for j in run.jobs) / (128.0 * handed)
