"""launch_pad_share: the share of the cells the kernels computed in the window
that no Seq2 needed, 100 * (1 - needed / launched), in percent
(program_counter).  Needed: the window's jobs' cells (``seqbench/roofline.py``).
Launched: the rise of the port's ``dispatch_launched_cells`` (each launch's
cells at its padded shapes, as the kernels' loop bounds set them) between
the window's edges, as the scan driver snapshots it into ``telemetry``.

Nothing where no kernel launched in the window (``run.launches``; on a CPU
the kernels' plain PyTorch versions run, whose cells the counter counts as
well), or where the run holds no such snapshot (the other drivers, or a
program without the counter)."""

KEY = "dispatch_launched_cells"


def read(run):
    start, end = run.telemetry.get("start", {}), run.telemetry.get("end", {})
    if not run.jobs or sum(run.launches.values()) <= 0 or KEY not in end:
        return None
    launched = end[KEY] - start.get(KEY, 0)
    if launched <= 0:
        return None
    return 100.0 * (1.0 - sum(j["cells"] for j in run.jobs) / launched)
