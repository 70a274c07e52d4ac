"""mesh_h2d_copies_per_job: the batch mesh's host-to-device copies
(``parallel/sharding.py::mesh_counts["mesh_h2d_copies"]``) over the window, a
job (program_counter).

It counts a card deployment's copies, so it reads nothing where the window
saw no device activity (as on a CPU), and nothing where the program keeps no
such counter (``drivers/batch_mesh.py`` leaves the snapshots empty)."""

NAME = "mesh_h2d_copies"


def read(run):
    t, snaps = run.trace, run.telemetry
    if not run.jobs or not t or t.get("busy_s", 0.0) <= 0.0:
        return None
    start, end = snaps.get("start", {}), snaps.get("end", {})
    if NAME not in start or NAME not in end:
        return None
    return (end[NAME] - start[NAME]) / len(run.jobs)
