"""mesh_place_ms: mean a job of the batch mesh's ``shard_replicate`` (Seq1 and
the table to each card, ``MPI_Bcast``) and ``shard_place`` (each shard's rows
and lengths, ``MPI_Scatter``) spans, in ms (program_span).

It prices a card deployment's placement, so it reads nothing where the window
saw no device activity (as on a CPU), and nothing where the program opens no
such span."""

PATHS = ("score.chunk_dispatch.shard_replicate", "score.chunk_dispatch.shard_place")


def read(run):
    t = run.trace
    if not run.spans or not t or t.get("busy_s", 0.0) <= 0.0:
        return None
    if not any(p in s for s in run.spans for p in PATHS):
        return None
    return sum(s.get(p, 0.0) for s in run.spans for p in PATHS) / len(run.spans) * 1e3
