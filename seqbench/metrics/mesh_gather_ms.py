"""mesh_gather_ms: mean a job of the batch mesh's ``shard_gather`` span, the
shards back to the host (``MPI_Gather``), in ms (program_span).  The host's
wait on the cards before it is ``dispatch_device_wait_ms``'s
``score.chunk_gather.device_wait``.

It prices a card deployment's gather, so it reads nothing where the window
saw no device activity (as on a CPU), and nothing where the program opens no
such span."""

PATH = "score.chunk_gather.shard_gather"


def read(run):
    t = run.trace
    if not run.spans or not t or t.get("busy_s", 0.0) <= 0.0:
        return None
    if not any(PATH in s for s in run.spans):
        return None
    return sum(s.get(PATH, 0.0) for s in run.spans) / len(run.spans) * 1e3
