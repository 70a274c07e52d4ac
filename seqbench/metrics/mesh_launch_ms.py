"""mesh_launch_ms: mean a job of the batch mesh's ``shard_launch`` span, each
card's kernel and epilogue enqueued, in ms (program_span).

It prices a card deployment's launches, so it reads nothing where the window
saw no device activity (as on a CPU), and nothing where the program opens no
such span."""

PATH = "score.chunk_dispatch.shard_launch"


def read(run):
    t = run.trace
    if not run.spans or not t or t.get("busy_s", 0.0) <= 0.0:
        return None
    if not any(PATH in s for s in run.spans):
        return None
    return sum(s.get(PATH, 0.0) for s in run.spans) / len(run.spans) * 1e3
