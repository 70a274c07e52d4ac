"""stream_window_wait_ms: mean a job of a ``--stream`` run's
``stream.window_wait`` span, the host's block on the oldest chunk's result
once its window of chunks in flight is full and at the stream's end (the
chunk's materialise: its gather and the wait on the card), in ms
(program_span).

Nothing where the program opens no such span."""

PATH = "stream.window_wait"


def read(run):
    if not run.spans or not any(PATH in s for s in run.spans):
        return None
    return sum(s.get(PATH, 0.0) for s in run.spans) / len(run.spans) * 1e3
