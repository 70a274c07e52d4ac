"""stream_parse_ms: mean a job of a ``--stream`` run's ``stream.parse`` span,
each chunk's Seq2s read from stdin and encoded (``io/parse.py::iter_chunks``),
in ms (program_span).

Nothing where the program opens no such span."""

PATH = "stream.parse"


def read(run):
    if not run.spans or not any(PATH in s for s in run.spans):
        return None
    return sum(s.get(PATH, 0.0) for s in run.spans) / len(run.spans) * 1e3
