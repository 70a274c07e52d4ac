"""serve_goodput_rps: requests due in the window answered done with every
row by the window's close, a second of the window (host clock).  Answers
that come in the grace time after the close are work the window did not
finish and count nowhere."""


def read(run):
    if not run.outcomes:
        return None
    return sum(o.kind == "done" and o.end_s <= run.window_s for o in run.outcomes) / run.window_s
