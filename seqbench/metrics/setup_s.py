"""setup_s: process start to the first timed job or request (host clock)."""


def read(run):
    return run.setup_s
