"""kernel_roofline: the least time the window's needed cells and bytes could
take at the card's peaks (``seqbench/roofline.py``) over the summed device
time of every kernel the window launched, scorers and epilogue alike, in
percent (device_trace)."""

from seqbench.roofline import least_seconds


def read(run):
    t = run.trace
    if not t or not t.get("cells") or t["kernel_s"] <= 0:
        return None
    return 100.0 * least_seconds(t["cells"], t["bytes"]) / t["kernel_s"]
