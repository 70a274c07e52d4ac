"""mesh_cards_concurrent: how many cards of a mesh worked at once, on average
over the time any of them worked: the sum of each card's busy seconds in the
window over the union of all cards' (device_trace).  1.0 when the cards take
turns, 4.0 when four work at once throughout.

It reads the per-card split that ``drivers/batch_mesh.py`` adds to the trace
summary, so nothing where there is none, or where the window saw no device
activity (as on a CPU)."""


def read(run):
    t = run.trace
    if not t or not t.get("cards") or t.get("busy_s", 0.0) <= 0.0:
        return None
    return sum(c["busy_s"] for c in t["cards"].values()) / t["busy_s"]
