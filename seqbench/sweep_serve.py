"""The knee of the served deployment: a cell's request mix at rising rates.

    python3 -m seqbench.sweep_serve --workload serve-steady --seed <n> \\
        --seconds 10 --rates 300,400,500

starts one server (as the cell does), warms it, then offers each rate
open-loop for ``--seconds``, with a pause between rates for the queue to
drain, sampling the server's queue depth (the ``healthz`` verb) every
0.25 s.  A rate holds when every request is answered ``done`` and the
queue does not grow: the mean depth over the last third of the phase is
no more than 8 above that of the first third.  The knee is the highest
rate that holds below the first that fails; one JSON line a rate, then
``{"knee_rps": ...}``.  Run once on the card; the serve cells' rates are
fractions of its answer, written into their traffic files.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import threading
import time

from seqbench import generate, harness
from seqbench.drivers.serve import HOST, Child, entries, warm
from seqbench.loadgen import OpenLoop, command

GROWTH = 8


def depths(port: int, stop: threading.Event, out: list) -> None:
    while not stop.wait(0.25):
        try:
            out.append(command(HOST, port, "healthz")["status"]["queue_depth"])
        except (OSError, KeyError, ConnectionError):
            pass


def phase(ctx, port: int, rate: float, index: int) -> dict:
    traffic = {**ctx.traffic, "rate_rps": rate}
    offsets = generate.arrivals(ctx.seed + index, traffic, ctx.seconds)
    reqs = generate.requests(ctx.seed + index, ctx.config, traffic, len(offsets), f"s{index}-")
    loop = OpenLoop(HOST, port, entries(reqs, offsets), clients=int(traffic["clients"]))
    seen: list = []
    stop = threading.Event()
    sampler = threading.Thread(target=depths, args=(port, stop, seen), daemon=True)
    t0 = time.monotonic() + 0.2
    sampler.start()
    outs = loop.run(t0, float(traffic["grace_s"]))
    stop.set()
    sampler.join(5.0)
    kinds = {k: sum(o.kind == k for o in outs) for k in ("done", "refused", "failed", "missing", "reset")}
    lat = sorted(o.latency_s for o in outs if o.kind == "done")
    third = max(1, len(seen) // 3)
    head, tail = seen[:third], seen[-third:]
    grows = bool(seen) and statistics.fmean(tail) > statistics.fmean(head) + GROWTH
    return {
        "rate_rps": rate, "offered": len(outs), **kinds,
        "goodput_rps": kinds["done"] / ctx.seconds,
        "p50_ms": lat[len(lat) // 2] * 1e3 if lat else None,
        "p95_ms": lat[int(0.95 * (len(lat) - 1))] * 1e3 if lat else None,
        "depth_first_third": statistics.fmean(head) if head else None,
        "depth_last_third": statistics.fmean(tail) if tail else None,
        "depth_max": max(seen) if seen else None,
        "holds": kinds["done"] == len(outs) and not grows,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="seqbench.sweep_serve")
    p.add_argument("--workload", default="serve-steady")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rates", required=True, help="comma-separated req/s, rising")
    p.add_argument("--pause", type=float, default=3.0)
    args = p.parse_args(argv)
    ctx = harness.context(args.workload, args.seed, args.seconds, False)
    child = Child(ctx)
    knee = None
    try:
        port = child.wait_port(300.0)
        warm(port, generate.requests(ctx.seed, ctx.config, ctx.traffic,
                                     int(ctx.traffic["warm_requests"]), "w", stream=4),
             int(ctx.traffic["clients"]))
        for i, rate in enumerate(float(r) for r in args.rates.split(",")):
            row = phase(ctx, port, rate, i + 1)
            print(json.dumps(row), flush=True)
            if not row["holds"]:
                break
            knee = rate
            time.sleep(args.pause)
    finally:
        child.stop()
    print(json.dumps({"knee_rps": knee, "card": child.report and child.report.get("kind")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
