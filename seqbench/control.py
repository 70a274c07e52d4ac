"""The controls of ``correct``: the plain reference put in the program's
place, computed so as to break one guarantee the configurations state,
and judged exactly as a run's answers are.

    python3 -m seqbench.control --workload <cell> --seeds 1,2,3 [--seconds S]

``int16`` accumulates in 16 bits, the precision below the int32 the
configurations state (the step a 16-bit DPX kernel would take);
``last_hit`` breaks ties toward the last candidate instead of the first.
Each must read above a limit of 0 in some compared number of every cell.
The answers judged are those a run of the cell checks: the pool jobs (or
the requests, the longest among them) sampled from the seed.  One JSON
line a seed and control.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from seqbench import generate, harness, judge, reference

CONTROLS = {"int16": {"acc": np.int16}, "last_hit": {"last_hit": True}}


def readings(ctx, variant: dict) -> dict:
    """The compared numbers when the control answers in the program's place."""
    if ctx.config["kind"] == "batch":
        pool = generate.jobs(ctx.seed, ctx.config, ctx.traffic)
        checked = judge.sample(ctx.seed, range(len(pool)), int(ctx.traffic["check_jobs"]))
        texts = {i: pool[i].text for i in checked}
        outs = dict(zip(checked, judge.parallel(lambda i: reference.stdout(texts[i], **variant),
                                                checked)))
        checks, _ = judge.judge_batch(texts, outs, 0, 0)
    else:
        offsets = generate.arrivals(ctx.seed, ctx.traffic, ctx.seconds)
        reqs = generate.requests(ctx.seed, ctx.config, ctx.traffic, len(offsets), "r")
        longest = max(reqs, key=lambda r: r.cells).id
        checked = judge.sample(ctx.seed, [r.id for r in reqs], int(ctx.traffic["check_requests"]),
                               always=(longest,))
        raws = {r.id: r.raw for r in reqs if r.id in set(checked)}
        outs = dict(zip(checked, judge.parallel(lambda rid: judge.request_rows(raws[rid], **variant),
                                                checked)))
        checks, _ = judge.judge_serve(raws, outs, 0)
    return {k: v["value"] for k, v in checks.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="seqbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=None, help="default: BENCHMARK.json's run_seconds")
    p.add_argument("--controls", default=",".join(CONTROLS))
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.context(args.workload, seed, 0.0, False)
        ctx.seconds = args.seconds or float(ctx.bench["run_seconds"])
        for name in args.controls.split(","):
            row = {"workload": args.workload, "seed": seed, "control": name,
                   **readings(ctx, CONTROLS[name])}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
