"""One run of one cell on the card:

    python3 -m seqbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It refuses to run (exit 1, no result)
without as many CUDA cards as the cell asks for, prints what it compared
with each limit as its last lines on stderr, and as the last line of
stdout one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``.  Where this process, or the server child of a serve cell,
holds JAX or the JAX package when the window has closed, it exits 1 and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from seqbench import harness


def main(argv: list[str] | None = None) -> int:
    started = harness.process_start()
    p = argparse.ArgumentParser(prog="seqbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    ctx = harness.context(args.workload, args.seed, args.seconds, bool(args.trace), started=started)
    # The deployment's environment, before the first import of torch.
    os.environ.update(ctx.config.get("env", {}))
    import torch

    need = int(ctx.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"seqbench: error: cell {args.workload!r} needs {need} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 1
    return emit(*harness.measure(ctx))


def emit(result: dict, run: harness.Run) -> int:
    """Print a measured run: its notes, each check beside its limit on
    stderr, and the result line; or, where this process or the server
    holds JAX or the JAX package, only that, and exit 1."""
    for line in run.notes:
        print(line, flush=True)
    held = harness.held_modules(run)
    if held:
        print(f"seqbench: error: the run's processes hold {', '.join(held)}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
