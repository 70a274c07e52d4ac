#!/usr/bin/env python3
"""The port's warm batch-CLI wall on max-size, for an A/B of two trees.

    python3 scripts/torch_cli_wall.py [--root DIR] [--reps N]   # one CUDA device

Imports ``mpi_openmp_cuda_tpu_torch`` from ``DIR`` (default: this
checkout; a ``git archive`` of another commit unpacked elsewhere gives
the other side of an A/B), writes the max-size input (Seq1 3000, 64 Seq2
of 1200..1999, seed 7, weights 10 2 3 4), runs ``io.cli.run`` on it once
in this process to build and load the kernels, then ``N`` more times
(default 20), each the CLI's whole run (parse, pad, copy in, launch,
copy out, print to ``/dev/null``) on the host clock.  Run the two trees
in turns in one call (A, B, B, A): host walls differ between machines
far more than between two trees on one.

The last line of stdout is a JSON object: the root, the walls in ms,
their minimum and median, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        print("torch_cli_wall: no CUDA device is available", file=sys.stderr)
        return 1
    from mpi_openmp_cuda_tpu_torch.io import cli
    from mpi_openmp_cuda_tpu_torch.models.workload import MAX_SIZE, synthetic_codes
    from mpi_openmp_cuda_tpu_torch.utils.timing import card_line

    seq1, seqs = synthetic_codes(*MAX_SIZE)

    def text(codes):
        return bytes((codes + 64).astype("uint8")).decode()

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "max-size.txt"
        path.write_text("10 2 3 4\n" + text(seq1) + f"\n{len(seqs)}\n"
                        + "".join(text(s) + "\n" for s in seqs))
        saved = os.dup(1)
        null = os.open(os.devnull, os.O_WRONLY)
        walls = []
        try:
            os.dup2(null, 1)
            for _ in range(args.reps + 1):
                t0 = time.perf_counter()
                rc = cli.run(["--input", str(path)])
                walls.append((time.perf_counter() - t0) * 1e3)
                if rc != 0:
                    raise SystemExit(f"torch_cli_wall: the CLI exited {rc}")
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
            os.close(null)
    walls = walls[1:]  # the first run builds and loads the kernels
    print(json.dumps({"root": args.root, "walls_ms": walls, "min_ms": min(walls),
                      "median_ms": statistics.median(walls), "card": card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
