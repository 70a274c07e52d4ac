#!/usr/bin/env python3
"""Packed vs fused scorer kernel on the card, across batch sizes per class.

    python3 scripts/torch_rowpack_sweep.py                 # Seq1 3000 and 1489
    python3 scripts/torch_rowpack_sweep.py --len1 3000     # one CUDA device

For each Seq1 length (``--len1``, comma-separated), each packing class l2s
in 8/16/32/64 and each batch size B in :data:`ROWS` (every Seq2 of
l2s/2+1..l2s chars, seeded), it times both kernels of the PyTorch + CUDA
port on the same bucket (CUDA events over back-to-back launches,
``utils.timing.time_ms``), checks that they agree exactly, and prints the
fused kernel's grid in resident-block waves (B x tiles over
``probe.resident_blocks``) beside the two times.  Per Seq1 length and
class it then prints the crossover: the smallest B, and its waves, from
which the packed kernel won at every larger size (none: the fused kernel
won at the largest).  The last line is a JSON object with every row and
crossover: what ``dispatch.choose_rowpack`` encodes.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# Batch sizes swept in every class.
ROWS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def main(argv=None) -> int:
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--len1", default="3000,1489",
                    help="comma-separated Seq1 lengths (at most 3000)")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    len1s = [int(x) for x in args.len1.split(",")]
    if not torch.cuda.is_available():
        print("torch_rowpack_sweep: no CUDA device is available", file=sys.stderr)
        return 1
    from mpi_openmp_cuda_tpu_torch.ops import _build
    from mpi_openmp_cuda_tpu_torch.ops import cuda_scorer as cs
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import pad_problem
    from mpi_openmp_cuda_tpu_torch.ops.probe import resident_blocks
    from mpi_openmp_cuda_tpu_torch.ops.values import value_table
    from mpi_openmp_cuda_tpu_torch.utils.timing import card_line, time_ms

    _build.build(["fused_scorer", "packed_scorer"])
    dev = torch.device("cuda")
    card = card_line()
    wave = resident_blocks(dev)
    print(f"card {card}; resident 128-thread blocks {wave}", flush=True)
    val = value_table([10, 2, 3, 4]).reshape(-1)
    rng = np.random.default_rng(7)
    rows, crossover = [], {}
    for len1 in len1s:
        seq1 = rng.integers(1, 27, size=len1).astype(np.int8)
        for l2s in cs.PACK_CLASSES:
            mine = []
            for b in ROWS:
                seqs = [
                    rng.integers(1, 27, size=int(n)).astype(np.int8)
                    for n in rng.integers(l2s // 2 + 1, l2s + 1, size=b)
                ]
                batch = pad_problem(seq1, seqs)
                st = cs.state_from_numpy(
                    batch.seq1ext, batch.len1, batch.seq2, batch.len2, val, dev
                )
                if not torch.equal(cs.packed_scorer(st, l2s), cs.fused_scorer(st)):
                    raise SystemExit(f"packed != fused at len1={len1}, l2s={l2s}, B={b}")
                waves = b * (batch.l1p // cs.TILE) / wave
                packed_ms = time_ms(lambda: cs.packed_scorer(st, l2s), reps=args.reps)
                fused_ms = time_ms(lambda: cs.fused_scorer(st), reps=args.reps)
                mine.append({"len1": len1, "l2s": l2s, "rows": b, "waves": waves,
                             "packed_ms": packed_ms, "fused_ms": fused_ms})
                print(f"len1 {len1} l2s {l2s:2d} B {b:5d} waves {waves:7.3f}: packed "
                      f"{packed_ms:.6f} ms, fused {fused_ms:.6f} ms "
                      f"({fused_ms / packed_ms:.3f}x)", flush=True)
            wins = [r["packed_ms"] < r["fused_ms"] for r in mine]
            first = next((i for i in range(len(mine)) if all(wins[i:])), None)
            cross = None if first is None else {
                "rows": mine[first]["rows"], "waves": mine[first]["waves"]}
            crossover[f"{len1}/{l2s}"] = cross
            print(f"crossover len1 {len1} l2s {l2s}: packed wins from "
                  + ("no size swept" if cross is None else
                     f"B {cross['rows']} ({cross['waves']:.3f} waves)"), flush=True)
            rows += mine
    print(json.dumps({"card": card, "resident_blocks": wave, "rows": rows,
                      "packed_wins_from": crossover}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
