#!/usr/bin/env python3
"""Packed vs fused scorer kernel on the card, across batch sizes per class.

    python3 scripts/torch_rowpack_sweep.py      # one CUDA device

For each packing class l2s in 8/16/32/64 and a range of batch sizes B
(Seq1 3000, every Seq2 of l2s/2+1..l2s chars, seeded), it times both
kernels of the PyTorch + CUDA port on the same bucket (CUDA events over
back-to-back launches, ``utils.timing.time_ms``), checks that they agree
exactly, and prints the fused kernel's grid in resident-block waves
(B x tiles over ``dispatch.resident_blocks``) beside the two times.  The
last line is a JSON object with every row and, per class, the smallest
wave count from which the packed kernel won at every larger size: the
crossover that ``dispatch.PACK_MIN_WAVES`` encodes.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# Packed blocks per offset tile: B = p x m rows for each m.
GROUPS = (4, 8, 16, 32, 48, 64, 88, 128, 176, 256, 512)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_rowpack_sweep: no CUDA device is available", file=sys.stderr)
        return 1
    from mpi_openmp_cuda_tpu_torch.ops import _build
    from mpi_openmp_cuda_tpu_torch.ops import cuda_scorer as cs
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import pad_problem, resident_blocks
    from mpi_openmp_cuda_tpu_torch.ops.values import value_table
    from mpi_openmp_cuda_tpu_torch.utils.timing import card_line, time_ms

    _build.build(["fused_scorer", "packed_scorer"])
    dev = torch.device("cuda")
    card = card_line()
    wave = resident_blocks(dev)
    print(f"card {card}; resident 128-thread blocks {wave}", flush=True)
    val = value_table([10, 2, 3, 4]).reshape(-1)
    rng = np.random.default_rng(7)
    seq1 = rng.integers(1, 27, size=3000).astype(np.int8)
    rows = []
    for l2s in cs.PACK_CLASSES:
        p = cs.TILE // l2s
        for m in GROUPS:
            b = p * m
            seqs = [
                rng.integers(1, 27, size=int(n)).astype(np.int8)
                for n in rng.integers(l2s // 2 + 1, l2s + 1, size=b)
            ]
            batch = pad_problem(seq1, seqs)
            st = cs.state_from_numpy(
                batch.seq1ext, batch.len1, batch.seq2, batch.len2, val, dev
            )
            if not torch.equal(cs.packed_scorer(st, l2s), cs.fused_scorer(st)):
                raise SystemExit(f"packed != fused at l2s={l2s}, B={b}")
            waves = b * (batch.l1p // cs.TILE) / wave
            packed_ms = time_ms(lambda: cs.packed_scorer(st, l2s), reps=50)
            fused_ms = time_ms(lambda: cs.fused_scorer(st), reps=50)
            rows.append({"l2s": l2s, "rows": b, "waves": waves,
                         "packed_ms": packed_ms, "fused_ms": fused_ms})
            print(f"l2s {l2s:2d} B {b:5d} waves {waves:7.3f}: packed "
                  f"{packed_ms:.6f} ms, fused {fused_ms:.6f} ms "
                  f"({fused_ms / packed_ms:.3f}x)", flush=True)
    crossover = {}
    for l2s in cs.PACK_CLASSES:
        mine = [r for r in rows if r["l2s"] == l2s]
        wins = [r["packed_ms"] < r["fused_ms"] for r in mine]
        first = next(
            (i for i in range(len(mine)) if all(wins[i:])), None
        )
        crossover[l2s] = None if first is None else mine[first]["waves"]
    print(json.dumps({"card": card, "resident_blocks": wave, "rows": rows,
                      "packed_wins_from_waves": crossover}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
