#!/usr/bin/env python3
"""The fused scorer's floor on the card, term by term, from measured
issue rates.

    python3 scripts/torch_issue_floor.py      # one CUDA device

1. Measures the issue-rate probe's three rates (``ops/probe.py::
   issue_probe_gelems``: fp32 FFMA, int32 IMAD, conflict-free shared
   loads) in 3 interleaved rounds and takes each op's median.
2. For the input3-class and the max-size workloads, counts the work of
   the scorer's own launches (``ops/costs.schedule_counts`` over
   ``dispatch.bucket_launches``) and prints each floor term (int ops over
   the ``arith`` rate, table lookups over the ``lookup`` rate, bytes over
   HBM) at its measured rate and at its data-sheet peak, beside the
   measured time of one run of the launches storing finished rows (device
   time, ``utils.timing.time_ms``).  One more line prices what the fused
   kernel's char loop issues per cell (``csrc/fused_kernels.cuh``; counted
   in its SASS, per pass of 4 steps x 4 offsets: 25 shared loads, i.e.
   20 lookups, 4 window chars and one 16-byte Seq2 load, and 57 int ops,
   i.e. 20 address adds, 21 prefix adds and 16 fused difference-max) at
   the measured rates; the bound counts the 1 lookup and 3 int ops a cell
   needs.  The scorer kernels alone (raw rows) are timed too, with each
   fused launch's live (pair, offset tile) clusters, those with a valid
   offset, beside the blocks the card holds at once
   (``probe.resident_blocks``).

The last line of stdout is a JSON object with every number.
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

ROUNDS = 3
ISSUED_LOADS_PER_CELL = 25 / 16
ISSUED_INT_OPS_PER_CELL = 57 / 16


def live_blocks(len1: int, lens, ntiles: int) -> int:
    """(pair, tile) clusters of a fused launch that pass its offset-tile
    skip: per pair, tile 0 and every tile holding an offset n < len1 - len2."""
    return sum(min(ntiles, max(1, -(-(len1 - n) // 128))) for n in lens)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_issue_floor: no CUDA device is available", file=sys.stderr)
        return 1
    from mpi_openmp_cuda_tpu_torch.models.workload import (
        MAX_SIZE, input3_class_problem, synthetic_codes,
    )
    from mpi_openmp_cuda_tpu_torch.ops import _build, costs
    from mpi_openmp_cuda_tpu_torch.ops.cuda_scorer import (
        TILE, fused_scorer, packed_scorer, score_rows,
    )
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import bucket_launches
    from mpi_openmp_cuda_tpu_torch.ops.probe import OPS, issue_probe_gelems, resident_blocks
    from mpi_openmp_cuda_tpu_torch.utils.timing import card_line, time_ms

    _build.build(["fused_scorer", "packed_scorer", "issue_probe"])
    dev = torch.device("cuda")
    card = card_line()
    print(f"card {card}", flush=True)
    rounds = {op: [] for op in OPS}
    for r in range(ROUNDS):
        for op in OPS:
            rounds[op].append(issue_probe_gelems(op, dev))
        print(f"round {r}: " + " ".join(
            f"{op}={rounds[op][-1] / 1e9:.3f}" for op in OPS) + " Gelem/s", flush=True)
    rate = {op: statistics.median(v) for op, v in rounds.items()}
    for op in OPS:
        print(f"{op}: median {rate[op] / 1e9:.3f} Gelem/s = "
              f"{100 * rate[op] / costs.PEAK_PER_S[op]:.2f} % of the data-sheet peak "
              f"{costs.PEAK_PER_S[op] / 1e9:.1f}", flush=True)

    p3 = input3_class_problem()
    seq1_m, seqs_m = synthetic_codes(*MAX_SIZE)
    workloads = {
        "input3-class": (p3.seq1_codes, p3.seq2_codes, p3.weights),
        "max-size": (seq1_m, seqs_m, [10, 2, 3, 4]),
    }
    report = {"card": card, "resident_blocks": resident_blocks(dev), "rates": rate, "rounds": rounds, "workloads": {}}
    for name, (seq1, seqs, weights) in workloads.items():
        launches = bucket_launches(seq1, seqs, weights, dev)
        counts = costs.schedule_counts(launches)

        def run():
            for b in launches:
                score_rows(b.state, b.l2s)

        def kernels():
            for b in launches:
                if b.l2s is None:
                    fused_scorer(b.state)
                else:
                    packed_scorer(b.state, b.l2s)

        wall_ms = time_ms(run, reps=10)
        kernel_ms = time_ms(kernels, reps=10)
        live = [live_blocks(b.state.len1, b.state.lens.tolist(), b.state.l1p // TILE)
                for b in launches if b.l2s is None]
        measured = costs.floor_terms(counts, rate["arith"], rate["lookup"])
        peak = costs.floor_terms(counts, costs.INT32_OPS_PER_S, costs.SMEM_WORDS_PER_S)
        issued_ms = ISSUED_LOADS_PER_CELL * counts.cells / rate["lookup"] * 1e3
        issued_int_ms = ISSUED_INT_OPS_PER_CELL * counts.cells / rate["arith"] * 1e3
        print(f"{name}: {len(launches)} launches, {counts.cells} cells, "
              f"{counts.bytes} bytes; measured {wall_ms:.6f} ms, the kernels "
              f"alone {kernel_ms:.6f} ms; fused live clusters per launch {live}; "
              f"{resident_blocks(dev)} blocks resident [{card}]", flush=True)
        for term in measured:
            print(f"  {term:8s}: {measured[term] * 1e3:.6f} ms at the measured rate, "
                  f"{peak[term] * 1e3:.6f} ms at the data-sheet peak", flush=True)
        floor_s, floor_by = costs.binding(measured)
        bound_s, bound_by = costs.binding(peak)
        print(f"  floor {floor_s * 1e3:.6f} ms ({floor_by}), wall/floor "
              f"{wall_ms / 1e3 / floor_s:.3f}; bound {bound_s * 1e3:.6f} ms "
              f"({bound_by}), wall/bound {wall_ms / 1e3 / bound_s:.3f}; "
              f"issued per cell at the measured rates: {ISSUED_LOADS_PER_CELL} "
              f"shared loads {issued_ms:.6f} ms, {ISSUED_INT_OPS_PER_CELL} int "
              f"ops {issued_int_ms:.6f} ms", flush=True)
        report["workloads"][name] = {
            "launches": len(launches), "cells": counts.cells, "bytes": counts.bytes,
            "wall_ms": wall_ms, "kernel_ms": kernel_ms, "live_blocks": live,
            "floor_ms_measured": {k: v * 1e3 for k, v in measured.items()},
            "floor_ms_peak": {k: v * 1e3 for k, v in peak.items()},
            "issued_loads_ms": issued_ms, "issued_int_ops_ms": issued_int_ms,
        }
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
