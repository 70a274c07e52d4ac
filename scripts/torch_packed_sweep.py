#!/usr/bin/env python3
"""Sweep of the packed scorer's warps a block on the card.

    python3 scripts/torch_packed_sweep.py
    python3 scripts/torch_packed_sweep.py --warps 4,8 --rounds 5

``csrc/packed_scorer.cu`` gives each (pair, 128-offset tile) a warp and a
block W such warps, which share one staged table and Seq1 window.  Each W
of ``--warps`` is a build with ``PACKED_WARPS`` = W (``nvcc -D``, into
``build/torch_kernels/``, all builds started together:
``_build.build_variants``), held exactly equal to ``packed_scorer_plain``
on every bucket of the workloads, then timed in ``--rounds`` interleaved
rounds: device ms of each bucket's launch (``utils.timing.time_ms``).  The
workloads are the 1024-short-row input (Seq1 3000, 1024 Seq2 of 5..64,
seed 7) split by ``dispatch.plan_buckets`` into its four class buckets,
every one forced through the packed kernel, and the same rows against
Seq1 1489.  The last line of stdout is a JSON object with the median ms
per build, Seq1 length and class, and the best W per cell.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from mpi_openmp_cuda_tpu_torch.ops import _build  # noqa: E402
from mpi_openmp_cuda_tpu_torch.ops import cuda_scorer as cs  # noqa: E402

DEFAULT_WARPS = "4,2,8,16"
WEIGHTS = [10, 2, 3, 4]
LEN1S = (3000, 1489)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warps", default=DEFAULT_WARPS,
                    help="comma-separated warps a block (at most 16)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    warps = [int(w) for w in args.warps.split(",")]
    if not torch.cuda.is_available():
        print("torch_packed_sweep: no CUDA device is available", file=sys.stderr)
        return 1
    from mpi_openmp_cuda_tpu_torch.models.workload import synthetic_codes
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import pad_problem, plan_buckets
    from mpi_openmp_cuda_tpu_torch.ops.values import value_table
    from mpi_openmp_cuda_tpu_torch.utils.timing import card_line, time_ms

    dev = torch.device("cuda")
    card = card_line()
    seq1, seqs = synthetic_codes(3000, 1024, 5, 64, 7)
    groups = plan_buckets([s.size for s in seqs])
    val = value_table(WEIGHTS).reshape(-1)
    work = {}  # "len1/l2s" -> state
    for len1 in LEN1S:
        for l2s, idx in sorted(groups.items()):
            batch = pad_problem(seq1[:len1], [seqs[i] for i in sorted(idx)])
            work[f"{len1}/{l2s}"] = (l2s, cs.state_from_numpy(
                batch.seq1ext, batch.len1, batch.seq2, batch.len2, val, dev))
    want = {key: cs.packed_scorer_plain(st, l2s) for key, (l2s, st) in work.items()}
    built = _build.build_variants(
        _build.CSRC_DIR / "packed_scorer.cu", {f"W{w}": (f"-DPACKED_WARPS={w}",) for w in warps})
    fns = {}
    for name, (lib, report) in built.items():
        regs = sorted({line.strip() for line in report.splitlines() if "registers" in line})
        print(f"built {name}: {regs}", flush=True)
        fns[name] = fn = cs.typed_entry(lib, "packed_scorer")
        for key, (l2s, st) in work.items():
            if not torch.equal(cs.call_entry(fn, st, l2s), want[key]):
                raise RuntimeError(f"{name} differs from plain at Seq1/class {key}")
    print(f"card {card}; {len(fns)} builds == plain on "
          f"{ {key: st.rows.shape[0] for key, (_, st) in work.items()} } rows", flush=True)
    ms = {name: {key: [] for key in work} for name in fns}
    for _ in range(max(1, args.rounds)):
        for name, fn in fns.items():
            for key, (l2s, st) in work.items():
                ms[name][key].append(time_ms(lambda: cs.call_entry(fn, st, l2s), args.reps))
    med = {name: {key: statistics.median(v) for key, v in per.items()}
           for name, per in ms.items()}
    for name, per in med.items():
        print(f"{name:4s} " + "  ".join(f"{key} {v:.6f}" for key, v in per.items()), flush=True)
    print(json.dumps({
        "card": card, "rounds": args.rounds, "reps": args.reps,
        "rows": {key: st.rows.shape[0] for key, (_, st) in work.items()},
        "ms": med,
        "best": {key: min(med, key=lambda n: med[n][key]) for key in work},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
