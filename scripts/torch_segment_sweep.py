#!/usr/bin/env python3
"""Sweep of the fused scorer's char-segment constants on the card.

    python3 scripts/torch_segment_sweep.py
    python3 scripts/torch_segment_sweep.py --configs 32x8x2,32x16x1 --rounds 5
    python3 scripts/torch_segment_sweep.py --source other.cu --configs 32x8x2

``csrc/fused_scorer.cu`` splits the chars of one (pair, offset tile) over
warps: one segment per ``FUSED_SEG_CHARS`` chars of the padded row length,
at most ``FUSED_MAX_SEG`` a block, in one block or, past that, in a cluster
of ``FUSED_CLUSTER`` blocks.  Each config ``CHARSxMAXxCLUSTER`` is built
with those macros set (``nvcc -D``, into ``build/torch_kernels/``, all
builds started together: ``_build.build_variants``), held
exactly equal to ``fused_scorer_plain`` on every launch of the workloads
(max-size: Seq1 3000, 64 Seq2 of 1200..1999, in its five launches and
padded into one, a full card; input3-class: the bench's; short rows: Seq1
3000, 1024 Seq2 of 5..64, its four buckets all through this kernel), then
timed in ``--rounds`` interleaved rounds: device ms of each workload's
launches back to back (``utils.timing.time_ms``).  ``--source`` adds builds
of other source files with the same C entry, for an A/B of two designs in
one call.  The last line of stdout is a JSON object with the median ms per
build.
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

# More than 32 segments a cluster would pass the 48 KB of shared memory.
DEFAULT_CONFIGS = "32x8x2,64x8x2,16x8x2,32x16x1,32x8x1,32x4x4,32x12x2,32x16x2"
WEIGHTS = [10, 2, 3, 4]


def build_all(sources, configs) -> dict:
    """{``stem:CHARSxMAXxCLUSTER``: typed C entry} of every source under every
    config, one nvcc each, all started together."""
    builds = {}
    for src in sources:
        variants = {
            "x".join(map(str, cfg)): (f"-DFUSED_SEG_CHARS={cfg[0]}",
                                      f"-DFUSED_MAX_SEG={cfg[1]}",
                                      f"-DFUSED_CLUSTER={cfg[2]}")
            for cfg in configs
        }
        for tag, (lib, _) in _build.build_variants(src, variants).items():
            builds[f"{src.stem}:{tag}"] = cs.typed_entry(lib, "fused_scorer")
    return builds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", default=DEFAULT_CONFIGS,
                    help="comma-separated CHARSxMAXxCLUSTER triples")
    ap.add_argument("--source", action="append", default=[],
                    help="another source file with the same C entry (repeatable)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    configs = [tuple(int(x) for x in c.split("x")) for c in args.configs.split(",")]
    if not torch.cuda.is_available():
        print("torch_segment_sweep: no CUDA device is available", file=sys.stderr)
        return 1
    from mpi_openmp_cuda_tpu_torch.models.workload import (
        MAX_SIZE, input3_class_problem, synthetic_codes)
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import (
        BucketLaunch, bucket_launches, pad_problem)
    from mpi_openmp_cuda_tpu_torch.ops.values import value_table
    from mpi_openmp_cuda_tpu_torch.utils.timing import card_line, time_ms

    dev = torch.device("cuda")
    card = card_line()
    prob3 = input3_class_problem()
    seq1, seqs = synthetic_codes(*MAX_SIZE)
    one = pad_problem(seq1, seqs)  # max-size as one padded launch: a full card
    one = cs.state_from_numpy(one.seq1ext, one.len1, one.seq2, one.len2,
                              value_table(WEIGHTS).reshape(-1), dev)
    work = {
        "short rows": bucket_launches(*synthetic_codes(3000, 1024, 5, 64, 7), WEIGHTS, dev),
        "max-size": bucket_launches(seq1, seqs, WEIGHTS, dev),
        "input3-class": bucket_launches(
            prob3.seq1_codes, prob3.seq2_codes, prob3.weights, dev),
        "max-size in one": [BucketLaunch(None, one, None)],
    }
    want = {tag: [cs.fused_scorer_plain(b.state) for b in ls] for tag, ls in work.items()}
    sources = [_build.CSRC_DIR / "fused_scorer.cu", *(Path(s).resolve() for s in args.source)]
    builds = build_all(sources, configs)
    for name, fn in builds.items():
        for tag, launches in work.items():
            for launch, ref in zip(launches, want[tag]):
                if not torch.equal(cs.call_entry(fn, launch.state), ref):
                    raise RuntimeError(f"{name} differs from plain on {tag}")
    print(f"card {card}; {len(builds)} builds == plain on "
          f"{ {t: len(ls) for t, ls in work.items()} } launches", flush=True)
    ms = {name: {tag: [] for tag in work} for name in builds}
    for _ in range(max(1, args.rounds)):
        for name, fn in builds.items():
            for tag, launches in work.items():
                ms[name][tag].append(time_ms(
                    lambda: [cs.call_entry(fn, b.state) for b in launches], args.reps))
    rows = {name: {tag: statistics.median(v) for tag, v in per.items()}
            for name, per in ms.items()}
    for name, per in rows.items():
        print(f"{name:28s} " + "  ".join(f"{t} {v:.6f} ms" for t, v in per.items()),
              flush=True)
    print(json.dumps({"card": card, "rounds": args.rounds, "reps": args.reps, "ms": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
