#!/usr/bin/env python3
"""Stage ablation of the port's fused scorer kernel on the card.

    python3 scripts/torch_kernel_ablate.py                  # max-size, every variant
    python3 scripts/torch_kernel_ablate.py --only nolookup,nomax --ab 5
    python3 scripts/torch_kernel_ablate.py --synthetic 1489x32x56-1152

``csrc/ablate_scorer.cu`` instantiates the kernels of ``csrc/fused_scorer.cu``
(the templates of ``csrc/fused_kernels.cuh``) once per variant; each
variant drops one stage of the kernel (the header lists them; ablations
are not composed) and ``base`` is the production kernel.  The wrapper
lives here and never in the production modules: ablations break semantics.

The workload (default: the max-size input, Seq1 3000 and 64 Seq2 of
1200..1999, seed 7; ``--synthetic L1xNxLO-HI`` or ``--input FILE`` for
another) is split into the scorer's own launches by
``dispatch.bucket_launches`` and every launch runs the fused design.
First ``base``, ``nostage``, ``nodiag`` and ``noskip`` are held exactly
equal to the production kernel on every launch and the other variants are
run once and synchronised.  Then each variant is timed against ``base``,
interleaved (base, variant, variant, base) in each of ``--ab`` passes:
device ms of all the launches back to back (CUDA events behind a sleeping
kernel, ``utils.timing.time_ms``), and the median over the passes of
(base - variant) / base, the share of the kernel's time that the dropped
stage holds.  The last line of stdout is a JSON object with every number.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from mpi_openmp_cuda_tpu_torch.ops import _build  # noqa: E402
from mpi_openmp_cuda_tpu_torch.ops import cuda_scorer as cs  # noqa: E402
from mpi_openmp_cuda_tpu_torch.ops.cuda_scorer import TILE, ScorerState  # noqa: E402

# The Variant enum of csrc/fused_kernels.cuh, in its order.
VARIANTS = ("base", "nostage", "nolookup", "nodiag", "nomax", "nocombine",
            "noreduce", "nok", "noskip")
# Variants that still compute the production rows.
EXACT = ("base", "nostage", "nodiag", "noskip")
WEIGHTS = [10, 2, 3, 4]

# Kernel launches of the wrapper: incremented only where it launches.
launch_counts = {"ablate_scorer": 0}


@functools.cache
def _entry():
    fn = _build.load("ablate_scorer").ablate_scorer_launch
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    # var, seq1ext, len1, rows, lens, batch, l2p, ntiles, val, partial, out,
    # stream
    fn.argtypes = [i, p, i, p, p, i, i, i, p, p, p, p]
    return fn


def ablate_scorer(state: ScorerState, var: str) -> torch.Tensor:
    """[B, 4] int32 rows of ``csrc/ablate_scorer.cu``'s ``var`` on CUDA
    tensors; on CPU tensors the plain version of the variants that keep
    the production rows (``cuda_scorer.fused_scorer_plain``)."""
    if var not in VARIANTS:
        raise ValueError(f"unknown variant {var!r}; expected one of {VARIANTS}")
    if cs._device_of(state) == "cpu":
        if var not in EXACT:
            raise ValueError(f"variant {var} has no plain version: it drops a stage")
        return cs.fused_scorer_plain(state)
    b, l2p = state.rows.shape
    ntiles = state.l1p // TILE
    dev = state.rows.device
    out = torch.empty((b, 4), dtype=torch.int32, device=dev)
    width = TILE * 2 if var == "noreduce" else 2
    partial = torch.empty((b, ntiles, width), dtype=torch.int32, device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(dev):
        err = _entry()(
            VARIANTS.index(var), ptr(state.seq1ext), state.len1, ptr(state.rows),
            ptr(state.lens), b, l2p, ntiles, ptr(state.val), ptr(partial), ptr(out),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    if err != 0:
        raise RuntimeError(f"ablate_scorer {var} launch failed: CUDA error {err}")
    launch_counts["ablate_scorer"] += 1
    return out


def parse_synthetic(spec: str) -> tuple[int, int, int, int]:
    """``"L1xNxLO-HI"`` -> (L1, N, LO, HI)."""
    try:
        l1, n, lohi = spec.split("x")
        lo, hi = lohi.split("-")
        return int(l1), int(n), int(lo), int(hi)
    except ValueError as e:
        raise ValueError(f"--synthetic wants L1xNxLO-HI, got {spec!r}") from e


def workload_launches(args, device):
    """(name, the workload's ``bucket_launches`` on ``device``)."""
    from mpi_openmp_cuda_tpu_torch.io.parse import load_problem
    from mpi_openmp_cuda_tpu_torch.models.workload import MAX_SIZE, synthetic_codes
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import bucket_launches

    if args.input:
        prob = load_problem(args.input)
        name, seq1, seqs, weights = args.input, prob.seq1_codes, prob.seq2_codes, prob.weights
    else:
        spec = parse_synthetic(args.synthetic) if args.synthetic else MAX_SIZE
        name = "x".join(map(str, spec[:2])) + f"x{spec[2]}-{spec[3]}"
        (seq1, seqs), weights = synthetic_codes(*spec), WEIGHTS
    return name, bucket_launches(seq1, seqs, weights, device)


def check_variants(launches) -> int:
    """Hold ``EXACT`` variants equal to ``fused_scorer`` on every launch
    and run the rest once; returns the max abs error (0) or raises."""
    err = 0
    for launch in launches:
        want = cs.fused_scorer(launch.state)
        for var in VARIANTS:
            got = ablate_scorer(launch.state, var)
            torch.cuda.synchronize()
            if var in EXACT:
                err = max(err, int((got.long() - want.long()).abs().max()))
                if not torch.equal(got, want):
                    raise RuntimeError(f"ablation {var} differs from fused_scorer")
    return err


def run_all(launches, var):
    for launch in launches:
        ablate_scorer(launch.state, var)


def time_variants(launches, variants, passes: int, reps: int) -> dict:
    """{variant: {"ms": [per pass], "base_ms": [per pass], "delta": [per
    pass]}} with every variant timed interleaved with base (base,
    variant, variant, base) in each pass; ``base`` itself gets its own
    two readings per pass."""
    from mpi_openmp_cuda_tpu_torch.utils.timing import time_ms

    def ms(var):
        return time_ms(lambda: run_all(launches, var), reps)

    out = {v: {"ms": [], "base_ms": [], "delta": []} for v in variants}
    for _ in range(passes):
        for var in variants:
            b0, v0, v1, b1 = ms("base"), ms(var), ms(var), ms("base")
            base, mine = (b0 + b1) / 2, (v0 + v1) / 2
            out[var]["ms"].append(mine)
            out[var]["base_ms"].append(base)
            out[var]["delta"].append((base - mine) / base)
    return out


def table(results) -> list[dict]:
    """Per variant: median ms, median base ms, median delta."""
    return [
        {
            "variant": var,
            "ms": statistics.median(r["ms"]),
            "base_ms": statistics.median(r["base_ms"]),
            "stage_share": statistics.median(r["delta"]),
        }
        for var, r in results.items()
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None, help="comma-separated variants")
    ap.add_argument("--ab", type=int, default=3, metavar="PASSES",
                    help="interleaved passes per variant; the median delta is reported")
    ap.add_argument("--synthetic", default=None, metavar="L1xNxLO-HI",
                    help="synthetic workload, seed 7 (default 3000x64x1200-1999)")
    ap.add_argument("--input", default=None, help="an input file instead")
    ap.add_argument("--reps", type=int, default=20, help="runs per timing")
    args = ap.parse_args(argv)
    variants = args.only.split(",") if args.only else list(VARIANTS)
    unknown = sorted(set(variants) - set(VARIANTS))
    if unknown or len(set(variants)) != len(variants):
        ap.error(f"--only: unknown or repeated variants {unknown or variants}")
    if not torch.cuda.is_available():
        print("torch_kernel_ablate: no CUDA device is available", file=sys.stderr)
        return 1
    from mpi_openmp_cuda_tpu_torch.utils.timing import card_line

    _build.build(["fused_scorer", "ablate_scorer"])
    card = card_line()
    name, launches = workload_launches(args, torch.device("cuda"))
    print(f"card {card}; workload {name}: {len(launches)} launches "
          f"{[(b.idx.size, b.state.rows.shape[1]) for b in launches]}", flush=True)
    check_variants(launches)
    print(f"{', '.join(EXACT)} == fused_scorer on every launch", flush=True)
    rows = table(time_variants(launches, variants, max(1, args.ab), args.reps))
    for r in rows:
        print(f"{r['variant']:9s} {r['ms']:.6f} ms  base {r['base_ms']:.6f} ms  "
              f"stage share {100 * r['stage_share']:+.1f} %", flush=True)
    print(json.dumps({"card": card, "workload": name, "passes": args.ab,
                      "reps": args.reps, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
