"""Batch CLI: ``python -m mpi_openmp_cuda_tpu_torch < input.txt``.

Parse stdin (or ``--input``), score every Seq2 with ``AlignmentScorer``
on the chosen device, and print ``#i: score: S, n: N, k: K`` per Seq2 on
stdout.  Diagnostics go to stderr; on any failure nothing reaches stdout.
Exit codes: 0 ok, 64 usage (bad flags), 65 fatal (bad input, weights
outside the int32 gate, no CUDA device without ``--device cpu``, a
failed kernel build or launch), 1 when the reader of stdout went away.
"""

from __future__ import annotations

import argparse
import sys

from ..ops.dispatch import AlignmentScorer
from .parse import load_problem
from .printer import guarded_stdout, print_results, write_json_sidecar

EX_OK = 0
EX_USAGE = 64
EX_FATAL = 65

PROG = "mpi_openmp_cuda_tpu_torch"


class UsageError(Exception):
    """A bad command line (exit code 64)."""


class _Parser(argparse.ArgumentParser):
    def error(self, message):
        raise UsageError(message)


def build_arg_parser() -> argparse.ArgumentParser:
    p = _Parser(
        prog=PROG,
        description="Batch sequence-alignment scorer on PyTorch + CUDA "
        "(stdin/stdout contract of the MPI+OpenMP+CUDA reference).",
    )
    p.add_argument("--input", default=None, help="input file (default: stdin)")
    p.add_argument(
        "--backend",
        choices=("auto", "cuda", "oracle"),
        default="auto",
        help="compute path (default auto = cuda: the Hopper kernels, or "
        "their plain PyTorch versions on --device cpu); oracle = host numpy",
    )
    p.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="device to score on (default cuda; cpu only when asked for)",
    )
    p.add_argument(
        "--json", default=None, metavar="PATH",
        help="also write results as a JSON sidecar file",
    )
    return p


def run(argv: list[str] | None = None) -> int:
    try:
        args = build_arg_parser().parse_args(argv)
    except UsageError as e:
        print(f"{PROG}: usage: {e}", file=sys.stderr)
        return EX_USAGE
    try:
        problem = load_problem(args.input)
        scorer = AlignmentScorer(args.backend, device=args.device)
        # Native libraries (the CUDA runtime, nvcc's build) may write to
        # fd 1; only the result lines reach the real stdout.
        with guarded_stdout() as out:
            results = scorer.score_codes(
                problem.seq1_codes, problem.seq2_codes, problem.weights
            )
            if args.json:
                write_json_sidecar(
                    results, args.json,
                    meta={"backend": scorer.backend, "device": args.device},
                )
            print_results(results, out=out)
        return EX_OK
    except BrokenPipeError:
        return 1
    except Exception as e:  # fail-stop: diagnose on stderr, nonzero exit
        print(f"{PROG}: error: {e}", file=sys.stderr)
        return EX_FATAL


def main() -> None:
    sys.exit(run())
