#!/usr/bin/env python3
"""End-to-end wall of the port's batch mode, ``--stream`` and ``--stream
--journal`` on one workload.

    python3 scripts/torch_stream_bench.py               # on the card
    python3 scripts/torch_stream_bench.py --device cpu  # the plain versions

``--stream`` overlaps the host's parse of chunk i+1 with the device's
work on chunk i (``io/cli.py``); ``--journal`` adds a per-sequence
resume record on top.  This script puts a number on each: the same input
through the three modes, in this process through ``io.cli.run`` with
stdout captured, round-robin for ``STREAM_BENCH_ROUNDS`` rounds (default
5) inside probe-bracketed attempts (``bench.interleaved_gated_rounds``,
``STREAM_BENCH_ATTEMPTS``, default 6), so the modes' ratios survive a
neighbour's drift.  Each mode runs once to warm up first; every mode's
stdout must equal batch mode's byte for byte, else the script raises and
publishes no timing.  A journal run writes a fresh file each time, so no
run resumes from another's results.

The input (:func:`build_input`) is ``BENCH_INPUT`` when set, else the
input3-class workload (Seq1 1489, 32 Seq2 of 56..1152, weights 2 2 1
10), with its Seq2 list repeated ``STREAM_BENCH_REPLICAS`` times (default
8: 256 Seq2), in chunks of ``STREAM_BENCH_CHUNK`` (default 32, one
input3-class batch a chunk).

Output: one JSON line with each mode's median ``e2e_s``,
``stream_vs_batch``, ``journal_vs_stream``, ``rounds``, the card line
and, where a probe ran, ``probe_gated`` and ``gemm_probe_bf16_tflops``.
Without a card it exits 1 unless ``--device cpu`` is given.
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

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

PROG = "torch_stream_bench"
MODES = ("batch", "stream", "stream+journal")


def build_input(replicas: int) -> tuple[str, int]:
    """``(path, number of Seq2)`` of a temporary input: ``BENCH_INPUT`` or
    the input3-class workload, its Seq2 list repeated ``replicas`` times.
    The synthetic text is ``scripts/stream_bench.py``'s byte for byte."""
    from mpi_openmp_cuda_tpu_torch.models.encoding import decode

    src = os.environ.get("BENCH_INPUT")
    if src:
        toks = Path(src).read_text().split()
        weights, seq1, n = toks[:4], toks[4], int(toks[5])
        seqs = toks[6:6 + n]
    else:
        rng = np.random.default_rng(3)
        weights = ["2", "2", "1", "10"]
        seq1 = decode(rng.integers(1, 27, size=1489))
        seqs = [decode(rng.integers(1, 27, size=int(n)))
                for n in rng.integers(56, 1153, size=32)]
    seqs = seqs * replicas
    fd, path = tempfile.mkstemp(suffix=".txt", prefix="stream_bench_")
    with os.fdopen(fd, "w") as fh:
        fh.write(" ".join(weights) + "\n" + seq1 + "\n")
        fh.write(f"{len(seqs)}\n" + "\n".join(seqs) + "\n")
    return path, len(seqs)


def run_mode(argv: list[str]) -> bytes:
    """One ``io.cli.run(argv)`` in this process, its stdout (file
    descriptor 1: the CLI prints through a duplicate of it) captured and
    returned; a non-zero exit raises."""
    from mpi_openmp_cuda_tpu_torch.io import cli

    sys.stdout.flush()
    saved = os.dup(1)
    with tempfile.TemporaryFile() as cap:
        try:
            os.dup2(cap.fileno(), 1)
            rc = cli.run(argv)
            sys.stdout.flush()
        finally:
            os.dup2(saved, 1)
            os.close(saved)
        cap.seek(0)
        out = cap.read()
    if rc != 0:
        raise RuntimeError(f"cli.run({argv}) -> rc {rc}")
    return out


def check_identical(outputs: dict) -> None:
    """Every mode's stdout equals batch mode's, or no timing is published."""
    for mode, out in outputs.items():
        if out != outputs["batch"]:
            raise RuntimeError(f"mode {mode} output diverges from batch; refusing to "
                               "publish timings for non-identical output")


def measure_modes(mode_args, rounds: int, golden: bytes, run=run_mode) -> dict:
    """Median wall of each mode over ``rounds`` round-robin rounds; every
    run's stdout must be ``golden``."""
    walls = {m: [] for m in MODES}
    for _ in range(rounds):
        for m in MODES:
            argv = mode_args(m)
            t0 = time.perf_counter()
            out = run(argv)
            walls[m].append(time.perf_counter() - t0)
            check_identical({"batch": golden, m: out})
    return {m: statistics.median(w) for m, w in walls.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG, description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to score on (default cuda; cpu only when asked for)")
    args = ap.parse_args(argv)
    import torch

    from mpi_openmp_cuda_tpu_torch import bench

    if args.device == "cuda" and not torch.cuda.is_available():
        print(f"{PROG}: error: no CUDA device is available (--device cpu scores "
              "with the plain versions)", file=sys.stderr)
        return 1
    replicas = int(os.environ.get("STREAM_BENCH_REPLICAS", "8"))
    rounds = int(os.environ.get("STREAM_BENCH_ROUNDS", "5"))
    max_attempts = int(os.environ.get("STREAM_BENCH_ATTEMPTS", "6"))
    chunk = os.environ.get("STREAM_BENCH_CHUNK", "32")
    device = torch.device(args.device)
    on_card, _, gate = bench.probe_gate(device)
    if on_card:
        from mpi_openmp_cuda_tpu_torch.utils.timing import card_line

        card = card_line()
    else:
        card = "cpu"
    path, n_seqs = build_input(replicas)
    with tempfile.TemporaryDirectory(prefix="stream_bench_j_") as jdir:
        def mode_args(mode):
            base = ["--input", path, "--device", args.device]
            if mode == "batch":
                return base
            if mode == "stream":
                return [*base, "--stream", chunk]
            # A fresh journal each run: a resume must never skip the work timed.
            jp = os.path.join(jdir, f"j{time.monotonic_ns()}.jsonl")
            return [*base, "--stream", chunk, "--journal", jp]

        try:
            warm = {m: run_mode(mode_args(m)) for m in MODES}
            check_identical(warm)
            med, attempt, gated = bench.interleaved_gated_rounds(
                lambda: measure_modes(mode_args, rounds, warm["batch"]),
                bench.probe_or_none if on_card else None,
                gate=gate, max_attempts=max_attempts)
            size = os.path.getsize(path)
        finally:
            os.unlink(path)
    source = os.path.basename(os.environ.get("BENCH_INPUT") or "input3-class")
    rec = {
        "metric": f"streaming e2e, {source} x{replicas} ({n_seqs} sequences)",
        "e2e_s": med,
        "stream_vs_batch": med["stream"] / med["batch"],
        "journal_vs_stream": med["stream+journal"] / med["stream"],
        "rounds": rounds,
        "card": card,
    }
    if attempt.pmin is not None:
        rec["probe_gated"] = bool(gated)
        rec["gemm_probe_bf16_tflops"] = attempt.pmin
    print(json.dumps(rec), flush=True)
    print(f"[stream-bench] {card}; input {size} bytes, chunk {chunk}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
