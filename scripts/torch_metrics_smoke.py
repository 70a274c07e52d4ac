#!/usr/bin/env python3
"""End-to-end smoke gate of the port's obs plane, the counterpart of
``scripts/metrics_smoke.py``.

    python3 scripts/torch_metrics_smoke.py                     # on the card
    python3 scripts/torch_metrics_smoke.py --device cpu --small

Runs the port's CLI with ``--metrics --metrics-out`` on the tiny fixture
and, without ``--small``, on the max-size workload too (both at once) (Seq1 3000, 64 Seq2
of 1200-1999, seed 7: ``models/workload.py::MAX_SIZE``), then gates every
artifact the plane promises:

* stdout is the run's golden (tiny's ``.out``; max-size's oracle rows);
* the JSON run report parses, passes ``obs.metrics.validate_report``,
  carries ``kind="run"`` with ``exit_code`` 0 and counted at least one
  dispatched chunk;
* the per-phase span section is present with non-negative durations;
* the ``.prom`` sidecar renders ``seqalign_chunks_dispatched_total``;
* on the card, each run launched a scorer kernel and the two runs
  together launched both.

Prints one JSON record (each run's counters and launches), then the OK
line, or every problem on a FAIL line; exits 0 or 1.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_drill_common as common  # noqa: E402

PROG = "torch_metrics_smoke"
TAG = "metrics-smoke"
FIXTURE = common.REPO / "tests" / "fixtures" / "tiny.txt"


def max_size_input(out: str):
    """``(input path, golden)`` of the max-size workload: ``golden()``
    is the port's numpy oracle's stdout."""
    from mpi_openmp_cuda_tpu_torch.models.encoding import decode
    from mpi_openmp_cuda_tpu_torch.models.workload import MAX_SIZE, synthetic_codes
    from mpi_openmp_cuda_tpu_torch.ops.oracle import prefix_best

    weights = [10, 2, 3, 4]
    seq1, seqs = synthetic_codes(*MAX_SIZE)
    path = os.path.join(out, "max-size.txt")
    with open(path, "w") as fh:
        fh.write(" ".join(map(str, weights)) + "\n" + decode(seq1) + "\n")
        fh.write(f"{len(seqs)}\n" + "".join(decode(s) + "\n" for s in seqs))

    def golden():
        return "".join(f"#{i}: score: {s}, n: {n}, k: {k}\n"
                       for i, (s, n, k) in enumerate(prefix_best(seq1, q, weights)
                                                     for q in seqs))

    return path, golden


def run_one(device: str, out: str, tag: str, input_path, golden, problems: list):
    """One CLI run of ``input_path``, ``golden()`` computed while it runs;
    its report, or None when the CLI failed."""
    report_path = os.path.join(out, f"{tag}.json")
    with open(input_path, "rb") as fh:
        proc = subprocess.Popen(
            common.cli_argv(device, "--metrics", "--metrics-out", report_path),
            stdin=fh, stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=common.REPO,
            env=common.drill_env(out))
    try:
        gold = golden()
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        sys.stderr.write(stderr.decode(errors="replace"))
        problems.append(f"{tag}: CLI exited {proc.returncode}")
        return None
    if stdout.decode() != gold:
        problems.append(f"{tag}: stdout differs from the golden")
    rec = common.load_report(report_path, problems, tag)
    if rec is not None:
        if rec["kind"] != "run":
            problems.append(f'{tag}: kind: want "run", got {rec["kind"]!r}')
        if rec.get("exit_code") != 0:
            problems.append(f"{tag}: exit_code: want 0, got {rec.get('exit_code')!r}")
        if not rec["counters"].get("chunks_dispatched"):
            problems.append(f"{tag}: counters.chunks_dispatched: want > 0")
        spans = rec.get("spans") or {}
        if not spans.get("phases"):
            problems.append(f"{tag}: spans.phases: want at least one recorded phase")
        if any(dur < 0 for _, dur in spans.get("phases", [])):
            problems.append(f"{tag}: spans.phases: negative duration")
    try:
        with open(report_path + ".prom", encoding="utf-8") as fh:
            prom = fh.read()
    except OSError as e:
        problems.append(f"{tag}: prom sidecar: {e}")
    else:
        if "seqalign_chunks_dispatched_total" not in prom:
            problems.append(f"{tag}: prom sidecar: missing seqalign_chunks_dispatched_total")
    return rec


def main(argv=None) -> int:
    args = common.parse_args(PROG, __doc__, argv)
    if not common.require_device(PROG, args.device):
        return 1
    out = tempfile.mkdtemp(prefix="torch_metrics_smoke_")
    runs = [("tiny", FIXTURE, FIXTURE.with_suffix(".out").read_text)]
    if not args.small:
        runs.append(("max-size", *max_size_input(out)))
    record = {"device": args.device, "small": args.small, "runs": {}}

    def scenario(tag, path, gold):
        def run(problems):
            rec = run_one(args.device, out, tag, path, gold, problems)
            if rec is None:
                return
            launches = common.launches_of(rec)
            if args.device == "cuda" and not sum(launches.values()):
                problems.append(f"{tag}: no scorer kernel launched ({launches})")
            record["runs"][tag] = {
                "chunks": rec["counters"].get("chunks_dispatched"),
                "phases": len((rec.get("spans") or {}).get("phases", [])),
                "counters": sorted(rec["counters"]), "launches": launches}
        return tag, run

    results = common.run_scenarios([scenario(*run) for run in runs])
    problems = [p for ps in results.values() for p in ps]
    scenarios = {tag: "fail" if ps else "ok" for tag, ps in results.items()}
    total = dict.fromkeys(common.KERNELS, 0)
    for run in record["runs"].values():
        common.add_launches(total, run["launches"])
    if not args.small:
        problems += common.launch_problems("runs", args.device, total)
    record.update(launches=total, scenarios=scenarios)
    chunks = {t: r["chunks"] for t, r in record["runs"].items()}
    return common.finish(TAG, problems, f"chunks={chunks}, launches={total}, "
                                        f"artifacts={out}", record)


if __name__ == "__main__":
    sys.exit(main())
