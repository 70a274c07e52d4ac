#!/usr/bin/env python3
"""The port's bench table: each workload row through the port's bench in
several processes, with the spread of its device wall.

    python3 scripts/torch_bench_table.py                      # the card rows
    python3 scripts/torch_bench_table.py --procs 2 --rows input3-class,gather
    python3 scripts/torch_bench_table.py --device cpu         # the CPU row
    python3 scripts/torch_bench_table.py --from-json records.ndjson

Each row writes its workload to an input file and runs ``python -m
mpi_openmp_cuda_tpu_torch.bench`` with ``BENCH_INPUT`` naming it (and
``BENCH_WEIGHTS`` where the row sets weights) in ``--procs`` separate
processes, one after another.  It prints each process's
``device_wall_us`` and ``formulation``, then the row: the min, median
and max ``device_wall_us``, elements/s at the median wall, the median
``e2e_warm_s``, the formulation and the card line.  One process alone
cannot say whether a later wall differs: this spread is what two walls
are compared against.  The last line of stdout is a JSON object with
every row's numbers; ``--records PATH`` also writes every bench record
read, one a line, for ``--from-json``.

Rows (``--rows`` names them; default all but ``cpu``):

* ``input3-class``: the bench's own workload (``models/workload.py``),
  weights 2 2 1 10;
* ``input4-class``: Seq1 2976 against 30 Seq2 of 5..64, seed 7
  (``models/workload.py::input4_problem``), the packed kernel's row;
* ``max-size``: Seq1 3000 against 64 Seq2 of 1200..1999, seed 7,
  weights 10 2 3 4, and ``skew``: Seq1 1489 against 64 Seq2 of
  1430..1486, seed 11 (``scripts/bench_table.py``'s draws, byte for
  byte: :func:`synthetic_max`, :func:`synthetic_skew`);
* ``gather``: input3-class at ``BENCH_WEIGHTS=1000000,1,1,1``, where its
  one launch (longest scored row 1122) is past the kernels' int32 window
  and routes to ``gather``.  The TPU table's ``40000,7,1,2`` stays on
  the kernels here: Hopper's int32 window (``2 * len2 * max|v| <
  2^31``) is wider than the TPU's feeds;
* ``input1``, ``input2``, ``input5``, ``input6``: the reference's own
  inputs, measured only where ``REFERENCE_DIR`` holds them, else named
  as skipped with no number;
* ``cpu``: input3-class with ``--device cpu`` (the plain versions; the
  only row ``--device cpu`` runs, and it has no device wall).

Without a card and without ``--device cpu`` the script exits 1; it never
falls back to the CPU.  The port's bench has no ``vs_baseline``, so the
"vs est. reference" column reads ``n/a``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

PROG = "torch_bench_table"
PKG = "mpi_openmp_cuda_tpu_torch"
GATHER_WEIGHTS = "1000000,1,1,1"
REFERENCE_ROWS = ("input1", "input2", "input5", "input6")
CARD_ROWS = ("input3-class", "input4-class", "max-size", "skew", "gather", *REFERENCE_ROWS)
# The bench variables a row sets; the others (BENCH_REPS, BENCH_ATTEMPTS)
# pass through to every process.
ROW_VARS = ("BENCH_INPUT", "BENCH_WEIGHTS", "BENCH_BACKEND")


def _problem(weights, seq1: str, seqs: list[str]):
    from mpi_openmp_cuda_tpu_torch.io.parse import Problem
    from mpi_openmp_cuda_tpu_torch.models.encoding import encode_normalized

    return Problem(weights=list(weights), seq1=seq1, seq2=seqs,
                   seq1_codes=encode_normalized(seq1),
                   seq2_codes=[encode_normalized(s) for s in seqs])


def _synthetic(seq1_len: int, lens_draw, seed: int = 7):
    """``scripts/bench_table.py::_synthetic``: ``lens_draw(rng)`` runs after
    the Seq1 draw on the same generator."""
    from mpi_openmp_cuda_tpu_torch.models.encoding import decode

    rng = np.random.default_rng(seed)
    seq1 = decode(rng.integers(1, 27, size=seq1_len))
    lens2 = [int(x) for x in lens_draw(rng)]
    return _problem([10, 2, 3, 4], seq1, [decode(rng.integers(1, 27, size=n)) for n in lens2])


def synthetic_max():
    """Max-size: Seq1 at its 3000-char cap, 64 Seq2 of 1200..1999 chars."""
    return _synthetic(3000, lambda rng: rng.integers(1200, 2000, size=64))


def synthetic_skew():
    """Length skew: every Seq2 within 4 % of Seq1's 1489 chars, so few
    offsets are valid and most of each tile's lanes are dead."""
    return _synthetic(1489, lambda rng: rng.integers(1430, 1487, size=64), seed=11)


def input4_class():
    from mpi_openmp_cuda_tpu_torch.models.encoding import decode
    from mpi_openmp_cuda_tpu_torch.models.workload import input4_problem

    seq1, seqs = input4_problem()
    return _problem([10, 2, 3, 4], decode(seq1), [decode(s) for s in seqs])


def problem_text(problem) -> str:
    """The stdin contract's text of a problem."""
    return "\n".join([" ".join(str(w) for w in problem.weights), problem.seq1,
                      str(len(problem.seq2)), *problem.seq2]) + "\n"


def fixture_path(name: str) -> Path:
    """A reference input under ``REFERENCE_DIR``; FileNotFoundError when
    the variable is unset or the file is not there."""
    base = os.environ.get("REFERENCE_DIR")
    path = Path(base or "") / f"{name}.txt"
    if not base or not path.is_file():
        raise FileNotFoundError(f"{name}.txt (REFERENCE_DIR={base or 'unset'})")
    return path


def row_spec(row: str, tmp: Path) -> tuple[Path, dict, list[str]]:
    """``(input file, bench variables, bench arguments)`` of one row; the
    file is written under ``tmp`` (a reference row reads its own)."""
    from mpi_openmp_cuda_tpu_torch.models.workload import input3_class_problem

    if row in REFERENCE_ROWS:
        return fixture_path(row), {}, []
    make = {"input3-class": input3_class_problem, "gather": input3_class_problem,
            "cpu": input3_class_problem, "input4-class": input4_class,
            "max-size": synthetic_max, "skew": synthetic_skew}[row]
    name = "input3-class" if row in ("gather", "cpu") else row
    path = tmp / f"{name}.txt"
    if not path.exists():
        path.write_text(problem_text(make()))
    env = {"BENCH_WEIGHTS": GATHER_WEIGHTS} if row == "gather" else {}
    return path, env, ["--device", "cpu"] if row == "cpu" else []


def run_bench(path: Path, env_extra: dict, args: list[str], timeout: float = 600) -> dict:
    """One bench process on ``path``: its record, validated and unwrapped
    as :func:`load_bench_records` unwraps it, plus the wrapped line."""
    env = {k: v for k, v in os.environ.items() if k not in ROW_VARS}
    env.update(BENCH_INPUT=str(path), **env_extra)
    proc = subprocess.run([sys.executable, "-m", f"{PKG}.bench", *args], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=timeout)
    lines = [line for line in proc.stdout.splitlines() if line.strip()]
    if proc.returncode != 0 or len(lines) != 1:
        raise RuntimeError(f"the bench exited {proc.returncode} with {len(lines)} stdout "
                           f"lines; stderr:\n{proc.stderr[-4000:]}")
    return {"line": lines[0], **_unwrap(json.loads(lines[0]))}


def summarize(row: str, records: list[dict], elements: int) -> dict:
    """A row's numbers over its processes' records."""
    walls = [r.get("device_wall_us") for r in records]
    walls = [w for w in walls if w is not None]
    med = statistics.median(walls) if walls else None
    return {
        "row": row,
        "metric": records[0]["metric"],
        "formulation": sorted({r["formulation"] for r in records}),
        "device": records[0]["device"],
        "power_limit_w": records[0].get("power_limit_w"),
        "procs": len(records),
        "device_wall_us": walls,
        "device_wall_us_min": min(walls) if walls else None,
        "device_wall_us_median": med,
        "device_wall_us_max": max(walls) if walls else None,
        "elements": elements,
        "elements_per_s_at_median": elements / (med / 1e6) if med else None,
        "e2e_warm_s_median": statistics.median(r["e2e_warm_s"] for r in records),
    }


def row_line(s: dict) -> str:
    """One markdown row of the measured table."""
    hw = f"{s['device']} ({'/'.join(s['formulation'])})"
    if s["device_wall_us_median"] is None:
        wall = "n/a (no device wall off the card)"
        rate = "n/a"
    else:
        wall = (f"{s['device_wall_us_min']:.3f} / {s['device_wall_us_median']:.3f} / "
                f"{s['device_wall_us_max']:.3f}")
        rate = f"{s['elements_per_s_at_median']:.4g}"
    return (f"| {s['row']} | {hw} | {wall} | {rate} | {s['e2e_warm_s_median'] * 1e3:.3f} "
            f"| {s['procs']} | n/a |")


TABLE_HEAD = ("| Row | Hardware (formulation) | device_wall_us min / median / max | "
              "elements/s at the median | e2e_warm ms (median) | processes | "
              "vs est. reference |\n|---|---|---|---|---|---|---|")


def measure(rows: list[str], procs: int, records_out=None) -> dict:
    """Every row in ``procs`` bench processes; prints as it goes and
    returns the summary object of the last line."""
    from mpi_openmp_cuda_tpu_torch.bench import brute_force_elements
    from mpi_openmp_cuda_tpu_torch.io.parse import load_problem

    out: dict = {"rows": [], "skipped": []}
    with tempfile.TemporaryDirectory(prefix="torch_bench_table_") as tmp:
        for row in rows:
            try:
                path, env, args = row_spec(row, Path(tmp))
            except FileNotFoundError as e:
                print(f"{row}: skipped, no reference input: {e}", flush=True)
                out["skipped"].append({"row": row, "reason": f"not found: {e}"})
                continue
            problem = load_problem(str(path))
            elements = brute_force_elements(problem.seq1_codes.size,
                                            [c.size for c in problem.seq2_codes])
            records = []
            for i in range(procs):
                rec = run_bench(path, env, args)
                line = rec.pop("line")
                if records_out is not None:
                    records_out.write(line + "\n")
                records.append(rec)
                print(f"{row}: process {i + 1}/{procs}: device_wall_us "
                      f"{rec.get('device_wall_us')}, formulation {rec['formulation']}, "
                      f"e2e_warm_s {rec['e2e_warm_s']}", flush=True)
            out["rows"].append(summarize(row, records, elements))
    print(TABLE_HEAD)
    for s in out["rows"]:
        print(row_line(s))
    for s in out["skipped"]:
        print(f"| {s['row']} | skipped: {s['reason']} | | | | | |")
    return out


# ---- --from-json: tabulate recorded records ----------------------------------


def _unwrap(rec: dict) -> dict:
    """A record without its envelope; a wrapped one is validated first."""
    from mpi_openmp_cuda_tpu_torch.obs.metrics import validate_report

    if "schema" in rec:
        validate_report(rec)
        rec = {k: v for k, v in rec.items()
               if k not in ("schema", "schema_version", "kind", "meta")}
    return rec


def load_bench_records(path: str) -> list[dict]:
    """Recorded bench output as bare records: a bare record or the run
    report envelope (validated by the port's ``obs.metrics.
    validate_report``, then unwrapped); the file one JSON document (an
    object or a list) or ndjson (bench stdout captures, ``--records``)."""
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        doc = None
    if isinstance(doc, dict):
        return [_unwrap(doc)]
    if isinstance(doc, list):
        return [_unwrap(rec) for rec in doc if isinstance(rec, dict)]
    return [_unwrap(json.loads(line)) for line in map(str.strip, text.splitlines())
            if line.startswith("{")]


def recorded_row(rec: dict) -> str:
    """One kernel row; a record with no value (the CPU's) reads n/a."""
    vs, value = rec.get("vs_baseline"), rec["value"]
    return (
        f"| {rec['metric']} | {f'{value:.4g}' if value is not None else 'n/a'} "
        f"{rec.get('unit', '')} "
        f"| {f'{vs:.3g}x' if isinstance(vs, (int, float)) else 'n/a'} |"
    )


def _pctl_cell(pctls: dict) -> str:
    return "/".join(f"{float(pctls.get(p, 0.0)) * 1e3:.0f}" for p in ("p50", "p90", "p99"))


def serve_load_row(rec: dict) -> str:
    """One row of the serve-load table (``load/report.py``'s record)."""
    arr = rec.get("arrival") or {}
    reqs = rec.get("requests") or {}
    retention = rec.get("goodput_retention")
    answered = reqs.get("done", 0) + reqs.get("rejected", 0) + reqs.get("failed", 0)
    offered = max(1, reqs.get("offered", 1))
    return (
        f"| {arr.get('process', '?')} @ {arr.get('rate_rps', 0.0):.1f} req/s "
        f"(k={arr.get('speedup_k', 1.0):.3g}, {arr.get('clients', '?')} cl) "
        f"| {rec.get('offered_rps', 0.0):.3g} "
        f"| {rec.get('goodput_rps', 0.0):.3g} "
        f"| {answered}/{offered} "
        f"| {_pctl_cell(rec.get('latency_s') or {})} "
        f"| {_pctl_cell(rec.get('queue_wait_s') or {})} "
        f"| {rec.get('shed_rate', 0.0) * 100:.1f}% "
        f"| {rec.get('deadline_miss_rate', 0.0) * 100:.1f}% "
        f"| {rec.get('batch_fill_ratio', 0.0):.2f} "
        f"| {f'{retention:.2f}x' if isinstance(retention, (int, float)) else 'n/a'} |"
    )


def _pctl(vals: list, q: float) -> float:
    """Nearest-rank percentile, as ``load/report.py`` ranks."""
    if not vals:
        return 0.0
    vs = sorted(vals)
    return vs[min(len(vs) - 1, max(0, round(q * (len(vs) - 1))))]


def print_fleet_tables(ga: dict) -> None:
    """A fleet coordinator's ``gap_attribution``: superblocks and clock
    offset a worker, then the board phases' percentiles over every
    fleet-scored superblock (``obs/trace.py``'s ``board_phases``)."""
    from mpi_openmp_cuda_tpu_torch.obs.trace import BOARD_PHASES

    rows = [r for r in ga.get("board_phases", ()) if isinstance(r, dict)]
    offsets = ga.get("clock_offsets") or {}
    by_worker: dict[str, list[dict]] = {}
    for r in rows:
        by_worker.setdefault(str(r.get("worker", "?")), []).append(r)
    print("| Worker | Fleet superblocks | Clock offset ms | Echo RTT ms |")
    print("|---|---|---|---|")
    for wid in sorted(by_worker):
        off = offsets.get(wid) or {}

        def _ms(key):
            v = off.get(key)
            return f"{float(v) * 1e3:.3g}" if isinstance(v, (int, float)) else "n/a"

        print(f"| {wid} | {len(by_worker[wid])} | {_ms('offset_s')} | {_ms('rtt_s')} |")
    print()
    print("| Board phase | p50 ms | p90 ms | total s |")
    print("|---|---|---|---|")
    totals = ga.get("board_phase_totals") or {}
    for name in BOARD_PHASES:
        vals = [float(r.get("phases", {}).get(name, 0.0)) for r in rows]
        print(f"| {name} | {_pctl(vals, 0.50) * 1e3:.3g} | {_pctl(vals, 0.90) * 1e3:.3g} "
              f"| {float(totals.get(name, sum(vals))):.4g} |")


def print_serve_load_table(records: list[dict]) -> None:
    print("| Arrival (open-loop) | Offered req/s | Goodput req/s "
          "| Answered | Latency p50/p90/p99 ms | Queue-wait p50/p90/p99 ms "
          "| Shed | Deadline miss | Batch fill | Retention |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for rec in records:
        print(serve_load_row(rec))


def print_recorded(records: list[dict]) -> None:
    """Kernel rows, then serve-load records as their own table, then each
    fleet coordinator's board-phase tables."""
    serve_load = [r for r in records if r.get("formulation") == "serve-load"]
    fleet = [r for r in records if (r.get("gap_attribution") or {}).get("board_phases")]
    kernel = [r for r in records if r.get("formulation") != "serve-load" and r not in fleet]
    if kernel:
        print("| Metric | Value | vs baseline |")
        print("|---|---|---|")
        for rec in kernel:
            print(recorded_row(rec))
    if serve_load:
        if kernel:
            print()
        print_serve_load_table(serve_load)
    for rec in fleet:
        if kernel or serve_load:
            print()
        print_fleet_tables(rec["gap_attribution"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG, description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: the card rows (default); cpu: the CPU row only")
    ap.add_argument("--procs", type=int, default=5, help="bench processes a row (default 5)")
    ap.add_argument("--rows", default=None,
                    help=f"comma-separated rows of {', '.join(CARD_ROWS)} "
                         "(default all); cpu with --device cpu")
    ap.add_argument("--records", metavar="PATH", default=None,
                    help="also write every bench record read, one a line")
    ap.add_argument("--from-json", metavar="PATH", default=None,
                    help="tabulate recorded bench output instead of measuring")
    args = ap.parse_args(argv)
    if args.from_json:
        print_recorded(load_bench_records(args.from_json))
        return 0
    import torch

    if args.device == "cpu":
        rows = ["cpu"]
    else:
        if not torch.cuda.is_available():
            print(f"{PROG}: error: no CUDA device is available; the card rows need "
                  "one (--device cpu measures the CPU row)", file=sys.stderr)
            return 1
        rows = args.rows.split(",") if args.rows else list(CARD_ROWS)
        unknown = sorted(set(rows) - set(CARD_ROWS))
        if unknown:
            ap.error(f"--rows: unknown rows {unknown}")
    if args.procs < 1:
        ap.error("--procs must be at least 1")
    if args.device == "cuda":
        from mpi_openmp_cuda_tpu_torch.utils.timing import card_line

        card = card_line()
    else:
        card = "cpu"
    print(f"card: {card}", flush=True)
    if args.records:
        with open(args.records, "w", encoding="utf-8") as fh:
            out = measure(rows, args.procs, fh)
    else:
        out = measure(rows, args.procs)
    print(json.dumps({"card": card, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
