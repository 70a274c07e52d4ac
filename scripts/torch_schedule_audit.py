#!/usr/bin/env python3
"""The port's schedule audit on the CPU: the Hopper cost sheet and the
launch audit (``analysis/costmodel.py``, ``analysis/traceaudit.py``) of the
input3-class workload (the bench's) and the max-size workload.

    python scripts/torch_schedule_audit.py [--update] [--out PATH]

For each workload: the cost sheet (every launch priced with the launch
model and the bound, totals, hot configs, declared launches by kernel,
comms rows) and the launch audit (the launches a traced dispatch makes,
held to the declaration, no PyTorch epilogue and one host fetch a batch, the
operand inventory and the donation section); then every entry point's
widenings, the sweep of every plannable launch shape, and the warm set of
max-size held against its hot configs (``aot/warmset.crosscheck_hot_configs``).
The golden ``tests/golden/torch_schedule_audit.json`` pins the stable
fields.  Exit 0 iff the report is schema-valid, nothing raised, no finding,
the warm set covers the hot configs and nothing drifted from the golden
(``--update`` rewrites it).  No device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GOLDEN_PATH = os.path.join(REPO, "tests", "golden", "torch_schedule_audit.json")


def workloads():
    """``[(name, problem)]``: input3-class, then max-size."""
    from mpi_openmp_cuda_tpu_torch.io.parse import Problem
    from mpi_openmp_cuda_tpu_torch.models.encoding import decode
    from mpi_openmp_cuda_tpu_torch.models.workload import (
        INPUT3_CLASS_NAME, MAX_SIZE, input3_class_problem, synthetic_codes)

    seq1, seqs = synthetic_codes(*MAX_SIZE)
    max_size = Problem(weights=[10, 2, 3, 4], seq1=decode(seq1),
                       seq2=[decode(c) for c in seqs], seq1_codes=seq1, seq2_codes=seqs)
    return [(INPUT3_CLASS_NAME, input3_class_problem()), ("synthetic-max-size", max_size)]


def build_report() -> dict:
    from mpi_openmp_cuda_tpu_torch.analysis.costmodel import (
        audit_config_space, schedule_cost_sheet)
    from mpi_openmp_cuda_tpu_torch.analysis.traceaudit import (
        audit_entry_points, audit_schedule)
    from mpi_openmp_cuda_tpu_torch.aot.warmset import crosscheck_hot_configs, select_warmset
    from mpi_openmp_cuda_tpu_torch.obs.metrics import wrap_report

    parts = []
    for name, problem in workloads():
        sheet = schedule_cost_sheet(problem)
        parts.append({
            "workload": name,
            "cost_sheet": sheet,
            "trace_audit": audit_schedule(problem),
            "warmset_uncovered": crosscheck_hot_configs(
                select_warmset(problem, "cuda"), sheet["hot_configs"]),
        })
    n, best = audit_config_space()
    return wrap_report("schedule-audit", {
        **parts[0],
        "more_workloads": parts[1:],
        "entry_points": audit_entry_points(),
        "config_space": {"shapes": n, "best": best.describe()},
    })


def _r(x):
    return None if x is None else round(x, 3)


def _view(part: dict) -> dict:
    sheet, trace = part["cost_sheet"], part["trace_audit"]
    totals = sheet["totals"]
    return {
        "workload": part["workload"],
        "launches": totals["launches"],
        "launches_by_kernel": totals["launches_by_kernel"],
        "executables": totals["executables"],
        "declared_launches": sheet["fused"]["declared_launches"],
        "fused_groups": sheet["fused"]["groups"],
        "predicted_wall_us": _r(totals["predicted_wall_us"]),
        "bound_us": _r(totals["bound_us"]),
        "predicted_bound_share": _r(sheet["predicted_bound_share"]),
        "buckets": [{k: b[k] for k in ("formulation", "l1p", "l2p", "rows", "live_pairs",
                                       "l2s", "cluster", "bucket_keys", "cells",
                                       "bytes_moved_min", "model")}
                    for b in sheet["buckets"]],
        "hot_configs": [{k: r[k] for k in ("rank", "formulation", "l2p", "l2s", "rows")}
                        for r in sheet["hot_configs"]],
        "scaling": [{"mesh": r["mesh"], "axis": r["axis"],
                     "efficiency": _r(r["predicted_scaling_efficiency"]),
                     "ring_steps": r.get("ring_steps")} for r in sheet["comms"]["scaling"]],
        "trace_launches": trace["launches_by_kernel"],
        "epilogues": trace["epilogues"],
        "host_fetches": trace["host_fetches"],
        "operand_findings": len(trace["findings"]),
        "donation": trace["donation"],
    }


def golden_view(report: dict) -> dict:
    return {
        "workloads": [_view(p) for p in [report, *report["more_workloads"]]],
        "entry_widenings": {f"{e['entry']}@{tuple(e['bucket'])}": e["widenings"]
                            for e in report["entry_points"]},
        "config_space": report["config_space"],
    }


def diff_views(want: dict, got: dict) -> list[str]:
    return [f"  {k}: golden {json.dumps(want.get(k))} != got {json.dumps(got.get(k))}"
            for k in sorted(set(want) | set(got)) if want.get(k) != got.get(k)]


def check(report: dict, golden: dict | None) -> list[str]:
    """Every failure of the gate, as rows (empty: pass)."""
    from mpi_openmp_cuda_tpu_torch.obs.metrics import validate_report

    rows = []
    try:
        validate_report(report)
    except ValueError as e:
        rows.append(f"schema: {e}")
    for part in [report, *report["more_workloads"]]:
        rows += [f"[{f['kind']}] {part['workload']} {f['entry']}: {f['detail']}"
                 for f in part["trace_audit"]["findings"]]
        rows += [f"[warmset] {part['workload']}: hot config {r} has no warm entry"
                 for r in part["warmset_uncovered"]]
    if golden is not None:
        rows += diff_views(golden, golden_view(report))
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--update", action="store_true", help="rewrite the golden from this run")
    parser.add_argument("--out", default=None, help="also write the full report here")
    args = parser.parse_args()
    report = build_report()
    view = golden_view(report)
    for w in view["workloads"]:
        print(f"  {w['workload']}: {w['launches']} launch(es) {w['launches_by_kernel']}, "
              f"declared {w['declared_launches']}, traced {w['trace_launches']}, "
              f"predicted {w['predicted_wall_us']} us, bound {w['bound_us']} us")
    print(f"  launch shapes priced: {view['config_space']['shapes']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
    if args.update:
        with open(GOLDEN_PATH, "w") as f:
            f.write(json.dumps(view, indent=1, sort_keys=True) + "\n")
        print(f"golden written: {GOLDEN_PATH}")
        golden = view
    else:
        with open(GOLDEN_PATH) as f:
            golden = json.load(f)
    rows = check(report, golden)
    for r in rows:
        print(f"FAIL {r}")
    print("schedule audit:", "FAIL" if rows else "OK")
    return 1 if rows else 0


if __name__ == "__main__":
    sys.exit(main())
