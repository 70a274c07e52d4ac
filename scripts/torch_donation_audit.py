#!/usr/bin/env python3
"""The port's staging dataflow audit on the CPU (``analysis/dataflow.py``):
the staged feed of ``ops/dispatch.py`` is made once, read once, recorded on
its consumer's stream for every operand, and re-staged from the host on
every retry path; with the launch audit's donation section of the
input3-class dispatch (eager PyTorch donates nothing: every large operand
is pinned with its reason).

    python scripts/torch_donation_audit.py [--update] [--out PATH]

The golden ``tests/golden/torch_donation_plan.json`` pins the plan (the
derived state fields, each launch entry's pins and call sites), the
re-staging paths, the findings, the counts and the donation section.
Exit 0 iff the report is schema-valid, it has no finding, and nothing
drifted from the golden (``--update`` rewrites it).  No device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GOLDEN_PATH = os.path.join(REPO, "tests", "golden", "torch_donation_plan.json")


def build_report() -> dict:
    from mpi_openmp_cuda_tpu_torch.analysis.dataflow import audit_dataflow
    from mpi_openmp_cuda_tpu_torch.analysis.traceaudit import audit_schedule
    from mpi_openmp_cuda_tpu_torch.models.workload import input3_class_problem
    from mpi_openmp_cuda_tpu_torch.obs.metrics import wrap_report

    trace = audit_schedule(input3_class_problem())
    return wrap_report("donation-audit", {
        **audit_dataflow(), "trace_audit": {"donation": trace["donation"]}})


def golden_view(report: dict) -> dict:
    plan = report["plan"]
    return {
        "state_fields": plan["state_fields"],
        "entries": [{"wrapper": e["wrapper"], "module": e["module"], "donate": e["donate"],
                     "pinned": [[p["name"], p["kind"]] for p in e["pinned"]],
                     "call_sites": e["call_sites"]} for e in plan["entries"]],
        "restage_paths": report["restage_paths"],
        "findings": report["findings"],
        "counts": report["counts"],
        "donation": report["trace_audit"]["donation"],
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
    rows += [f"[{f['kind']}] {f['entry']}: {f['detail']}" for f in report["findings"]]
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
    print(f"  state fields (record_stream each): {view['state_fields']}")
    for r in view["restage_paths"]:
        print(f"  {'ok ' if r['ok'] else 'BAD'} {r['root']} -> {r['leaf']} "
              f"({len(r['path'])} calls)")
    print(f"  donation: supported false, {len(view['donation']['pinned_live'])} large "
          "operand(s) pinned")
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
    print("donation audit:", "FAIL" if rows else "OK")
    return 1 if rows else 0


if __name__ == "__main__":
    sys.exit(main())
