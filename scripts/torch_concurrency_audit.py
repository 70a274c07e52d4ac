#!/usr/bin/env python3
"""The port's concurrency gate on the CPU: the lock graph and the
interleaving explorer over ``mpi_openmp_cuda_tpu_torch``.

    python scripts/torch_concurrency_audit.py [--update] [--out PATH]

1. **Lock graph** (``analysis/lockgraph.py``): every lock acquisition site
   and lock-ordering edge of the port; fails on a lock-order cycle, a
   blocking operation reachable while a serve-plane or obs lock is held,
   or a lock acquired and released by different classes.
2. **Interleavings** (``analysis/interleave.py``): the port's real
   ``Membership`` / ``LeaseTable`` / ``FleetCoordinator`` /
   ``RequestQueue`` under a virtual scheduler, every sleep-set-pruned
   interleaving to a depth bound, the fleet protocol's invariants checked
   on each schedule.

The golden ``tests/golden/torch_concurrency_audit.json`` pins the lock
inventory, the ordering edges, the finding count (0) and each scenario's
explored-schedule count.  Exit 0 iff both passes are clean, the report is
schema-valid and nothing drifted from the golden (``--update`` rewrites
it).  Needs no device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GOLDEN_PATH = os.path.join(REPO, "tests", "golden", "torch_concurrency_audit.json")
MIN_SCHEDULES = 1000


def build_report(interleave_report: dict | None = None) -> dict:
    """The enveloped report; ``interleave_report`` reuses a run of
    ``interleave.run_all`` (the tests share one)."""
    from mpi_openmp_cuda_tpu_torch.analysis.interleave import run_all
    from mpi_openmp_cuda_tpu_torch.analysis.lockgraph import audit_lock_graph
    from mpi_openmp_cuda_tpu_torch.obs.metrics import wrap_report

    il = interleave_report if interleave_report is not None else run_all()
    return wrap_report("concurrency-audit", {"lockgraph": audit_lock_graph(),
                                             "interleave": il})


def golden_view(report: dict) -> dict:
    """The drift-gated subset: static facts of the tree and the explorer."""
    lg, il = report["lockgraph"], report["interleave"]
    return {
        "locks": sorted(lg["locks"]),
        "edges": sorted(f"{e['src']} -> {e['dst']}" for e in lg["edges"]),
        "findings": lg["counts"]["findings"],
        "scenarios": [
            {"name": r["name"], "depth": r["depth"], "schedules": r["schedules"],
             "violations": len(r["violations"]), "invariants": list(r["invariants"])}
            for r in il["scenarios"]
        ],
        "total_schedules": il["total_schedules"],
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
    rows += [f"lockgraph [{f['kind']}] {f['detail']}" for f in report["lockgraph"]["findings"]]
    il = report["interleave"]
    rows += [f"interleave {r['name']}: {v}" for r in il["scenarios"] for v in r["violations"]]
    if il["total_schedules"] < MIN_SCHEDULES:
        rows.append(f"interleave explored {il['total_schedules']} < {MIN_SCHEDULES} schedules")
    if golden is not None:
        rows += diff_views(golden, golden_view(report))
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--update", action="store_true",
                        help="rewrite the golden from this run")
    parser.add_argument("--out", default=None, help="also write the full report here")
    args = parser.parse_args()
    report = build_report()
    view = golden_view(report)
    print(json.dumps(view, indent=1, sort_keys=True))
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
    print("concurrency audit:", "FAIL" if rows else "OK")
    return 1 if rows else 0


if __name__ == "__main__":
    sys.exit(main())
