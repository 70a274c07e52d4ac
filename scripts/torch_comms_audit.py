#!/usr/bin/env python3
"""The port's comms audit on the CPU (``analysis/collectives.py``): every
mesh form (``2``, ``batch:2``, ``seq:4``, ``2x2``) run on ``[cpu] x N``
through ``LocalCollectives`` at the representative batch, its per-slot
collective sequences inventoried, held to each other and to the plan,
the ring's shifts held to ``ring_plan``'s R and the cost sheet's, and the
``parallel/`` source checked for collectives under rank-dependent branches
and for device crossings outside ``comm.py``.

    python scripts/torch_comms_audit.py [--update] [--out PATH]

The golden ``tests/golden/torch_comms_audit.json`` pins each form's
sequence, signature and ``comm.log`` (``chip_smoke.py`` phase 19 holds the
card's logs at ``2x2`` and ``seq:4`` to it), the ring cross-check, the
counts and the modelled scaling rows (NVLink at the data-sheet rate, not
measured).  Exit 0 iff the report is schema-valid, it has no finding, and
nothing drifted from the golden (``--update`` rewrites it).  No device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GOLDEN_PATH = os.path.join(REPO, "tests", "golden", "torch_comms_audit.json")


def build_report() -> dict:
    from mpi_openmp_cuda_tpu_torch.analysis.collectives import audit_collectives
    from mpi_openmp_cuda_tpu_torch.obs.metrics import wrap_report

    return wrap_report("comms-audit", audit_collectives())


def golden_view(report: dict) -> dict:
    return {
        "entries": [{k: e[k] for k in ("spec", "entry", "mesh_axes", "positions",
                                       "collectives", "signature", "consistent",
                                       "counts", "log", "payload_bytes")}
                    for e in report["entries"]],
        "ring_crosscheck": report["ring_crosscheck"],
        "counts": report["counts"],
        "scaling": [{"mesh": r["mesh"], "axis": r["axis"],
                     "comms_wall_us": round(r["comms_wall_us"], 3),
                     "efficiency": round(r["predicted_scaling_efficiency"], 3)}
                    for r in report["comms"]["scaling"]],
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
    for e in view["entries"]:
        kinds = [op["kind"] for op in e["collectives"]]
        print(f"  {e['spec']:<8s} {e['entry']:<22s} {e['positions']} slots, "
              f"a slot: {kinds}, consistent {e['consistent']}")
    for r in view["ring_crosscheck"]:
        print(f"  ring {r['entry']}: R {r['planned_r']}, shifts {r['shifts']}, "
              f"sheet {r['sheet_r']}, match {r['match']}")
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
    print("comms audit:", "FAIL" if rows else "OK")
    return 1 if rows else 0


if __name__ == "__main__":
    sys.exit(main())
