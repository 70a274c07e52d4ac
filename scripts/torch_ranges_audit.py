#!/usr/bin/env python3
"""The port's bounds certificate on the CPU (``analysis/ranges.py``):
every constant of ``ops/bounds.py`` re-derived from Hopper numerics and
diffed against its wired value.

    python scripts/torch_ranges_audit.py [--update] [--out PATH]

The golden ``tests/golden/torch_ranges_cert.json`` pins every
``derived_constants`` row (name, derived, wired, ok) and the
counts.  Exit 0 iff no constant drifted, the report is schema-valid and
nothing drifted from the golden (``--update`` rewrites it).  The JAX
package's jaxpr interval pass has no counterpart: the port has no jaxprs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GOLDEN_PATH = os.path.join(REPO, "tests", "golden", "torch_ranges_cert.json")


def build_report() -> dict:
    from mpi_openmp_cuda_tpu_torch.analysis.ranges import certify
    from mpi_openmp_cuda_tpu_torch.obs.metrics import wrap_report

    return wrap_report("bounds-cert", certify())


def golden_view(report: dict) -> dict:
    return {
        "derived_constants": [
            {k: r[k] for k in ("name", "derived", "wired", "ok")}
            for r in report["derived_constants"]
        ],
        "counts": dict(report["counts"]),
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
    rows += [f"[{f['kind']}] {f['name']}: {f['detail']}" for f in report["findings"]]
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
    for r in view["derived_constants"]:
        print(f"  {'ok' if r['ok'] else 'DRIFT':<5s} {r['name']:<28s} derived "
              f"{r['derived']!r} wired {r['wired']!r}")
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
    print("bounds certificate:", "FAIL" if rows else "OK")
    return 1 if rows else 0


if __name__ == "__main__":
    sys.exit(main())
