#!/usr/bin/env python3
"""The port's failure-path certifier on the CPU (``analysis/exitflow.py``
over ``mpi_openmp_cuda_tpu_torch``).

    python scripts/torch_exitpath_audit.py [--update] [--out PATH]

Proves, over the package's raise/except/finally propagation graph:

1. **Sink totality** — every production raise site's exception reaches a
   legal sink: the port's ``RetryPolicy`` ladder (``retry-policy``), a
   typed serve wire-error reply (``wire-reply``), the sysexits map of
   ``io/cli.py`` (``exit-map``: 64 usage / 65 fatal / 75 resumable), or a
   reasoned ``# advisory:`` swallow;
2. **Flush on every exit** — every exit of ``io/cli.py run()`` and
   ``serve/loop.py run_serve()`` passes through the finally-first flush
   (``_flush_obs`` in the CLI);
3. **Exit-75 rooting** — ``EX_TEMPFAIL`` only from deadline/drain causes;
4. **Fault-registry liveness** — every ``resilience/faults.py`` site names
   a fire point the production graph reaches.

The golden ``tests/golden/torch_exitpath_audit.json`` pins the sink
inventory (a non-zero ``retry-policy`` count among it), the per-module
raise counts, the advisory markers, the flush and fault summaries and the
headline counts.  Exit 0 iff there is no finding, the report is
schema-valid and nothing drifted (``--update`` rewrites the golden).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GOLDEN_PATH = os.path.join(REPO, "tests", "golden", "torch_exitpath_audit.json")


def build_report() -> dict:
    from mpi_openmp_cuda_tpu_torch.analysis.exitflow import audit_exitflow
    from mpi_openmp_cuda_tpu_torch.obs.metrics import wrap_report

    return wrap_report("exitpath-audit", audit_exitflow())


def golden_view(report: dict) -> dict:
    """The drift-gated subset (flush line spans are not pinned: an edit
    above the try would churn them; the protected-return counts are)."""
    return {
        "sinks": dict(report["sinks"]),
        "raise_modules": dict(report["raise_modules"]),
        "advisory": list(report["advisory"]),
        "flush": {
            mod: {"function": f["function"], "flush_calls": sorted(f["flush_calls"]),
                  "protected_returns": f["protected_returns"]}
            for mod, f in report["flush"].items()
        },
        "fault_sites": dict(report["fault_sites"]),
        "findings": len(report["findings"]),
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
    rows += [f"[{f['kind']}] {f['module']}:{f['line']}: {f['detail']}"
             for f in report["findings"]]
    if not report["sinks"].get("retry-policy"):
        rows.append("no raise site reaches the RetryPolicy ladder (retry-policy sinks 0)")
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
    print("exit-path audit:", "FAIL" if rows else "OK")
    return 1 if rows else 0


if __name__ == "__main__":
    sys.exit(main())
