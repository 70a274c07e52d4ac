#!/usr/bin/env python3
"""The port's static-analysis gate on the CPU: every pass of
``mpi_openmp_cuda_tpu_torch/analysis/`` over the port's own tree.

    python scripts/torch_analyze.py [--skip-interleave]

Passes, cheapest first:

1. seqlint       — the repo-specific AST rules (``analysis/seqlint.py``);
2. lock graph    — lock ordering and blocking reachability
                   (``analysis/lockgraph.py``; golden drift in
                   ``scripts/torch_concurrency_audit.py``);
3. exit flow     — the failure-path certifier (``analysis/exitflow.py``;
                   golden drift in ``scripts/torch_exitpath_audit.py``);
4. bounds        — ``ops/bounds.py`` re-derived from Hopper numerics
                   (``analysis/ranges.py``; golden drift in
                   ``scripts/torch_ranges_audit.py``);
5. shared memory — every launchable kernel configuration against the
                   H100's opt-in limit (``analysis/smem.py``; against the
                   card's own attributes in ``chip_smoke.py`` phase 18);
6. contracts     — every scoring entry point's plain version at a tiny
                   CPU size against its output contract
                   (``analysis/contracts.py``);
7. interleave    — the fleet protocol's interleavings
                   (``analysis/interleave.py``).

Every pass runs whatever the others did; the run ends with a summary
table.  Exit 0 iff every pass is clean.  Needs no device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _seqlint():
    from mpi_openmp_cuda_tpu_torch.analysis import seqlint

    return f"{seqlint.run_or_raise()} files, 0 findings"


def _lockgraph():
    from mpi_openmp_cuda_tpu_torch.analysis import lockgraph

    c = lockgraph.run_or_raise()["counts"]
    return f"{c['locks']} locks, {c['edges']} edge(s), 0 findings"


def _exitflow():
    from mpi_openmp_cuda_tpu_torch.analysis import exitflow

    r = exitflow.run_or_raise()
    return (f"{r['counts']['production_raises']} production raises, "
            f"{r['sinks'].get('retry-policy', 0)} retry-policy sinks, 0 findings")


def _ranges():
    from mpi_openmp_cuda_tpu_torch.analysis import ranges

    c = ranges.run_or_raise()["counts"]
    return f"{c['constants_ok']}/{c['constants']} constants certified"


def _smem():
    from mpi_openmp_cuda_tpu_torch.analysis import smem

    n, worst = smem.audit_chooser_space()
    return (f"{n} configs within {smem.H100_SMEM_OPTIN} B; worst {worst.kernel} "
            f"L2P {worst.l2p}: {worst.total_bytes} B; fused fits L2P <= "
            f"{smem.max_fused_l2p()}")


def _contracts():
    from mpi_openmp_cuda_tpu_torch.analysis import contracts

    return f"{len(contracts.audit_entry_points())} entry/bucket rows OK"


def _interleave():
    from mpi_openmp_cuda_tpu_torch.analysis import interleave

    r = interleave.run_or_raise()
    return f"{r['total_schedules']} schedules, 0 violations"


PASSES = (
    ("seqlint", _seqlint), ("lockgraph", _lockgraph), ("exitflow", _exitflow),
    ("ranges", _ranges), ("smem", _smem), ("contracts", _contracts),
    ("interleave", _interleave),
)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--skip-interleave", action="store_true",
                        help="leave out the interleaving explorer (the slowest pass)")
    args = parser.parse_args()
    rows, failed = [], False
    for name, fn in PASSES:
        if name == "interleave" and args.skip_interleave:
            rows.append((name, "SKIP", 0.0, "--skip-interleave"))
            continue
        t0 = time.perf_counter()
        try:
            status, detail = "OK", fn()
        except Exception as e:  # noqa: BLE001 - a crash is that pass's failure
            status, detail, failed = "FAIL", f"{type(e).__name__}: {e}", True
        rows.append((name, status, time.perf_counter() - t0, detail))
        print(f"== {name}: {status} — {detail}", flush=True)
    print("\n  pass         status   wall_s  detail")
    for name, status, wall, detail in rows:
        print(f"  {name:<12s} {status:<6s} {wall:7.2f}  {detail.splitlines()[0][:100]}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
