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
7. cost model    — every plannable launch shape priced, and the
                   input3-class sheet (``analysis/costmodel.py``; golden
                   drift in ``scripts/torch_schedule_audit.py``);
8. launch audit  — input3-class's traced dispatch against the declared
                   launches, its operands (``analysis/traceaudit.py``);
9. comms         — every mesh form's collectives on ``[cpu] x N``, the
                   ``parallel/`` source (``analysis/collectives.py``;
                   golden drift in ``scripts/torch_comms_audit.py``);
10. dataflow     — the staged feed's single use, stream safety and
                   re-staging on retry (``analysis/dataflow.py``; golden
                   drift in ``scripts/torch_donation_audit.py``);
11. interleave   — the fleet protocol's interleavings
                   (``analysis/interleave.py``).

The build counter (``analysis/recompile.py``) needs a card to count on;
``chip_smoke.py`` phase 19 holds it at 0 in steady state.

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


def _costmodel():
    from mpi_openmp_cuda_tpu_torch.analysis import costmodel
    from mpi_openmp_cuda_tpu_torch.models.workload import input3_class_problem

    n, best = costmodel.audit_config_space()
    t = costmodel.schedule_cost_sheet(input3_class_problem())["totals"]
    return (f"{n} launch shapes priced (nearest its bound: {best.kind} L2P {best.l2p}, "
            f"{best.bound_share:.3f}); input3-class {t['launches']} launch(es), "
            f"predicted {t['predicted_wall_us']:.3f} us")


def _traceaudit():
    from mpi_openmp_cuda_tpu_torch.analysis import traceaudit
    from mpi_openmp_cuda_tpu_torch.models.workload import input3_class_problem

    r = traceaudit.run_or_raise(input3_class_problem())
    rows = traceaudit.audit_entry_points()
    return (f"input3-class {r['launches_by_kernel']} == declared, {r['epilogues']} "
            f"epilogue, {r['host_fetches']} host fetch, {len(rows)} entry rows, 0 findings")


def _collectives():
    from mpi_openmp_cuda_tpu_torch.analysis import collectives

    c = collectives.run_or_raise()["counts"]
    return f"{c['entries']} mesh forms, {c['collectives']} collectives, 0 findings"


def _dataflow():
    from mpi_openmp_cuda_tpu_torch.analysis import dataflow

    c = dataflow.run_or_raise()["counts"]
    return f"{c['restage_paths']} re-staging paths, {c['pinned']} pins, 0 findings"


def _interleave():
    from mpi_openmp_cuda_tpu_torch.analysis import interleave

    r = interleave.run_or_raise()
    return f"{r['total_schedules']} schedules, 0 violations"


PASSES = (
    ("seqlint", _seqlint), ("lockgraph", _lockgraph), ("exitflow", _exitflow),
    ("ranges", _ranges), ("smem", _smem), ("contracts", _contracts),
    ("costmodel", _costmodel), ("traceaudit", _traceaudit), ("collectives", _collectives),
    ("dataflow", _dataflow), ("interleave", _interleave),
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
