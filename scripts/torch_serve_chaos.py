#!/usr/bin/env python3
"""Serve chaos tier of the port, the counterpart of
``scripts/serve_chaos.py``: the SLO armour under injected faults.

    python3 scripts/torch_serve_chaos.py                     # on the card
    python3 scripts/torch_serve_chaos.py --device cpu --small

Six pipe-mode scenarios, each a real ``python -m mpi_openmp_cuda_tpu_torch
--serve`` process with counted fault schedules (``resilience/faults.py``),
all started at once, gated on what the armour promises:

* **breaker**: transient primary-dispatch failures open the circuit
  breaker, dispatch rides the pinned degraded backend while open, the
  cooldown probes half-open and a healthy probe closes it: one open,
  one half-open and one close in one run report;
* **poison**: a poisoned session fails every superblock holding it;
  bisection isolates it with a typed error while its co-batched victim
  scores and meets its deadline;
* **overload**: a modelled burst exhausts the admission bucket: o1 and
  o2 shed with the typed ``overloaded`` error and a numeric
  ``retry_after_s``, o0 completes;
* **client-loss**: a client dead mid-stream forfeits its results; the
  server absorbs it (``serve_clients_lost`` 1) and exits clean;
* **drain**: a pre-armed drain (``SEQALIGN_DRAIN=1``) journals the one
  admitted request (``d0``), exits 75, and the journal bytes are the same
  across a rerun;
* **usage**: an unknown ``--faults`` site is exit 64 naming the known
  sites.

Every scenario also gates "no Traceback on stderr" and a valid run
report; on the card each scenario that scores holds its report's launch
counters (both kernels: the breaker's come from the primary path before
it opens and after it closes).  Prints one JSON record, then the OK line
or every problem; exits 0 or 1.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_drill_common as common  # noqa: E402

PROG = "torch_serve_chaos"
TAG = "serve-chaos"


class Drill:
    def __init__(self, device: str, small: bool, out: str):
        self.device = device
        self.shapes = common.Shapes(small)
        self.out = out
        self.launches: dict[str, dict] = {}

    def run_serve(self, name, requests, *, faults=None, env_extra=None, argv_extra=(),
                  journal=None):
        """One pipe-mode --serve process: ``(rc, records, report, stderr)``;
        ``report`` None when unreadable (gated by the caller).  Its
        requests, stdout and report stay in the drill's directory as
        ``<name>.ndjson``, ``<name>.out.ndjson`` and
        ``<name>.report.json``."""
        reqfile = os.path.join(self.out, f"{name}.ndjson")
        with open(reqfile, "w", encoding="utf-8") as fh:
            for raw in requests:
                fh.write(json.dumps(raw) + "\n")
        report_path = os.path.join(self.out, f"{name}.report.json")
        argv = common.cli_argv(self.device, "--serve", "--input", reqfile,
                               "--metrics-out", report_path)
        if faults:
            argv += ["--faults", faults]
        if journal:
            argv += ["--journal", journal]
        argv += list(argv_extra)
        proc = subprocess.run(argv, cwd=common.REPO, env=common.drill_env(self.out, env_extra),
                              capture_output=True, text=True, timeout=300)
        with open(os.path.join(self.out, f"{name}.out.ndjson"), "w") as fh:
            fh.write(proc.stdout)
        records = [json.loads(line) for line in proc.stdout.splitlines() if line.strip()]
        report = common.read_report(report_path)
        return proc.returncode, records, report, proc.stderr

    def base_gates(self, name, rc, report, stderr, problems, *, want_rc=0, scores=True):
        from mpi_openmp_cuda_tpu_torch.obs.metrics import validate_report

        if rc != want_rc:
            problems.append(f"{name}: exit code: want {want_rc}, got {rc}\n{stderr[-3000:]}")
        if "Traceback" in stderr:
            problems.append(f"{name}: server crashed (Traceback on stderr)")
        if report is None:
            problems.append(f"{name}: no readable run report")
            return
        try:
            validate_report(report)
        except ValueError as e:
            problems.append(f"{name}: {e}")
        if scores:
            launches = common.launches_of(report)
            self.launches[name] = launches
            problems += common.launch_problems(name, self.device, launches)

    def req(self, rid, rows, **extra):
        return self.shapes.req(rid, rows, **extra)

    def scenario_breaker(self, problems):
        """Open on repeated transient failures, serve degraded while open,
        probe half-open after the cooldown, close on the healthy probe."""
        name = "breaker"
        reqs = [self.req(f"b{i}", ["ACGT", "GATTACA"]) for i in range(4)]
        rc, records, report, stderr = self.run_serve(
            name, reqs, faults="chunk_dispatch:fail=2",
            argv_extra=("--degrade", "--retries", "3"),
            env_extra={
                # One request a tick, so the breaker's tick-counted cooldown
                # follows a known schedule: open during b0's retries, b1 on
                # the pinned degraded backend, the tick after the 2-tick
                # cooldown probes half-open, b2's primary success closes.
                "SEQALIGN_SERVE_MAX_POP": "1",
                "SEQALIGN_BREAKER_THRESHOLD": "2",
                "SEQALIGN_BREAKER_COOLDOWN": "2",
                "SEQALIGN_BREAKER_WINDOW": "16",
            })
        self.base_gates(name, rc, report, stderr, problems)
        done = {r["id"] for r in records if r.get("done")}
        if done != {f"b{i}" for i in range(4)}:
            problems.append(f"{name}: every request must score; done={sorted(done)}")
        if report:
            c = report["counters"]
            for counter in ("breaker_opens", "breaker_half_opens", "breaker_closes"):
                if c.get(counter) != 1:
                    problems.append(f"{name}: counters.{counter}: want 1, got {c.get(counter)}")
            state = report["gauges"].get("breaker_state")
            if state != "closed":
                problems.append(f"{name}: gauges.breaker_state: want 'closed' after the "
                                f"probe, got {state!r}")
            if not c.get("degrade_transitions"):
                problems.append(f"{name}: the open breaker never pinned the degraded "
                                "backend (no degrade_transitions)")

    def scenario_poison(self, problems):
        """Bisection isolates the poison; the co-batched victim scores and
        meets its deadline."""
        name = "poison"
        seq2 = ["ACGT", "GATTACA"]
        rc, records, report, stderr = self.run_serve(
            name, [self.req("poison", seq2), self.req("victim", seq2, deadline_s=300.0)],
            faults="poison-session:fail=1")
        self.base_gates(name, rc, report, stderr, problems)
        errors = {r["id"]: r["error"] for r in records if "error" in r}
        if set(errors) != {"poison"} or "poison" not in errors.get("poison", ""):
            problems.append(f"{name}: want exactly one typed poison error, got {errors}")
        if not [r for r in records if r.get("done") and r["id"] == "victim"]:
            problems.append(f"{name}: the co-batched victim must score ON TIME (no "
                            "deadline error), got no done record")
        if report and report["counters"].get("serve_poisoned") != 1:
            problems.append(f"{name}: counters.serve_poisoned: want 1, got "
                            f"{report['counters'].get('serve_poisoned')}")

    def scenario_overload(self, problems):
        """The modelled burst sheds typed ``overloaded`` + retry_after_s."""
        name = "overload"
        rc, records, report, stderr = self.run_serve(
            name, [self.req(f"o{i}", ["ACGT"]) for i in range(3)],
            faults="overload-burst:fail=2")
        self.base_gates(name, rc, report, stderr, problems)
        if answered(records) != {"o0", "o1", "o2"}:
            problems.append(f"{name}: every request must be answered, got "
                            f"{sorted(answered(records))}")
        shed = [r for r in records if r.get("error") == "overloaded"]
        if {r["id"] for r in shed} != {"o1", "o2"}:
            problems.append(f"{name}: want o1+o2 shed as 'overloaded', got "
                            f"{[r.get('id') for r in shed]}")
        for r in shed:
            if not isinstance(r.get("retry_after_s"), (int, float)):
                problems.append(f"{name}: shed record lacks retry_after_s: {r}")
        if not any(r.get("done") and r["id"] == "o0" for r in records):
            problems.append(f"{name}: the admitted request must complete")

    def scenario_client_loss(self, problems):
        """A client dead mid-stream is absorbed, never crashes the loop."""
        name = "client-loss"
        rc, records, report, stderr = self.run_serve(
            name, [self.req("gone", ["ACGT"]), self.req("also", ["TTTT"])],
            faults="dead-socket-midstream:fail=1")
        self.base_gates(name, rc, report, stderr, problems)
        if report and report["counters"].get("serve_clients_lost") != 1:
            problems.append(f"{name}: counters.serve_clients_lost: want 1, got "
                            f"{report['counters'].get('serve_clients_lost')}")

    def scenario_drain(self, problems):
        """A pre-armed drain journals what it admitted and exits 75, with
        the same journal bytes across a rerun."""
        name = "drain"
        reqs = [self.req(f"d{i}", ["ACGT", "GATTACA"]) for i in range(3)]
        journals = []
        for attempt in ("a", "b"):
            journal = os.path.join(self.out, f"drain-{attempt}.jsonl")
            rc, records, report, stderr = self.run_serve(
                f"{name}-{attempt}", reqs, env_extra={"SEQALIGN_DRAIN": "1"},
                journal=journal)
            self.base_gates(f"{name}-{attempt}", rc, report, stderr, problems, want_rc=75,
                            scores=False)
            # The pre-armed flag stops ingest after the FIRST line (the drain
            # check sits at the read loop's line boundary), so exactly d0 is
            # admitted, then journaled.
            drained = {r.get("id") for r in records if r.get("drained")}
            if drained != {"d0"}:
                problems.append(f"{name}-{attempt}: every admitted request gets a drained "
                                f"notice, want exactly d0, got {sorted(drained)}")
            try:
                with open(journal, "rb") as fh:
                    journals.append(fh.read())
            except OSError as e:
                problems.append(f"{name}-{attempt}: no journal: {e}")
                journals.append(b"")
        if journals[0] != journals[1]:
            problems.append(f"{name}: drained-journal goldens differ across rerun "
                            "(the resume token must be deterministic)")
        if b'"request"' not in journals[0]:
            problems.append(f"{name}: journal holds no request records")

    def scenario_usage(self, problems):
        """Unknown --faults site: exit 64 with the known-site list."""
        name = "usage"
        proc = subprocess.run(
            common.cli_argv(self.device, "--serve", "--input", os.devnull,
                            "--faults", "warp-core:fail=1"),
            cwd=common.REPO, env=common.drill_env(self.out), capture_output=True,
            text=True, timeout=120)
        if proc.returncode != 64:
            problems.append(f"{name}: unknown fault site: want exit 64, got "
                            f"{proc.returncode}")
        if "known sites" not in proc.stderr:
            problems.append(f"{name}: stderr must list the known sites, got: "
                            f"{proc.stderr.strip()[:200]}")


def answered(records: list[dict]) -> set:
    """Request ids that got a terminal answer (done or a typed error)."""
    return {r.get("id") for r in records if r.get("done") or "error" in r}


def main(argv=None) -> int:
    args = common.parse_args(PROG, __doc__, argv)
    if not common.require_device(PROG, args.device):
        return 1
    out = tempfile.mkdtemp(prefix="torch_serve_chaos_")
    drill = Drill(args.device, args.small, out)
    results = common.run_scenarios([
        ("breaker", drill.scenario_breaker),
        ("poison", drill.scenario_poison),
        ("overload", drill.scenario_overload),
        ("client-loss", drill.scenario_client_loss),
        ("drain", drill.scenario_drain),
        ("usage", drill.scenario_usage),
    ])
    problems = [p for ps in results.values() for p in ps]
    total = dict.fromkeys(common.KERNELS, 0)
    for launches in drill.launches.values():
        common.add_launches(total, launches)
    problems += common.launch_problems("scenarios", args.device, total)
    record = {"device": args.device, "small": args.small,
              "scenarios": {n: "fail" if ps else "ok" for n, ps in results.items()},
              "launches": total, "launches_by_scenario": drill.launches}
    return common.finish(TAG, problems, "breaker cycle, poison quarantine, overload shed, "
                                        "client loss, drain golden, usage gate; "
                                        f"launches={total}; artifacts={out}", record)


if __name__ == "__main__":
    sys.exit(main())
