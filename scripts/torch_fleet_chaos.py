#!/usr/bin/env python3
"""Fleet chaos tier of the port, the counterpart of
``scripts/fleet_chaos.py``: exactly-once under worker murder, zombies,
torn posts, stalled leases, a murdered coordinator and a burst overload.

    python3 scripts/torch_fleet_chaos.py                     # on the card
    python3 scripts/torch_fleet_chaos.py --device cpu --small

Every scenario runs a real coordinator (``python -m
mpi_openmp_cuda_tpu_torch --serve --fleet-board``) and real
``--fleet-worker`` processes over a ``FileBoard`` directory of its own,
the scenarios in two waves (each wave's at once), and gates the one promise that matters: every
admitted request is answered exactly once, its records byte-identical to
a clean fleetless run's:

* **kill-worker**: a worker is SIGKILLed (``kill:fleet-worker``) right
  after claiming the superblock; the membership declares it dead, the
  block re-dispatches at a bumped epoch and a survivor that enlists after
  the death (inside the 8 s lease) scores it;
* **zombie-fence**: a worker freezes its heartbeats after scoring
  (``zombie:fleet-worker``), is declared dead and its block rescued, then
  posts its stale epoch-0 result anyway: fenced, never demuxed;
* **torn-post**: a torn result post (``board:torn-post``) reads as
  missing; the lease expires and the re-dispatched epoch scores clean;
* **lease-stall**: a worker claims and never scores (``lease:stall``);
  lease expiry re-dispatches and the same worker completes it;
* **coordinator-kill**: the coordinator is SIGKILLed at its second pump
  tick (``kill:fleet-coordinator``); a ``--fleet-standby`` wins
  generation 1, replays the checkpoint and answers every request;
* **burst-overload**: 5x admission overload (``burst:overload``) while
  the only worker is SIGKILLed: every excess request is shed with a typed
  ``overloaded`` and a positive ``retry_after_s``, and the admitted one
  survives the kill through re-dispatch; the staging prices the request
  with the port's own ``serve/slo.py::RequestCostModel``;
* **usage**: ``--fleet-worker`` or ``--fleet-standby`` without
  ``--fleet-board`` is exit 64 naming the flag.

Completed runs also gate the board (only the registry, the shutdown
beacon and the generation record survive the final sweep), "no
Traceback", ``shed_state == accept`` and a valid run report.  On the card
the kernels are built once here before any worker starts, each worker's
time from spawn to registration is printed, and each scoring scenario's
reports (coordinator, workers, standby) must count fused and packed
launches.  Prints one JSON record, then the OK line or every problem;
exits 0 or 1.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import threading

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_drill_common as common  # noqa: E402
from torch_drill_common import Worker  # noqa: E402

PROG = "torch_fleet_chaos"
TAG = "fleet-chaos"

#: The JAX drill's request set: both requests share weights and Seq1, so
#: they pack into ONE superblock, the unit the fleet claims, kills, fences
#: and re-dispatches.
REQ_ROWS = (("r1", ["ACGT", "GATTACA"]), ("r2", ["TTTT"]))
SCENARIOS = ("baseline", "kill-worker", "zombie-fence", "torn-post", "lease-stall",
             "coordinator-kill", "burst-overload", "usage")


class Drill:
    def __init__(self, device: str, small: bool, out: str):
        self.device = device
        self.shapes = common.Shapes(small)
        self.out = out
        self.reqs = [self.shapes.req(rid, rows) for rid, rows in REQ_ROWS]
        self.baseline: dict | None = None
        self.baseline_ready = threading.Event()
        self.launches: dict[str, dict] = {}
        self.registration_s: dict[str, float | None] = {}
        self._lock = threading.Lock()

    # -- processes ------------------------------------------------------------
    def worker(self, board, tag, *, faults=None, env_extra=None) -> Worker:
        report = os.path.join(self.out, f"{tag}.worker.json")
        return Worker(self.device, self.out, board, tag, faults=faults,
                      env_extra=env_extra, argv_extra=("--metrics-out", report))

    def worker_report(self, tag):
        return common.read_report(os.path.join(self.out, f"{tag}.worker.json"))

    def registered(self, w: Worker) -> bool:
        ok = w.wait_registered()
        with self._lock:
            self.registration_s[w.tag] = w.registered_s
        if ok:
            common.log(PROG, f"worker {w.tag} ({w.wid}) registered {w.registered_s:.3f} s "
                             "after its spawn")
        return ok

    def run_coordinator(self, name, *, board=None, faults=None, env_extra=None,
                        expect_kill=False, reqs=None):
        """One pipe-mode --serve process (the fleet coordinator when
        ``board`` is set): ``(rc, records, report, stderr)``; its requests
        and stdout stay as ``<name>.ndjson`` and ``<name>.out.ndjson``."""
        reqfile = os.path.join(self.out, f"{name}.ndjson")
        with open(reqfile, "w", encoding="utf-8") as fh:
            for raw in reqs or self.reqs:
                fh.write(json.dumps(raw) + "\n")
        report_path = os.path.join(self.out, f"{name}.report.json")
        argv = common.cli_argv(self.device, "--serve", "--input", reqfile,
                               "--metrics-out", report_path)
        if board:
            argv += ["--fleet-board", board]
        if faults:
            argv += ["--faults", faults]
        proc = subprocess.run(argv, cwd=common.REPO, env=common.drill_env(self.out, env_extra),
                              capture_output=True, text=True, timeout=300)
        with open(os.path.join(self.out, f"{name}.out.ndjson"), "w") as fh:
            fh.write(proc.stdout)
        records = common.parse_records(proc.stdout, tolerant=expect_kill)
        return proc.returncode, records, common.read_report(report_path), proc.stderr

    def relief(self, doomed: Worker, board: str, tag: str, box: list) -> threading.Thread:
        """Spawn a survivor the moment ``doomed`` is reaped, well inside the
        8 s lease the coordinator waits before declaring the death."""
        def relieve():
            doomed.proc.wait()
            survivor = self.worker(board, tag)
            box.append(survivor)
            self.registered(survivor)

        t = threading.Thread(target=relieve, daemon=True)
        t.start()
        return t

    # -- gates ----------------------------------------------------------------
    def want_baseline(self) -> dict:
        self.baseline_ready.wait()
        return self.baseline or {}

    def scoring_gates(self, name, reports, problems):
        launches = common.launches_of(*reports)
        with self._lock:
            self.launches[name] = launches
        problems += common.launch_problems(name, self.device, launches)

    def base_gates(self, name, rc, records, report, stderr, problems):
        from mpi_openmp_cuda_tpu_torch.obs.metrics import validate_report

        if rc != 0:
            problems.append(f"{name}: coordinator exit code: want 0, got {rc}\n"
                            f"{stderr[-3000:]}")
        if "Traceback" in stderr:
            problems.append(f"{name}: coordinator crashed (Traceback on stderr)")
        if report is None:
            problems.append(f"{name}: no readable run report")
        else:
            try:
                validate_report(report)
            except ValueError as e:
                problems.append(f"{name}: {e}")
            if report["gauges"].get("shed_state") != "accept":
                problems.append(f"{name}: fleet faults must not trip admission: want "
                                f"shed_state 'accept', got "
                                f"{report['gauges'].get('shed_state')!r}")
        got = common.by_id(records)
        baseline = self.want_baseline()
        if got != baseline:
            problems.append(f"{name}: per-id records must be byte-identical to the clean "
                            f"fleetless run (exactly once, no loss, no doubles); want "
                            f"{baseline}, got {got}")

    @staticmethod
    def counter_gates(name, report, wants, problems):
        if report is None:
            return
        c = report.get("counters", {})
        for counter, want in wants.items():
            if c.get(counter, 0) < want:
                problems.append(f"{name}: counters.{counter}: want >= {want}, got "
                                f"{c.get(counter, 0)}")

    # -- scenarios --------------------------------------------------------------
    def scenario_baseline(self, problems):
        """The clean fleetless run every scenario's records must match."""
        try:
            rc, records, report, stderr = self.run_coordinator("baseline")
            if rc != 0 or "Traceback" in stderr:
                problems.append(f"baseline: clean run failed (rc {rc})\n{stderr[-3000:]}")
            self.baseline = common.by_id(records)
            answered = {r.get("id") for r in records if r.get("done")}
            if answered != {"r1", "r2"}:
                problems.append(f"baseline: want r1+r2 done, got {sorted(answered)}")
            self.scoring_gates("baseline", [report], problems)
        finally:
            self.baseline_ready.set()

    def scenario_kill_worker(self, problems):
        """kill -9 the claiming worker mid-superblock; a survivor that
        enlists after the death scores the re-dispatched epoch.  The doomed
        worker is the only one registered when the coordinator starts, so
        it claims the block and dies (``kill:fleet-worker`` fires at score
        entry, after the claim)."""
        name = "kill-worker"
        board = os.path.join(self.out, f"{name}.board")
        doomed = self.worker(board, f"{name}-doomed", faults="kill:fleet-worker:fail=1")
        box: list[Worker] = []
        try:
            if not self.registered(doomed):
                problems.append(f"{name}: doomed worker never registered")
                return
            relief = self.relief(doomed, board, f"{name}-survivor", box)
            rc, records, report, stderr = self.run_coordinator(
                name, board=board,
                env_extra={"SEQALIGN_LEASE_S": "8", "SEQALIGN_FLEET_WORKERS": "2"})
            relief.join(timeout=120)
        finally:
            doomed_rc = doomed.reap()
            for w in box:
                w.reap()
        self.base_gates(name, rc, records, report, stderr, problems)
        if doomed_rc != -signal.SIGKILL:
            problems.append(f"{name}: doomed worker must die by SIGKILL, got rc {doomed_rc}")
        self.counter_gates(name, report, {"fleet_joins": 2, "fleet_deaths": 1,
                                          "fleet_redispatches": 1}, problems)
        problems += common.stale_key_problems(name, board)
        self.scoring_gates(name, [report] + [self.worker_report(w.tag) for w in box],
                           problems)

    def scenario_zombie_fence(self, problems):
        """A worker scores, then freezes its heartbeats and outlives its
        lease before posting: the block is already rescued, so the stale
        epoch-0 post lands on the board but never reaches a client."""
        name = "zombie-fence"
        board = os.path.join(self.out, f"{name}.board")
        zombie = self.worker(board, name, faults="zombie:fleet-worker:fail=1")
        try:
            if not self.registered(zombie):
                problems.append(f"{name}: zombie worker never registered")
                return
            rc, records, report, stderr = self.run_coordinator(
                name, board=board,
                env_extra={"SEQALIGN_LEASE_S": "1", "SEQALIGN_FLEET_WORKERS": "1"})
        finally:
            zombie_rc = zombie.reap()
        self.base_gates(name, rc, records, report, stderr, problems)
        if zombie_rc != 0:
            problems.append(f"{name}: the zombie must exit 0 after its stale post, got "
                            f"rc {zombie_rc}")
        self.counter_gates(name, report, {"fleet_deaths": 1, "fleet_redispatches": 1},
                           problems)
        # Either face of the smoking gun: the stale epoch-0 post was
        # fence-counted (it landed before the final sweep), or the raw file
        # is still on the board (it landed after the run completed).  The
        # byte-identical gate already proved no client saw it.
        fenced = int((report or {}).get("counters", {}).get("fleet_fenced_posts", 0))
        stale = os.path.join(board, "seqalign", "fleet", "result", "g0b1", "e0")
        if fenced < 1 and not os.path.exists(stale):
            problems.append(f"{name}: the zombie's stale e0 result was neither "
                            f"fence-counted (fleet_fenced_posts=0) nor left on the board "
                            f"at {stale}; did it ever post?")
        self.scoring_gates(name, [report, self.worker_report(name)], problems)

    def _lease_scenario(self, name, faults, problems):
        board = os.path.join(self.out, f"{name}.board")
        worker = self.worker(board, name, faults=faults)
        try:
            if not self.registered(worker):
                problems.append(f"{name}: worker never registered")
                return
            rc, records, report, stderr = self.run_coordinator(
                name, board=board,
                env_extra={"SEQALIGN_LEASE_S": "3", "SEQALIGN_FLEET_WORKERS": "1"})
        finally:
            worker_rc = worker.reap()
        self.base_gates(name, rc, records, report, stderr, problems)
        if worker_rc != 0:
            problems.append(f"{name}: worker must exit clean, got rc {worker_rc}")
        self.counter_gates(name, report, {"fleet_lease_expiries": 1,
                                          "fleet_redispatches": 1}, problems)
        problems += common.stale_key_problems(name, board)
        self.scoring_gates(name, [report, self.worker_report(name)], problems)

    def scenario_torn_post(self, problems):
        """A torn half-written result reads as missing; lease expiry
        re-dispatches and the bumped epoch scores clean."""
        self._lease_scenario("torn-post", "board:torn-post:fail=1", problems)

    def scenario_lease_stall(self, problems):
        """A worker claims and never scores; lease expiry re-dispatches and
        the same worker completes the bumped epoch."""
        self._lease_scenario("lease-stall", "lease:stall:fail=1", problems)

    def scenario_coordinator_kill(self, problems):
        """SIGKILL the coordinator with its superblock in flight; the
        standby wins generation 1, replays the checkpoint and answers both
        requests.  ``kill:fleet-coordinator:fail=1,after=1`` fires at the
        second pump tick: tick 1 has dispatched the block and checkpointed
        both requests as unanswered, tick 2 dies before its collect, so
        exactly-once holds deterministically."""
        name = "coordinator-kill"
        board = os.path.join(self.out, f"{name}.board")
        fleet_env = {"SEQALIGN_LEASE_S": "2", "SEQALIGN_FLEET_WORKERS": "1"}
        worker = self.worker(board, name)
        standby_out = open(os.path.join(self.out, f"{name}.standby.ndjson"), "w+")
        standby_log_path = os.path.join(self.out, f"{name}.standby.log")
        standby_log = open(standby_log_path, "w")
        standby_report = os.path.join(self.out, f"{name}.standby.report.json")
        standby = subprocess.Popen(
            common.cli_argv(self.device, "--fleet-standby", "--fleet-board", board,
                            "--metrics-out", standby_report),
            cwd=common.REPO, env=common.drill_env(self.out, fleet_env), stdout=standby_out,
            stderr=standby_log)
        standby_rc = None
        try:
            if not self.registered(worker):
                problems.append(f"{name}: worker never registered")
                return
            rc, records, report, stderr = self.run_coordinator(
                name, board=board, env_extra=fleet_env,
                faults="kill:fleet-coordinator:fail=1,after=1", expect_kill=True)
            try:
                standby_rc = standby.wait(timeout=240)
            except subprocess.TimeoutExpired:
                problems.append(f"{name}: standby never completed the takeover")
        finally:
            if standby.poll() is None:
                standby.kill()
                standby.wait()
            worker_rc = worker.reap()
            standby_out.seek(0)
            standby_records = common.parse_records(standby_out.read())
            standby_out.close()
            standby_log.close()
        if rc != -signal.SIGKILL:
            problems.append(f"{name}: coordinator must die by SIGKILL, got rc {rc}")
        if standby_rc != 0:
            problems.append(f"{name}: standby must exit 0 after serving, got rc {standby_rc}")
        if worker_rc != 0:
            problems.append(f"{name}: worker must exit clean, got rc {worker_rc}")
        with open(standby_log_path) as fh:
            if "Traceback" in fh.read():
                problems.append(f"{name}: standby crashed (Traceback on stderr)")
        # The one promise: the dead leader's replies and the successor's,
        # merged, are byte-identical to the clean baseline per id.
        got = common.by_id(records + standby_records)
        baseline = self.want_baseline()
        if got != baseline:
            problems.append(f"{name}: combined coordinator+standby records must be "
                            f"byte-identical to the clean fleetless run; want {baseline}, "
                            f"got {got}")
        sb_report = common.load_report(standby_report, problems, f"{name} standby report")
        if sb_report is not None:
            if sb_report["gauges"].get("fleet_leader_epoch") != 1:
                problems.append(f"{name}: standby must lead generation 1, gauge says "
                                f"{sb_report['gauges'].get('fleet_leader_epoch')!r}")
            self.counter_gates(f"{name}(standby)", sb_report, {
                "fleet_takeovers": 1, "fleet_leader_fenced": 1, "fleet_joins": 1}, problems)
        problems += common.stale_key_problems(name, board)
        self.scoring_gates(name, [report, sb_report, self.worker_report(name)], problems)

    def scenario_burst_overload(self, problems):
        """Sustained 5x overload while a worker is murdered: the bucket sheds
        typed rejections only, the one admitted request survives the kill
        and re-dispatch exactly once, nothing is dropped or doubled.

        Admission: the cost scale prices r1 at exactly 1.0 modelled second
        (the port's Hopper launch model) against a 2.0 s budget, so r1
        (bucket empty: always admitted) charges half the budget;
        ``burst:overload:fail=8,after=1`` skips r1's probe and prices each
        follower at 5x (5.0 s > the 1.0 s left), so all eight shed with
        ``overloaded`` and the retry hint while r1 is out on the fleet.
        Fleet: kill-worker's staging."""
        from mpi_openmp_cuda_tpu_torch.serve.slo import RequestCostModel

        name = "burst-overload"
        r1 = self.reqs[0]
        prior_s = RequestCostModel(scale=1.0).request_cost_s(r1)
        if prior_s <= 0.0:
            problems.append(f"{name}: the cost model priced the baseline request at "
                            f"{prior_s}; cannot stage the bucket")
            return
        fleet_env = {
            "SEQALIGN_LEASE_S": "8",
            "SEQALIGN_FLEET_WORKERS": "2",
            "SEQALIGN_SERVE_COST_SCALE": f"{1.0 / prior_s:.9g}",
            "SEQALIGN_SERVE_COST_BUDGET_S": "2.0",
        }
        overload = [self.shapes.req(f"o{i}", ["TTTT"]) for i in range(1, 9)]
        board = os.path.join(self.out, f"{name}.board")
        doomed = self.worker(board, f"{name}-doomed", faults="kill:fleet-worker:fail=1")
        box: list[Worker] = []
        try:
            if not self.registered(doomed):
                problems.append(f"{name}: doomed worker never registered")
                return
            relief = self.relief(doomed, board, f"{name}-survivor", box)
            rc, records, report, stderr = self.run_coordinator(
                name, board=board, faults="burst:overload:fail=8,after=1",
                env_extra=fleet_env, reqs=[r1] + overload)
            relief.join(timeout=120)
        finally:
            doomed_rc = doomed.reap()
            for w in box:
                w.reap()
        from mpi_openmp_cuda_tpu_torch.obs.metrics import validate_report

        if rc != 0:
            problems.append(f"{name}: coordinator exit code: want 0, got {rc}\n"
                            f"{stderr[-3000:]}")
        if "Traceback" in stderr:
            problems.append(f"{name}: coordinator crashed (Traceback on stderr)")
        if doomed_rc != -signal.SIGKILL:
            problems.append(f"{name}: doomed worker must die by SIGKILL, got rc {doomed_rc}")
        if report is None:
            problems.append(f"{name}: no readable run report")
        else:
            try:
                validate_report(report)
            except ValueError as e:
                problems.append(f"{name}: {e}")
            if report["gauges"].get("shed_state") != "accept":
                problems.append(f"{name}: bucket sheds must not trip the wait-driven shed "
                                f"machine: want shed_state 'accept', got "
                                f"{report['gauges'].get('shed_state')!r}")
        got = common.by_id(records)
        baseline = self.want_baseline()
        if got.get("r1") != baseline.get("r1"):
            problems.append(f"{name}: r1 must survive the kill byte-identical to the clean "
                            f"run; want {baseline.get('r1')}, got {got.get('r1')}")
        for raw in overload:
            oid = raw["id"]
            recs = [r for r in records if r.get("id") == oid]
            if len(recs) != 1:
                problems.append(f"{name}: {oid}: want exactly one reply, got {len(recs)}: "
                                f"{recs}")
                continue
            rec = recs[0]
            if rec.get("error") != "overloaded":
                problems.append(f"{name}: {oid}: want a typed 'overloaded' shed, got {rec}")
            ra = rec.get("retry_after_s")
            if not isinstance(ra, (int, float)) or ra <= 0:
                problems.append(f"{name}: {oid}: overloaded shed lacks a positive "
                                f"retry_after_s hint, got {ra!r}")
        self.counter_gates(name, report, {"serve_shed": 8, "fleet_joins": 2,
                                          "fleet_deaths": 1, "fleet_redispatches": 1},
                           problems)
        problems += common.stale_key_problems(name, board)
        self.scoring_gates(name, [report] + [self.worker_report(w.tag) for w in box],
                           problems)

    def scenario_usage(self, problems):
        """--fleet-worker / --fleet-standby without --fleet-board: exit 64."""
        for flag in ("--fleet-worker", "--fleet-standby"):
            proc = subprocess.run(common.cli_argv(self.device, flag), cwd=common.REPO,
                                  env=common.drill_env(self.out), capture_output=True,
                                  text=True, timeout=120)
            if proc.returncode != 64:
                problems.append(f"usage: {flag} without --fleet-board: want exit 64, got "
                                f"{proc.returncode}")
            if "--fleet-board" not in proc.stderr:
                problems.append(f"usage: {flag}: stderr must name the missing flag, got: "
                                f"{proc.stderr.strip()[:200]}")


def main(argv=None) -> int:
    args = common.parse_args(PROG, __doc__, argv)
    if not common.require_device(PROG, args.device):
        return 1
    out = tempfile.mkdtemp(prefix="torch_fleet_chaos_")
    drill = Drill(args.device, args.small, out)
    # Two waves: the scenarios whose survivor must enlist inside the 8 s
    # lease after a death start once the first wave's processes are gone,
    # so no cold start of theirs competes with a dozen others.
    results = common.run_scenarios(
        [("baseline", drill.scenario_baseline),
         ("zombie-fence", drill.scenario_zombie_fence),
         ("torn-post", drill.scenario_torn_post),
         ("lease-stall", drill.scenario_lease_stall),
         ("coordinator-kill", drill.scenario_coordinator_kill),
         ("usage", drill.scenario_usage)],
        [("kill-worker", drill.scenario_kill_worker),
         ("burst-overload", drill.scenario_burst_overload)],
    )
    results = {name: results[name] for name in SCENARIOS}
    problems = [p for ps in results.values() for p in ps]
    total = dict.fromkeys(common.KERNELS, 0)
    for launches in drill.launches.values():
        common.add_launches(total, launches)
    record = {"device": args.device, "small": args.small,
              "scenarios": {n: "fail" if ps else "ok" for n, ps in results.items()},
              "launches": total, "launches_by_scenario": drill.launches,
              "registration_s": drill.registration_s}
    return common.finish(TAG, problems, "kill -9 redispatch, zombie fence, torn post, lease "
                                        "stall, coordinator kill -9 -> standby takeover, "
                                        "burst overload under worker kill, usage gates; "
                                        f"launches={total}; artifacts={out}", record)


if __name__ == "__main__":
    sys.exit(main())
