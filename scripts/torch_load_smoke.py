#!/usr/bin/env python3
"""Open-loop load smoke and refit A/B gate of the port, the counterpart
of ``scripts/load_smoke.py``.

    python3 scripts/torch_load_smoke.py                     # on the card
    python3 scripts/torch_load_smoke.py --device cpu --small

Boots ``python -m mpi_openmp_cuda_tpu_torch --serve --port 0
--metrics-out --trace-out`` as a real process and drives it with the
port's load plane (``mpi_openmp_cuda_tpu_torch/load``) through the
measure-model-refit loop:

1. **calibrate**: one warm-up phase a length bucket, a capacity burst,
   then a constant phase just under saturation whose goodput is the
   pre-saturation plateau every later gate is relative to;
2. **2x** (the captured schedule): constant arrivals at twice the
   plateau, saved to disk; every request answered or typed-rejected,
   goodput at least 80 % of the plateau, and the ``serve-load`` record
   validates;
3. **5x**: bursty arrivals at five times the plateau with a deadline mix
   (``deadline_mix=0.4``): answered-or-typed;
4. **refit** (``load/refit.py``) from server A's trace ``gap_attribution``
   (at least ``refit.MIN_LAUNCHES`` priced launches) and its queue-wait
   percentiles, anchored to the port's registry default of
   ``SEQALIGN_SERVE_COST_BUDGET_S``;
5. **replay A/B**: the same saved 2x schedule against two fresh servers,
   b1 with the prior knobs and b2 with the refit's; b2's p99 queue wait
   must be strictly lower, and b2 must shed typed ``overloaded`` records
   carrying ``retry_after_s``.

Every server is also gated on SIGTERM -> 75, a valid report and trace,
the shed and breaker transitions of its trace (one step a tick) and, on
the card, fused and packed launches in its report.

Under ``--small`` every rate, count and shape is the JAX script's
(:data:`SMALL`).  Without it (:func:`card_profile`) the requests are the
serve plane's users' (Seq1 3000, four to eight Seq2 of 1200-1999 or of
5-64 chars) and the phases are derived again instead of copied: the
capacity burst is ``SERVE_CAL_N`` requests at once, as chip_smoke.py's
serve phase calibrates, the plateau runs ``PLATEAU_S`` seconds, the 2x
phase ``SERVE_LOAD_S`` and the 5x phase ``FIVE_X_S`` seconds, each capped
at ``SERVE_LOAD_MAX`` requests, the calibrated rate is not clamped, and the
servers' queue holds ``SERVE_LOAD_MAX`` requests (:func:`card_profile`).
Prints one JSON record (plateau, 2x and 5x goodput and p99 latency, the
refit's scale and budget, b1's and b2's p99 queue wait, the launches),
then the OK line or every problem; exits 0 or 1.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_drill_common as common  # noqa: E402

PROG = "torch_load_smoke"
TAG = "load-smoke"
SEED = 7
SHED_WAIT_S = 0.75
#: The refit SLO: p90 queue wait at most this.  Well under SHED_WAIT_S, so
#: the refit budget lands inside the reactive shed machine's backstop
#: (which trips only once waits reach 0.75 s): the A/B gate measures the
#: bucket's proactive pricing, not the backstop both runs share.
TARGET_WAIT_S = 0.1
GRACE_S = 60.0

# The card's phases, sized by duration (chip_smoke.py's serve phase).
SERVE_CAL_N = 256
PLATEAU_S = 3.0
SERVE_LOAD_S = 10.0
FIVE_X_S = 2.0
SERVE_LOAD_MAX = 8000


@dataclasses.dataclass(frozen=True)
class Profile:
    """Every rate, count and shape of one run of the drill."""

    workload: dict
    len_mix: tuple
    clients: int
    server_env: dict
    warm_n: int
    cal_n: int
    cal_rate: float
    cal_clamp: tuple  # (lo, hi) on the calibrated rate; hi None: no clamp
    plateau_n: tuple  # (duration s, fixed count): one of the two set
    two_x: tuple  # (duration s, min, max) requests
    five_x: tuple  # (duration s, min, max) requests


def _count(rate: float, duration_s: float, lo: int, hi: int) -> int:
    return int(min(hi, max(lo, rate * duration_s)))


#: The JAX drill's numbers: compute-bound requests for a CPU running XLA
#: (Seq1 512, Seq2 300-512), the 60 req/s clamp, the 120 and 80 caps.
SMALL = Profile(
    workload=dict(problem_keys=2, pairs_per_request=(4, 8), seq1_len=512),
    len_mix=((300, 384, 0.5), (450, 512, 0.5)),
    clients=24,
    server_env={"SEQALIGN_SERVE_BLOCK_ROWS": "8", "SEQALIGN_SERVE_MAX_QUEUE": "96"},
    warm_n=4,
    cal_n=16,
    cal_rate=200.0,
    cal_clamp=(2.0, 60.0),
    plateau_n=(None, 24),
    two_x=(2.5, 24, 120),
    five_x=(1.2, 16, 80),
)


def card_profile() -> Profile:
    """The card's run: the serve plane's users' requests (both kernels),
    the phases derived from the calibrated capacity by duration."""
    return Profile(
        workload=dict(problem_keys=2, pairs_per_request=(4, 8),
                      seq1_len=common.FULL_SEQ1_LEN),
        len_mix=((*common.LONG_LENS, 0.5), (*common.SHORT_LENS, 0.5)),
        clients=24,
        # The JAX drill's queue of 96 holds seconds of its CPU server's
        # work, far past SHED_WAIT_S, so its depth never decides a wait and
        # the A/B measures the refit bucket.  On the card 96 (or the
        # default 256) requests drain in 0.1-0.3 s: the depth backstop
        # would cap both replays' waits alike.  A queue of SERVE_LOAD_MAX
        # never fills.
        server_env={"SEQALIGN_SERVE_MAX_QUEUE": str(SERVE_LOAD_MAX)},
        warm_n=4,
        cal_n=SERVE_CAL_N,
        cal_rate=4000.0,
        cal_clamp=(2.0, None),
        plateau_n=(PLATEAU_S, None),
        two_x=(SERVE_LOAD_S, 24, SERVE_LOAD_MAX),
        five_x=(FIVE_X_S, 16, SERVE_LOAD_MAX),
    )


def prior_budget_s() -> float:
    """The admission budget the refit anchors to: the port's registry
    default of ``SEQALIGN_SERVE_COST_BUDGET_S``."""
    from mpi_openmp_cuda_tpu_torch.utils.env import ENV_VARS

    return float(next(v.default for v in ENV_VARS
                      if v.name == "SEQALIGN_SERVE_COST_BUDGET_S"))


def requests(profile: Profile, n: int, seed: int, prefix: str, len_mix=None, **extra):
    from mpi_openmp_cuda_tpu_torch.load import workload

    return workload.synth_requests(n, seed=seed, id_prefix=prefix,
                                   len_mix=len_mix or profile.len_mix,
                                   **profile.workload, **extra)


def warm_schedules(profile: Profile) -> list:
    """One warm-up schedule a length bucket, so every shape is paid for
    before anything is measured."""
    from mpi_openmp_cuda_tpu_torch.load import arrival, replay

    return [replay.build_schedule(
                arrival.arrival_times("burst", profile.warm_n, 50.0, seed=SEED),
                requests(profile, profile.warm_n, SEED + i, f"w{i}",
                         len_mix=((lo, hi, 1.0),)))
            for i, (lo, hi, _) in enumerate(profile.len_mix)]


def calibration_schedule(profile: Profile):
    from mpi_openmp_cuda_tpu_torch.load import arrival, replay

    return replay.build_schedule(
        arrival.arrival_times("burst", profile.cal_n, profile.cal_rate, seed=SEED),
        requests(profile, profile.cal_n, SEED + 1, "c"))


def calibrated_rate(profile: Profile, goodput: float) -> float:
    lo, hi = profile.cal_clamp
    rate = max(goodput, lo)
    return rate if hi is None else min(rate, hi)


def plateau_schedule(profile: Profile, c0: float):
    from mpi_openmp_cuda_tpu_torch.load import arrival, replay

    rate = max(3.0, 0.9 * c0)
    duration, fixed = profile.plateau_n
    n = fixed if fixed is not None else _count(rate, duration, 24, SERVE_LOAD_MAX)
    return rate, replay.build_schedule(
        arrival.arrival_times("constant", n, rate, seed=SEED),
        requests(profile, n, SEED + 2, "p"))


def schedule_2x(profile: Profile, plateau: float):
    from mpi_openmp_cuda_tpu_torch.load import arrival, replay

    rate = 2.0 * plateau
    n = _count(rate, *profile.two_x)
    return rate, replay.build_schedule(
        arrival.arrival_times("constant", n, rate, seed=SEED),
        requests(profile, n, SEED + 3, "a"))


def schedule_5x(profile: Profile, plateau: float):
    from mpi_openmp_cuda_tpu_torch.load import arrival, replay

    rate = 5.0 * plateau
    n = _count(rate, *profile.five_x)
    return rate, replay.build_schedule(
        arrival.arrival_times("burst", n, rate, seed=SEED, burst_size=8),
        requests(profile, n, SEED + 4, "b", deadline_mix=0.4, deadline_s=2.0))


def refit_from(trace: dict | None, report: dict | None):
    """The refit of server A's measurements against the prior."""
    from mpi_openmp_cuda_tpu_torch.load import refit

    return refit.refit((trace or {}).get("gap_attribution"), report,
                       prior_budget_s=prior_budget_s(), target_wait_s=TARGET_WAIT_S)


class Server:
    """One ``--serve --port 0`` process with report and trace outputs."""

    def __init__(self, device: str, tag: str, out: str, profile: Profile,
                 extra_env: dict | None = None):
        self.tag = tag
        self.report_path = os.path.join(out, f"{tag}_run.json")
        self.trace_path = os.path.join(out, f"{tag}_trace.json")
        env = common.drill_env(out)
        for k, v in profile.server_env.items():
            env.setdefault(k, v)
        env["SEQALIGN_SERVE_SHED_WAIT_S"] = f"{SHED_WAIT_S:g}"
        env.update(extra_env or {})
        self.proc = subprocess.Popen(
            common.cli_argv(device, "--serve", "--port", "0", "--metrics-out",
                            self.report_path, "--trace-out", self.trace_path),
            stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            cwd=common.REPO, env=env, text=True)
        self.port: int | None = None
        self.stderr_lines: list[str] = []
        self._drain: threading.Thread | None = None
        for line in self.proc.stderr:
            self.stderr_lines.append(line)
            m = common.PORT_RE.search(line)
            if m:
                self.port = int(m.group(1))
                break
        if self.port is not None:
            # Keep draining stderr, so the server never blocks on a full pipe.
            self._drain = threading.Thread(
                target=lambda: self.stderr_lines.extend(self.proc.stderr), daemon=True)
            self._drain.start()

    def stop(self):
        """SIGTERM, wait, load and validate both artifacts:
        ``(exit code, report, trace, problems)``."""
        problems: list[str] = []
        rc = None
        try:
            if self.proc.poll() is None:
                self.proc.send_signal(signal.SIGTERM)
            rc = self.proc.wait(timeout=120)
            if self._drain is not None:
                self._drain.join(10)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait(timeout=30)
        if rc != 75:
            problems.append(f"{self.tag}: exit code: want 75 (drained), got {rc}\n"
                            f"{''.join(self.stderr_lines)[-3000:]}")
        if "Traceback" in "".join(self.stderr_lines):
            problems.append(f"{self.tag}: server crashed (Traceback on stderr)")
        report = common.load_report(self.report_path, problems, f"{self.tag} report")
        trace = common.load_report(self.trace_path, problems, f"{self.tag} trace")
        return rc, report, trace, problems


def drive(server: Server, sched, profile: Profile):
    from mpi_openmp_cuda_tpu_torch.load import driver

    return driver.drive("127.0.0.1", server.port, sched, clients=profile.clients,
                        grace_s=GRACE_S)


def fmt(result) -> str:
    c = result.counts()
    return (f"offered={result.offered} done={c['done']} rejected={c['rejected']} "
            f"failed={c['failed']} missing={c['missing']} reset={c['reset']} "
            f"goodput={result.goodput_rps:.3f}/s")


def p99_latency(result):
    from mpi_openmp_cuda_tpu_torch.obs.metrics import percentile

    lat = result.latencies_s()
    return round(percentile(lat, 0.99), 6) if lat else None


def queue_wait_p99(report):
    return (((report or {}).get("histograms") or {}).get("queue_wait_s") or {}).get("p99")


def server_gates(device, tag, report, trace, problems, launches):
    from mpi_openmp_cuda_tpu_torch.load import gates

    if trace is not None:
        problems += gates.transition_problems(trace.get("traceEvents", []))
    counted = common.launches_of(report)
    launches[tag] = counted
    problems += common.launch_problems(tag, device, counted)


def main(argv=None) -> int:
    from mpi_openmp_cuda_tpu_torch.load import gates, refit, replay
    from mpi_openmp_cuda_tpu_torch.load import report as load_report
    from mpi_openmp_cuda_tpu_torch.obs.metrics import validate_report

    args = common.parse_args(PROG, __doc__, argv)
    if not common.require_device(PROG, args.device):
        return 1
    profile = SMALL if args.small else card_profile()
    out = tempfile.mkdtemp(prefix="torch_load_smoke_")
    problems: list[str] = []
    launches: dict[str, dict] = {}
    record: dict = {"device": args.device, "small": args.small, "launches_by_server": launches}

    def log(msg):
        common.log(TAG, msg)

    # ---- server A: calibrate, saturate, capture ------------------------------
    srv = Server(args.device, "a", out, profile)
    if srv.port is None:
        print(f"{TAG}: FAIL: server A never announced its port")
        sys.stderr.write("".join(srv.stderr_lines))
        return 1
    for i, warm in enumerate(warm_schedules(profile)):
        problems += gates.survival_problems(drive(srv, warm, profile), phase=f"warmup{i}")
    cal = drive(srv, calibration_schedule(profile), profile)
    problems += gates.survival_problems(cal, phase="calibrate")
    c0 = calibrated_rate(profile, cal.goodput_rps)
    plat_rate, plat_sched = plateau_schedule(profile, c0)
    plat = drive(srv, plat_sched, profile)
    problems += gates.survival_problems(plat, phase="plateau")
    plateau = plat.goodput_rps
    log(f"calibrated capacity~{c0:.3f}/s plateau={plateau:.3f}/s at {plat_rate:.3f}/s "
        f"({fmt(plat)})")
    record.update(calibrated_rps=c0, plateau_rps=plateau, plateau_p99_latency_s=p99_latency(plat))
    if plateau <= 0.0:
        srv.stop()
        return common.finish(TAG, problems + ["plateau goodput is zero; aborting phases"],
                             "", record)

    # 2x: THE captured schedule, saved for the refit A/B replay.
    rate2, sched2 = schedule_2x(profile, plateau)
    sched_path = os.path.join(out, "schedule_2x.jsonl")
    replay.save_schedule(sched_path, sched2)
    over2 = drive(srv, sched2, profile)
    problems += gates.survival_problems(over2, phase="2x", plateau_rps=plateau,
                                        min_goodput_frac=0.8)
    log(f"2x @ {rate2:.3f}/s: {fmt(over2)}")

    # 5x, bursty, with a deadline mix: answered-or-typed survival.
    rate5, sched5 = schedule_5x(profile, plateau)
    over5 = drive(srv, sched5, profile)
    problems += gates.survival_problems(over5, phase="5x")
    log(f"5x @ {rate5:.3f}/s: {fmt(over5)}")
    record.update({
        "2x": {"rate_rps": rate2, "offered": over2.offered, "goodput_rps": over2.goodput_rps,
               "p99_latency_s": p99_latency(over2), "counts": over2.counts()},
        "5x": {"rate_rps": rate5, "offered": over5.offered, "goodput_rps": over5.goodput_rps,
               "p99_latency_s": p99_latency(over5), "counts": over5.counts()},
    })

    _, report_a, trace_a, srv_problems = srv.stop()
    problems += srv_problems
    server_gates(args.device, "a", report_a, trace_a, problems, launches)

    # The serve-load bench record (the 2x phase against the plateau).
    rec = load_report.serve_load_record(over2, report_a, process="constant", rate_rps=rate2,
                                        seed=SEED, clients=profile.clients,
                                        plateau_rps=plateau)
    try:
        validate_report(rec)
    except ValueError as e:
        problems.append(f"serve-load record schema: {e}")
    record_path = os.path.join(out, "serve_load_record.json")
    with open(record_path, "w", encoding="utf-8") as fh:
        json.dump(rec, fh, indent=1, sort_keys=True)

    # ---- refit: measured gap rows and queue waits against the prior ----------
    if trace_a is None or report_a is None:
        return common.finish(TAG, problems + ["server A artifacts missing; cannot refit"],
                             "", record)
    fit = refit_from(trace_a, report_a)
    log("measured-vs-prior delta report:")
    for row in fit.delta_rows():
        log(f"  {row['knob']}: prior={row['prior']:g} refit={row['refit']:g} "
            f"drift={row['drift']:g}x ({row['evidence']})")
    for finding in fit.findings:
        log(f"  finding: {finding}")
    if fit.launches < refit.MIN_LAUNCHES:
        problems.append(f"refit: only {fit.launches} priced launches in the trace (want >= "
                        f"{refit.MIN_LAUNCHES}); the gap pipeline is dark")
    record["refit"] = {"scale": fit.scale, "budget_s": fit.budget_s,
                       "prior_budget_s": fit.prior_budget_s, "launches": fit.launches,
                       "drift": fit.drift, "measured_p90_wait_s": fit.measured_p90_wait_s}

    # ---- replay A/B: the same captured schedule, prior against refit ---------
    sched_replay = replay.load_schedule(sched_path)
    if [(t, raw) for t, raw in sched_replay] != [(round(t, 9), raw) for t, raw in sched2]:
        problems.append("the reloaded 2x schedule differs from the saved one")
    b_results: dict = {}
    for tag, extra_env in (("b1", {}), ("b2", fit.env())):
        srv_b = Server(args.device, tag, out, profile, extra_env=extra_env)
        if srv_b.port is None:
            problems.append(f"{tag}: server never announced its port")
            srv_b.stop()
            continue
        res = drive(srv_b, sched_replay, profile)
        problems += gates.survival_problems(res, phase=tag)
        _, report_b, trace_b, srv_problems = srv_b.stop()
        problems += srv_problems
        server_gates(args.device, tag, report_b, trace_b, problems, launches)
        b_results[tag] = (res, report_b)
        log(f"replay {tag}: {fmt(res)}")

    if "b1" in b_results and "b2" in b_results:
        res2 = b_results["b2"][0]
        p99_1, p99_2 = (queue_wait_p99(b_results[t][1]) for t in ("b1", "b2"))
        record["replay"] = {"b1_p99_queue_wait_s": p99_1, "b2_p99_queue_wait_s": p99_2,
                            "b1": b_results["b1"][0].counts(), "b2": res2.counts()}
        if not isinstance(p99_1, (int, float)) or not isinstance(p99_2, (int, float)):
            problems.append(f"replay A/B: queue_wait_s p99 missing from a report "
                            f"(b1={p99_1!r}, b2={p99_2!r})")
        else:
            log(f"refit A/B on the identical schedule: p99 queue wait {p99_1:.6f}s (prior) "
                f"-> {p99_2:.6f}s (refit)")
            if p99_2 >= p99_1:
                problems.append(f"refit did not improve p99 queue wait on the replayed "
                                f"schedule: prior {p99_1:.6f}s vs refit {p99_2:.6f}s")
        shed2 = [o for o in res2.outcomes if o.kind == "rejected"]
        if not shed2:
            problems.append("replay b2: the refit bucket admitted everything; expected "
                            "typed 'overloaded' sheds once admission is priced at measured "
                            "walls")
        elif any(o.retry_after_s is None for o in shed2):
            problems.append("replay b2: an overloaded rejection lacks the measured "
                            "retry_after_s hint")

    total = dict.fromkeys(common.KERNELS, 0)
    for counted in launches.values():
        common.add_launches(total, counted)
    record.update(launches=total, scenarios={"load": "fail" if problems else "ok"})
    return common.finish(TAG, problems,
                         f"plateau={plateau:.3f}/s, 2x retention="
                         f"{over2.goodput_rps / plateau:.2f}, refit scale={fit.scale:g}, "
                         f"budget={fit.budget_s:g}s, launches={total}, record={record_path}",
                         record)


if __name__ == "__main__":
    sys.exit(main())
