"""The port's load plane against the contract ``tests/test_load.py`` pins
for the JAX package (its tests, on ``mpi_openmp_cuda_tpu_torch/load/``):
arrival schedules, workload synthesis, record/replay, survival gates, the
refit loop and the serve-load record, plus one driver test against a
canned loopback ndjson server; then the port's generator and schedule
against the JAX package's (byte-identical for a seed), and one short
open-loop run against the port's own ``--serve`` in a subprocess.
"""

from __future__ import annotations

import json
import socket
import threading

import pytest

from mpi_openmp_cuda_tpu_torch.load import arrival, driver, gates, refit, replay, workload
from mpi_openmp_cuda_tpu_torch.load.report import serve_load_record
from mpi_openmp_cuda_tpu_torch.obs.metrics import validate_report
from mpi_openmp_cuda_tpu_torch.serve.slo import SHED_ACCEPT, SHED_DRAIN, SHED_NEW


# -- arrival processes -------------------------------------------------------


class TestArrival:
    def test_constant_is_evenly_spaced(self):
        assert arrival.constant_times(5, 2.0) == [0.0, 0.5, 1.0, 1.5, 2.0]

    def test_poisson_is_seeded_and_sorted(self):
        a = arrival.poisson_times(64, 10.0, seed=3)
        b = arrival.poisson_times(64, 10.0, seed=3)
        c = arrival.poisson_times(64, 10.0, seed=4)
        assert a == b  # same seed, same host-independent offsets
        assert a != c
        assert a == sorted(a) and all(t >= 0.0 for t in a)
        # Mean inter-arrival gap tracks 1/rate (loose: 64 draws).
        mean_gap = a[-1] / (len(a) - 1)
        assert 0.04 < mean_gap < 0.25

    def test_burst_groups_preserve_average_rate(self):
        times = arrival.burst_times(10, 2.0, burst_size=4)
        # Groups of 4 land together, spaced size/rate = 2 s apart.
        assert times == [0.0] * 4 + [2.0] * 4 + [4.0] * 2

    def test_ramp_gaps_shrink_toward_target_rate(self):
        times = arrival.ramp_times(32, 8.0, ramp_from_rps=2.0)
        gaps = [b - a for a, b in zip(times, times[1:])]
        assert gaps[0] == pytest.approx(1.0 / 2.0)
        assert gaps[-1] < gaps[0]  # the rate climbed
        assert all(g > 0.0 for g in gaps)

    def test_dispatch_and_validation(self):
        assert arrival.arrival_times("constant", 3, 1.0) == [0.0, 1.0, 2.0]
        with pytest.raises(ValueError, match="unknown arrival process"):
            arrival.arrival_times("lognormal", 3, 1.0)
        with pytest.raises(ValueError, match="count"):
            arrival.constant_times(-1, 1.0)
        with pytest.raises(ValueError, match="rate_rps"):
            arrival.constant_times(3, 0.0)
        with pytest.raises(ValueError, match="ramp_from_rps"):
            arrival.ramp_times(3, 1.0, ramp_from_rps=-1.0)


# -- workload synthesis ------------------------------------------------------


class TestWorkload:
    def test_same_seed_same_bytes(self):
        a = workload.synth_requests(24, seed=11)
        b = workload.synth_requests(24, seed=11)
        c = workload.synth_requests(24, seed=12)
        assert a == b
        assert a != c

    def test_problem_key_diversity_is_exact_round_robin(self):
        reqs = workload.synth_requests(12, seed=1, problem_keys=3)
        keys = [(tuple(r["weights"]), r["seq1"]) for r in reqs]
        assert len(set(keys)) == 3
        assert keys[0] == keys[3] == keys[6]  # round-robin, not stochastic

    def test_len_mix_and_pair_bounds_respected(self):
        reqs = workload.synth_requests(
            32,
            seed=2,
            len_mix=((10, 20, 1.0),),
            pairs_per_request=(2, 3),
            seq1_len=40,
        )
        for r in reqs:
            assert len(r["seq1"]) == 40
            assert 2 <= len(r["seq2"]) <= 3
            assert all(10 <= len(s) <= 20 for s in r["seq2"])

    def test_deadline_mix_extremes(self):
        none = workload.synth_requests(16, seed=3, deadline_mix=0.0)
        assert not any("deadline_s" in r for r in none)
        every = workload.synth_requests(
            16, seed=3, deadline_mix=1.0, deadline_s=2.5
        )
        assert all(r["deadline_s"] == 2.5 for r in every)

    def test_validation_errors(self):
        with pytest.raises(ValueError, match="count"):
            workload.synth_requests(-1, seed=0)
        with pytest.raises(ValueError, match="inverted"):
            workload.synth_requests(1, seed=0, pairs_per_request=(3, 2))
        with pytest.raises(ValueError, match="len_mix"):
            workload.synth_requests(1, seed=0, len_mix=((10, 4, 1.0),))
        with pytest.raises(ValueError, match="deadline_mix"):
            workload.synth_requests(1, seed=0, deadline_mix=1.5)


# -- record/replay -----------------------------------------------------------


class TestReplay:
    def _sched(self):
        reqs = workload.synth_requests(4, seed=5)
        return replay.build_schedule([0.0, 0.5, 1.0, 1.5], reqs)

    def test_build_schedule_sorts_and_validates(self):
        reqs = workload.synth_requests(2, seed=5)
        sched = replay.build_schedule([1.0, 0.25], reqs)
        assert [t for t, _ in sched] == [0.25, 1.0]
        with pytest.raises(ValueError, match="shape mismatch"):
            replay.build_schedule([0.0], reqs)
        with pytest.raises(ValueError, match=">= 0"):
            replay.build_schedule([-1.0, 0.0], reqs)

    def test_scale_schedule_compresses_gaps(self):
        sched = self._sched()
        fast = replay.scale_schedule(sched, 2.0)
        assert [t for t, _ in fast] == [0.0, 0.25, 0.5, 0.75]
        assert [r for _, r in fast] == [r for _, r in sched]  # same bodies
        with pytest.raises(ValueError, match="k must be > 0"):
            replay.scale_schedule(sched, 0.0)

    def test_save_load_round_trip(self, tmp_path):
        sched = self._sched()
        path = str(tmp_path / "cap.jsonl")
        replay.save_schedule(path, sched)
        assert replay.load_schedule(path) == sched

    def test_load_rejects_torn_capture_naming_the_line(self, tmp_path):
        path = str(tmp_path / "torn.jsonl")
        with open(path, "w", encoding="utf-8") as fh:
            fh.write('{"t_s": 0.0, "raw": {"id": "a"}}\n')
            fh.write('{"t_s": 0.5, "raw"\n')  # torn mid-write
        with pytest.raises(ValueError, match="torn.jsonl:2"):
            replay.load_schedule(path)
        with open(path, "w", encoding="utf-8") as fh:
            fh.write('{"t_s": -2, "raw": {"id": "a"}}\n')
        with pytest.raises(ValueError, match="torn.jsonl:1"):
            replay.load_schedule(path)


# -- survival gates ----------------------------------------------------------


def _result(outcomes, *, duration_s=10.0):
    return driver.LoadResult(
        outcomes=outcomes,
        offered=len(outcomes),
        duration_s=duration_s,
        send_span_s=duration_s,
    )


def _done(i, latency=0.1):
    return driver.Outcome(id=f"q{i}", kind="done", latency_s=latency)


class TestSurvivalGates:
    def test_all_answered_passes(self):
        res = _result(
            [_done(0), driver.Outcome(id="q1", kind="rejected",
                                      error="overloaded", retry_after_s=0.5)]
        )
        assert gates.survival_problems(res, phase="2x") == []

    def test_silent_drop_and_reset_are_fatal(self):
        res = _result(
            [
                _done(0),
                driver.Outcome(id="q1", kind="missing"),
                driver.Outcome(id="q2", kind="reset", error="ECONNRESET"),
            ]
        )
        problems = gates.survival_problems(res, phase="5x")
        assert any("silently dropped" in p for p in problems)
        assert any("connection resets" in p for p in problems)

    def test_untyped_rejection_lacks_backoff_hint(self):
        res = _result(
            [driver.Outcome(id="q0", kind="rejected", error="overloaded")]
        )
        problems = gates.survival_problems(res, phase="2x")
        assert any("retry_after_s" in p for p in problems)

    def test_goodput_collapse_past_saturation(self):
        # 4 done over 10 s = 0.4 req/s against a 1.0 req/s plateau.
        res = _result([_done(i) for i in range(4)])
        problems = gates.survival_problems(
            res, phase="2x", plateau_rps=1.0, min_goodput_frac=0.8
        )
        assert any("collapsed" in p for p in problems)
        assert gates.survival_problems(
            res, phase="2x", plateau_rps=0.45, min_goodput_frac=0.8
        ) == []

    def test_require_typed_shed(self):
        res = _result([_done(0)])
        problems = gates.survival_problems(
            res, phase="5x", require_typed_shed=True
        )
        assert any("expected typed sheds" in p for p in problems)


def _instant(name, **args):
    return {"ph": "i", "name": name, "args": args}


class TestTransitionGates:
    def test_legal_shed_and_breaker_sequences_pass(self):
        events = [
            _instant("serve.shed.state", state=SHED_NEW),
            _instant("serve.shed.state", state=SHED_DRAIN),
            _instant("serve.shed.state", state=SHED_NEW),
            _instant("serve.shed.state", state=SHED_ACCEPT),
            _instant("breaker.open"),
            _instant("breaker.half_open"),
            _instant("breaker.close"),
        ]
        assert gates.transition_problems(events) == []

    def test_teleporting_shed_transition_flagged(self):
        events = [_instant("serve.shed.state", state=SHED_DRAIN)]
        problems = gates.transition_problems(events)
        assert any("illegal transition" in p for p in problems)

    def test_unknown_shed_state_flagged(self):
        problems = gates.transition_problems(
            [_instant("serve.shed.state", state="panic")]
        )
        assert any("unknown state" in p for p in problems)

    def test_illegal_breaker_transition_flagged(self):
        problems = gates.transition_problems([_instant("breaker.half_open")])
        assert any("breaker sequence" in p for p in problems)


# -- the refit loop ----------------------------------------------------------


def _gap(launches):
    return {
        "launches": [
            {"measured_s": m, "modelled_s": mo} for m, mo in launches
        ]
    }


def _report(p90_wait):
    return {"histograms": {"queue_wait_s": {"p50": 0.0, "p90": p90_wait,
                                            "p99": p90_wait}}}


class TestRefit:
    def test_scale_from_gap_rows_with_drift_finding(self):
        # Measured walls 100x the modelled prior: refit the multiplier,
        # flag the drift, leave the prior itself untouched.
        fit = refit.refit(
            _gap([(1.0, 0.01), (2.0, 0.02), (3.0, 0.03)]),
            _report(0.0),
            prior_budget_s=4.0,
            target_wait_s=0.5,
        )
        assert fit.scale == pytest.approx(100.0)
        assert fit.prior_scale == 1.0 and fit.drift == pytest.approx(100.0)
        assert any("cost-model drift" in f for f in fit.findings)
        assert fit.env()["SEQALIGN_SERVE_COST_SCALE"] == "100"

    def test_thin_evidence_holds_the_prior(self):
        fit = refit.refit(
            _gap([(1.0, 0.01)]), _report(0.0),
            prior_budget_s=4.0, target_wait_s=0.5,
        )
        assert fit.scale == 1.0 and fit.launches == 1
        assert any("insufficient gap evidence" in f for f in fit.findings)

    def test_budget_shrinks_toward_target_wait(self):
        # p90 wait 1.0 s against a 0.1 s target: budget tightens 10x.
        fit = refit.refit(
            _gap([(0.01, 0.01)] * 3), _report(1.0),
            prior_budget_s=4.0, target_wait_s=0.1,
        )
        assert fit.budget_s == pytest.approx(0.4)
        assert any("admission-budget drift" in f for f in fit.findings)

    def test_wait_under_target_holds_the_budget(self):
        fit = refit.refit(
            _gap([(0.01, 0.01)] * 3), _report(0.05),
            prior_budget_s=4.0, target_wait_s=0.1,
        )
        assert fit.budget_s == 4.0
        assert not any("admission-budget" in f for f in fit.findings)

    def test_clamps_bound_both_knobs(self):
        fit = refit.refit(
            _gap([(1e9, 1e-9)] * 3), _report(1e6),
            prior_budget_s=4.0, target_wait_s=0.1,
        )
        assert fit.scale == refit.SCALE_CLAMP[1]
        assert fit.budget_s == pytest.approx(
            refit.BUDGET_CLAMP[0] * 4.0
        )  # floor: never tighten to zero

    def test_delta_rows_carry_evidence(self):
        fit = refit.refit(
            _gap([(1.0, 0.5)] * 4), _report(0.0),
            prior_budget_s=4.0, target_wait_s=0.5,
        )
        rows = fit.delta_rows()
        assert [r["knob"] for r in rows] == [
            "SEQALIGN_SERVE_COST_SCALE", "SEQALIGN_SERVE_COST_BUDGET_S",
        ]
        assert "4 launch gap rows" in rows[0]["evidence"]


# -- the serve-load bench record ---------------------------------------------


class TestServeLoadRecord:
    def _record(self):
        outcomes = [_done(i, latency=0.1 * (i + 1)) for i in range(8)] + [
            driver.Outcome(id="q8", kind="rejected", error="overloaded",
                           retry_after_s=0.5),
            driver.Outcome(id="q9", kind="failed", error="deadline"),
        ]
        res = _result(outcomes, duration_s=4.0)
        server_report = {
            "histograms": {"queue_wait_s": {"p50": 0.01, "p90": 0.05,
                                            "p99": 0.09}},
            "counters": {"serve_shed_transitions": 2},
            "gauges": {"batch_fill_ratio": 0.75},
        }
        return serve_load_record(
            res, server_report,
            process="burst", rate_rps=5.0, seed=7, clients=4,
            plateau_rps=2.5,
        )

    def test_record_validates_and_reports_the_slo_surface(self):
        rec = self._record()
        validate_report(rec)  # the schema gate the smoke runs
        assert rec["kind"] == "bench"
        assert rec["formulation"] == "serve-load"
        assert rec["goodput_rps"] == pytest.approx(8 / 4.0)
        assert rec["shed_rate"] == pytest.approx(2 / 10)
        assert rec["deadline_miss_rate"] == pytest.approx(1 / 10)
        assert rec["queue_wait_s"]["p90"] == 0.05
        assert rec["goodput_retention"] == pytest.approx(2.0 / 2.5)
        assert rec["requests"]["rejected"] == 1

    def test_tampered_record_fails_the_schema_gate(self):
        rec = self._record()
        del rec["arrival"]
        rec["shed_rate"] = 7.0  # a rate outside [0, 1]
        with pytest.raises(ValueError) as e:
            validate_report(rec)
        assert "arrival" in str(e.value)
        assert "shed_rate" in str(e.value)


# -- the open-loop driver against a canned server ----------------------------


class _CannedServer:
    """Loopback ndjson server scripted by request id: stream+done,
    typed overload, typed failure, or deliberate silence."""

    def __init__(self):
        self._srv = socket.create_server(("127.0.0.1", 0))
        self.port = self._srv.getsockname()[1]
        self._threads = []
        self._accept = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept.start()

    def _accept_loop(self):
        try:
            while True:
                conn, _ = self._srv.accept()
                t = threading.Thread(
                    target=self._serve_conn, args=(conn,), daemon=True
                )
                t.start()
                self._threads.append(t)
        except OSError:
            pass

    def _serve_conn(self, conn):
        try:
            with conn, conn.makefile("r", encoding="utf-8") as rfile:
                for line in rfile:
                    if not line.strip():
                        continue
                    rid = json.loads(line).get("id", "")
                    if rid.startswith("silent"):
                        continue  # the silent drop the gates must catch
                    if rid.startswith("rej"):
                        out = [{"id": rid, "error": "overloaded",
                                "retry_after_s": 0.25}]
                    elif rid.startswith("fail"):
                        out = [{"id": rid, "error": "queue full"}]
                    else:
                        out = [{"id": rid, "index": 0, "score": 1},
                               {"id": rid, "done": True, "count": 1}]
                    payload = "".join(json.dumps(r) + "\n" for r in out)
                    conn.sendall(payload.encode("utf-8"))
        except (OSError, ValueError):
            pass

    def close(self):
        self._srv.close()


class TestDriver:
    def test_outcomes_classified_per_reply_shape(self):
        srv = _CannedServer()
        try:
            reqs = [{"id": rid, "seq1": "ACGT", "seq2": ["ACGT"]}
                    for rid in ("ok0", "rej1", "fail2", "silent3", "ok4")]
            sched = replay.build_schedule([0.0] * len(reqs), reqs)
            res = driver.drive(
                "127.0.0.1", srv.port, sched,
                clients=2, grace_s=0.6, timeout_s=5.0,
            )
        finally:
            srv.close()
        kinds = {o.id: o.kind for o in res.outcomes}
        assert kinds == {
            "ok0": "done", "rej1": "rejected", "fail2": "failed",
            "silent3": "missing", "ok4": "done",
        }
        by_id = {o.id: o for o in res.outcomes}
        assert by_id["rej1"].retry_after_s == 0.25
        assert by_id["fail2"].error == "queue full"
        assert by_id["ok0"].lines == 1  # the streamed row before done
        assert by_id["ok0"].latency_s is not None
        assert res.offered == 5
        assert {o.id for o in res.outcomes if o.answered} == {
            "ok0", "rej1", "fail2", "ok4",
        }

    def test_refused_connection_classifies_reset_not_hang(self):
        # A port nobody listens on: every outcome is a typed reset.
        probe = socket.create_server(("127.0.0.1", 0))
        port = probe.getsockname()[1]
        probe.close()
        reqs = [{"id": "a"}, {"id": "b"}]
        sched = replay.build_schedule([0.0, 0.0], reqs)
        res = driver.drive(
            "127.0.0.1", port, sched, clients=1, grace_s=0.2, timeout_s=0.5
        )
        assert [o.kind for o in res.outcomes] == ["reset", "reset"]
        assert all(not o.answered for o in res.outcomes)


# -- the port against the JAX package, and against its own server -----------

import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from mpi_openmp_cuda_tpu.load import arrival as jarrival  # noqa: E402
from mpi_openmp_cuda_tpu.load import replay as jreplay  # noqa: E402
from mpi_openmp_cuda_tpu.load import workload as jworkload  # noqa: E402


@pytest.mark.parametrize("process", ["constant", "poisson", "burst", "ramp"])
def test_schedules_and_requests_equal_the_jax_generator(process):
    times = arrival.arrival_times(process, 12, 40.0, seed=4)
    assert times == jarrival.arrival_times(process, 12, 40.0, seed=4)
    reqs = workload.synth_requests(12, seed=9, problem_keys=3, deadline_mix=0.5)
    assert json.dumps(reqs) == json.dumps(
        jworkload.synth_requests(12, seed=9, problem_keys=3, deadline_mix=0.5))
    assert replay.build_schedule(times, reqs) == jreplay.build_schedule(times, reqs)


def test_open_loop_run_against_the_port_server_passes_the_gates(tmp_path):
    """A poisson schedule replayed against ``--serve --port 0 --device
    cpu`` in a subprocess: every request answered or rejected with a
    type, the serve-load record valid, SIGTERM -> 75 with the report
    written."""
    repo = Path(__file__).resolve().parent.parent
    report = tmp_path / "run.json"
    env = {**os.environ, "SEQALIGN_CACHE_DIR": str(tmp_path / "cache")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "mpi_openmp_cuda_tpu_torch", "--serve", "--device", "cpu",
         "--port", "0", "--metrics-out", str(report)],
        cwd=repo, env=env, stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True,
    )
    try:
        port = None
        for line in proc.stderr:
            if "serving on 127.0.0.1:" in line:
                port = int(line.rsplit(":", 1)[1])
                break
        assert port is not None
        reqs = workload.synth_requests(16, seed=3, len_mix=((4, 60, 1.0),))
        sched = replay.build_schedule(
            arrival.arrival_times("poisson", 16, 40.0, seed=3), reqs)
        result = driver.drive("127.0.0.1", port, sched, clients=4, grace_s=60.0)
    finally:
        proc.terminate()
        _, err = proc.communicate(timeout=60)
    assert proc.returncode == 75, err
    assert gates.survival_problems(result, phase="poisson") == []
    assert result.counts()["done"] == len(sched)
    rec = serve_load_record(result, json.loads(report.read_text()),
                            process="poisson", rate_rps=40.0, seed=3, clients=4)
    validate_report(rec)
    assert rec["requests"]["offered"] == len(sched)
