"""The port's fleet observability plane against the contract
``tests/test_fleet_obs.py`` pins for the JAX package (its tests, on the
port's modules): trace-context propagation coordinator -> worker ->
coordinator on a MemoryBoard (the worker threads the stamp into the
port's ``ChunkPipeline.dispatch(trace_ctx=)``), the deterministic
clock-offset estimator, board-phase gap attribution, the merged
offset-aligned timeline against the JAX package's own golden
``tests/golden/fleet_trace.json``, snapshot federation and the failover
flight-recorder triggers; then the stamp on the port's own launch rows.

Everything runs on fake clocks and in-memory boards.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import pathlib

import numpy as np
import pytest

from mpi_openmp_cuda_tpu_torch.obs import arm_observability, disarm_observability
from mpi_openmp_cuda_tpu_torch.obs.export import (
    collect_worker_snapshot,
    post_worker_snapshot,
)
from mpi_openmp_cuda_tpu_torch.obs.flightrec import (
    DUMP_TRIGGERS,
    FlightRecorder,
    active_flightrec,
    dump_fleet_tape,
)
from mpi_openmp_cuda_tpu_torch.obs.metrics import (
    fleet_to_prometheus,
    validate_report,
)
from mpi_openmp_cuda_tpu_torch.obs.telemetry import render_metrics
from mpi_openmp_cuda_tpu_torch.obs.trace import (
    BOARD_PHASES,
    TraceRecorder,
    active_trace,
)
from mpi_openmp_cuda_tpu_torch.resilience.membership import (
    ClockOffsetEstimator,
    claim_key,
    obs_snapshot_key,
    read_obs_snapshot,
    result_key,
)
from mpi_openmp_cuda_tpu_torch.resilience.rescue import MemoryBoard
from mpi_openmp_cuda_tpu_torch.serve.fleet import FleetCoordinator, FleetWorker

GOLDEN = pathlib.Path(__file__).parent / "golden" / "fleet_trace.json"


class FakeClock:
    """ServeClock stand-in: time moves only when a wait consumes it."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def now(self) -> float:
        return self.t

    def block_until(self, cond, predicate, timeout_s: float) -> bool:
        self.t += max(0.0, float(timeout_s))
        return predicate()


class Block:
    """The superblock fields the fleet protocol reads, plus the trace
    linkage the obs plane propagates."""

    def __init__(self, n_rows: int = 2):
        self.weights = [1, -3, -5, -2]
        self.seq1_codes = np.arange(4, dtype=np.int8)
        self.codes = [np.full(3, i, dtype=np.int8) for i in range(n_rows)]

    def link_ids(self):
        return ["a", "b"]

    def link_traces(self):
        return ["t1", "t2"]


class StubPipeline:
    """Deterministic rows; records every dispatch's keyword context so
    the propagation assertions can read what the worker threaded in."""

    def __init__(self):
        self.dispatches: list[dict] = []

    def dispatch(self, seq1, codes, weights, budget, **kw):
        self.dispatches.append(kw)
        return len(codes)

    def materialise(self, promise, seq1, codes, weights, budget):
        return np.stack(
            [np.full(3, i, dtype=np.int64) for i in range(promise)]
        )


class StubPolicy:
    def new_budget(self):
        return object()


@pytest.fixture
def obs_plane():
    registry, recorder = arm_observability(
        lambda: 0.0, lambda: 0.0, with_trace=True, flightrec_depth=16
    )
    yield registry, recorder
    disarm_observability()


def make_coordinator(board, clock, **kw):
    kw.setdefault("lease_s", 5.0)
    kw.setdefault("poll_s", 1.0)
    collected, fallback = [], []
    coord = FleetCoordinator(
        board,
        local_score=fallback.append,
        demux=lambda rows, block: collected.append((rows, block)),
        clock=clock,
        **kw,
    )
    return coord, collected, fallback


def tick(coord, clock, n: int = 1) -> None:
    for _ in range(n):
        clock.t += coord.poll_s
        coord.pump()


def enlist(board, wid: str, beat: int = 1) -> None:
    from mpi_openmp_cuda_tpu_torch.resilience.membership import (
        heartbeat_key,
        worker_key,
    )

    board.post(worker_key(wid), json.dumps({"wid": wid, "pid": 1}))
    board.post(heartbeat_key(wid), str(beat))


def make_worker(board, wid: str) -> FleetWorker:
    worker = FleetWorker(board, StubPipeline(), StubPolicy(), FakeClock())
    worker.wid = wid
    return worker


# -- clock-offset estimator --------------------------------------------------


class TestClockOffsetEstimator:
    def test_known_skew_recovered(self):
        # Worker clock = coordinator clock + 100s, symmetric 0.1s RTT:
        # the NTP midpoint recovers the skew exactly.
        est = ClockOffsetEstimator()
        est.observe("w1", 10.0, 110.05, 10.1)
        assert est.offset("w1") == pytest.approx(100.0)
        assert est.uncertainty("w1") == pytest.approx(0.05)
        assert est.to_coordinator("w1", 110.05) == pytest.approx(10.05)

    def test_min_rtt_pair_wins(self):
        # A tighter echo replaces a looser one; a looser one does not.
        est = ClockOffsetEstimator()
        est.observe("w1", 10.0, 111.0, 12.0)  # rtt 2.0
        est.observe("w1", 20.0, 120.06, 20.1)  # rtt 0.1 — wins
        assert est.offset("w1") == pytest.approx(100.01)
        est.observe("w1", 30.0, 135.0, 31.0)  # rtt 1.0 — ignored
        assert est.offset("w1") == pytest.approx(100.01)

    def test_garbage_and_negative_rtt_dropped(self):
        est = ClockOffsetEstimator()
        est.observe("w1", "nope", 1.0, 2.0)
        est.observe("w1", 5.0, 1.0, 4.0)  # t_seen < t_post: rtt < 0
        est.observe("w1", float("nan"), 1.0, 2.0)
        assert est.offset("w1") is None
        assert est.to_coordinator("w1", 1.0) is None
        assert est.snapshot() == {}

    def test_snapshot_shape(self):
        est = ClockOffsetEstimator()
        est.observe("w2", 10.0, 110.05, 10.1)
        est.observe("w1", 0.0, 50.0, 0.2)
        snap = est.snapshot()
        assert list(snap) == ["w1", "w2"]
        assert set(snap["w1"]) == {"offset_s", "rtt_s"}


# -- trace-context round-trip on a MemoryBoard -------------------------------


class TestTraceRoundTrip:
    def test_offer_carries_context_and_worker_threads_it(self, obs_plane):
        board, clock = MemoryBoard(), FakeClock()
        coord, collected, _ = make_coordinator(board, clock)
        worker = make_worker(board, "w1")
        enlist(board, "w1")
        tick(coord, clock, 1)
        assert coord.accepting()

        bid = coord.offer(Block())
        offer = json.loads(board.get(f"seqalign/fleet/offer/{bid}"))
        assert offer["traces"] == ["t1", "t2"]
        assert offer["links"] == ["a", "b"]
        assert isinstance(offer["t_offer"], float)

        assert worker.step()
        ctx = worker.pipeline.dispatches[0]
        assert ctx["links"] == ["a", "b"]
        assert ctx["trace_ctx"] == {
            "traces": ["t1", "t2"],
            "worker": "w1",
            "epoch": 0,
        }
        claim = json.loads(board.get(claim_key(bid, 0)))
        assert "t_claim" in claim
        result = json.loads(board.get(result_key(bid, 0)))
        assert result["traces"] == ["t1", "t2"]
        assert result["t_score"] <= result["t_post"]

        tick(coord, clock, 1)
        assert len(collected) == 1  # demuxed exactly once

    def test_board_phase_row_lands_on_the_trace_plane(self, obs_plane):
        board, clock = MemoryBoard(), FakeClock()
        coord, collected, _ = make_coordinator(board, clock)
        enlist(board, "w1")
        tick(coord, clock, 1)
        bid = coord.offer(Block())
        # Hand-drive the worker protocol with a +100s skewed clock so
        # the claim echo feeds the estimator BEFORE the result lands.
        board.claim(
            claim_key(bid, 0),
            json.dumps({"wid": "w1", "epoch": 0, "t_claim": clock.t + 100.6}),
        )
        tick(coord, clock, 1)
        assert coord.offsets.offset("w1") is not None
        board.post(
            result_key(bid, 0),
            json.dumps({
                "bid": bid,
                "epoch": 0,
                "wid": "w1",
                "rows": [[0, 0, 0], [1, 1, 1]],
                "traces": ["t1", "t2"],
                "t_score": clock.t + 100.7,
                "t_post": clock.t + 101.2,
            }),
        )
        tick(coord, clock, 1)
        assert len(collected) == 1

        tracer = active_trace()
        ga = tracer.gap_attribution()
        assert len(ga["board_phases"]) == 1
        row = ga["board_phases"][0]
        assert row["bid"] == bid and row["worker"] == "w1"
        assert row["traces"] == ["t1", "t2"]
        assert row["request_ids"] == ["a", "b"]
        assert isinstance(row["clock_offset_s"], float)
        phases = row["phases"]
        assert set(phases) == set(BOARD_PHASES)
        for v in phases.values():
            assert math.isfinite(v) and v >= 0.0
        assert phases["total"] == pytest.approx(
            sum(v for k, v in phases.items() if k != "total"), abs=1e-9
        )
        totals = ga["board_phase_totals"]
        assert set(totals) == set(BOARD_PHASES)
        assert "w1" in ga["clock_offsets"]

    def test_local_runs_keep_the_exact_base_section(self, obs_plane):
        # No fleet rows -> no fleet keys: local run reports stay
        # byte-identical to the pre-fleet-obs plane.
        ga = active_trace().gap_attribution()
        assert set(ga) == {
            "launches",
            "launch_count",
            "unfinished_launches",
            "total_measured_s",
            "total_modelled_s",
            "total_gap_s",
        }


# -- snapshot posts: torn / alien / missing reads ---------------------------


class TestSnapshotReads:
    def test_torn_snapshot_reads_as_missing(self):
        board = MemoryBoard()
        board.post(obs_snapshot_key("w1"), '{"wid": "w1", "metr')
        assert read_obs_snapshot(board, "w1") is None
        assert collect_worker_snapshot(board, "w1") is None

    def test_alien_snapshot_reads_as_missing(self):
        # A snapshot claiming another worker's identity under this key
        # (a replayed or misrouted post) must not be attributed.
        board = MemoryBoard()
        board.post(obs_snapshot_key("w1"), json.dumps({"wid": "w2"}))
        assert read_obs_snapshot(board, "w1") is None

    def test_gather_survives_torn_and_alien_posts(self, obs_plane):
        board, clock = MemoryBoard(), FakeClock()
        coord, _, _ = make_coordinator(board, clock)
        enlist(board, "w1")
        enlist(board, "w2")
        board.post(obs_snapshot_key("w1"), "not json at all")
        board.post(obs_snapshot_key("w2"), json.dumps({"wid": "other"}))
        tick(coord, clock, 6)  # crosses the gather cadence
        registry, _ = obs_plane
        assert registry.fleet == {}

    def test_worker_snapshot_round_trip(self, obs_plane):
        board = MemoryBoard()
        post_worker_snapshot(board, "w1", 1.5, beat=3)
        snap = collect_worker_snapshot(board, "w1")
        assert snap["wid"] == "w1" and snap["beat"] == 3
        assert snap["t_board"] == 1.5
        assert isinstance(snap["metrics"], dict)
        assert isinstance(snap["t_trace_us"], float)
        assert isinstance(snap["trace"]["events"], list)
        assert isinstance(snap["tape"], list)


# -- metrics federation ------------------------------------------------------


class TestFederation:
    def test_worker_labelled_families(self):
        text = fleet_to_prometheus({
            "w3": {
                "uptime_s": 1.25,
                "counters": {"serve_batches": 4},
                "gauges": {"backend": "xla", "queue_depth": 2},
                "histograms": {
                    "queue_wait_s": {"count": 3, "sum": 0.5, "p90": 0.3}
                },
            },
            "w4": {"counters": {"serve_batches": 7}},
        })
        assert 'seqalign_serve_batches_total{worker="w3"} 4' in text
        assert 'seqalign_serve_batches_total{worker="w4"} 7' in text
        assert 'seqalign_backend_info{worker="w3",value="xla"} 1' in text
        assert 'seqalign_queue_depth{worker="w3"} 2' in text
        assert 'seqalign_queue_wait_s_count{worker="w3"} 3' in text
        assert 'seqalign_uptime_seconds{worker="w3"} 1.25' in text
        # One HELP/TYPE head per family, not per worker.
        assert text.count("# TYPE seqalign_serve_batches_total counter") == 1

    def test_skip_heads_suppresses_duplicate_declarations(self):
        fleet = {"w1": {"counters": {"serve_batches": 1}}}
        text = fleet_to_prometheus(fleet, skip_heads={
            "seqalign_serve_batches_total"
        })
        assert "# TYPE seqalign_serve_batches_total" not in text
        assert 'seqalign_serve_batches_total{worker="w1"} 1' in text

    def test_render_metrics_appends_fleet_section(self, obs_plane):
        registry, _ = obs_plane
        registry.inc("serve_batches", 2)
        registry.record_fleet("w1", {"counters": {"serve_batches": 5}})
        text = render_metrics()
        assert "seqalign_serve_batches_total 2" in text
        assert 'seqalign_serve_batches_total{worker="w1"} 5' in text
        assert text.count("# TYPE seqalign_serve_batches_total counter") == 1


# -- flight recorder: failover triggers + fleet tape collection --------------


class TestFlightRecFleet:
    def test_failover_events_are_dump_triggers(self):
        assert DUMP_TRIGGERS["leader.takeover"] == "leader-takeover"
        assert DUMP_TRIGGERS["leader.fenced"] == "leader-fenced"

    def test_takeover_event_dumps_the_tape(self, tmp_path, monkeypatch):
        monkeypatch.delenv("TPU_SEQALIGN_COMPILE_CACHE", raising=False)
        monkeypatch.setenv("SEQALIGN_CACHE_DIR", str(tmp_path))
        rec = FlightRecorder(depth=8, clock=lambda: 0.0)
        rec.record_event("serve.batch.dispatch", {"rows": 2})
        rec.record_event("leader.takeover", {"gen": 2})
        assert len(rec.dump_paths) == 1
        dump = json.loads(pathlib.Path(rec.dump_paths[0]).read_text())
        validate_report(dump)
        assert dump["reason"] == "leader-takeover"
        assert [e["name"] for e in dump["events"]] == [
            "serve.batch.dispatch",
            "leader.takeover",
        ]

    def test_fenced_event_dumps_the_tape(self, tmp_path, monkeypatch):
        monkeypatch.delenv("TPU_SEQALIGN_COMPILE_CACHE", raising=False)
        monkeypatch.setenv("SEQALIGN_CACHE_DIR", str(tmp_path))
        rec = FlightRecorder(depth=8, clock=lambda: 0.0)
        rec.record_event("leader.fenced", {"key": "k"})
        assert len(rec.dump_paths) == 1

    def test_fleet_tape_dump_roundtrip(self, tmp_path, monkeypatch):
        monkeypatch.delenv("TPU_SEQALIGN_COMPILE_CACHE", raising=False)
        monkeypatch.setenv("SEQALIGN_CACHE_DIR", str(tmp_path))
        tape = [
            {"kind": "event", "seq": 1, "t": 0.1, "name": "x", "fields": {}},
            {"kind": "span", "seq": 2, "t": 0.2, "name": "score.y",
             "dur_s": 0.05},
            {"kind": "garbage"},  # filtered, not fatal
            "not even a dict",
        ]
        path = dump_fleet_tape("w9", tape, "worker-dead")
        assert path is not None and os.path.exists(path)
        dump = json.loads(pathlib.Path(path).read_text())
        validate_report(dump)
        assert dump["worker"] == "w9"
        assert dump["reason"] == "worker-dead:w9"
        assert len(dump["events"]) == 2

    def test_dead_worker_tape_collected_once(self, obs_plane, tmp_path,
                                             monkeypatch):
        monkeypatch.delenv("TPU_SEQALIGN_COMPILE_CACHE", raising=False)
        monkeypatch.setenv("SEQALIGN_CACHE_DIR", str(tmp_path))
        board, clock = MemoryBoard(), FakeClock()
        coord, _, _ = make_coordinator(board, clock)
        enlist(board, "w1")
        tick(coord, clock, 1)
        # The worker's last snapshot carries a tape, then it goes silent.
        board.post(obs_snapshot_key("w1"), json.dumps({
            "wid": "w1",
            "tape": [{"kind": "event", "seq": 1, "t": 0.0, "name": "beat",
                      "fields": {}}],
        }))
        tick(coord, clock, coord.lease_ticks + 2)  # earn the death verdict
        assert "w1" in coord._tapes_collected
        registry, _ = obs_plane
        assert registry.counters.get("fleet_tapes_collected") == 1
        tapes = list((tmp_path / "flightrec").glob("fleet-tape-w1-*.json"))
        assert len(tapes) == 1


# -- merged offset-aligned timeline (golden) ---------------------------------


def _fake_tracer() -> TraceRecorder:
    # A step clock: every read advances 1ms, so the event sequence is
    # exactly reproducible and the golden can keep its timestamps.
    steps = itertools.count()
    return TraceRecorder(lambda: next(steps) * 0.001)


def test_merged_timeline_golden():
    tracer = _fake_tracer()
    # One local launch with a fleet stamp, as a worker would record it.
    tracer.launch_begin(
        1, links=["a", "b"], len1=4, lens=[3, 3],
        ctx={"traces": ["t1"], "worker": "w1", "epoch": 0},
    )
    tracer.launch_end(1)
    # One gathered worker track, shifted by a known offset.
    tracer.set_worker_track("w7", [
        {"ph": "X", "pid": 2, "tid": 1, "cat": "launch", "name": "launch",
         "ts": 100.0, "dur": 50.0, "args": {"traces": ["t2"]}},
        {"ph": "i", "pid": 1, "tid": 3, "cat": "bus", "name": "fleet.x",
         "ts": 120.0, "args": {}},
    ], shift_us=500.0)
    tracer.set_clock_offsets({"w7": {"offset_s": 0.0005, "rtt_s": 0.0001}})
    tracer.board_phase({
        "bid": "g0b1", "worker": "w7", "epoch": 0, "traces": ["t2"],
        "request_ids": ["c"], "clock_offset_s": 0.0005,
        "phases": {"offer_to_claim": 0.001, "claim_to_score": 0.002,
                   "score_to_post": 0.003, "post_to_demux": 0.004,
                   "total": 0.01},
    })
    rec = tracer.export(exit_code=0)
    validate_report(rec)

    # Hard gates before the golden: the worker track exists, offset-
    # shifted, with generated process/thread metadata.
    evs = rec["traceEvents"]
    track = [e for e in evs if e.get("pid") == 3 and e.get("ph") != "M"]
    assert [e["ts"] for e in track] == [600.0, 620.0]
    meta = [e for e in evs if e.get("pid") == 3 and e.get("ph") == "M"]
    procs = {e["args"]["name"] for e in meta if e["name"] == "process_name"}
    threads = {e["args"]["name"] for e in meta if e["name"] == "thread_name"}
    assert procs == {"seqalign-worker w7"}
    assert {"measured", "events"} <= threads

    body = json.loads(json.dumps(rec, sort_keys=True))
    assert body == _golden_on_the_hopper_model()


def _golden_on_the_hopper_model() -> dict:
    """The JAX package's golden with its one cost-model number (the
    modelled wall of the one local launch, on the TPU model there)
    re-derived on the port's Hopper launch model, and the fields computed
    from it (the modelled track's duration, the gap, the totals); every
    other byte is the golden's."""
    from mpi_openmp_cuda_tpu_torch.obs.trace import modelled_launch_wall_s

    want = json.loads(GOLDEN.read_text())
    modelled = modelled_launch_wall_s(4, [3, 3])
    assert modelled > 0.0
    ga = want["gap_attribution"]
    (row,) = ga["launches"]
    row["modelled_s"] = round(modelled, 9)
    row["gap_s"] = round(row["measured_s"] - modelled, 9)
    ga["total_modelled_s"] = round(modelled, 9)
    ga["total_gap_s"] = round(ga["total_measured_s"] - modelled, 9)
    (ev,) = [e for e in want["traceEvents"] if e.get("name") == "modelled"]
    ev["dur"] = round(modelled * 1e6, 3)
    return want


def test_worker_stamp_reaches_the_ports_launch_rows(obs_plane):
    """The fleet stamp a worker threads into ``ChunkPipeline.dispatch``
    lands on each trace launch row of the port's scorer, as the JAX
    pipeline stamps its launch span."""
    from mpi_openmp_cuda_tpu_torch.io.pipeline import ChunkPipeline
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import AlignmentScorer
    from mpi_openmp_cuda_tpu_torch.resilience.degrade import BackendDegrader
    from mpi_openmp_cuda_tpu_torch.resilience.policy import RetryPolicy

    policy = RetryPolicy()
    deg = BackendDegrader(AlignmentScorer("cuda", device="cpu"),
                          lambda b: AlignmentScorer(b, device="cpu"))
    board, clock = MemoryBoard(), FakeClock()
    coord, collected, _ = make_coordinator(board, clock)
    worker = FleetWorker(board, ChunkPipeline(policy, deg), policy, FakeClock())
    worker.wid = "w1"
    enlist(board, "w1")
    tick(coord, clock, 1)
    block = Block()
    block.codes = [np.array([0, 1], dtype=np.int8), np.array([2], dtype=np.int8)]
    coord.offer(block)
    assert worker.step()
    tick(coord, clock, 1)
    assert len(collected) == 1
    rows = active_trace().gap_attribution()["launches"]
    assert rows and all(r["traces"] == ["t1", "t2"] and r["worker"] == "w1"
                        and r["epoch"] == 0 and r["request_ids"] == ["a", "b"]
                        for r in rows)
