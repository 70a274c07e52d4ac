"""The port's span plane: one recorder a run, recording only when read; the
CLI's plumbing and the breakdown spans of a batch job and of a serve tick;
the bounded recorder with live totals; the clock anchor; and the
benchmark's readers of the new spans and counters."""

from __future__ import annotations

import importlib.util
import json
import time
from pathlib import Path

import pytest

from mpi_openmp_cuda_tpu_torch import obs as tobs
from mpi_openmp_cuda_tpu_torch.io import cli as tcli
from mpi_openmp_cuda_tpu_torch.io.pipeline import ChunkPipeline
from mpi_openmp_cuda_tpu_torch.obs import spans as tspans
from mpi_openmp_cuda_tpu_torch.obs import trace as ttrace
from mpi_openmp_cuda_tpu_torch.obs.telemetry import answer_cmd
from mpi_openmp_cuda_tpu_torch.ops.dispatch import AlignmentScorer
from mpi_openmp_cuda_tpu_torch.resilience.degrade import BackendDegrader
from mpi_openmp_cuda_tpu_torch.resilience.policy import RetryPolicy
from mpi_openmp_cuda_tpu_torch.serve.loop import ServeLoop
from mpi_openmp_cuda_tpu_torch.utils.profiling import PhaseTimer
from seqbench.harness import Run

REPO = Path(__file__).resolve().parents[1]
FIX = REPO / "tests" / "fixtures"
PLUMBING = ["run.args", "run.arm", "run.flush", "run.teardown"]


@pytest.fixture
def quiet_env(monkeypatch, tmp_path):
    monkeypatch.setenv("SEQALIGN_BACKOFF_BASE", "0")
    monkeypatch.setenv("SEQALIGN_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.delenv("TPU_SEQALIGN_COMPILE_CACHE", raising=False)
    for var in ("SEQALIGN_DEADLINE_S", "SEQALIGN_DRAIN", "SEQALIGN_FAULTS",
                "SEQALIGN_FAULT_RETRIES", "SEQALIGN_METRICS", "SEQALIGN_METRICS_OUT",
                "SEQALIGN_TRACE", "SEQALIGN_HEARTBEAT_S", "SEQALIGN_PREWARM",
                "SEQALIGN_CHECK", "SEQALIGN_SERVE_PORT", "SEQALIGN_TELEMETRY_PORT"):
        monkeypatch.delenv(var, raising=False)
    yield monkeypatch
    tobs.disarm_observability()


def _listened(monkeypatch):
    """Swap the CLI's ``PhaseTimer`` for one whose recorder has a close
    listener (what an outside reader of the run's spans does); returns
    the list of closed ``(path, start, dur)``."""
    seen: list = []

    class Listened(PhaseTimer):
        def __init__(self, enabled=False, recorder=None):
            recorder = recorder if recorder is not None else tspans.SpanRecorder()
            recorder.listeners.append(lambda *span: seen.append(span))
            super().__init__(enabled, recorder=recorder)

    monkeypatch.setattr(tcli, "PhaseTimer", Listened)
    return seen


def _run(argv, capfd):
    rc = tcli.run(argv)
    out, err = capfd.readouterr()
    return rc, out, err


# -- the span tree of a batch run ------------------------------------------


def test_a_listener_sees_the_whole_batch_tree_with_no_plane(quiet_env, capfd):
    seen = _listened(quiet_env)
    rc, out, _ = _run(["--input", str(FIX / "stress_small.txt"), "--device", "cpu"], capfd)
    assert rc == 0 and out == (FIX / "stress_small.out").read_text()
    paths = [p for p, _, _ in seen]
    assert paths == ["run.args", "run.arm", "parse", "setup.scorer", "setup.stage", "setup",
                     "score.chunk_dispatch", "score.chunk_gather", "score", "print",
                     "run.flush", "run.teardown"]
    # No event is waited on without a card: no device_wait span.
    assert not [p for p in paths if p.endswith("device_wait")]
    assert tobs.metrics.active_metrics() is None and tspans.active_spans() is None


def test_the_spans_tile_the_run(quiet_env, capfd):
    """Consecutive top-level spans leave no gap wider than a few statements."""
    seen = _listened(quiet_env)
    t0 = time.perf_counter()
    rc, _, _ = _run(["--input", str(FIX / "tiny.txt"), "--device", "cpu"], capfd)
    t1 = time.perf_counter()
    assert rc == 0
    top = sorted((s, s + d) for p, s, d in seen if p.count(".") == 0 or p in PLUMBING)
    covered = sum(e - s for s, e in top)
    assert top[0][0] >= t0 and top[-1][1] <= t1
    assert covered >= 0.8 * (top[-1][1] - top[0][0])


@pytest.mark.parametrize("argv,paths", [
    (["--stream", "3"], {"setup.scorer", "stream.chunk_dispatch", "stream.chunk_prefetch",
                         "stream.chunk_gather"}),
    (["--backend", "oracle"], {"setup.scorer", "score.chunk_dispatch", "score.chunk_gather"}),
], ids=["stream", "oracle"])
def test_other_paths_nest_their_spans_too(argv, paths, quiet_env, capfd):
    seen = _listened(quiet_env)
    rc, out, _ = _run(["--input", str(FIX / "stress_small.txt"), "--device", "cpu", *argv],
                      capfd)
    assert rc == 0 and out == (FIX / "stress_small.out").read_text()
    got = {p for p, _, _ in seen}
    assert set(PLUMBING) <= got
    if "--backend" in argv:
        paths = (paths - {"score.chunk_dispatch"})  # the oracle dispatches nothing
    assert paths <= got


def test_profile_and_report_phases_are_the_four(quiet_env, tmp_path, capfd):
    report = tmp_path / "m.json"
    rc, _, err = _run(["--input", str(FIX / "stress_small.txt"), "--device", "cpu",
                       "--profile", "--metrics-out", str(report)], capfd)
    assert rc == 0
    names = [ln.split()[1].rstrip(":") for ln in err.splitlines() if ln.startswith("[profile]")]
    assert names == ["parse", "setup", "score", "print", "total"]
    rec = json.loads(report.read_text())
    assert [p for p, _ in rec["spans"]["phases"]] == ["parse", "setup", "score", "print"]
    totals = rec["spans"]["totals"]
    assert {"run.args", "run.arm", "setup.scorer", "setup.stage"} <= set(totals)
    # Closed after the report was written.
    assert "run.teardown" not in totals


def test_profile_alone_nests_dispatch_under_the_phases(quiet_env, capfd):
    seen = []
    orig = tspans.SpanRecorder._close

    def spy(self, path, start, dur, detail):
        seen.append(path)
        return orig(self, path, start, dur, detail)

    quiet_env.setattr(tspans.SpanRecorder, "_close", spy)
    rc, _, err = _run(["--input", str(FIX / "tiny.txt"), "--device", "cpu", "--profile"], capfd)
    assert rc == 0 and "[profile]            total:" in err
    assert {"score.chunk_dispatch", "score.chunk_gather"} <= set(seen)
    assert tspans.active_spans() is None


# -- recording only when read ----------------------------------------------


def test_nothing_records_when_nothing_reads(quiet_env, capfd):
    closed, armed = [], []
    quiet_env.setattr(tspans.SpanRecorder, "_close", lambda *a: closed.append(a))
    orig = tcli._run_batch

    def spy(args, policy, out, timer, dist=None):
        armed.append((tspans.active_spans(), timer.read, timer.phase("x")))
        return orig(args, policy, out, timer, dist)

    quiet_env.setattr(tcli, "_run_batch", spy)
    rc, out, err = _run(["--input", str(FIX / "tiny.txt"), "--device", "cpu"], capfd)
    assert (rc, out, err) == (0, (FIX / "tiny.out").read_text(), "")
    assert closed == []
    assert armed == [(None, False, tspans.NULL_SPAN)]


def test_a_phase_timer_reads_only_when_read():
    timer = PhaseTimer()
    assert timer.phase("parse") is tspans.NULL_SPAN and timer.phases == []
    timer.enabled = True
    with timer.phase("parse"):
        pass
    assert [p for p, _ in timer.phases] == ["parse"]
    rec = tspans.SpanRecorder()
    quiet = PhaseTimer(recorder=rec)
    tspans.activate_spans(recorder=rec)
    try:
        with quiet.phase("score"), tspans.span("chunk_gather"):
            pass
    finally:
        tspans.deactivate_spans()
    assert [p for p, _ in rec.spans] == ["score.chunk_gather", "score"]


def test_the_plane_adopts_the_run_recorder():
    rec = tspans.SpanRecorder()
    try:
        _, got = tobs.arm_observability(with_trace=True, recorder=rec)
        assert got is rec and tspans.active_spans() is rec
        assert ttrace.active_trace()._t0 == rec.clock_s
    finally:
        tobs.disarm_observability()
    assert tspans.active_spans() is None


# -- the bounded recorder --------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 10.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def test_the_recorder_past_its_cap_keeps_exact_totals(monkeypatch):
    monkeypatch.setattr(tspans, "MAX_SPANS", 3)
    clock = FakeClock()
    rec = tspans.SpanRecorder(clock)
    with rec.span("serve"):
        for i in range(10):
            with rec.span("serve.wait", detail=True):
                clock.advance(0.25)
            with rec.span("chunk_gather"):
                clock.advance(0.5)
    assert len(rec.spans) == 3 and rec.dropped == 18
    assert rec.phases() == [("serve", 7.5)]
    assert rec.totals() == {"serve.serve.wait": 2.5, "serve.chunk_gather": 5.0, "serve": 7.5}
    assert rec.snapshot()["serve.serve.wait"] == {"count": 10, "seconds": 2.5}
    assert rec.is_detail("serve.serve.wait") and not rec.is_detail("serve.chunk_gather")


def test_the_cap_is_the_trace_cap():
    assert tspans.MAX_SPANS == ttrace.MAX_EVENTS


def test_add_records_under_the_open_spans():
    clock = FakeClock()
    rec = tspans.SpanRecorder(clock)
    seen = []
    rec.listeners.append(lambda *s: seen.append(s))
    start = rec.now()
    clock.advance(1.0)
    rec.add("run.args", start)
    with rec.span("setup"):
        t = rec.now()
        clock.advance(0.5)
        rec.add("stage", t, detail=True)
    assert seen == [("run.args", 10.0, 1.0), ("setup.stage", 11.0, 0.5),
                    ("setup", 11.0, 0.5)]
    assert rec.phases() == [("setup", 0.5)] and rec.is_detail("setup.stage")


# -- the serve tick --------------------------------------------------------


class TickClock:
    """Serve clock stand-in: ``now()`` counts calls, ``block_until`` never
    blocks."""

    def __init__(self):
        self.t = 0.0

    def now(self) -> float:
        self.t += 1.0
        return self.t

    def block_until(self, cond, predicate, timeout_s):
        return predicate()


class Sink:
    def __init__(self):
        self.records = []

    def send(self, obj):
        self.records.append(obj)


def _request(rid, seq2):
    return json.dumps({"id": rid, "weights": [1, -3, -5, -2], "seq1": "ACGTACGTAC",
                       "seq2": list(seq2)})


def test_metrics_verb_carries_span_totals_and_block_rows():
    try:
        reg, rec = tobs.arm_observability()
        policy = RetryPolicy()
        deg = BackendDegrader(AlignmentScorer("cuda", device="cpu"),
                              lambda b: AlignmentScorer(b, device="cpu"), enabled=False)
        loop = ServeLoop(ChunkPipeline(policy, deg), policy, clock=TickClock(), window_s=0.01)
        sink = Sink()
        loop.queue.open_source()  # a live client: the tick lingers to coalesce
        loop.ingest(_request("a", ["ACGT", "TTTT"]), sink)
        loop.ingest(_request("b", ["GGGG"]), sink)
        assert loop.tick()
        loop.ingest(_request("c", ["ACG", "CGT", "GTA"]), sink)
        loop.tick()
        loop.tick()
        answer = answer_cmd("metrics")
    finally:
        tobs.disarm_observability()
    assert sum("done" in r for r in sink.records) == 3
    snap = answer["metrics"]
    assert snap["counters"]["serve_batches"] == 2
    assert snap["counters"]["serve_block_rows"] == 6
    spans = snap["spans"]
    for path in ("serve.wait", "serve.linger", "serve.plan", "serve.intake", "serve.journal",
                 "serve.advance", "chunk_dispatch", "chunk_prefetch", "chunk_gather",
                 "serve.request.emit"):
        assert spans[path]["count"] >= 1, path
    assert spans["serve.wait"]["count"] == 3 and spans["serve.linger"]["count"] == 2
    assert spans["serve.plan"]["count"] == 3
    assert all(v["seconds"] >= 0 for v in spans.values())
    assert json.loads(json.dumps(answer)) == answer


def test_metrics_verb_without_spans_has_no_section():
    try:
        tobs.metrics.activate_metrics()
        assert "spans" not in answer_cmd("metrics")["metrics"]
    finally:
        tobs.disarm_observability()
    assert answer_cmd("metrics") == {"telemetry": "metrics", "metrics": {}}


def test_serve_trace_files_tick_spans_as_detail(quiet_env, tmp_path, capfd):
    reqfile = tmp_path / "requests.ndjson"
    reqfile.write_text(_request("a", ["ACGT"]) + "\n")
    trace_out = tmp_path / "trace.json"
    rc, _, _ = _run(["--serve", "--device", "cpu", "--input", str(reqfile),
                     "--trace-out", str(trace_out)], capfd)
    assert rc == 0
    rec = json.loads(trace_out.read_text())
    spans = {(e["name"], e["cat"]) for e in rec["traceEvents"]
             if e.get("cat") in ("span", "detail")}
    assert {("serve.serve.wait", "detail"), ("serve.serve.plan", "detail"),
            ("setup.scorer", "detail"), ("serve.chunk_gather", "span"),
            ("serve.serve.request.emit", "span")} <= spans
    assert not [n for n, _ in spans if n.startswith("run.")]


# -- one clock -------------------------------------------------------------


def test_a_span_start_maps_between_wall_readings():
    rec = tspans.SpanRecorder()
    seen = []
    rec.listeners.append(lambda *s: seen.append(s))
    before = time.time_ns()
    with rec.span("score"):
        time.sleep(0.002)
    after = time.time_ns()
    ((_, start, dur),) = seen
    anchor = rec.anchor()
    assert anchor == {"clock_s": rec.clock_s, "unix_ns": rec.unix_ns}

    def unix_ns(t):
        return anchor["unix_ns"] + (t - anchor["clock_s"]) * 1e9

    assert before <= unix_ns(start) <= unix_ns(start + dur) <= after


def test_trace_ts_maps_through_the_envelope_anchor():
    rec = tspans.SpanRecorder()
    tracer = ttrace.TraceRecorder(spans=rec)
    rec.listeners.append(tracer.span_closed)
    before = time.time_ns()
    with rec.span("score"):
        time.sleep(0.002)
    after = time.time_ns()
    env = tracer.export()
    (ev,) = [e for e in env["traceEvents"] if e.get("cat") == "span"]
    anchor = env["clock_anchor"]
    assert before <= anchor["unix_ns"] + ev["ts"] * 1000 <= after


def test_cli_reports_and_traces_carry_one_anchor(quiet_env, tmp_path, capfd):
    report, trace_out = tmp_path / "m.json", tmp_path / "t.json"
    before = time.time_ns()
    rc, _, _ = _run(["--input", str(FIX / "tiny.txt"), "--device", "cpu",
                     "--metrics-out", str(report), "--trace-out", str(trace_out)], capfd)
    after = time.time_ns()
    assert rc == 0
    rep, tr = json.loads(report.read_text()), json.loads(trace_out.read_text())
    assert rep["clock_anchor"] == tr["clock_anchor"]
    assert before <= tr["clock_anchor"]["unix_ns"] <= after
    for ev in tr["traceEvents"]:
        if ev.get("cat") in ("span", "detail"):
            assert before <= tr["clock_anchor"]["unix_ns"] + ev["ts"] * 1000 <= after
    assert {"parse", "setup.stage"} <= {e.get("name") for e in tr["traceEvents"]}


# -- the benchmark's readers -----------------------------------------------


def _reader(name: str):
    path = REPO / "seqbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _batch_run(spans, busy_s=0.02, trace=True) -> Run:
    return Run("batch", 1.0, 20.0, attempted=len(spans), failed=0, checks={},
               device={}, jobs=[{"wall_s": 0.01, "cells": 1, "bytes": 1}] * len(spans),
               spans=spans, trace={"busy_s": busy_s, "window_s": 20.0} if trace else None)


JOBS = [
    {"run.args": 0.001, "run.arm": 0.0002, "parse": 0.001, "setup.stage": 0.002,
     "setup": 0.003, "score.chunk_gather.device_wait": 0.0005, "score": 0.001,
     "run.flush": 0.0001, "run.teardown": 0.0003},
    {"run.args": 0.002, "run.arm": 0.0002, "parse": 0.001, "setup.stage": 0.004,
     "setup": 0.005, "score.chunk_gather.device_wait": 0.0015, "score": 0.002,
     "run.flush": 0.0001, "run.teardown": 0.0001},
]


@pytest.mark.parametrize("name,want", [
    ("cli_plumbing_ms", (1.6 + 2.4) / 2),
    ("dispatch_stage_ms", 3.0),
    ("dispatch_device_wait_ms", 1.0),
])
def test_batch_readers(name, want):
    read = _reader(name)
    assert read(_batch_run(JOBS)) == pytest.approx(want)
    # No device activity, no trace, no spans, or a program without the span.
    assert read(_batch_run(JOBS, busy_s=0.0)) is None
    assert read(_batch_run(JOBS, trace=False)) is None
    assert read(_batch_run([])) is None
    assert read(_batch_run([{"parse": 0.001, "setup": 0.003, "score": 0.001}])) is None


def _serve_run(start, end) -> Run:
    return Run("serve", 1.0, 20.0, attempted=1, failed=0, checks={}, device={},
               telemetry={k: v for k, v in (("start", start), ("end", end)) if v is not None})


def _snap(uptime, wait, linger, batches, rows=None):
    counters = {"serve_batches": batches}
    if rows is not None:
        counters["serve_block_rows"] = rows
    snap = {"uptime_s": uptime, "counters": counters}
    if wait is not None:
        snap["spans"] = {"serve.serve.wait": {"count": 3, "seconds": wait},
                         "serve.serve.linger": {"count": 2, "seconds": linger},
                         "serve.chunk_gather": {"count": 9, "seconds": 4.0}}
    return snap


def test_serve_loop_busy_share_reader():
    read = _reader("serve_loop_busy_share.steady")
    run = _serve_run(_snap(10.0, 1.0, 0.5, 4, 8), _snap(30.0, 9.0, 6.5, 40, 900))
    assert read(run) == pytest.approx(100.0 * (1.0 - 14.0 / 20.0))
    assert read(_serve_run(_snap(10.0, None, None, 4), _snap(30.0, None, None, 40))) is None
    assert read(_serve_run(None, _snap(30.0, 9.0, 6.5, 40, 900))) is None
    assert read(_serve_run(_snap(10.0, 1.0, 0.5, 4), _snap(10.0, 1.0, 0.5, 4))) is None


def test_serve_rows_per_block_reader():
    read = _reader("serve_rows_per_block.steady")
    assert read(_serve_run(_snap(10.0, 1.0, 0.5, 4, 8), _snap(30.0, 9.0, 6.5, 40, 908))) == 25.0
    assert read(_serve_run(_snap(10.0, None, None, 4), _snap(30.0, None, None, 40))) is None
    assert read(_serve_run(_snap(10.0, 1.0, 0.5, 4, 8), _snap(30.0, 1.0, 0.5, 4, 8))) is None
    assert read(_serve_run(None, None)) is None
