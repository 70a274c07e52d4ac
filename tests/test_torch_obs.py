"""The port's obs plane against the JAX package's: the metrics registry
(snapshots, Prometheus text, the heartbeat line, the report schema), the
span recorder and the ``[profile]`` report, the report writers, the
watchdog's heartbeat, the recompile event of a kernel build, and both
CLIs run in-process on the CPU with the plane armed, every exit path
(0, 65, 75) included.  Inputs are the repo's fixtures or fixed event
sequences; every comparison is exact equality."""

from __future__ import annotations

import json
import os
import signal
import tempfile
import threading
from pathlib import Path

import pytest
import torch

from mpi_openmp_cuda_tpu.io import cli as jcli
from mpi_openmp_cuda_tpu.obs import export as jexport
from mpi_openmp_cuda_tpu.obs import metrics as jmetrics
from mpi_openmp_cuda_tpu.obs import spans as jspans
from mpi_openmp_cuda_tpu.obs.flightrec import FlightRecorder as JFlightRecorder
from mpi_openmp_cuda_tpu.utils.profiling import PhaseTimer as JPhaseTimer
from mpi_openmp_cuda_tpu_torch import obs as tobs
from mpi_openmp_cuda_tpu_torch.io import cli as tcli
from mpi_openmp_cuda_tpu_torch.obs import events as tevents
from mpi_openmp_cuda_tpu_torch.obs import export as texport
from mpi_openmp_cuda_tpu_torch.obs import metrics as tmetrics
from mpi_openmp_cuda_tpu_torch.obs import spans as tspans
from mpi_openmp_cuda_tpu_torch.obs.flightrec import FlightRecorder as TFlightRecorder
from mpi_openmp_cuda_tpu_torch.ops import _build
from mpi_openmp_cuda_tpu_torch.resilience import watchdog as twatchdog
from mpi_openmp_cuda_tpu_torch.utils.profiling import PhaseTimer as TPhaseTimer

REPO = Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"
# Few fixtures keep these tests cheap; on each, both CLIs plan one launch
# group, so their per-launch counters can agree.
CLI_FIXTURES = ("tiny", "dup_and_k0", "mixedcase")


class FakeClock:
    """A monotonic clock that moves only when told to."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# Every event record_event maps, the serve and fleet events included.
EVENTS = [
    ("retry.attempt", {}), ("retry.backoff", {"delay": 0.5}),
    ("retry.backoff", {"delay": 0.003}), ("degrade.transition", {}),
    ("watchdog.expiry", {}), ("watchdog.guard", {"state": "armed"}),
    ("watchdog.guard", {"state": "disarmed"}), ("drain.request", {}),
    ("fault.injected", {}), ("recompile", {}), ("log", {"line": "x"}),
    ("rescue.beacon_miss", {}), ("rescue.orphans", {"count": 3}),
    ("serve.request.admitted", {"depth": 2}), ("serve.request.rejected", {}),
    ("serve.request.done", {"latency_s": 0.04}), ("serve.request.done", {"latency_s": 7.0}),
    ("serve.batch.dispatch", {"fill": 0.75, "depth": 1}),
    ("serve.request.failed", {"error": "deadline"}), ("serve.request.failed", {"error": "x"}),
    ("serve.request.shed", {}), ("serve.shed.state", {"state": "shed-new"}),
    ("serve.queue.wait", {"wait_s": 0.002}), ("serve.request.abandoned", {}),
    ("serve.request.poisoned", {}), ("serve.block.failed", {}), ("serve.client.lost", {}),
    ("worker.join", {"workers": 2}), ("worker.dead", {"workers": 1}),
    ("lease.expired", {}), ("lease.fenced", {}), ("fleet.redispatch", {}),
    ("fleet.deadletter", {}), ("leader.elected", {"gen": 1}),
    ("leader.takeover", {"gen": 2}), ("leader.fenced", {}), ("leader.deposed", {}),
    ("board.gc", {"count": 4}), ("fleet.score.start", {}), ("fleet.tape.collected", {}),
    ("serve.request.duplicate", {}), ("breaker.open", {}), ("breaker.half_open", {}),
    ("breaker.close", {}), ("something.new", {}),
]


def _fed(mod, events=EVENTS):
    clock = FakeClock()
    reg = mod.MetricsRegistry(clock)
    for name, fields in events:
        reg.record_event(name, fields)
        clock.advance(0.25)
    reg.inc("chunks_dispatched", 3)
    reg.gauge("backend", "cuda")
    reg.gauge("chunks_total", 6)
    return reg


def test_registry_snapshots_are_equal():
    assert _fed(tmetrics).snapshot() == _fed(jmetrics).snapshot()


@pytest.mark.parametrize("events", [EVENTS, EVENTS[:11], []], ids=["all", "batch", "none"])
def test_prometheus_text_is_byte_equal(events):
    t = tmetrics.to_prometheus(_fed(tmetrics, events).snapshot())
    j = jmetrics.to_prometheus(_fed(jmetrics, events).snapshot())
    assert t == j
    if events is EVENTS:
        assert 'seqalign_request_latency_s_bucket{le="+Inf"} 2' in t


def test_fleet_prometheus_text_is_byte_equal():
    snap = _fed(tmetrics).snapshot()
    fleet = {"w1": snap, "w0": _fed(tmetrics, EVENTS[:5]).snapshot(), "bad": 3}
    assert tmetrics.fleet_to_prometheus(fleet) == jmetrics.fleet_to_prometheus(fleet)


@pytest.mark.parametrize("events", [EVENTS, EVENTS[:11], []], ids=["all", "batch", "none"])
def test_heartbeat_line_is_equal(events):
    snap = _fed(tmetrics, events).snapshot()
    assert texport.heartbeat_line(snap) == jexport.heartbeat_line(snap)


def test_percentile_and_histogram_match():
    vals = [0.4, 0.001, 3.0, 0.02, 0.02, 9.0]
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert tmetrics.percentile(vals, q) == jmetrics.percentile(vals, q)
    th, jh = tmetrics.Histogram((0.01, 1.0)), jmetrics.Histogram((0.01, 1.0))
    for v in vals:
        th.observe(v)
        jh.observe(v)
    assert th.snapshot() == jh.snapshot()


def _envelopes(metrics_mod, frec_cls, tmp_path):
    run = metrics_mod.run_report(_fed(metrics_mod), exit_code=65, meta={"m": 1})
    bench = metrics_mod.wrap_report("bench", {"metric": "x", "value": 1.0})
    rec = frec_cls(depth=4, clock=FakeClock())
    for name, fields in EVENTS[:6]:
        rec.record_event(name, fields)
    rec.span_closed("score", 0.0, 0.5)
    flight = metrics_mod.wrap_report("flightrec", {
        "reason": "test", "depth": rec.depth, "dropped": 0, "events": rec.snapshot_tape()})
    return {"run": run, "bench": bench, "flightrec": flight}


@pytest.mark.parametrize("kind", ["run", "bench", "flightrec"])
def test_each_validator_accepts_the_other_packages_envelopes(kind, tmp_path, monkeypatch):
    monkeypatch.setenv("SEQALIGN_CACHE_DIR", str(tmp_path))
    t = _envelopes(tmetrics, TFlightRecorder, tmp_path)[kind]
    j = _envelopes(jmetrics, JFlightRecorder, tmp_path)[kind]
    assert t == j
    for rec in (t, j):
        tmetrics.validate_report(rec)
        jmetrics.validate_report(rec)


@pytest.mark.parametrize("bad", [
    {"schema": "other", "schema_version": 0, "kind": ""},
    {"schema": tmetrics.RUN_REPORT_SCHEMA, "schema_version": 1, "kind": "run",
     "counters": {"a": "x"}, "gauges": {}, "histograms": {"h": {"count": 1}}},
    {"schema": tmetrics.RUN_REPORT_SCHEMA, "schema_version": 1, "kind": "trace",
     "traceEvents": [{}], "gap_attribution": {"launches": [{}]}},
    {"schema": tmetrics.RUN_REPORT_SCHEMA, "schema_version": 1, "kind": "flightrec",
     "reason": "", "depth": "x", "events": [{"kind": "?"}]},
], ids=["envelope", "run", "trace", "flightrec"])
def test_validators_reject_alike(bad):
    with pytest.raises(ValueError) as t:
        tmetrics.validate_report(bad)
    with pytest.raises(ValueError) as j:
        jmetrics.validate_report(bad)
    assert str(t.value) == str(j.value)


def _spans(mod):
    clock = FakeClock()
    rec = mod.SpanRecorder(clock)
    for phase in ("parse", "setup", "score", "print"):
        with rec.span(phase):
            clock.advance(0.0125)
            if phase == "score":
                for _ in range(2):
                    with rec.span("chunk_dispatch"):
                        clock.advance(0.001)
                    with rec.span("chunk_gather"):
                        clock.advance(0.0031)
    return rec


def test_span_paths_totals_and_profile_report_are_equal(capsys):
    t, j = _spans(tspans), _spans(jspans)
    assert t.spans == j.spans
    assert [p for p, _ in t.spans][:3] == ["parse", "setup", "score.chunk_dispatch"]
    assert t.totals() == j.totals() and t.phases() == j.phases()
    TPhaseTimer(enabled=True, recorder=t).report()
    tout = capsys.readouterr().err
    JPhaseTimer(enabled=True, recorder=j).report()
    assert tout == capsys.readouterr().err
    assert "[profile]            total:" in tout
    TPhaseTimer(enabled=False, recorder=t).report()
    assert capsys.readouterr().err == ""


def test_flushed_report_and_prom_sidecar_are_byte_equal(tmp_path):
    paths = {}
    for tag, mod, exp, sp in (("t", tmetrics, texport, tspans), ("j", jmetrics, jexport, jspans)):
        path = str(tmp_path / f"{tag}.json")
        exp.flush_run_report(_fed(mod), _spans(sp), path, exit_code=75,
                             extra={"gap_attribution": {"launches": []}})
        paths[tag] = path
    for suffix in ("", ".prom"):
        assert Path(paths["t"] + suffix).read_bytes() == Path(paths["j"] + suffix).read_bytes()
    rec = json.loads(Path(paths["t"]).read_text())
    assert rec["exit_code"] == 75 and rec["spans"]["totals"]["score.chunk_gather"] == 0.0062
    assert texport.flush_run_report(None, None, paths["t"]) is None


def test_arm_and_disarm_cover_every_tier(tmp_path):
    try:
        reg, rec = tobs.arm_observability(with_trace=True, flightrec_depth=8)
        tevents.publish("retry.attempt")
        with tspans.span("score"):
            pass
        assert reg.counters == {"retry_attempts": 1}
        assert rec.phases()[0][0] == "score"
        assert tobs.trace.active_trace() is not None
        assert tobs.flightrec.active_flightrec().snapshot_tape()[-1]["name"] == "score"
    finally:
        tobs.disarm_observability()
    assert (tmetrics.active_metrics(), tspans.active_spans(), tevents.active_bus(),
            tobs.trace.active_trace(), tobs.flightrec.active_flightrec()) == (None,) * 5
    assert tspans.span("x") is tspans.span("y")  # the shared no-op context


# -- the watchdog's heartbeat ----------------------------------------------


def test_heartbeat_only_watchdog_beats_and_enforces_nothing():
    beats = threading.Event()
    wd = twatchdog.activate_watchdog(None, heartbeat_s=0.005, heartbeat=beats.set)
    try:
        assert beats.wait(5.0)
        with twatchdog.guard("dispatch"):
            twatchdog.check_expired("wait")  # no deadline: never expires
        with twatchdog.guard("dispatch"), pytest.raises(twatchdog.HangWithoutDeadlineError):
            twatchdog.hang_until_deadline("hang:dispatch")
        assert wd.expiries == 0
    finally:
        twatchdog.deactivate_watchdog()
    assert not [t for t in threading.enumerate() if t.name == twatchdog.THREAD_NAME]


@pytest.mark.parametrize("kwargs", [{"deadline_s": None}, {"deadline_s": 0},
                                    {"deadline_s": None, "heartbeat_s": 0}])
def test_watchdog_rejects_what_the_jax_one_rejects(kwargs):
    with pytest.raises(ValueError):
        twatchdog.Watchdog(**kwargs)


def test_heartbeat_callback_reads_the_armed_registry():
    lines = []
    beat = texport.heartbeat_callback(log=lines.append)
    beat()
    assert lines == []  # no registry armed
    reg = tmetrics.activate_metrics(FakeClock())
    try:
        reg.inc("chunks_dispatched", 2)
        reg.gauge("chunks_total", 5)
        beat()
    finally:
        tmetrics.deactivate_metrics()
    assert lines == ["[obs] chunk 2/5 retries=0 degraded=no"]


# -- the recompile event ---------------------------------------------------


def test_a_kernel_build_publishes_one_recompile_event(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "k.cu"
    src.write_text("")
    reg = tmetrics.activate_metrics(FakeClock())
    bus = tevents.activate_bus()
    bus.subscribe(reg.record_event)
    try:
        _build._compile({"a": (src, tmp_path / "build" / "a.so", ()),
                         "b": (src, tmp_path / "build" / "b.so", ())})
    finally:
        tevents.deactivate_bus()
        tmetrics.deactivate_metrics()
    assert reg.counters == {"recompiles": 2}


# -- both CLIs in-process, the plane armed ---------------------------------


@pytest.fixture
def quiet_env(monkeypatch, tmp_path):
    monkeypatch.setenv("SEQALIGN_BACKOFF_BASE", "0")
    # The suite turns the cache home off (tests/conftest.py), so flight
    # recorder dumps go to the temp dir: a fresh one per test.
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    for var in ("SEQALIGN_DEADLINE_S", "SEQALIGN_DRAIN", "SEQALIGN_FAULTS",
                "SEQALIGN_FAULT_RETRIES", "SEQALIGN_METRICS", "SEQALIGN_METRICS_OUT",
                "SEQALIGN_HEARTBEAT_S", "SEQALIGN_TRACE"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def _run(mod, argv, capfd):
    rc = mod.run(argv)
    cap = capfd.readouterr()
    return rc, cap.out, cap.err


MODES = {
    "plain": [],
    "retry": ["--faults", "chunk_scoring:fail=1", "--retries", "2"],
    "degrade": ["--degrade", "--retries", "1", "--faults", "chunk_scoring:fail=2"],
    "drain": ["--journal", "{tmp}/j.jsonl"],
}


# The counters both CLIs must agree on: all of them but `recompiles`, which
# counts jit compiles in the JAX CLI and nvcc builds in the port (none on the
# CPU), the port's feed counters (`feed_h2d_copies`, `feed_h2d_bytes`:
# its one-copy byte arena, which the JAX feed has no counterpart of) and
# its epilogue counters (`epilogue_kernel_rows`, `epilogue_torch_rows`: where
# each row was finished) and `dispatch_launched_cells` (the cells its kernels
# compute at their launches' shapes).
# Timings (spans, uptime) and gauges are not compared: the three TPU-only
# gauges (config_feed, config_superblock, config_chunk) have no counterpart
# on the card, and `backend` names each package's own chain.
_PORT_ONLY_COUNTERS = frozenset({"recompiles", "feed_h2d_copies", "feed_h2d_bytes",
                                 "epilogue_kernel_rows", "epilogue_torch_rows",
                                 "dispatch_launched_cells"})


def _counters(rec) -> dict:
    return {k: v for k, v in rec["counters"].items() if k not in _PORT_ONLY_COUNTERS}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("fixture", CLI_FIXTURES)
def test_cli_reports_match_the_jax_cli(fixture, mode, tmp_path, quiet_env, capfd):
    path = str(FIX / f"{fixture}.txt")
    if mode == "drain":
        quiet_env.setenv("SEQALIGN_DRAIN", "1")
    want_rc = 75 if mode == "drain" else 0
    reports = {}
    outs = {}
    for tag, mod, dev in (("jax", jcli, []), ("port", tcli, ["--device", "cpu"])):
        extra = [a.replace("{tmp}", str(tmp_path / tag)) for a in MODES[mode]]
        (tmp_path / tag).mkdir()
        report = tmp_path / f"{tag}.json"
        rc, out, err = _run(mod, ["--input", path, *dev, *extra, "--metrics-out",
                                  str(report)], capfd)
        assert rc == want_rc, err
        reports[tag] = json.loads(report.read_text())
        outs[tag] = out
        tmetrics.validate_report(reports[tag])
        jmetrics.validate_report(reports[tag])
    assert outs["port"] == outs["jax"]
    if mode == "drain":
        assert outs["port"] == "" and reports["port"]["exit_code"] == 75
    else:
        assert outs["port"] == (FIX / f"{fixture}.out").read_text()
        # With the plane off the port prints the same bytes.
        (tmp_path / "off").mkdir()
        extra = [a.replace("{tmp}", str(tmp_path / "off")) for a in MODES[mode]]
        rc, out, err = _run(tcli, ["--input", path, "--device", "cpu", *extra], capfd)
        assert rc == 0 and out == outs["port"]
    assert _counters(reports["port"]) == _counters(reports["jax"])
    assert reports["port"]["exit_code"] == reports["jax"]["exit_code"] == want_rc
    if mode != "drain":
        assert reports["port"]["gauges"]["config_fused_groups"] == 1


def test_fatal_exit_writes_the_report_and_dumps_the_flight_recorder(tmp_path, quiet_env, capfd):
    bad = tmp_path / "bad.txt"
    bad.write_text("1 2 3\n")
    reports = {}
    for tag, mod, dev in (("jax", jcli, []), ("port", tcli, ["--device", "cpu"])):
        report = tmp_path / f"{tag}.json"
        rc, out, err = _run(mod, ["--input", str(bad), *dev, "--metrics-out", str(report)],
                            capfd)
        assert rc == 65 and out == ""
        assert "flight recorder dumped" in err
        reports[tag] = json.loads(report.read_text())
    assert _counters(reports["port"]) == _counters(reports["jax"])
    assert reports["port"]["exit_code"] == reports["jax"]["exit_code"] == 65
    dumps = list((tmp_path / "tmp").glob("*/flightrec/flightrec-*-fatal-exit.json"))
    assert sorted(d.parent.parent.name for d in dumps) == [
        "mpi_openmp_cuda_tpu", "mpi_openmp_cuda_tpu_torch"]
    for dump in dumps:
        jmetrics.validate_report(json.loads(dump.read_text()))
        tmetrics.validate_report(json.loads(dump.read_text()))


@pytest.mark.parametrize("fixture", sorted(p.stem for p in FIX.glob("*.txt")))
def test_off_means_off(fixture, tmp_path, quiet_env, capfd):
    """No obs flag: stdout and stderr of a fixture run are the golden and
    nothing; no plane and no SIGUSR2 handler is left, nothing is dumped."""
    before = signal.getsignal(signal.SIGUSR2)
    rc, out, err = _run(tcli, ["--input", str(FIX / f"{fixture}.txt"), "--device", "cpu"],
                        capfd)
    assert (rc, out, err) == (0, (FIX / f"{fixture}.out").read_text(), "")
    assert tmetrics.active_metrics() is None and tspans.active_spans() is None
    assert signal.getsignal(signal.SIGUSR2) == before
    assert not list((tmp_path / "tmp").iterdir())


def test_obs_flags_change_no_stdout_and_restore_sigusr2(tmp_path, quiet_env, capfd):
    before = signal.getsignal(signal.SIGUSR2)
    seen = []
    orig = tcli._run_batch

    def spy(*a, **k):
        seen.append(signal.getsignal(signal.SIGUSR2))
        return orig(*a, **k)

    quiet_env.setattr(tcli, "_run_batch", spy)
    report, trace = tmp_path / "m.json", tmp_path / "t.json"
    rc, out, err = _run(tcli, ["--input", str(FIX / "stress_small.txt"), "--device", "cpu",
                               "--metrics-out", str(report), "--trace-out", str(trace),
                               "--profile", "--heartbeat", "0.01"], capfd)
    assert rc == 0 and out == (FIX / "stress_small.out").read_text()
    assert seen == [tcli._sigusr2_dump] and signal.getsignal(signal.SIGUSR2) == before
    rec = json.loads(report.read_text())
    tmetrics.validate_report(rec)
    assert [p for p, _ in rec["spans"]["phases"]] == ["parse", "setup", "score", "print"]
    assert {"score.chunk_dispatch", "score.chunk_gather"} <= set(rec["spans"]["totals"])
    assert rec["gap_attribution"]["launch_count"] == 1
    assert "[profile]            score:" in err
    assert Path(str(report) + ".prom").read_text().startswith("# HELP seqalign_")


def test_stream_phases_and_chunks_total(tmp_path, quiet_env, capfd):
    report = tmp_path / "m.json"
    rc, out, _ = _run(tcli, ["--input", str(FIX / "stress_small.txt"), "--device", "cpu",
                             "--stream", "5", "--metrics-out", str(report)], capfd)
    assert rc == 0 and out == (FIX / "stress_small.out").read_text()
    rec = json.loads(report.read_text())
    assert [p for p, _ in rec["spans"]["phases"]] == ["setup", "parse_header", "stream"]
    assert rec["gauges"]["chunks_total"] == 3 and rec["counters"]["chunks_dispatched"] == 3
    assert {"stream.chunk_dispatch", "stream.chunk_gather"} <= set(rec["spans"]["totals"])


@pytest.mark.parametrize("var,value", [("SEQALIGN_METRICS_OUT", "{tmp}/env.json"),
                                       ("SEQALIGN_TRACE", "{tmp}/env-trace.json")])
def test_env_vars_arm_the_plane(var, value, tmp_path, quiet_env, capfd):
    target = value.replace("{tmp}", str(tmp_path))
    quiet_env.setenv(var, target)
    rc, _, _ = _run(tcli, ["--input", str(FIX / "tiny.txt"), "--device", "cpu"], capfd)
    assert rc == 0
    tmetrics.validate_report(json.loads(Path(target).read_text()))


@pytest.mark.parametrize("argv,env", [(["--heartbeat", "0"], None),
                                      (["--heartbeat", "x"], None),
                                      ([], ("SEQALIGN_HEARTBEAT_S", "soon")),
                                      ([], ("SEQALIGN_HEARTBEAT_S", "-1"))])
def test_bad_obs_settings_are_usage_errors(argv, env, quiet_env, capfd):
    if env:
        quiet_env.setenv(*env)
    rc, out, err = _run(tcli, ["--input", str(FIX / "tiny.txt"), "--device", "cpu", *argv],
                        capfd)
    assert out == "" and rc == (2 if argv else 64), err
    assert "heartbeat" in err.lower() or "HEARTBEAT" in err


def test_sigusr2_dumps_the_armed_flight_recorder(tmp_path, quiet_env):
    tobs.arm_observability(flightrec_depth=4)
    try:
        tevents.publish("retry.attempt")
        # The dump runs on a helper thread (never under the interrupted
        # thread's recorder lock): wait for it before disarming.
        tcli._sigusr2_dump(signal.SIGUSR2, None).join(timeout=60)
    finally:
        tobs.disarm_observability()
    (dump,) = (tmp_path / "tmp" / "mpi_openmp_cuda_tpu_torch" / "flightrec").glob(
        "*-sigusr2.json")
    rec = json.loads(dump.read_text())
    assert rec["reason"] == "sigusr2" and rec["events"][0]["name"] == "retry.attempt"
    assert os.path.basename(str(dump)).startswith(f"flightrec-{os.getpid()}-")
