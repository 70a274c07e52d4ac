"""The port's trace plane against the JAX package's: the trace recorder's
export (the same events on the same tracks, the same gap attribution),
its modelled launch wall from the Hopper launch model, one launch row per
launch group from ``ops/dispatch.py``, the flight recorder's ring and
dumps, ``--trace-out`` on every exit path, ``--trace DIR``'s
``torch.profiler`` trace and the port's cache home.  Every comparison is
exact equality."""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path

import numpy as np
import pytest

from mpi_openmp_cuda_tpu.io import cli as jcli
from mpi_openmp_cuda_tpu.obs import flightrec as jflightrec
from mpi_openmp_cuda_tpu.obs import metrics as jmetrics
from mpi_openmp_cuda_tpu.obs import trace as jtrace
from mpi_openmp_cuda_tpu_torch.io import cli as tcli
from mpi_openmp_cuda_tpu_torch.models.workload import synthetic_codes
from mpi_openmp_cuda_tpu_torch.obs import flightrec as tflightrec
from mpi_openmp_cuda_tpu_torch.obs import metrics as tmetrics
from mpi_openmp_cuda_tpu_torch.obs import trace as ttrace
from mpi_openmp_cuda_tpu_torch.ops import dispatch as tdispatch
from mpi_openmp_cuda_tpu_torch.ops import schedule
from mpi_openmp_cuda_tpu_torch.utils import env as tenv
from mpi_openmp_cuda_tpu_torch.utils.profiling import device_trace

REPO = Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"


class FakeClock:
    def __init__(self):
        self.t = 10.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


LAUNCHES = [(3000, [1200, 1999, 1500]), (40, [9, 12, 16, 0, 41]), (5, [1, 2, 2])]


def _drive(mod):
    """One fixed sequence of bus events, span closures and launches."""
    clock = FakeClock()
    rec = mod.TraceRecorder(clock)
    rec.record_event("watchdog.guard", {"state": "armed", "site": "chunk dispatch"})
    rec.record_event("serve.request.admitted", {"trace": 7, "id": "r7"})
    for i, (len1, lens) in enumerate(LAUNCHES):
        rec.launch_begin(("k", i), links=["r7"] if i == 0 else (), len1=len1, lens=lens)
        clock.advance(0.002)
        rec.span_closed("score.chunk_dispatch", clock() - 0.002, 0.002)
        rec.launch_end(("k", i))
    rec.launch_begin("never-ended", len1=10, lens=[3])
    rec.launch_end("unknown")
    rec.record_event("serve.request.done", {"trace": 7})
    return rec


def _shape(export):
    return [(e["name"], e.get("cat"), e["ph"], e["pid"], e["tid"])
            for e in export["traceEvents"]]


def test_trace_exports_have_the_same_events_and_tracks():
    t, j = _drive(ttrace).export(exit_code=0), _drive(jtrace).export(exit_code=0)
    assert _shape(t) == _shape(j)
    assert t.keys() == j.keys()
    assert t["gap_attribution"].keys() == j["gap_attribution"].keys()
    for rt, rj in zip(t["gap_attribution"]["launches"], j["gap_attribution"]["launches"]):
        assert rt.keys() == rj.keys()
        assert (rt["request_ids"], rt["rows"], rt["len1"], rt["measured_s"]) == (
            rj["request_ids"], rj["rows"], rj["len1"], rj["measured_s"])
    assert t["gap_attribution"]["unfinished_launches"] == 1
    for rec in (t, j):
        tmetrics.validate_report(rec)
        jmetrics.validate_report(rec)


def test_modelled_wall_is_the_hopper_launch_model():
    rows = _drive(ttrace).gap_attribution()["launches"]
    for row, (len1, lens) in zip(rows, LAUNCHES):
        live = [x for x in lens if x > 0]
        l2p = -(-max(live) // 128) * 128
        want = schedule.launch_us(len1, live, l2p) * 1e-6
        assert row["modelled_s"] == round(want, 9) > 0
        assert row["gap_s"] == round(row["measured_s"] - want, 9)


@pytest.mark.parametrize("lens", [[], [0, 0], "bad"])
def test_modelled_wall_is_zero_without_live_rows(lens):
    assert ttrace.modelled_launch_wall_s(100, lens) == 0.0


def test_dispatch_records_one_launch_per_launch_group():
    seq1, seqs = synthetic_codes(400, 40, 1, 300, 3)
    launches = tdispatch.bucket_launches(seq1, seqs, [10, 2, 3, 4], tdispatch.resolve_device("cpu"))
    assert len(launches) >= 2
    rec = ttrace.activate_trace()
    try:
        got = tdispatch.AlignmentScorer(device="cpu").score_codes(seq1, seqs, [10, 2, 3, 4])
    finally:
        ttrace.deactivate_trace()
    gap = rec.gap_attribution()
    assert gap["launch_count"] == len(launches) and gap["unfinished_launches"] == 0
    assert [r["rows"] for r in gap["launches"]] == [b.idx.size for b in launches]
    for row, b in zip(gap["launches"], launches):
        want = ttrace.modelled_launch_wall_s(400, [seqs[i].size for i in b.idx])
        assert row["modelled_s"] == round(want, 9) > 0
    assert got.shape == (len(seqs), 3)


def test_a_failed_result_leaves_its_launches_unfinished(monkeypatch):
    from mpi_openmp_cuda_tpu_torch.resilience import faults

    seq1, seqs = synthetic_codes(200, 10, 1, 100, 5)
    rec = ttrace.activate_trace()
    faults.activate_faults("chunk_scoring:fail=1")
    try:
        pend = tdispatch.AlignmentScorer(device="cpu").score_codes_async(seq1, seqs, [1, 2, 3, 4])
        with pytest.raises(faults.InjectedFaultError):
            pend.result()
    finally:
        faults.deactivate_faults()
        ttrace.deactivate_trace()
    gap = rec.gap_attribution()
    assert gap["launch_count"] == 0 and gap["unfinished_launches"] == len(pend.trace_keys) >= 1


def test_no_trace_keys_when_the_trace_is_off():
    seq1, seqs = synthetic_codes(200, 10, 1, 100, 5)
    pend = tdispatch.AlignmentScorer(device="cpu").score_codes_async(seq1, seqs, [1, 2, 3, 4])
    assert pend.trace_keys == ()
    pend.result()


def _ring(mod):
    clock = FakeClock()
    rec = mod.FlightRecorder(depth=3, clock=clock)
    for i in range(5):
        rec.record_event("retry.attempt", {"i": i})
        clock.advance(0.5)
    rec.span_closed("score", 1.0, 0.25)
    return rec


def test_flight_recorder_rings_are_equal():
    t, j = _ring(tflightrec), _ring(jflightrec)
    assert t.snapshot_tape() == j.snapshot_tape()
    assert t.snapshot_tape(limit=1) == j.snapshot_tape(limit=1)
    assert t._dropped == j._dropped == 3


def test_watchdog_expiry_triggers_a_dump(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    rec = tflightrec.activate_flightrec(8)
    try:
        rec.record_event("watchdog.expiry", {"site": "x"})
        assert tflightrec.dump_active("manual") is not None
    finally:
        tflightrec.deactivate_flightrec()
    assert tflightrec.dump_active("off") is None
    names = sorted(Path(p).name.rsplit("-", 1)[1] for p in rec.dump_paths)
    assert names == ["expiry.json", "manual.json"]
    for path in rec.dump_paths:
        body = json.loads(Path(path).read_text())
        jmetrics.validate_report(body)
        assert Path(path).parent == tmp_path / "mpi_openmp_cuda_tpu_torch" / "flightrec"


@pytest.mark.parametrize("env,want", [
    ({"SEQALIGN_CACHE_DIR": "/x/home"}, "/x/home"),
    ({"TPU_SEQALIGN_COMPILE_CACHE": "/legacy"}, "/legacy"),
    ({"TPU_SEQALIGN_COMPILE_CACHE": "off", "SEQALIGN_CACHE_DIR": "/x"}, None),
    ({}, os.path.join(os.path.expanduser("~"), ".cache", "mpi_openmp_cuda_tpu_torch")),
])
def test_cache_home(env, want, monkeypatch):
    for var in ("SEQALIGN_CACHE_DIR", "TPU_SEQALIGN_COMPILE_CACHE"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tenv.cache_home() == want


# -- the CLI's trace flags -------------------------------------------------


@pytest.fixture
def quiet_env(monkeypatch, tmp_path):
    monkeypatch.setenv("SEQALIGN_BACKOFF_BASE", "0")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    for var in ("SEQALIGN_DEADLINE_S", "SEQALIGN_DRAIN", "SEQALIGN_FAULTS",
                "SEQALIGN_METRICS_OUT", "SEQALIGN_TRACE"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


@pytest.mark.parametrize("fixture", ["tiny", "stress_small"])
def test_trace_out_holds_one_row_per_launch_group(fixture, tmp_path, quiet_env, capfd):
    path = FIX / f"{fixture}.txt"
    trace, report = tmp_path / "t.json", tmp_path / "m.json"
    rc = tcli.run(["--input", str(path), "--device", "cpu", "--trace-out", str(trace),
                   "--metrics-out", str(report)])
    out = capfd.readouterr().out
    assert rc == 0 and out == path.with_suffix(".out").read_text()
    rec = json.loads(trace.read_text())
    tmetrics.validate_report(rec)
    jmetrics.validate_report(rec)
    from mpi_openmp_cuda_tpu_torch.io.parse import load_problem

    prob = load_problem(str(path))
    groups = tdispatch.bucket_launches(prob.seq1_codes, prob.seq2_codes, prob.weights,
                                       tdispatch.resolve_device("cpu"))
    rows = [e for e in rec["traceEvents"] if e["name"] == "dispatch"]
    assert len(rows) == len(groups) == rec["gap_attribution"]["launch_count"]
    assert all(r["modelled_s"] > 0 for r in rec["gap_attribution"]["launches"])
    assert json.loads(report.read_text())["gap_attribution"] == rec["gap_attribution"]
    names = {e["name"] for e in rec["traceEvents"]}
    assert {"parse", "score", "score.chunk_dispatch", "score.chunk_gather", "print"} <= names


def test_trace_out_is_written_on_a_fatal_exit_like_the_jax_cli(tmp_path, quiet_env, capfd):
    bad = tmp_path / "bad.txt"
    bad.write_text("1 2 3 4 AB1 1 A\n")
    recs = {}
    for tag, mod, dev in (("jax", jcli, []), ("port", tcli, ["--device", "cpu"])):
        trace = tmp_path / f"{tag}.json"
        assert mod.run(["--input", str(bad), *dev, "--trace-out", str(trace)]) == 65
        recs[tag] = json.loads(trace.read_text())
    capfd.readouterr()
    assert recs["port"]["exit_code"] == recs["jax"]["exit_code"] == 65
    assert _names(recs["port"]) == _names(recs["jax"])


def _names(rec):
    return [(e["name"], e["ph"], e["pid"], e["tid"]) for e in rec["traceEvents"]
            if e.get("cat") != "bus" or e["name"] != "recompile"]


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path / "prof")):
        np.arange(10).sum()
    (path,) = (tmp_path / "prof").glob("trace-*.json")
    assert "traceEvents" in json.loads(path.read_text())
    with device_trace(None):
        pass


def test_cli_trace_dir_profiles_the_score_phase(tmp_path, quiet_env, capfd):
    rc = tcli.run(["--input", str(FIX / "tiny.txt"), "--device", "cpu",
                   "--trace", str(tmp_path / "prof")])
    assert rc == 0 and capfd.readouterr().out == (FIX / "tiny.out").read_text()
    (path,) = (tmp_path / "prof").glob("trace-*.json")
    names = {e.get("name", "") for e in json.loads(path.read_text())["traceEvents"]}
    assert any("aten::" in n for n in names)


# -- live telemetry and the serve trace ----------------------------------------

import math  # noqa: E402
import urllib.error  # noqa: E402
import urllib.request  # noqa: E402

from mpi_openmp_cuda_tpu.obs import telemetry as jtelemetry  # noqa: E402
from mpi_openmp_cuda_tpu_torch.obs import arm_observability, disarm_observability  # noqa: E402
from mpi_openmp_cuda_tpu_torch.obs import events as tevents  # noqa: E402
from mpi_openmp_cuda_tpu_torch.obs.telemetry import TelemetryServer, answer_cmd  # noqa: E402
from mpi_openmp_cuda_tpu_torch.serve.loop import ServeLoop  # noqa: E402

GOLDEN_TRACE = REPO / "tests" / "golden" / "serve_trace.json"
SERVE_WEIGHTS = [1, -3, -5, -2]


class _Sink:
    def __init__(self):
        self.records = []

    def send(self, obj):
        self.records.append(obj)


def _serve_request(rid, seq1="ACGTACGT", seq2=("ACGT", "TTTT")):
    return {"id": rid, "weights": SERVE_WEIGHTS, "seq1": seq1, "seq2": list(seq2)}


@pytest.fixture
def disarmed():
    yield
    disarm_observability()


def test_answer_cmd_disarmed_planes_equal_the_jax_answers(disarmed):
    for cmd in ("metrics", "healthz", "trace", "bogus"):
        assert answer_cmd(cmd) == jtelemetry.answer_cmd(cmd)
    status = {"ok": True, "queue_depth": 3}
    assert answer_cmd("healthz", status=status) == {"telemetry": "healthz", "status": status}
    assert "unknown telemetry cmd" in answer_cmd("bogus")["error"]


def test_answer_cmd_trace_armed(disarmed):
    arm_observability(with_trace=True)
    tevents.publish("serve.request.admitted", id="a", trace="t1")
    rec = answer_cmd("trace")
    jmetrics.validate_report(rec["trace"])
    assert "serve.request.admitted" in [e.get("name") for e in rec["trace"]["traceEvents"]]


def test_serve_ingest_telemetry_verb_not_queued():
    loop = ServeLoop(None, None)
    sink = _Sink()
    loop.ingest('{"cmd": "healthz"}\n', sink)
    assert loop.queue.depth() == 0  # never admitted, never priced
    assert sink.records == [{"telemetry": "healthz", "status": {
        "ok": True, "queue_depth": 0, "shed_state": "accept", "breaker_state": None}}]
    loop.ingest('{"cmd": "nonsense"}\n', sink)
    assert "unknown telemetry cmd" in sink.records[-1]["error"]


def test_telemetry_http_endpoints(disarmed):
    reg, _ = arm_observability(with_trace=True)
    reg.inc("retry_attempts")
    srv = TelemetryServer(0, status=lambda: {"ok": True, "queue_depth": 0})
    base = f"http://127.0.0.1:{srv.start()}"
    try:
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as resp:
            assert resp.headers["Content-Type"].startswith("text/plain")
            body = resp.read().decode("utf-8")
        assert "# HELP seqalign_retry_attempts_total Total retry attempts" in body
        assert "seqalign_retry_attempts_total 1" in body
        with urllib.request.urlopen(f"{base}/healthz", timeout=10) as resp:
            assert json.loads(resp.read()) == {
                "telemetry": "healthz", "status": {"ok": True, "queue_depth": 0}}
        with urllib.request.urlopen(f"{base}/trace", timeout=10) as resp:
            tr = json.loads(resp.read())
        assert tr["telemetry"] == "trace"
        jmetrics.validate_report(tr["trace"])
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"{base}/nope", timeout=10)
        assert exc.value.code == 404
    finally:
        srv.close()
        srv.close()  # idempotent


_KEEP_ARGS = ("id", "trace", "outcome", "links", "request_ids", "rows", "len1")


def _project(rec: dict) -> list[dict]:
    """tests/test_trace.py's projection: tracks, names and request/launch
    linkage, no times."""
    kept = []
    for ev in rec["traceEvents"]:
        if ev.get("ph") == "M":
            kept.append(ev)
            continue
        cat, name = ev.get("cat"), ev.get("name", "")
        if not (cat in ("request", "launch", "model")
                or (cat in ("bus", "span") and name.startswith("serve."))):
            continue
        args = ev.get("args", {})
        kept.append({"ph": ev["ph"], "pid": ev["pid"], "tid": ev["tid"], "cat": cat,
                     "name": name, "args": {k: args[k] for k in _KEEP_ARGS if k in args}})
    return kept


def test_serve_trace_equals_the_jax_golden(tmp_path, quiet_env, capfd):
    """The canonical coalescing scenario (two requests sharing a problem
    key: one superblock, one launch of 64 rows) projects onto the JAX
    package's golden trace."""
    reqfile = tmp_path / "requests.ndjson"
    reqfile.write_text(json.dumps(_serve_request("a")) + "\n"
                       + json.dumps(_serve_request("b", seq2=["GGGG"])) + "\n")
    trace_out, report = tmp_path / "trace.json", tmp_path / "run.json"
    rc = tcli.run(["--serve", "--device", "cpu", "--input", str(reqfile),
                   "--metrics-out", str(report), "--trace-out", str(trace_out)])
    capfd.readouterr()
    assert rc == 0
    rec = json.loads(trace_out.read_text())
    jmetrics.validate_report(rec)
    ga = rec["gap_attribution"]
    assert ga["launch_count"] == 1 and ga["unfinished_launches"] == 0
    (row,) = ga["launches"]
    assert sorted(row["request_ids"]) == ["a", "b"] and row["rows"] == 64
    want_us = schedule.launch_us(8, [4, 4, 4] + [128] * 61, 128)
    assert row["modelled_s"] == round(want_us * 1e-6, 9)
    for field in ("measured_s", "modelled_s", "gap_s"):
        assert math.isfinite(row[field])
    assert json.loads(report.read_text())["gap_attribution"]["launches"] == ga["launches"]
    assert _project(rec) == json.loads(GOLDEN_TRACE.read_text())
