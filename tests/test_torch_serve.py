"""The port's serve plane against the contract ``tests/test_serve.py`` pins
for the JAX package (its tests, on the port's modules and the port's CLI on
``--device cpu``):

* serve-mode result ``line`` values are byte-identical to the batch CLI's
  stdout for the same problem;
* concurrent requests sharing a problem key coalesce into shared
  superblocks (one ``chunks_dispatched`` for two requests);
* a malformed request is one typed error record, never loop death;
* SIGTERM mid-run finishes in-flight superblocks, journals the queued
  leftovers, exits 75, and ``--resume`` finishes them byte-identically.

Then what is the port's own: the same request file through both packages'
``--serve`` (the same records, lines equal to both batch CLIs), serve
journals that resume across packages, the combination rejections and
their messages beside the JAX CLI's, the superblocks' launches (packed
for a block of short rows) and the kernels' spy on the card.

Unit layers (queue/batcher/session) run on a fake clock, so no test here
sleeps.
"""

from __future__ import annotations

import json
import signal

import pytest


from mpi_openmp_cuda_tpu_torch.serve.batcher import plan_blocks
from mpi_openmp_cuda_tpu_torch.serve.queue import (
    ADMIT_CLOSED,
    ADMIT_FULL,
    ADMIT_OK,
    RequestQueue,
)
from mpi_openmp_cuda_tpu_torch.serve.session import (
    build_session,
    journal_drained,
    load_drained,
)


from mpi_openmp_cuda_tpu_torch.io import cli as tcli


def run_cli_inproc(*args, capfd, rc_want=0):
    """The port's CLI in-process on the CPU: (stdout, stderr)."""
    rc = tcli.run(["--device", "cpu", *args])
    captured = capfd.readouterr()
    assert rc == rc_want, captured.err
    return captured.out, captured.err


@pytest.fixture(autouse=True)
def _quiet_env(monkeypatch):
    # No real backoff sleeps; no ambient survival or serve settings.
    monkeypatch.setenv("SEQALIGN_BACKOFF_BASE", "0")
    for var in ("SEQALIGN_DEADLINE_S", "SEQALIGN_DRAIN", "SEQALIGN_FAULTS",
                "SEQALIGN_FAULT_RETRIES", "SEQALIGN_SERVE_PORT",
                "SEQALIGN_TELEMETRY_PORT", "SEQALIGN_SERVE_DEADLINE_S"):
        monkeypatch.delenv(var, raising=False)


class FakeClock:
    """Deterministic ServeClock stand-in: ``now()`` counts calls;
    ``block_until`` never blocks — it evaluates the predicate once."""

    def __init__(self):
        self.t = 0.0

    def now(self) -> float:
        self.t += 1.0
        return self.t

    def block_until(self, cond, predicate, timeout_s):
        return predicate()


class Sink:
    """Responder stand-in collecting every sent record."""

    def __init__(self):
        self.records = []

    def send(self, obj):
        self.records.append(obj)


WEIGHTS = [1, -3, -5, -2]


def _request(rid, seq1="ACGTACGT", seq2=("ACGT", "TTTT")):
    return {
        "id": rid,
        "weights": WEIGHTS,
        "seq1": seq1,
        "seq2": list(seq2),
    }


def _queued(raw, sink=None, seq=1):
    class _Item:
        pass

    item = _Item()
    item.raw = raw
    item.responder = sink or Sink()
    item.admitted_t = 0.0
    item.seq = seq
    return item


# -- queue units -------------------------------------------------------------


class TestRequestQueue:
    def test_admission_cap(self):
        q = RequestQueue(2, FakeClock())
        s = Sink()
        assert q.submit(_request("a"), s) == ADMIT_OK
        assert q.submit(_request("b"), s) == ADMIT_OK
        assert q.submit(_request("c"), s) == ADMIT_FULL
        assert q.depth() == 2

    def test_closed_queue_rejects(self):
        q = RequestQueue(4, FakeClock())
        q.close()
        assert q.submit(_request("a"), Sink()) == ADMIT_CLOSED
        assert q.depth() == 0

    def test_pop_ready_takes_all_then_limit(self):
        q = RequestQueue(8, FakeClock())
        for rid in "abcd":
            q.submit(_request(rid), Sink())
        popped = q.pop_ready(0.1, 0.1, limit=3)
        assert [it.raw["id"] for it in popped] == ["a", "b", "c"]
        assert [it.raw["id"] for it in q.pop_ready(0.1, 0.1)] == ["d"]
        assert q.pop_ready(0.1, 0.1) == []

    def test_seq_numbers_are_unique_and_monotonic(self):
        q = RequestQueue(8, FakeClock())
        q.submit(_request(None), Sink())
        q.submit(_request(None), Sink())
        a, b = q.pop_ready(0.1, 0.1)
        assert (a.seq, b.seq) == (1, 2)

    def test_idle_tracks_sources(self):
        q = RequestQueue(8, FakeClock())
        assert q.idle()
        q.open_source()
        assert not q.idle()
        q.close_source()
        assert q.idle()

    def test_drain_pending_empties(self):
        q = RequestQueue(8, FakeClock())
        q.submit(_request("a"), Sink())
        assert [it.raw["id"] for it in q.drain_pending()] == ["a"]
        assert q.depth() == 0


# -- session / batcher units -------------------------------------------------


class TestSession:
    def test_out_of_order_fill_emits_in_index_order(self):
        sink = Sink()
        sess = build_session(
            _queued(_request("r", seq2=("ACGT", "TTTT", "GG")), sink),
            FakeClock(),
        )
        sess.fill(2, (5, 0, 0))
        sess.fill(0, (14, 1, 1))
        assert [r["line"] for r in sink.records] == [
            "#0: score: 14, n: 1, k: 1"
        ]
        sess.fill(1, (10, 0, 3))
        assert [r.get("line", "done") for r in sink.records] == [
            "#0: score: 14, n: 1, k: 1",
            "#1: score: 10, n: 0, k: 3",
            "#2: score: 5, n: 0, k: 0",
            "done",
        ]
        assert sink.records[-1] == {"id": "r", "done": True, "n": 3}

    def test_default_id_from_admission_seq(self):
        raw = _request(None)
        del raw["id"]
        sess = build_session(_queued(raw, seq=7), FakeClock())
        assert sess.id == "req-7"

    @pytest.mark.parametrize(
        "raw, want",
        [
            ({"weights": [1, 2, 3], "seq1": "AC", "seq2": []}, "weights"),
            ({"weights": WEIGHTS, "seq1": "", "seq2": []}, "seq1"),
            ({"weights": WEIGHTS, "seq1": "AC", "seq2": "AC"}, "seq2"),
            (
                {"weights": WEIGHTS, "seq1": "AC", "seq2": ["A", ""]},
                "empty",
            ),
            (
                {"weights": WEIGHTS, "seq1": "A" * 3001, "seq2": ["A"]},
                "BUF_SIZE_SEQ1",
            ),
            (
                {"weights": WEIGHTS, "seq1": "AC", "seq2": ["A" * 2001]},
                "BUF_SIZE_SEQ2",
            ),
        ],
    )
    def test_invalid_requests_are_typed_rejections(self, raw, want):
        from mpi_openmp_cuda_tpu_torch.serve.session import RequestError

        with pytest.raises(RequestError, match=want):
            build_session(_queued(raw), FakeClock())


class TestBatcher:
    def _sessions(self, specs):
        out = []
        for i, (seq1, seq2) in enumerate(specs):
            out.append(
                build_session(
                    _queued(_request(f"r{i}", seq1, seq2)), FakeClock()
                )
            )
        return out

    def test_shared_key_requests_coalesce_into_one_block(self):
        s1, s2 = self._sessions(
            [("ACGTACGT", ("ACGT", "TTTT")), ("ACGTACGT", ("GGGG",))]
        )
        blocks = plan_blocks([s1, s2], rows_per_block=8)
        assert len(blocks) == 1
        (b,) = blocks
        assert b.real_rows == 3
        assert len(b.codes) == 8  # padded to the fixed shape
        assert b.fill_ratio == pytest.approx(3 / 8)
        assert b.tags[:3] == [(s1, 0), (s1, 1), (s2, 0)]
        assert b.tags[3:] == [None] * 5

    def test_foreign_keys_get_separate_blocks(self):
        s1, s2 = self._sessions(
            [("ACGTACGT", ("ACGT",)), ("TTTTTTTT", ("ACGT",))]
        )
        assert len(plan_blocks([s1, s2], rows_per_block=8)) == 2

    def test_length_buckets_split_within_a_key(self):
        s1, s2 = self._sessions(
            [("ACGTACGT", ("ACGT",)), ("ACGTACGT", ("AC" * 150,))]
        )
        blocks = plan_blocks([s1, s2], rows_per_block=4)
        assert len(blocks) == 2
        sizes = sorted({b.codes[-1].size for b in blocks})
        assert sizes == [128, 384]  # pad rows carry the bucket length

    def test_every_block_has_exactly_rows_per_block(self):
        (s1,) = self._sessions([("ACGTACGT", tuple(["ACGT"] * 11))])
        blocks = plan_blocks([s1], rows_per_block=4)
        assert [len(b.codes) for b in blocks] == [4, 4, 4]
        assert [b.real_rows for b in blocks] == [4, 4, 3]


# -- obs satellites ----------------------------------------------------------


class TestServeObservability:
    def test_histogram_helper(self):
        from mpi_openmp_cuda_tpu_torch.obs.metrics import Histogram

        h = Histogram()
        for v in (2.0, 1.0, 4.0):
            h.observe(v)
        assert h == {"count": 3, "sum": 7.0, "min": 1.0, "max": 4.0}

    def test_serve_events_map_to_metrics(self):
        from mpi_openmp_cuda_tpu_torch.obs.metrics import MetricsRegistry

        reg = MetricsRegistry(clock=lambda: 0.0)
        reg.record_event("serve.request.admitted", {"depth": 3})
        reg.record_event("serve.request.rejected", {"reason": "full"})
        reg.record_event("serve.request.done", {"latency_s": 0.5})
        reg.record_event(
            "serve.batch.dispatch", {"rows": 7, "fill": 0.875, "depth": 1}
        )
        assert reg.counters == {
            "serve_requests": 1,
            "serve_rejections": 1,
            "serve_completed": 1,
            "serve_batches": 1,
            "serve_block_rows": 7,
        }
        assert reg.gauges["queue_depth"] == 1
        assert reg.gauges["batch_fill_ratio"] == 0.875
        assert reg.histograms["request_latency_s"]["count"] == 1

    def test_heartbeat_gains_queue_suffix_only_in_serve(self):
        from mpi_openmp_cuda_tpu_torch.obs.export import heartbeat_line

        base = {"counters": {}, "gauges": {}}
        assert heartbeat_line(base) == "[obs] chunk 0/? retries=0 degraded=no"
        serve = {"counters": {}, "gauges": {"queue_depth": 5}}
        assert heartbeat_line(serve).endswith(" queue=5")


# -- the serve journal -------------------------------------------------------


class TestServeJournal:
    def test_round_trip(self, tmp_path):
        path = str(tmp_path / "serve.jsonl")
        raws = [_request("a"), _request("b")]
        journal_drained(path, raws)
        assert load_drained(path) == raws
        with open(path) as f:
            recs = [json.loads(l) for l in f.read().splitlines()]
        assert recs[-1] == {"event": "drain"}

    def test_clean_exit_rewrite_is_empty(self, tmp_path):
        path = str(tmp_path / "serve.jsonl")
        journal_drained(path, [_request("a")])
        journal_drained(path, [])
        assert load_drained(path) == []

    def test_missing_file_is_fresh_start(self, tmp_path):
        assert load_drained(str(tmp_path / "absent.jsonl")) == []

    def test_foreign_journal_refused(self, tmp_path):
        path = tmp_path / "batch.jsonl"
        path.write_text('{"format": "mpi_openmp_cuda_tpu.journal.v1"}\n')
        with pytest.raises(ValueError, match="mutually foreign"):
            load_drained(str(path))


# -- CLI usage gates ---------------------------------------------------------


class TestServeUsage:
    @pytest.mark.parametrize(
        "argv",
        [
            ("--serve", "--stream", "4"),
            ("--serve", "--selfcheck"),
            ("--serve", "--distributed"),
        ],
    )
    def test_serve_combo_rejections(self, argv, capfd):
        _, err = run_cli_inproc(*argv, capfd=capfd, rc_want=64)
        assert "cannot be combined with --serve" in err

    def test_port_requires_serve(self, capfd):
        _, err = run_cli_inproc("--port", "0", capfd=capfd, rc_want=64)
        assert "--port requires --serve" in err


# -- end-to-end over the stdin pipe ------------------------------------------


def _serve_records(out: str) -> list[dict]:
    return [json.loads(l) for l in out.splitlines() if l.strip()]


def _lines_by_id(records) -> dict:
    got: dict[str, list[str]] = {}
    for rec in records:
        if "line" in rec:
            got.setdefault(rec["id"], []).append(rec["line"])
    return got


class TestServePipeE2E:
    SEQ2 = ["ACGT", "TTTT", "ACGTTGCA", "AC" * 40, "GATTACA"]

    def test_serve_lines_byte_identical_to_batch_cli(self, tmp_path, capfd):
        reqfile = tmp_path / "reqs.ndjson"
        reqfile.write_text(
            json.dumps(_request("r1", "ACGTACGT", self.SEQ2)) + "\n"
        )
        serve_out, _ = run_cli_inproc(
            "--serve", "--input", str(reqfile), capfd=capfd
        )
        records = _serve_records(serve_out)
        assert records[-1] == {"id": "r1", "done": True, "n": len(self.SEQ2)}

        batch_in = tmp_path / "batch.txt"
        batch_in.write_text(
            " ".join(str(w) for w in WEIGHTS)
            + f"\nACGTACGT\n{len(self.SEQ2)}\n"
            + "\n".join(self.SEQ2)
            + "\n"
        )
        batch_out, _ = run_cli_inproc(
            "--input", str(batch_in), capfd=capfd
        )
        assert "\n".join(_lines_by_id(records)["r1"]) + "\n" == batch_out

    @pytest.mark.no_chaos  # exact dispatch accounting
    def test_shared_key_requests_share_superblocks(self, tmp_path, capfd):
        reqfile = tmp_path / "reqs.ndjson"
        reqfile.write_text(
            json.dumps(_request("a", "ACGTACGT", ["ACGT", "TTTT"]))
            + "\n"
            + json.dumps(_request("b", "ACGTACGT", ["GGGG"]))
            + "\n"
        )
        report = tmp_path / "report.json"
        out, _ = run_cli_inproc(
            "--serve",
            "--input",
            str(reqfile),
            "--metrics-out",
            str(report),
            capfd=capfd,
        )
        records = _serve_records(out)
        assert {r["id"] for r in records if r.get("done")} == {"a", "b"}
        rep = json.loads(report.read_text())
        # Both requests pooled into ONE superblock: one dispatch, one
        # batch, fewer dispatches than requests — the coalescing proof.
        assert rep["counters"]["serve_requests"] == 2
        assert rep["counters"]["serve_batches"] == 1
        assert rep["counters"]["chunks_dispatched"] == 1
        assert rep["gauges"]["batch_fill_ratio"] == round(3 / 64, 4)
        assert rep["gauges"]["serve_steady_compiles"] == 0

    def test_malformed_requests_do_not_kill_the_loop(self, tmp_path, capfd):
        reqfile = tmp_path / "reqs.ndjson"
        reqfile.write_text(
            "this is not json\n"
            + json.dumps({"id": "w3", "weights": [1, 2, 3], "seq1": "AC",
                          "seq2": ["AC"]})
            + "\n"
            + json.dumps(_request("bad-alpha", "ACGT", ["B@D!"]))
            + "\n"
            + json.dumps(_request("ok", "ACGTACGT", ["ACGT"]))
            + "\n"
        )
        out, _ = run_cli_inproc(
            "--serve", "--input", str(reqfile), capfd=capfd
        )
        records = _serve_records(out)
        errors = {r["id"]: r["error"] for r in records if "error" in r}
        assert None in errors and "not JSON" in errors[None]
        assert "w3" in errors
        assert "bad-alpha" in errors
        assert any(r.get("done") and r["id"] == "ok" for r in records)

    def test_queue_full_rejection(self, tmp_path, monkeypatch, capfd):
        monkeypatch.setenv("SEQALIGN_SERVE_MAX_QUEUE", "1")
        reqfile = tmp_path / "reqs.ndjson"
        reqfile.write_text(
            "".join(
                json.dumps(_request(rid, "ACGTACGT", ["ACGT"])) + "\n"
                for rid in ("r1", "r2", "r3")
            )
        )
        out, _ = run_cli_inproc(
            "--serve", "--input", str(reqfile), capfd=capfd
        )
        records = _serve_records(out)
        full = [r for r in records if "queue full" in r.get("error", "")]
        assert {r["id"] for r in full} == {"r2", "r3"}
        assert any(r.get("done") and r["id"] == "r1" for r in records)


# -- drain → 75 → resume -----------------------------------------------------


@pytest.mark.no_chaos  # exact per-call signal timing and journal accounting
def test_sigterm_mid_serve_drains_journals_and_resumes(
    tmp_path, monkeypatch, capfd
):
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import AlignmentScorer

    journal = str(tmp_path / "serve.jsonl")
    reqfile = tmp_path / "reqs.ndjson"
    reqfile.write_text(
        "".join(
            json.dumps(_request(rid, "ACGTACGT", ["ACGT", "GATTACA"])) + "\n"
            for rid in ("r1", "r2", "r3")
        )
    )
    calls = {"n": 0}
    orig = AlignmentScorer.score_codes_async

    def signalling(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            signal.raise_signal(signal.SIGTERM)
        return orig(self, *a, **kw)

    monkeypatch.setattr(AlignmentScorer, "score_codes_async", signalling)
    # One request per tick so the signal lands between superblocks.
    monkeypatch.setenv("SEQALIGN_SERVE_MAX_POP", "1")
    out, err = run_cli_inproc(
        "--serve",
        "--input",
        str(reqfile),
        "--journal",
        journal,
        capfd=capfd,
        rc_want=75,
    )
    records = _serve_records(out)
    # r1 and r2 finished (their superblocks were in flight); r3 never
    # started — journaled and told so.
    done = {r["id"] for r in records if r.get("done")}
    assert done == {"r1", "r2"}
    assert {"id": "r3", "drained": True} in records
    assert "journaled" in err and "--resume" in err
    assert [raw["id"] for raw in load_drained(journal)] == ["r3"]

    monkeypatch.setattr(AlignmentScorer, "score_codes_async", orig)
    r3_out, _ = run_cli_inproc(
        "--serve",
        "--input",
        "/dev/null",
        "--journal",
        journal,
        "--resume",
        capfd=capfd,
    )
    r3 = _serve_records(r3_out)
    assert {"id": "r3", "done": True, "n": 2} in r3
    # The resumed lines are the same bytes a fresh scoring produces
    # (r1 scored the identical problem above).
    assert _lines_by_id(r3)["r3"] == _lines_by_id(records)["r1"]
    # Clean completion empties the journal: double-resume is a no-op.
    assert load_drained(journal) == []
    empty_out, _ = run_cli_inproc(
        "--serve",
        "--input",
        "/dev/null",
        "--journal",
        journal,
        "--resume",
        capfd=capfd,
    )
    assert _serve_records(empty_out) == []


# -- loopback socket e2e -----------------------------------------------------


@pytest.mark.no_chaos  # exact done/drain record accounting on a live socket
def test_loopback_socket_concurrent_clients_then_sigterm(
    tmp_path, monkeypatch, capfd
):
    """The persistent transport, in-process: cli.run owns the main
    thread (the drain guard needs it for signal handlers); client
    threads connect over loopback, stream requests, and read their own
    result records back; SIGTERM then drains the server to exit 75."""
    import os
    import socket
    import threading

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]

    results: dict[str, list[dict]] = {}
    failures: list[BaseException] = []

    def client(rid, seq2):
        try:
            deadline = 60.0
            while True:
                try:
                    conn = socket.create_connection(
                        ("127.0.0.1", port), timeout=5
                    )
                    break
                except OSError:
                    deadline -= 0.05
                    if deadline <= 0:
                        raise
                    threading.Event().wait(0.05)
            with conn:
                conn.sendall(
                    (json.dumps(_request(rid, "ACGTACGT", seq2)) + "\n")
                    .encode()
                )
                buf = b""
                while b'"done"' not in buf:
                    chunk = conn.recv(65536)
                    if not chunk:
                        break
                    buf += chunk
            results[rid] = [
                json.loads(l) for l in buf.decode().splitlines() if l
            ]
        except BaseException as e:  # surfaced in the main thread
            failures.append(e)

    threads = [
        threading.Thread(target=client, args=(rid, seq2), daemon=True)
        for rid, seq2 in (
            ("c1", ["ACGT", "GATTACA"]),
            ("c2", ["TTTT"]),
        )
    ]

    def fire_when_served():
        for t in threads:
            t.join(120)
        os.kill(os.getpid(), signal.SIGTERM)

    for t in threads:
        t.start()
    stopper = threading.Thread(target=fire_when_served, daemon=True)
    stopper.start()

    _, err = run_cli_inproc(
        "--serve", "--port", str(port), "--input", "/dev/null",
        capfd=capfd, rc_want=75,
    )
    stopper.join(120)
    assert not failures, failures
    assert "serving on 127.0.0.1:" in err
    assert set(results) == {"c1", "c2"}
    for rid, n in (("c1", 2), ("c2", 1)):
        assert {"id": rid, "done": True, "n": n} in results[rid]
        assert len(_lines_by_id(results[rid])[rid]) == n


# -- the port against the JAX package's --serve -----------------------------

from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mpi_openmp_cuda_tpu.io import cli as jcli  # noqa: E402
from mpi_openmp_cuda_tpu_torch.ops import cuda_scorer as cs  # noqa: E402
from mpi_openmp_cuda_tpu_torch.ops import dispatch as tdispatch  # noqa: E402

FIX = Path(__file__).resolve().parent / "fixtures"
FIXTURES = sorted(FIX.glob("*.txt"))
_LETTERS = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"))


def _fixture_request(path: Path) -> dict:
    tok = path.read_text().split()
    n = int(tok[5])
    return {"id": path.stem, "weights": [int(t) for t in tok[:4]], "seq1": tok[4],
            "seq2": tok[6:6 + n]}


def _seeded_requests(seed: int) -> list[dict]:
    """Several problem keys, mixed lengths: len2 = 0 (a typed error in
    both packages), len2 == len1, len2 > len1, short rows that pack, one
    malformed and one out-of-range request."""
    rng = np.random.default_rng(seed)

    def word(n):
        return "".join(rng.choice(_LETTERS, size=int(n)))

    keys = [([int(w) for w in rng.integers(1, 12, size=4)], word(rng.integers(60, 200)))
            for _ in range(3)]
    reqs = []
    for i in range(7):
        weights, seq1 = keys[i % len(keys)]
        lens = list(rng.integers(1, 150, size=int(rng.integers(1, 12))))
        if i == 1:
            lens += [len(seq1), len(seq1) + 5]
        if i == 2:
            lens = list(rng.integers(1, 40, size=10))  # a packing class fills
        reqs.append({"id": f"s{seed}-{i}", "weights": weights, "seq1": seq1,
                     "seq2": [word(n) for n in lens]})
    reqs.append({"id": f"s{seed}-empty", "weights": keys[0][0], "seq1": keys[0][1],
                 "seq2": ["AC", ""]})
    reqs.append({"id": f"s{seed}-range", "weights": [2**31, 1, 1, 1], "seq1": "ACGT",
                 "seq2": ["AC"]})
    return reqs


def _jax_run(*args, capfd, rc_want=0):
    rc = jcli.run(list(args))
    captured = capfd.readouterr()
    assert rc == rc_want, captured.err
    return captured.out, captured.err


def _by_id(records) -> dict:
    got: dict = {}
    for rec in records:
        got.setdefault(rec.get("id"), []).append(rec)
    return got


def _batch_text(raw) -> str:
    return (" ".join(str(w) for w in raw["weights"]) + f"\n{raw['seq1']}\n"
            + f"{len(raw['seq2'])}\n" + "".join(s + "\n" for s in raw["seq2"]))


@pytest.mark.no_chaos
@pytest.mark.parametrize("seed", [3, 11])
def test_serve_records_equal_the_jax_serve_and_both_batch_clis(seed, tmp_path, capfd):
    reqs = _seeded_requests(seed)
    reqfile = tmp_path / "reqs.ndjson"
    reqfile.write_text("".join(json.dumps(r) + "\n" for r in reqs) + "not json\n")
    port_out, _ = run_cli_inproc("--serve", "--input", str(reqfile), capfd=capfd)
    jax_out, _ = _jax_run("--serve", "--input", str(reqfile), capfd=capfd)
    port_recs, jax_recs = _serve_records(port_out), _serve_records(jax_out)
    assert _by_id(port_recs) == _by_id(jax_recs)
    assert "not JSON" in _by_id(port_recs)[None][0]["error"]
    assert "empty" in _by_id(port_recs)[f"s{seed}-empty"][0]["error"]
    assert "32-bit" in _by_id(port_recs)[f"s{seed}-range"][0]["error"]
    lines = _lines_by_id(port_recs)
    for raw in reqs[:7]:
        batch_in = tmp_path / f"{raw['id']}.txt"
        batch_in.write_text(_batch_text(raw))
        want, _ = run_cli_inproc("--input", str(batch_in), capfd=capfd)
        assert "\n".join(lines[raw["id"]]) + "\n" == want
        assert _jax_run("--input", str(batch_in), capfd=capfd)[0] == want


@pytest.mark.parametrize("path", FIXTURES, ids=[p.stem for p in FIXTURES])
def test_fixture_problems_as_requests_print_the_goldens(path, tmp_path, capfd):
    reqfile = tmp_path / "reqs.ndjson"
    reqfile.write_text(json.dumps(_fixture_request(path)) + "\n")
    out, _ = run_cli_inproc("--serve", "--input", str(reqfile), capfd=capfd)
    records = _serve_records(out)
    n = len(_fixture_request(path)["seq2"])
    assert records[-1] == {"id": path.stem, "done": True, "n": n}
    got = "".join(line + "\n" for line in _lines_by_id(records).get(path.stem, []))
    assert got == path.with_suffix(".out").read_text()


@pytest.mark.no_chaos
def test_fixture_requests_equal_the_jax_serve(tmp_path, capfd):
    # empty_batch (a request of no Seq2) is left out: the JAX serve loop
    # exits 65 on it (test_request_of_no_seq2_is_answered_done below).
    reqfile = tmp_path / "reqs.ndjson"
    reqfile.write_text("".join(json.dumps(_fixture_request(p)) + "\n" for p in FIXTURES
                               if p.stem != "empty_batch"))
    port_out, _ = run_cli_inproc("--serve", "--input", str(reqfile), capfd=capfd)
    jax_out, _ = _jax_run("--serve", "--input", str(reqfile), capfd=capfd)
    assert _by_id(_serve_records(port_out)) == _by_id(_serve_records(jax_out))


def test_request_of_no_seq2_is_answered_done(tmp_path, capfd):
    # Where the port departs from the JAX package: its batcher opens an
    # empty superblock group for a request of no Seq2 and the serve loop
    # dies on it (exit 65); the port answers it with the done record
    # Session.advance is written to send, and serves the next request.
    reqfile = tmp_path / "reqs.ndjson"
    empty = {"id": "e", "weights": WEIGHTS, "seq1": "TTGACA", "seq2": []}
    reqfile.write_text(json.dumps(empty) + "\n" + json.dumps(_request("a")) + "\n")
    out, _ = run_cli_inproc("--serve", "--input", str(reqfile), capfd=capfd)
    records = _serve_records(out)
    assert {"id": "e", "done": True, "n": 0} in records
    assert {"id": "a", "done": True, "n": 2} in records
    _, err = _jax_run("--serve", "--input", str(reqfile), capfd=capfd, rc_want=65)
    assert "list index out of range" in err


@pytest.mark.no_chaos
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_serve_journal_resumes_in_the_other_package(writer, tmp_path, monkeypatch, capfd):
    """SIGTERM at the second superblock (one request a tick) of one
    package's --serve; the other package's --resume finishes the journaled
    requests with the records a fresh run gives."""
    from mpi_openmp_cuda_tpu.ops.dispatch import AlignmentScorer as JScorer

    reqs = _seeded_requests(5)[:4]
    reqfile = tmp_path / "reqs.ndjson"
    reqfile.write_text("".join(json.dumps(r) + "\n" for r in reqs))
    journal = str(tmp_path / "serve.jsonl")
    scorer, run_writer, run_reader = (
        (JScorer, _jax_run, run_cli_inproc) if writer == "jax"
        else (tdispatch.AlignmentScorer, run_cli_inproc, _jax_run))
    calls = {"n": 0}
    orig = scorer.score_codes_async

    def signalling(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            signal.raise_signal(signal.SIGTERM)
        return orig(self, *a, **kw)

    monkeypatch.setenv("SEQALIGN_SERVE_MAX_POP", "1")
    with monkeypatch.context() as mp:
        mp.setattr(scorer, "score_codes_async", signalling)
        out, _ = run_writer("--serve", "--input", str(reqfile), "--journal", journal,
                            capfd=capfd, rc_want=75)
    left = [r["id"] for r in load_drained(journal)]
    assert left and left == [r["id"] for r in reqs][-len(left):]
    assert {"id": left[0], "drained": True} in _serve_records(out)
    resumed, _ = run_reader("--serve", "--input", "/dev/null", "--journal", journal,
                            "--resume", capfd=capfd)
    fresh, _ = run_cli_inproc("--serve", "--input", str(reqfile), capfd=capfd)
    want = {k: v for k, v in _by_id(_serve_records(fresh)).items() if k in left}
    assert _by_id(_serve_records(resumed)) == want
    assert load_drained(journal) == []


class TestServeUsageAgainstJax:
    @pytest.mark.parametrize(
        "argv",
        [
            ("--serve", "--stream", "4"),
            ("--serve", "--selfcheck"),
            ("--serve", "--distributed"),
            ("--port", "0"),
            ("--telemetry-port", "0"),
            ("--fleet-worker",),
            ("--fleet-worker", "--serve", "--fleet-board", "board"),
            ("--fleet-standby", "--fleet-worker", "--fleet-board", "board"),
            ("--fleet-board", "board"),
        ],
    )
    def test_rejections_carry_the_jax_cli_code_and_message(self, argv, capfd):
        _, port_err = run_cli_inproc(*argv, capfd=capfd, rc_want=64)
        _, jax_err = _jax_run(*argv, capfd=capfd, rc_want=64)
        strip = lambda e: e.strip().split(": error: ", 1)[1]  # noqa: E731
        assert strip(port_err) == strip(jax_err)
        assert port_err.startswith("mpi_openmp_cuda_tpu_torch: error: ")

    def test_serve_without_a_card_exits_65(self, monkeypatch, tmp_path, capfd):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        reqfile = tmp_path / "reqs.ndjson"
        reqfile.write_text(json.dumps(_request("a")) + "\n")
        rc = tcli.run(["--serve", "--input", str(reqfile)])
        captured = capfd.readouterr()
        assert rc == 65 and captured.out == ""
        assert "no CUDA device" in captured.err

    def test_serve_composes_with_a_mesh(self, monkeypatch, tmp_path, capfd):
        monkeypatch.setenv("SEQALIGN_HOST_DEVICES", "2")
        reqfile = tmp_path / "reqs.ndjson"
        reqfile.write_text(json.dumps(_fixture_request(FIX / "mixedcase.txt")) + "\n")
        out, _ = run_cli_inproc("--serve", "--mesh", "2", "--input", str(reqfile),
                                capfd=capfd)
        got = "".join(line + "\n" for line in _lines_by_id(_serve_records(out))["mixedcase"])
        assert got == (FIX / "mixedcase.out").read_text()


# -- the superblocks' launches -------------------------------------------------


def _block_launches(specs, rows_per_block=64):
    sessions = [
        build_session(_queued(_request(f"r{i}", seq1, seq2)), FakeClock())
        for i, (seq1, seq2) in enumerate(specs)
    ]
    blocks = plan_blocks(sessions, rows_per_block=rows_per_block)
    return blocks, [
        tdispatch.bucket_launches(b.seq1_codes, b.codes, b.weights, torch.device("cpu"))
        for b in blocks
    ]


def test_canonical_block_is_one_fused_launch_of_64_rows():
    # The JAX package's canonical scenario: 3 short rows + 61 pad rows of
    # the 128 bucket are one launch, as in its trace golden (the short
    # rows are fewer than MIN_BUCKET_ROWS, so they merge into the pads'
    # bucket and no packing class forms).
    blocks, launches = _block_launches(
        [("ACGTACGT", ("ACGT", "TTTT")), ("ACGTACGT", ("GGGG",))])
    (block,), (plan,) = blocks, launches
    assert len(plan) == 1 and plan[0].l2s is None and plan[0].idx.size == 64


def test_block_of_eight_short_rows_and_pads_splits_packed_and_fused():
    # Where the port launches a block differently from the JAX package:
    # the scorer re-buckets each block with packing on, so >= 8 real rows
    # of at most 8 chars form a packing class (the packed kernel) and the
    # 128-char pad rows their own fused launch (packed keys never join a
    # launch group).  The JAX scorer packs the block as a whole (the pads
    # are 128 wide: one fused launch).  Same rows either way.
    blocks, launches = _block_launches([("ACGT" * 40, tuple(["ACGTACG"] * 8))])
    (plan,) = launches
    assert sorted((b.l2s or 0, b.idx.size) for b in plan) == [(0, 56), (8, 8)]


def test_full_short_block_runs_only_the_packed_kernel():
    rng = np.random.default_rng(7)
    seq2 = tuple("".join(rng.choice(_LETTERS, size=int(n)))
                 for n in rng.integers(5, 65, size=64))
    _, (plan,) = _block_launches([("ACGT" * 200, seq2)])
    assert plan and all(b.l2s is not None for b in plan)
    assert sum(b.idx.size for b in plan) == 64


@pytest.mark.gpu
def test_serve_blocks_launch_both_kernels_on_card(tmp_path, capfd):
    """On the card a --serve run's superblocks go through fused_scorer and
    packed_scorer, each launch equal to its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(9)
    short = ["".join(rng.choice(_LETTERS, size=int(n))) for n in rng.integers(5, 65, size=64)]
    long_ = ["".join(rng.choice(_LETTERS, size=int(n))) for n in rng.integers(200, 900, size=8)]
    reqfile = tmp_path / "reqs.ndjson"
    reqfile.write_text(
        json.dumps({"id": "short", "weights": [10, 2, 3, 4], "seq1": "ACGT" * 250,
                    "seq2": short}) + "\n"
        + json.dumps({"id": "long", "weights": [10, 2, 3, 4], "seq1": "ACGT" * 250,
                      "seq2": long_}) + "\n")
    seen = []
    real = {"fused": cs.fused_scorer, "packed": cs.packed_scorer}

    def fresh(finished):
        return (finished[0].clone(), *finished[1:]) if finished else ()

    def fused(state, *finished):
        want = cs.fused_scorer_plain(state, *fresh(finished))
        got = real["fused"](state, *finished)
        assert torch.equal(got, want)
        seen.append("fused_scorer")
        return got

    def packed(state, l2s, *finished):
        want = cs.packed_scorer_plain(state, l2s, *fresh(finished))
        got = real["packed"](state, l2s, *finished)
        assert torch.equal(got, want)
        seen.append("packed_scorer")
        return got

    cs.reset_launch_counts()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdispatch, "fused_scorer", fused)
        mp.setattr(tdispatch, "packed_scorer", packed)
        rc = tcli.run(["--serve", "--input", str(reqfile)])
    out = capfd.readouterr().out
    assert rc == 0
    assert set(seen) == {"fused_scorer", "packed_scorer"}
    assert cs.launch_counts["fused_scorer"] >= 1 and cs.launch_counts["packed_scorer"] >= 1
    done = {r["id"] for r in _serve_records(out) if r.get("done")}
    assert done == {"short", "long"}


@pytest.mark.no_chaos
def test_kill_at_a_serve_tick_loses_and_doubles_nothing(tmp_path):
    """``kill:serve-tick`` SIGKILLs the server at its second tick (one
    request a tick): the live journal holds exactly the unanswered
    requests, and ``--resume`` answers them, none twice."""
    import os
    import subprocess
    import sys

    repo = Path(__file__).resolve().parent.parent
    reqfile = tmp_path / "reqs.ndjson"
    reqfile.write_text("".join(
        json.dumps(_request(rid, "ACGTACGT", ["ACGT", "GATTACA"])) + "\n"
        for rid in ("r1", "r2", "r3")))
    journal = str(tmp_path / "serve.jsonl")
    env = {**os.environ, "SEQALIGN_SERVE_MAX_POP": "1",
           "SEQALIGN_CACHE_DIR": str(tmp_path / "cache")}
    base = [sys.executable, "-m", "mpi_openmp_cuda_tpu_torch", "--serve", "--device", "cpu",
            "--journal", journal]
    killed = subprocess.run(
        base + ["--input", str(reqfile), "--faults", "kill:serve-tick:fail=1,after=1"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=120)
    assert killed.returncode == -9, killed.stderr
    first = _serve_records(killed.stdout)
    assert {r["id"] for r in first if r.get("done")} == {"r1"}
    assert [raw["id"] for raw in load_drained(journal)] == ["r2", "r3"]
    resumed = subprocess.run(base + ["--input", "/dev/null", "--resume"], cwd=repo, env=env,
                             capture_output=True, text=True, timeout=120)
    assert resumed.returncode == 0, resumed.stderr
    second = _serve_records(resumed.stdout)
    assert {r["id"] for r in second if r.get("done")} == {"r2", "r3"}
    assert _lines_by_id(second)["r2"] == _lines_by_id(first)["r1"]
    assert load_drained(journal) == []
