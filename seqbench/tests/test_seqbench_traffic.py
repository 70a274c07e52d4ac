"""The frozen traffic: the same seed gives byte-identical jobs, requests and
arrivals, every seed the same work; the open-loop client times from the
due time, so a stalled server shows in every request it delays."""

from __future__ import annotations

import json
import socket
import threading
import time

import pytest

from seqbench import generate, harness, reference
from seqbench.loadgen import OpenLoop


def cell(name):
    ctx = harness.context(name, 0, 1.0, False)
    return ctx.config, ctx.traffic


@pytest.mark.parametrize("name", ["batch-long", "batch-short"])
def test_jobs_repeat_byte_for_byte(name):
    config, traffic = cell(name)
    traffic = {**traffic, "pool_jobs": 3}
    a = generate.jobs(2**31 + 11, config, traffic)
    b = generate.jobs(2**31 + 11, config, traffic)
    assert [j.text for j in a] == [j.text for j in b]
    assert [j.text for j in a] != [j.text for j in generate.jobs(12, config, traffic)]


@pytest.mark.parametrize("name", ["batch-long", "batch-short"])
def test_jobs_follow_the_traffic_file(name):
    config, traffic = cell(name)
    job = generate.jobs(5, config, {**traffic, "pool_jobs": 1})[0]
    tokens = job.text.split()
    lo, hi = traffic["seq2_len"]
    assert len(tokens[4]) == traffic["seq1_len"]
    assert int(tokens[5]) == traffic["seq2_per_job"] == len(tokens[6:])
    assert all(lo <= len(s) <= hi for s in tokens[6:])
    assert [int(w) for w in tokens[:4]] == config["weights"][0]


def test_every_seed_does_the_same_work():
    config, traffic = cell("batch-long")
    traffic = {**traffic, "pool_jobs": 8}
    cells = [sum(j.cells for j in generate.jobs(seed, config, traffic)) for seed in (1, 2, 3)]
    assert max(cells) / min(cells) < 1.002


def test_requests_and_arrivals_repeat_byte_for_byte():
    config, traffic = cell("serve-steady")
    traffic = {**traffic, "rate_rps": 40}
    for seed in (7, 2**31 + 5):
        a, b = (generate.requests(seed, config, traffic, 30, "r") for _ in range(2))
        assert [r.payload for r in a] == [r.payload for r in b]
        assert generate.arrivals(seed, traffic, 2.0) == generate.arrivals(seed, traffic, 2.0)
    offsets = generate.arrivals(7, traffic, 2.0)
    assert len(offsets) == 80 and offsets == sorted(offsets)
    assert 0 <= offsets[0] and offsets[-1] < 2.0


def test_requests_are_the_fixture_problems():
    config, traffic = cell("serve-steady")
    reqs = generate.requests(3, config, traffic, 60, "r")
    problems = traffic["problems"]
    seen = {p["name"]: 0 for p in problems}
    seq1_of = {}
    for r in reqs:
        p = next(p for p in problems if len(r.raw["seq1"]) == p["seq1_len"])
        seen[p["name"]] += 1
        assert r.raw["weights"] == p["weights"]
        assert len(r.raw["seq2"]) == p["seq2_count"]
        lo, hi = p["seq2_len"]
        assert all(lo <= len(s) <= hi for s in r.raw["seq2"])
        assert seq1_of.setdefault(p["name"], r.raw["seq1"]) == r.raw["seq1"]
    assert set(seen.values()) == {60 // len(problems)}


def test_homologs_follow_the_fixtures():
    config, traffic = cell("serve-steady")
    reqs = generate.requests(4, config, traffic, 12, "r")
    by_len = {len(r.raw["seq1"]): r for r in reqs}
    # input2: its one Seq2 is its Seq1 less one character, unchanged.
    r2 = by_len[344]
    s1, s2 = r2.raw["seq1"], r2.raw["seq2"][0]
    assert any(s1[:i] + s1[i + 1 :] == s2 for i in range(len(s1)))
    # input3: a quarter of its 32 Seq2s align far above the rest.
    r3 = by_len[1489]
    scores = sorted(row[0] for row in reference.rows(r3.raw["weights"], r3.raw["seq1"],
                                                    r3.raw["seq2"]))
    assert min(scores[-8:]) > 0 > max(scores[:-8])


class StallingServer:
    """Answers each request line at once with one row and ``done``, except
    that it stops reading for ``stall_s`` once ``stall_at_s`` has passed."""

    def __init__(self, stall_at_s: float, stall_s: float):
        self.sock = socket.create_server(("127.0.0.1", 0))
        self.port = self.sock.getsockname()[1]
        self.t0 = time.monotonic()
        self.stall_at_s, self.stall_s = stall_at_s, stall_s
        self.stalled = False
        threading.Thread(target=self.accept, daemon=True).start()

    def accept(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self.serve, args=(conn,), daemon=True).start()

    def serve(self, conn):
        buf = b""
        with conn:
            while True:
                try:
                    chunk = conn.recv(1 << 16)
                except OSError:
                    return
                if not chunk:
                    return
                buf += chunk
                *lines, buf = buf.split(b"\n")
                for line in lines:
                    if not self.stalled and time.monotonic() - self.t0 > self.stall_at_s:
                        self.stalled = True
                        time.sleep(self.stall_s)
                    rid = json.loads(line)["id"]
                    conn.sendall((json.dumps({"id": rid, "line": "#0: score: 1, n: 0, k: 0"})
                                  + "\n" + json.dumps({"id": rid, "done": True, "n": 1}) + "\n")
                                 .encode())

    def close(self):
        self.sock.close()


def test_a_server_stall_shows_in_due_time_latency():
    server = StallingServer(stall_at_s=0.5, stall_s=0.6)
    try:
        entries = [(i * 0.02, f"q{i}", (json.dumps({"id": f"q{i}"}) + "\n").encode())
                   for i in range(60)]
        loop = OpenLoop("127.0.0.1", server.port, entries, clients=1)
        t0 = time.monotonic() + 0.05
        server.t0 = t0
        outs = loop.run(t0, grace_s=5.0)
    finally:
        server.close()
    assert all(o.kind == "done" and o.lines == ["#0: score: 1, n: 0, k: 0"] for o in outs)
    # Sent on time (the socket buffer takes them), answered after the stall.
    assert max(o.sent_s - o.due_s for o in outs) < 0.2
    stalled = [o for o in outs if 0.55 <= o.due_s <= 0.9]
    assert stalled and min(o.latency_s for o in stalled) > 0.15
    assert max(o.latency_s for o in outs) > 0.5
    assert min(o.latency_s for o in outs if o.due_s > 1.15) < 0.05
