"""The serve driver: the port's server as a child process, offered the
cell's requests open-loop over loopback sockets.

Set-up starts ``python -m seqbench.serve_child -- --serve --port 0``
with the configuration's CLI arguments (its documented defaults unless
they say otherwise), makes the requests from the seed while it starts,
waits for the port it announces, and sends ``warm_requests`` of the
cell's shapes at once, waiting for every answer.  The window is the
schedule: ``rate_rps * --seconds`` requests due over ``--seconds``
(``seqbench/generate.py::arrivals``), each timed from its due time to its
``done`` record.  The server's counters are read by the ``metrics``
telemetry verb at the window's start and end.  Once every request has
its answer (or ``grace_s`` has passed), the child is drained (SIGTERM)
and reports its peak memory and, with ``--trace 1``, its device trace.
A sample of the done requests drawn from the seed, the longest among
them, is then scored by the plain reference on the host.

This process never touches the card: one process uses it, the server.
"""

from __future__ import annotations

import collections
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

from seqbench import generate, judge
from seqbench.harness import ROOT, Run
from seqbench.loadgen import OpenLoop, command
from seqbench.serve_child import MARK

HOST = "127.0.0.1"
PORT_LINE = re.compile(r"serving on 127\.0\.0\.1:(\d+)")


class Child:
    """The server process and a reader of its stderr."""

    def __init__(self, ctx):
        cmd = [sys.executable, "-m", "seqbench.serve_child", *(["--trace"] if ctx.trace else []),
               "--", "--serve", "--port", "0", "--device", ctx.device,
               *ctx.config.get("cli_args", [])]
        # The checkout that holds this harness holds the port beside it.
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
        env.update(ctx.config.get("env", {}))
        self.proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdin=subprocess.PIPE,
                                     stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        self.tail: collections.deque = collections.deque(maxlen=40)
        self.port: int | None = None
        self.report: dict | None = None
        self._ready = threading.Event()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self.proc.stderr:
            line = line.rstrip("\n")
            if line.startswith(MARK):
                self.report = json.loads(line[len(MARK):])
                continue
            self.tail.append(line)
            m = PORT_LINE.search(line)
            if m and self.port is None:
                self.port = int(m.group(1))
                self._ready.set()
        self._ready.set()

    def wait_port(self, timeout_s: float) -> int:
        self._ready.wait(timeout_s)
        if self.port is None:
            raise RuntimeError("the server did not start: " + " | ".join(self.tail))
        return self.port

    def tell(self, line: str) -> None:
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()

    def stop(self, timeout_s: float = 60.0) -> None:
        """Drain the server and wait for it; kill it if it will not end."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            self.proc.wait(timeout_s)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self._reader.join(10.0)
        self.proc.stdin.close()


def entries(reqs, offsets):
    return [(off, r.id, r.payload) for off, r in zip(offsets, reqs)]


def warm(port: int, reqs, clients: int) -> None:
    """Send ``reqs`` at once and require every one done."""
    outs = OpenLoop(HOST, port, entries(reqs, [0.0] * len(reqs)), clients=clients).run(
        time.monotonic(), grace_s=120.0)
    bad = [o for o in outs if o.kind != "done"]
    if bad:
        raise RuntimeError(f"{len(bad)} warm-up requests not done, e.g. {bad[0]}")


def at(t: float, fn) -> threading.Thread:
    """Run ``fn`` in a thread at monotonic time ``t``."""

    def go():
        time.sleep(max(0.0, t - time.monotonic()))
        fn()

    th = threading.Thread(target=go, daemon=True)
    th.start()
    return th


def bad_answer(o, raw) -> bool:
    """Missing, reset, untyped or failed, or done with the wrong lines."""
    if o.kind == "done":
        return o.done_n != len(raw["seq2"]) or not judge.well_formed(o.lines, len(raw["seq2"]))
    return o.kind != "refused"


def run(ctx) -> Run:
    traffic, seed = ctx.traffic, ctx.seed
    child = Child(ctx)
    snaps: dict = {}
    try:
        warm_reqs = generate.requests(seed, ctx.config, traffic, int(traffic["warm_requests"]), "w",
                                      stream=4)
        offsets = generate.arrivals(seed, traffic, ctx.seconds)
        reqs = generate.requests(seed, ctx.config, traffic, len(offsets), "r")
        port = child.wait_port(300.0)
        warm(port, warm_reqs, int(traffic["clients"]))
        loop = OpenLoop(HOST, port, entries(reqs, offsets), clients=int(traffic["clients"]))
        t0 = time.monotonic() + 0.2

        def mark(name: str, verb: str):
            def fn():
                if ctx.trace:
                    child.tell(verb)
                snaps[name] = command(HOST, port, "metrics")["metrics"]
            return fn

        marks = [at(t0, mark("start", "start")), at(t0 + ctx.seconds, mark("end", "stop"))]
        setup_s = t0 - ctx.started
        outcomes = loop.run(t0, float(traffic["grace_s"]))
        for th in marks:
            th.join(30.0)
    finally:
        child.stop()
    report = child.report
    if report is None:
        raise RuntimeError("the server left no report: " + " | ".join(child.tail))
    raw = {r.id: r.raw for r in reqs}
    cells = {r.id: r.cells for r in reqs}
    bad = sum(bad_answer(o, raw[o.id]) for o in outcomes)
    done = [o.id for o in outcomes if o.kind == "done" and not bad_answer(o, raw[o.id])]
    longest = max(done, key=lambda rid: cells[rid], default=None)
    checked = judge.sample(seed, done, int(traffic["check_requests"]),
                           always=() if longest is None else (longest,))
    lines = {o.id: o.lines for o in outcomes}
    checks, wrong = judge.judge_serve({rid: raw[rid] for rid in checked},
                                      {rid: lines[rid] for rid in checked}, bad)
    late = sorted(o.sent_s - o.due_s for o in outcomes if o.sent_s is not None)
    notes = []
    if late:
        p95 = late[min(len(late) - 1, int(0.95 * len(late)))]
        notes.append(f"seqbench: generator lateness over {len(late)} sends: p95 {p95 * 1e3:.3f} ms,"
                     f" max {late[-1] * 1e3:.3f} ms")
    launches = report.get("launches", {})
    notes.append("seqbench: server kernel launches (warm-up and window) "
                 + " ".join(f"{k} {v}" for k, v in sorted(launches.items())))
    device = {"platform": "gpu" if ctx.device == "cuda" else "cpu", "kind": report["kind"],
              "count": 1, "memory_peak_bytes": report["memory_peak_bytes"]}
    return Run("serve", setup_s, ctx.seconds, attempted=len(outcomes), failed=bad + len(wrong),
               checks=checks, device=device, outcomes=outcomes, telemetry=snaps,
               trace=report.get("trace"), held=report["held"], notes=notes)
