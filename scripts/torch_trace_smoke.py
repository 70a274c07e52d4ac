#!/usr/bin/env python3
"""End-to-end smoke gate of the port's tracing tier, the counterpart of
``scripts/trace_smoke.py``.

    python3 scripts/torch_trace_smoke.py                     # on the card
    python3 scripts/torch_trace_smoke.py --device cpu --small

Boots ``python -m mpi_openmp_cuda_tpu_torch --serve --port 0
--telemetry-port 0 --trace-out`` as a real process, fires two concurrent
loopback clients of one problem key (so their rows coalesce into shared
launches) and, while the server is still up, scrapes the live plane both
ways: HTTP ``/metrics`` and the in-band ``{"cmd": ...}`` socket verbs.
Then SIGTERMs the server and gates what the tier promises:

* the live scrape and the exit-time run report agree on the request and
  dispatch counters (one registry, two views);
* the trace artifact is a valid ``kind="trace"`` envelope, every launch
  event carries at least one linked request id, every gap row is finite
  and the totals equal the sums of the rows;
* the run report carries the same ``gap_attribution`` section;
* a batch run with an injected dispatch hang under ``--deadline 0.05
  --retries 2`` exits 0 and leaves a valid ``watchdog-expiry``
  flight-recorder dump with a ``watchdog.expiry`` event under
  ``$SEQALIGN_CACHE_DIR/flightrec``;
* on the card, both runs' reports count kernel launches (the serve run
  both kernels).

The batch run scores the tiny fixture under ``--small``, else the two
clients' full-size rows.  Prints one JSON record, then the OK line or
every problem; exits 0 or 1.
"""

from __future__ import annotations

import glob
import json
import math
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_drill_common as common  # noqa: E402

PROG = "torch_trace_smoke"
TAG = "trace-smoke"
N_CLIENTS = 2
CLIENT_ROWS = (["ACGT", "TTTT"], ["GGGG", "GATTACA"])


def client(port: int, raw: dict, results: dict, errors: list) -> None:
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=60) as conn:
            conn.sendall((json.dumps(raw) + "\n").encode())
            conn.settimeout(120)
            buf = b""
            while b'"done"' not in buf:
                chunk = conn.recv(65536)
                if not chunk:
                    break
                buf += chunk
        results[raw["id"]] = [json.loads(x) for x in buf.decode().splitlines() if x]
    except Exception as e:
        errors.append(f"client {raw['id']}: {e}")


def verb(conn: socket.socket, cmd: str) -> dict:
    """One in-band telemetry verb -> one JSON record off the socket."""
    conn.sendall((json.dumps({"cmd": cmd}) + "\n").encode())
    buf = b""
    while b"\n" not in buf:
        chunk = conn.recv(65536)
        if not chunk:
            break
        buf += chunk
    return json.loads(buf.decode().splitlines()[0])


def serve_run(device: str, shapes, out: str, problems: list, record: dict) -> None:
    report_path = os.path.join(out, "run.json")
    trace_path = os.path.join(out, "trace.json")
    # A wide gather window, so both "concurrent" clients land in one pop
    # even on a loaded box: the shared launch gated on below.
    env = common.drill_env(out)
    env.setdefault("SEQALIGN_SERVE_WINDOW_S", "0.5")
    proc = subprocess.Popen(
        common.cli_argv(device, "--serve", "--port", "0", "--telemetry-port", "0",
                        "--metrics-out", report_path, "--trace-out", trace_path),
        stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        cwd=common.REPO, env=env, text=True)
    reqs = [shapes.req(f"c{i}", rows) for i, rows in enumerate(CLIENT_ROWS)]
    live: dict = {}
    results: dict = {}
    rc = None
    stderr_lines: list[str] = []
    try:
        port = telem_port = None
        # The telemetry announcement comes first, the serve socket's second.
        for line in proc.stderr:
            stderr_lines.append(line)
            m = common.TELEM_RE.search(line)
            if m:
                telem_port = int(m.group(1))
            m = common.PORT_RE.search(line)
            if m:
                port = int(m.group(1))
                break
        if port is None or telem_port is None:
            problems.append(f"server announcements missing (serve={port}, "
                            f"telemetry={telem_port})\n{''.join(stderr_lines)[-3000:]}")
            return
        drain = threading.Thread(target=lambda: stderr_lines.extend(proc.stderr),
                                 daemon=True)
        drain.start()
        errors: list[str] = []
        threads = [threading.Thread(target=client, args=(port, raw, results, errors),
                                    daemon=True) for raw in reqs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        problems.extend(errors)

        # Mid-run, server still up: scrape the live plane both ways.
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{telem_port}/metrics",
                                        timeout=30) as resp:
                live["prom"] = resp.read().decode("utf-8")
        except Exception as e:
            problems.append(f"live /metrics scrape: {e}")
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=30) as conn:
                conn.settimeout(60)
                live["metrics"] = verb(conn, "metrics")
                live["healthz"] = verb(conn, "healthz")
                live["trace"] = verb(conn, "trace")
        except Exception as e:
            problems.append(f"socket telemetry verbs: {e}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        drain.join(10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)

    if rc != 75:
        problems.append(f"exit code: want 75 (drained), got {rc}")
    if "Traceback" in "".join(stderr_lines):
        problems.append("server crashed (Traceback on stderr)")
    for raw in reqs:
        recs = results.get(raw["id"], [])
        if not any(r.get("done") for r in recs):
            problems.append(f"{raw['id']}: no done record")
        if sum(1 for r in recs if "line" in r) != len(raw["seq2"]):
            problems.append(f"{raw['id']}: want {len(raw['seq2'])} result lines, got {recs}")

    # -- live plane gates ---------------------------------------------------------
    from mpi_openmp_cuda_tpu_torch.obs.metrics import validate_report

    live_counters = {}
    if "metrics" in live:
        live_counters = live["metrics"].get("metrics", {}).get("counters", {})
        if live_counters.get("serve_requests") != N_CLIENTS:
            problems.append(f"live verb counters.serve_requests: want {N_CLIENTS}, got "
                            f"{live_counters.get('serve_requests')}")
    if "healthz" in live and live["healthz"].get("status", {}).get("ok") is not True:
        problems.append(f"live healthz: want ok=true, got {live['healthz']}")
    if "trace" in live:
        try:
            validate_report(live["trace"]["trace"])
        except (KeyError, ValueError) as e:
            problems.append(f"live trace verb: {e}")
    if "prom" in live:
        if "# HELP seqalign_serve_requests_total" not in live["prom"]:
            problems.append("live /metrics: HELP line for serve_requests missing")
        if f"seqalign_serve_requests_total {N_CLIENTS}" not in live["prom"]:
            problems.append(f"live /metrics: seqalign_serve_requests_total {N_CLIENTS} "
                            "not found")

    # -- exit artifacts -------------------------------------------------------------
    report = common.load_report(report_path, problems)
    if report is not None:
        counters = report["counters"]
        for key in ("serve_requests", "chunks_dispatched"):
            if live_counters and counters.get(key) != live_counters.get(key):
                problems.append(f"live vs final counters.{key}: scrape said "
                                f"{live_counters.get(key)}, report says {counters.get(key)}")
        if "gap_attribution" not in report:
            problems.append("run report: gap_attribution section missing")
        launches = common.launches_of(report)
        record["launches_by_run"]["serve"] = launches
        problems += common.launch_problems("serve run", device, launches)

    trace = common.load_report(trace_path, problems)
    if trace is None:
        return
    if trace.get("kind") != "trace":
        problems.append(f"trace kind: want 'trace', got {trace.get('kind')}")
    launches = [e for e in trace.get("traceEvents", ()) if e.get("cat") == "launch"]
    if not launches:
        problems.append("trace: no launch events recorded")
    for ev in launches:
        if not ev.get("args", {}).get("request_ids"):
            problems.append(f"trace: launch without linked requests: {ev}")
    ga = trace.get("gap_attribution", {})
    rows = ga.get("launches", ())
    record["trace_launches"] = len(launches)
    if len(rows) != len(launches):
        problems.append(f"gap rows: want one per launch ({len(launches)}), got {len(rows)}")
    for row in rows:
        for field in ("measured_s", "modelled_s", "gap_s"):
            v = row.get(field)
            if not isinstance(v, (int, float)) or not math.isfinite(v):
                problems.append(f"gap row {field}: not finite: {row}")
    for total, field in (("total_measured_s", "measured_s"),
                         ("total_modelled_s", "modelled_s"), ("total_gap_s", "gap_s")):
        want = sum(row.get(field, 0.0) for row in rows)
        if abs(ga.get(total, 0.0) - want) > 1e-6:
            problems.append(f"gap totals: {total}={ga.get(total)} != sum of rows {want}")
    if report is not None and report.get("gap_attribution") != ga:
        problems.append("run report gap_attribution != trace gap_attribution")


def flightrec_run(device: str, shapes, out: str, problems: list, record: dict) -> None:
    """An injected dispatch hang under a deadline: the run still succeeds
    (retried), and the flight recorder leaves a watchdog-expiry dump."""
    cache_dir = os.path.join(out, "cache")
    env = common.drill_env(out, {"SEQALIGN_BACKOFF_BASE": "0"})
    if shapes.small:
        input_path = str(common.REPO / "tests" / "fixtures" / "tiny.txt")
    else:
        input_path = os.path.join(out, "flightrec.txt")
        with open(input_path, "w") as fh:
            fh.write(shapes.batch_text([r for rows in CLIENT_ROWS for r in rows]))
    report_path = os.path.join(out, "flightrec.report.json")
    proc = subprocess.run(
        common.cli_argv(device, "--input", input_path, "--retries", "2",
                        "--deadline", "0.05", "--faults", "hang:dispatch:fail=1",
                        "--metrics", "--metrics-out", report_path),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, cwd=common.REPO, env=env,
        text=True, timeout=600)
    if proc.returncode != 0:
        problems.append(f"flightrec run: want rc 0 (hang retried), got {proc.returncode}:\n"
                        f"{proc.stderr[-2000:]}")
        return
    report = common.load_report(report_path, problems)
    if report is not None:
        launches = common.launches_of(report)
        record["launches_by_run"]["flightrec"] = launches
        problems += common.launch_problems("flightrec run", device, launches,
                                           want=() if shapes.small else common.KERNELS)
        if device == "cuda" and not sum(launches.values()):
            problems.append(f"flightrec run: no scorer kernel launched ({launches})")
    dumps = sorted(glob.glob(os.path.join(cache_dir, "flightrec",
                                          "flightrec-*-watchdog-expiry.json")))
    if not dumps:
        problems.append(f"no watchdog-expiry dump under {cache_dir}/flightrec")
        return
    dump = common.load_report(dumps[0], problems)
    if dump is None:
        return
    if dump.get("reason") != "watchdog-expiry":
        problems.append(f"dump reason: want 'watchdog-expiry', got {dump.get('reason')}")
    if not any(e.get("name") == "watchdog.expiry" for e in dump.get("events", ())):
        problems.append("dump tape: watchdog.expiry event missing")


def main(argv=None) -> int:
    args = common.parse_args(PROG, __doc__, argv)
    if not common.require_device(PROG, args.device):
        return 1
    out = tempfile.mkdtemp(prefix="torch_trace_smoke_")
    shapes = common.Shapes(args.small)
    record = {"device": args.device, "small": args.small, "launches_by_run": {}}
    results = common.run_scenarios([
        ("serve", lambda p: serve_run(args.device, shapes, out, p, record)),
        ("flightrec", lambda p: flightrec_run(args.device, shapes, out, p, record)),
    ])
    problems = [p for ps in results.values() for p in ps]
    total = dict.fromkeys(common.KERNELS, 0)
    for launches in record["launches_by_run"].values():
        common.add_launches(total, launches)
    record.update(scenarios={n: "fail" if ps else "ok" for n, ps in results.items()},
                  launches=total)
    return common.finish(TAG, problems, f"requests={N_CLIENTS}, live scrape == report, "
                                        "linked launches + finite gap rows, flightrec dump; "
                                        f"launches={total}; artifacts={out}", record)


if __name__ == "__main__":
    sys.exit(main())
