#!/usr/bin/env python3
"""End-to-end smoke gate of the port's fleet observability plane, the
counterpart of ``scripts/fleet_trace_smoke.py``.

    python3 scripts/torch_fleet_trace_smoke.py                     # on the card
    python3 scripts/torch_fleet_trace_smoke.py --device cpu --small

Boots a real fleet over a ``FileBoard``: one coordinator (``python -m
mpi_openmp_cuda_tpu_torch --serve --port 0 --telemetry-port 0
--fleet-board``) and two ``--fleet-worker`` processes.  A first wave of
loopback clients makes fleet superblocks flow; the coordinator's
``/metrics`` is scraped until it exposes both workers; then one worker is
SIGKILLed, a second wave is scored by the survivor alone, and the
coordinator is SIGTERMed.  The gates:

* **trace propagation**: every launch in the survivor's trace artifact
  carries at least one admission-minted trace id and its worker stamp;
* **board-phase attribution**: the coordinator's ``gap_attribution``
  has one row a fleet-scored superblock, each with the five finite board
  phases of ``obs/trace.py::BOARD_PHASES`` whose total equals their sum,
  trace ids and a per-worker clock offset; the totals equal the rows'
  sums;
* **metrics federation**: the live ``/metrics`` scrape exposes
  ``worker="wN"``-labelled families for both workers beside the local
  plane;
* **fleet flight recorder**: the murdered worker's last posted tape is
  collected into a valid ``fleet-tape-*`` dump;
* **merged timeline**: the coordinator's trace carries at least one
  per-worker track (``seqalign-worker`` process metadata);
* on the card, the survivor's report counts fused and packed launches.

On the card the kernels are built once here before the workers start,
and each worker's time from spawn to registration is printed.  Prints one
JSON record, then the OK line or every problem; exits 0 or 1.
"""

from __future__ import annotations

import glob
import json
import math
import os
import re
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_drill_common as common  # noqa: E402

PROG = "torch_fleet_trace_smoke"
TAG = "fleet-trace-smoke"
WORKER_LABEL_RE = re.compile(r'\{worker="(w\d+)"')


def client(port: int, raw: dict, errors: list) -> None:
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
        recs = [json.loads(x) for x in buf.decode().splitlines() if x]
        if not any(r.get("done") for r in recs):
            errors.append(f"client {raw['id']}: no done record in {recs}")
    except Exception as e:
        errors.append(f"client {raw['id']}: {e}")


def wave(port: int, reqs, errors: list) -> None:
    """One wave of concurrent loopback clients, joined before return."""
    threads = [threading.Thread(target=client, args=(port, raw, errors), daemon=True)
               for raw in reqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)


def scrape(telem_port: int) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{telem_port}/metrics",
                                timeout=30) as resp:
        return resp.read().decode("utf-8")


def poll(predicate, timeout_s: float, interval_s: float = 0.25):
    """Poll until ``predicate()`` is truthy; None on timeout."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        got = predicate()
        if got:
            return got
        time.sleep(interval_s)
    return None


def phase_gates(ga: dict, wids: set, problems: list) -> None:
    """The board-phase attribution contract on a ``gap_attribution``."""
    from mpi_openmp_cuda_tpu_torch.obs.trace import BOARD_PHASES

    rows = ga.get("board_phases", ())
    if not rows:
        problems.append("gap_attribution: no board_phases rows")
        return
    for row in rows:
        if not row.get("traces"):
            problems.append(f"board phase row without trace ids: {row}")
        if row.get("worker") not in wids:
            problems.append(f"board phase row names unknown worker: {row.get('worker')} "
                            f"not in {sorted(wids)}")
        phases = row.get("phases", {})
        if set(phases) != set(BOARD_PHASES):
            problems.append(f"board phase row: want phases {sorted(BOARD_PHASES)}, got "
                            f"{sorted(phases)}")
            continue
        for name, v in phases.items():
            if not isinstance(v, (int, float)) or not math.isfinite(v) or v < 0:
                problems.append(f"board phase {name}: not finite: {row}")
        want = sum(v for k, v in phases.items() if k != "total")
        if abs(phases["total"] - want) > 1e-6:
            problems.append(f"board phase total {phases['total']} != sum of phases "
                            f"{want}: {row}")
    totals = ga.get("board_phase_totals", {})
    for name in BOARD_PHASES:
        want = sum(r.get("phases", {}).get(name, 0.0) for r in rows)
        if abs(totals.get(name, 0.0) - want) > 1e-6:
            problems.append(f"board_phase_totals.{name}={totals.get(name)} != sum of "
                            f"rows {want}")
    if not ga.get("clock_offsets"):
        problems.append("gap_attribution: clock_offsets section empty")


def main(argv=None) -> int:
    args = common.parse_args(PROG, __doc__, argv)
    if not common.require_device(PROG, args.device):
        return 1
    out = tempfile.mkdtemp(prefix="torch_fleet_trace_smoke_")
    shapes = common.Shapes(args.small)
    board = os.path.join(out, "board")
    cache_dir = os.path.join(out, "cache")
    report_path = os.path.join(out, "coordinator.report.json")
    trace_path = os.path.join(out, "coordinator.trace.json")
    survivor_trace = os.path.join(out, "survivor.trace.json")
    survivor_report = os.path.join(out, "survivor.report.json")
    problems: list[str] = []
    record: dict = {"device": args.device, "small": args.small}

    survivor = common.Worker(args.device, out, board, "survivor",
                             argv_extra=("--trace-out", survivor_trace,
                                         "--metrics-out", survivor_report))
    victim = common.Worker(args.device, out, board, "victim")
    wids = {survivor.wid, victim.wid}

    # The murdered worker's death verdict (and its tape's collection) must
    # land within the run, and the dumps where this drill owns them.
    env = common.drill_env(out, {"SEQALIGN_LEASE_S": "2", "SEQALIGN_FLEET_WORKERS": "2"})
    proc = subprocess.Popen(
        common.cli_argv(args.device, "--serve", "--port", "0", "--telemetry-port", "0",
                        "--fleet-board", board, "--metrics-out", report_path,
                        "--trace-out", trace_path),
        stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        cwd=common.REPO, env=env, text=True)
    federated = ""
    rc = None
    tapes: list[str] = []
    stderr_lines: list[str] = []
    t0 = time.perf_counter()
    try:
        for w in (survivor, victim):
            if w.wait_registered():
                common.log(PROG, f"worker {w.tag} ({w.wid}) registered {w.registered_s:.3f} "
                                 "s after its spawn")
            else:
                problems.append(f"worker {w.tag} never registered on the board")
        record["registration_s"] = {w.tag: w.registered_s for w in (survivor, victim)}
        port = telem_port = None
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
            return common.finish(TAG, problems, "", record)
        drain = threading.Thread(target=lambda: stderr_lines.extend(proc.stderr),
                                 daemon=True)
        drain.start()

        # Wave 1: both workers up; fleet superblocks flow.
        wave(port, [shapes.req("c0", ["ACGT", "TTTT"]), shapes.req("c1", ["GATTACA"])],
             problems)

        # Federation: scrape until both workers' snapshot-fed families are
        # exposed with worker labels.
        def both_exposed():
            text = scrape(telem_port)
            return text if wids <= set(WORKER_LABEL_RE.findall(text)) else None

        federated = poll(both_exposed, 60.0) or ""
        if not federated:
            problems.append(f"/metrics never exposed worker-labelled families for both "
                            f"workers {sorted(wids)}")

        # Murder one worker; its last posted tape must be collected once the
        # membership declares it dead.
        victim.proc.send_signal(signal.SIGKILL)
        victim_rc = victim.proc.wait(timeout=60)
        if victim_rc != -signal.SIGKILL:
            problems.append(f"victim worker: want SIGKILL death, got rc {victim_rc}")
        tape_glob = os.path.join(cache_dir, "flightrec", f"fleet-tape-{victim.wid}-*.json")
        tapes = poll(lambda: glob.glob(tape_glob), 60.0) or []
        if not tapes:
            problems.append(f"dead worker's tape never collected under {tape_glob}")

        # Wave 2: only the survivor is left to score.
        wave(port, [shapes.req("c2", ["GGGG"])], problems)

        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        drain.join(10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        try:
            survivor_rc = survivor.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            survivor.proc.kill()
            survivor_rc = survivor.proc.wait()
            problems.append("survivor worker never saw the shutdown beacon")
        survivor.log.close()
        if victim.proc.poll() is None:
            victim.proc.kill()
        victim.reap()
    record["wall_s"] = time.perf_counter() - t0

    if rc != 75:
        problems.append(f"coordinator exit code: want 75 (drained), got {rc}")
    if survivor_rc != 0:
        problems.append(f"survivor worker: want exit 0, got {survivor_rc}")
    if "Traceback" in "".join(stderr_lines):
        problems.append("coordinator crashed (Traceback on stderr)")

    # -- federation ---------------------------------------------------------------
    if federated:
        for wid in sorted(wids):
            if f'seqalign_uptime_seconds{{worker="{wid}"}}' not in federated:
                problems.append(f"/metrics: federated uptime family missing for {wid}")
        if "seqalign_serve_requests_total " not in federated:
            problems.append("/metrics: local (unlabelled) plane missing from the "
                            "federated scrape")

    # -- tape -----------------------------------------------------------------------
    if tapes:
        tape = common.load_report(tapes[0], problems)
        if tape is not None:
            if tape.get("worker") != victim.wid:
                problems.append(f"tape worker: want {victim.wid}, got {tape.get('worker')}")
            if not tape.get("events"):
                problems.append(f"collected tape is empty: {tapes[0]}")

    # -- board phases and clock offsets (both artifacts agree) ------------------------
    report = common.load_report(report_path, problems)
    trace = common.load_report(trace_path, problems)
    for rec, tag in ((report, "report"), (trace, "trace")):
        if rec is None or "gap_attribution" not in rec:
            problems.append(f"{tag}: gap_attribution missing")
    if report is not None and trace is not None:
        if report.get("gap_attribution") != trace.get("gap_attribution"):
            problems.append("report gap_attribution != trace gap_attribution")
    if trace is not None and "gap_attribution" in trace:
        phase_gates(trace["gap_attribution"], wids, problems)
        record["board_phase_rows"] = len(trace["gap_attribution"].get("board_phases", ()))

    # -- merged per-worker tracks -------------------------------------------------------
    if trace is not None:
        tracks = {e["args"]["name"] for e in trace.get("traceEvents", ())
                  if e.get("ph") == "M" and e.get("name") == "process_name"
                  and str(e.get("args", {}).get("name", "")).startswith("seqalign-worker")}
        if not tracks:
            problems.append("merged trace: no seqalign-worker per-worker track metadata")
        record["worker_tracks"] = sorted(tracks)

    # -- trace propagation onto the worker's launches ----------------------------------
    wtrace = common.load_report(survivor_trace, problems)
    if wtrace is not None:
        launches = [e for e in wtrace.get("traceEvents", ()) if e.get("cat") == "launch"]
        if not launches:
            problems.append("survivor trace: no fleet launch events")
        for ev in launches:
            a = ev.get("args", {})
            if not a.get("traces"):
                problems.append(f"survivor launch without propagated trace ids: {ev}")
            if a.get("worker") != survivor.wid:
                problems.append(f"survivor launch without its worker stamp: {ev}")
        record["survivor_trace_launches"] = len(launches)
    survivor_rep = common.load_report(survivor_report, problems)
    launches = common.launches_of(survivor_rep)
    problems += common.launch_problems("survivor", args.device, launches)
    record.update(launches=launches,
                  scenarios={"fleet-trace": "fail" if problems else "ok"})
    return common.finish(TAG, problems, "stamped fleet launches, five-phase board "
                                        "attribution with matching totals, federated "
                                        f"/metrics for {len(wids)} workers, dead worker's "
                                        "tape collected, merged per-worker tracks; "
                                        f"launches={launches}; artifacts={out}", record)


if __name__ == "__main__":
    sys.exit(main())
