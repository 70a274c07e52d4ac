"""What the port's serve and fleet drills share.

The drills are ``scripts/torch_{metrics_smoke,serve_chaos,trace_smoke,
load_smoke,fleet_chaos,fleet_trace_smoke}.py``, the port's counterparts
of the JAX package's ``scripts/{metrics_smoke,serve_chaos,trace_smoke,
load_smoke,fleet_chaos,fleet_trace_smoke}.py``: the same scenarios, gates
and request ids, run against ``python -m mpi_openmp_cuda_tpu_torch``.
Each takes

* ``--device {cuda,cpu}`` (default ``cuda``), passed to every process it
  starts; without a card and without ``--device cpu`` it exits 1 with the
  CLI's own error, never quietly on the CPU;
* ``--small``: the JAX script's own request shapes (Seq1 of 16, Seq2 of
  4-7 chars).  Without it a scenario's Seq2 rows are the size the
  server's users send (:func:`Shapes.rows`): each of the JAX script's
  rows becomes one row of 1200-1999 chars and eight of 5-64 against a
  Seq1 of 3000, so the fused and the packed kernel both launch.

On the card every scoring scenario holds its run reports' launch
counters (:func:`launch_problems`): a drill that passed only on a
degraded backend does not count.  Each drill prints one JSON record
(:func:`finish`: its scenarios, the kernel launches by kernel, its
measurements) and then ``<drill>: OK (...)``, or one ``<drill>: FAIL:``
line a problem; it exits 0 or 1.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

PKG = "mpi_openmp_cuda_tpu_torch"
KERNELS = ("fused_scorer", "packed_scorer")

# The JAX drills' request shapes (--small).
SMALL_WEIGHTS = [1, -3, -5, -2]
SMALL_SEQ1 = "ACGTACGTACGTACGT"
# Full size: Seq1 at its 3000-char cap, each small row mapped to one row of
# LONG_LENS and SHORT_PER_ROW rows of SHORT_LENS (chip_smoke.py SERVE_LOAD's
# long rows; the packed kernel's classes).  A block's short rows launch the
# packed kernel only as a bucket of at least dispatch.MIN_BUCKET_ROWS (8)
# rows; fewer merge into the long rows' fused launch.
FULL_SEQ1_LEN = 3000
LONG_LENS = (1200, 1999)
SHORT_LENS = (5, 64)
SHORT_PER_ROW = 8
ALPHABET = "ACGT"
SEED = 7

PORT_RE = re.compile(r"serving on 127\.0\.0\.1:(\d+)")
TELEM_RE = re.compile(r"telemetry on 127\.0\.0\.1:(\d+)")


def parse_args(prog: str, doc: str, argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog=prog, description=doc.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device every started process scores on (default cuda; "
                         "cpu only when asked for)")
    ap.add_argument("--small", action="store_true",
                    help="the JAX drill's own request shapes instead of full-size rows")
    return ap.parse_args(argv)


def require_device(prog: str, device: str) -> bool:
    """True when ``device`` can score.  On ``cuda`` the kernels are built
    here, once, before any process starts, so no worker compiles inside a
    lease window; a missing card prints the CLI's own error."""
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import resolve_device

    try:
        resolve_device(device)
    except RuntimeError as e:
        print(f"{prog}: error: {e}", file=sys.stderr)
        return False
    if device == "cuda":
        from mpi_openmp_cuda_tpu_torch.ops import _build

        t0 = time.perf_counter()
        _build.build(list(KERNELS))
        log(prog, f"kernels {', '.join(KERNELS)} ready in {time.perf_counter() - t0:.3f} s "
                  f"({_build.BUILD_DIR})")
    return True


def log(prog: str, msg: str) -> None:
    print(f"{prog}: {msg}", flush=True)


def cli_argv(device: str, *args) -> list[str]:
    return [sys.executable, "-m", PKG, "--device", device, *map(str, args)]


def drill_env(out: str, extra: dict | None = None) -> dict:
    """A started process's environment: short retry backoff, and the
    cache home (flight-recorder dumps) inside the drill's own directory."""
    env = dict(os.environ)
    env.setdefault("SEQALIGN_BACKOFF_BASE", "0.01")
    env["SEQALIGN_CACHE_DIR"] = os.path.join(out, "cache")
    env.pop("TPU_SEQALIGN_COMPILE_CACHE", None)
    env.update(extra or {})
    return env


class Shapes:
    """A drill's request shapes: the JAX drill's under ``--small``, else
    full size, deterministic from :data:`SEED`."""

    def __init__(self, small: bool):
        self.small = small
        self.weights = list(SMALL_WEIGHTS)
        if small:
            self.seq1 = SMALL_SEQ1
        else:
            rng = random.Random(SEED)
            self.seq1 = "".join(rng.choice(ALPHABET) for _ in range(FULL_SEQ1_LEN))
        self._rows: dict[str, list[str]] = {}

    def rows(self, small_rows: list[str]) -> list[str]:
        """The Seq2 rows standing for the JAX drill's ``small_rows``; the
        same small row always maps to the same full rows."""
        if self.small:
            return list(small_rows)
        out = []
        for row in small_rows:
            if row not in self._rows:
                rng = random.Random(f"{SEED}:{row}")
                lens = [rng.randint(*LONG_LENS)] + [
                    rng.randint(*SHORT_LENS) for _ in range(SHORT_PER_ROW)]
                self._rows[row] = ["".join(rng.choice(ALPHABET) for _ in range(n))
                                   for n in lens]
            out += self._rows[row]
        return out

    def req(self, rid: str, small_rows: list[str], **extra) -> dict:
        return {"id": rid, "weights": self.weights, "seq1": self.seq1,
                "seq2": self.rows(small_rows), **extra}

    def batch_text(self, small_rows: list[str]) -> str:
        """The batch CLI's input for the same problem."""
        rows = self.rows(small_rows)
        return (" ".join(map(str, self.weights)) + "\n" + self.seq1 + "\n"
                + f"{len(rows)}\n" + "".join(r + "\n" for r in rows))


def read_report(path) -> dict | None:
    try:
        with open(path, encoding="utf-8") as fh:
            return json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None


def load_report(path, problems: list, tag: str | None = None) -> dict | None:
    """The report at ``path`` when it parses and validates, else None with
    the problem listed."""
    from mpi_openmp_cuda_tpu_torch.obs.metrics import validate_report

    try:
        with open(path, encoding="utf-8") as fh:
            rec = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        problems.append(f"no readable report at {path}: {e}")
        return None
    try:
        validate_report(rec)
    except ValueError as e:
        problems.append(f"{tag or os.path.basename(str(path))}: {e}")
        return None
    return rec


def launches_of(*reports) -> dict[str, int]:
    """Kernel launches by kernel, summed over run reports (None skipped)."""
    out = dict.fromkeys(KERNELS, 0)
    for rep in reports:
        counters = (rep or {}).get("counters") or {}
        for k in KERNELS:
            out[k] += int(counters.get(f"{k}_launches", 0))
    return out


def launch_problems(name: str, device: str, launches: dict, want=KERNELS) -> list[str]:
    """On the card, each kernel of ``want`` must have launched (the
    primary path scored, not a degraded backend); nothing on the CPU,
    where the plain versions run and no kernel launches."""
    if device != "cuda":
        return []
    return [f"{name}: no {k} launch in its run reports ({launches})"
            for k in want if launches.get(k, 0) < 1]


def add_launches(total: dict, launches: dict) -> None:
    for k in KERNELS:
        total[k] = total.get(k, 0) + launches.get(k, 0)


def run_scenarios(*waves) -> dict[str, list[str]]:
    """Run each wave of scenarios (``(name, fn)``, ``fn(problems)``) at
    once, each in a thread of its own with its own problem list, one wave
    after the other; a scenario that raises is a problem of its own, with
    the traceback.  Returns each name's problems, in the given order."""
    results = {name: [] for wave in waves for name, _ in wave}

    def guarded(name, fn):
        try:
            fn(results[name])
        except Exception:  # reported as the scenario's failure, never swallowed
            results[name].append(f"{name}: raised\n{traceback.format_exc()}")

    for wave in waves:
        threads = [threading.Thread(target=guarded, args=(name, fn), daemon=True)
                   for name, fn in wave]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    return results


def finish(tag: str, problems: list[str], ok_detail: str, record: dict) -> int:
    """Print the drill's JSON record, then its OK line or one FAIL line a
    problem; the exit code."""
    print(json.dumps({"drill": tag, **record}, sort_keys=True), flush=True)
    if problems:
        for p in problems:
            print(f"{tag}: FAIL: {p}")
        return 1
    print(f"{tag}: OK ({ok_detail})")
    return 0


# -- the fleet drills ----------------------------------------------------------

class Worker:
    """One ``--fleet-worker`` process, its output in a log file; its
    board id is ``w<pid>``."""

    def __init__(self, device, out, board, tag, *, faults=None, env_extra=None,
                 argv_extra=()):
        argv = cli_argv(device, "--fleet-worker", "--fleet-board", board, *argv_extra)
        if faults:
            argv += ["--faults", faults]
        self.tag = tag
        self.board = board
        self.log_path = os.path.join(out, f"{tag}.worker.log")
        self.log = open(self.log_path, "w")
        self.spawned = time.perf_counter()
        self.proc = subprocess.Popen(argv, cwd=REPO, env=drill_env(out, env_extra),
                                     stdout=self.log, stderr=subprocess.STDOUT)
        self.wid = f"w{self.proc.pid}"
        self.registered_s: float | None = None

    def wait_registered(self, timeout_s: float = 90.0) -> bool:
        """Block until this worker's registration is on the board; keeps
        the time from spawn to registration."""
        path = os.path.join(self.board, "seqalign", "fleet", "worker", self.wid)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if os.path.exists(path):
                self.registered_s = time.perf_counter() - self.spawned
                return True
            if self.proc.poll() is not None:
                break
            time.sleep(0.02)
        return False

    def reap(self, timeout_s: float = 60.0) -> int:
        """Wait the worker out (the coordinator's shutdown beacon releases
        it); SIGKILL as the last resort, so a drill never hangs."""
        try:
            rc = self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait()
        self.log.close()
        return rc


def parse_records(text: str, *, tolerant: bool = False) -> list[dict]:
    """ndjson -> records; ``tolerant`` skips a torn line (a SIGKILLed
    coordinator's last)."""
    records = []
    for line in text.splitlines():
        if not line.strip():
            continue
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError:
            if not tolerant:
                raise
    return records


def by_id(records) -> dict:
    """Per-request transcripts, each record serialised with sorted keys:
    the unit of the exactly-once, byte-identical comparison."""
    out: dict = {}
    for r in records:
        out.setdefault(r.get("id"), []).append(json.dumps(r, sort_keys=True))
    return out


def stale_key_problems(name: str, board: str) -> list[str]:
    """After a completed run the leader's final sweep leaves only the
    worker registry, the shutdown beacon and the generation record: no
    offer, claim, result, checkpoint or observability key and no torn
    ``.tmp.`` file."""
    root = os.path.join(board, "seqalign", "fleet")
    keep = ("worker", "hb", "leader", "leaderhb", "shutdown")
    left = []
    for dirpath, _dirs, files in os.walk(root):
        for fname in files:
            rel = os.path.relpath(os.path.join(dirpath, fname), root)
            if fname.startswith(".tmp."):
                left.append(f"{rel} (torn tmp)")
            elif rel.split(os.sep)[0] not in keep:
                left.append(rel)
    if left:
        return [f"{name}: stale board keys survived the completed run: {sorted(left)}"]
    return []
