"""``scripts/torch_trace_smoke.py`` (the port's counterpart of
``scripts/trace_smoke.py``) on the CPU at the JAX drill's shapes: the
serve run (live registry == run report, linked launches, finite gap rows)
and the watchdog-expiry flight-recorder run both pass, and without a card
the drill refuses to run."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "scripts" / "torch_trace_smoke.py"


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trace_smoke")
    proc = subprocess.run([sys.executable, str(SCRIPT), "--device", "cpu", "--small"],
                          cwd=REPO, env={**os.environ, "TMPDIR": str(tmp)},
                          capture_output=True, text=True, timeout=300)
    (out,) = tmp.glob("torch_trace_smoke_*")
    return proc.returncode, proc.stdout.splitlines() + proc.stderr.splitlines(), out


def record(lines) -> dict:
    return next(json.loads(x) for x in lines if x.startswith('{"device"'))


def test_small_run_is_ok(drill):
    rc, lines, _ = drill
    assert rc == 0, "\n".join(lines)
    assert [x for x in lines if x.startswith("trace-smoke: OK (")]


@pytest.mark.parametrize("scenario", ["serve", "flightrec"])
def test_scenario_passed(drill, scenario):
    assert record(drill[1])["scenarios"][scenario] == "ok", "\n".join(drill[1])


def test_artifacts_link_every_launch_to_its_requests(drill):
    """The two clients' rows coalesce: the trace's launches all carry
    request ids, and the dump names the watchdog expiry."""
    _, lines, out = drill
    trace = json.loads((out / "trace.json").read_text())
    launches = [e for e in trace["traceEvents"] if e.get("cat") == "launch"]
    assert launches and record(lines)["trace_launches"] == len(launches)
    assert {r for e in launches for r in e["args"]["request_ids"]} == {"c0", "c1"}
    (dump,) = (out / "cache" / "flightrec").glob("flightrec-*-watchdog-expiry.json")
    assert json.loads(dump.read_text())["reason"] == "watchdog-expiry"


def test_without_a_card_it_exits_non_zero(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device can score")
    proc = subprocess.run([sys.executable, str(SCRIPT), "--small"], cwd=REPO,
                          env={**os.environ, "TMPDIR": str(tmp_path)},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert "no CUDA device is available" in proc.stderr
    assert "OK" not in proc.stdout
