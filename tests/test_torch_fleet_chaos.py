"""``scripts/torch_fleet_chaos.py`` (the port's counterpart of
``scripts/fleet_chaos.py``) on the CPU at the JAX drill's shapes: every
scenario (kill -9, zombie fence, torn post, lease stall, coordinator
kill, burst overload, usage) passes with its records byte-identical to
the fleetless baseline, the baseline is the JAX CLI's, and without a card
the drill refuses to run."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "scripts" / "torch_fleet_chaos.py"
SCENARIOS = ("baseline", "kill-worker", "zombie-fence", "torn-post", "lease-stall",
             "coordinator-kill", "burst-overload", "usage")


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet_chaos")
    proc = subprocess.run([sys.executable, str(SCRIPT), "--device", "cpu", "--small"],
                          cwd=REPO, env={**os.environ, "TMPDIR": str(tmp)},
                          capture_output=True, text=True, timeout=400)
    (out,) = tmp.glob("torch_fleet_chaos_*")
    return proc.returncode, proc.stdout.splitlines() + proc.stderr.splitlines(), out


def record(lines) -> dict:
    return next(json.loads(x) for x in lines if x.startswith('{"device"'))


def test_small_run_is_ok(drill):
    rc, lines, _ = drill
    assert rc == 0, "\n".join(lines)
    assert [x for x in lines if x.startswith("fleet-chaos: OK (")]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scenario_passed(drill, scenario):
    assert record(drill[1])["scenarios"][scenario] == "ok", "\n".join(drill[1])


def test_every_worker_registered_and_was_timed(drill):
    """Each worker's time from spawn to registration is kept: the six
    first workers and the two survivors."""
    got = record(drill[1])["registration_s"]
    assert len(got) == 8 and all(isinstance(v, float) and v > 0 for v in got.values())


def test_fleetless_baseline_is_the_jax_clis(drill):
    """The JAX CLI's ``--serve`` on the drill's request file writes the
    port's baseline records, id for id."""
    _, _, out = drill
    proc = subprocess.run([sys.executable, "-m", "mpi_openmp_cuda_tpu", "--serve", "--input",
                           str(out / "baseline.ndjson")], cwd=REPO,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"}, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr

    def by_id(text):
        out: dict = {}
        for line in text.splitlines():
            rec = json.loads(line)
            out.setdefault(rec["id"], []).append(json.dumps(rec, sort_keys=True))
        return out

    assert by_id((out / "baseline.out.ndjson").read_text()) == by_id(proc.stdout)


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
