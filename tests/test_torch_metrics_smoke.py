"""``scripts/torch_metrics_smoke.py`` (the port's counterpart of
``scripts/metrics_smoke.py``) on the CPU at the JAX drill's shapes: the
run passes its gates, its report names the JAX report's counters for the
same fixture, and without a card it refuses to run."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "scripts" / "torch_metrics_smoke.py"
FIXTURE = REPO / "tests" / "fixtures" / "tiny.txt"


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """One ``--device cpu --small`` run: ``(exit code, stdout lines)``."""
    tmp = tmp_path_factory.mktemp("metrics_smoke")
    proc = subprocess.run([sys.executable, str(SCRIPT), "--device", "cpu", "--small"],
                          cwd=REPO, env={**os.environ, "TMPDIR": str(tmp)},
                          capture_output=True, text=True, timeout=300)
    return proc.returncode, proc.stdout.splitlines(), proc.stderr


def test_small_run_passes_every_gate(drill):
    rc, lines, err = drill
    assert rc == 0, "\n".join(lines) + err
    assert lines[-1].startswith("metrics-smoke: OK (")
    rec = json.loads(lines[-2])
    assert rec["drill"] == "metrics-smoke" and rec["device"] == "cpu" and rec["small"]
    assert rec["scenarios"] == {"tiny": "ok"}
    assert rec["runs"]["tiny"]["chunks"] >= 1 and rec["runs"]["tiny"]["phases"] >= 1


def test_report_counters_are_the_jax_reports(drill, tmp_path):
    """The port's run report on tiny counts what the JAX CLI's does, but
    for ``recompiles``: XLA compiles the JAX CLI's program in every cold
    process, the port on the CPU compiles nothing (its counter counts nvcc
    builds on the card); and beside them the port's own feed counters
    (``feed_h2d_copies``, ``feed_h2d_bytes``: its one-copy byte arena) and
    ``epilogue_torch_rows`` (the rows its plain versions finish on the
    CPU; on the card ``epilogue_kernel_rows`` counts the finish kernels'),
    and ``dispatch_launched_cells`` (the cells its kernels compute)."""
    report = tmp_path / "jax.json"
    with open(FIXTURE, "rb") as fh:
        proc = subprocess.run([sys.executable, "-m", "mpi_openmp_cuda_tpu", "--metrics",
                               "--metrics-out", str(report)], stdin=fh, cwd=REPO,
                              env={**os.environ, "JAX_PLATFORMS": "cpu"},
                              capture_output=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    jax_counters = set(json.loads(report.read_text())["counters"]) - {"recompiles"}
    rec = json.loads(drill[1][-2])
    port = set(rec["runs"]["tiny"]["counters"])
    feed = {"feed_h2d_copies", "feed_h2d_bytes", "epilogue_torch_rows", "dispatch_launched_cells"}
    assert feed <= port and port - feed == jax_counters


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
