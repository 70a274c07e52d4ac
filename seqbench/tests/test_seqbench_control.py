"""``correct`` comes out false where it must: each cell's control (the
reference in the program's place, breaking a stated guarantee), and a run
whose timed path is broken underneath, skipping only the look for a card:
an answer altered where it is produced, and half of a batch left out."""

from __future__ import annotations

import numpy as np
import pytest

from seqbench import control, harness


def small(ctx):
    """The cell's own shapes, fewer answers checked."""
    if ctx.config["kind"] == "batch":
        ctx.traffic = {**ctx.traffic, "pool_jobs": 4, "check_jobs": 2}
    else:
        ctx.traffic = {**ctx.traffic, "check_requests": 4}
        ctx.seconds = 40 / ctx.traffic["rate_rps"]
    return ctx


@pytest.mark.parametrize("cell", ["batch-long", "serve-steady", "batch-short"])
def test_a_control_fails_every_cell(cell):
    ctx = small(harness.context(cell, 2**31 + 3, 1.0, False))
    readings = {name: control.readings(ctx, variant) for name, variant in control.CONTROLS.items()}
    assert any(v > 0 for r in readings.values() for v in r.values()), readings


def test_int16_fails_the_long_rows_at_weight_100():
    ctx = small(harness.context("batch-long", 11, 1.0, False))
    assert control.readings(ctx, {"acc": np.int16})["wrong_lines"] > 0


@pytest.fixture
def broken_batch(monkeypatch):
    from mpi_openmp_cuda_tpu_torch.ops import dispatch

    real = dispatch.AlignmentScorer.score_codes

    def plant(fault):
        def score_codes(self, *a, **k):
            rows = np.array(real(self, *a, **k))
            if fault == "altered":
                rows[0, 0] += 1
            elif fault == "half":
                rows = rows[: len(rows) // 2]
            return rows

        monkeypatch.setattr(dispatch.AlignmentScorer, "score_codes", score_codes)

    return plant


@pytest.mark.parametrize("fault,number", [("altered", "wrong_lines"), ("half", "malformed_jobs")])
def test_a_broken_batch_path_is_not_correct(tiny_root, broken_batch, fault, number):
    broken_batch(fault)
    ctx = harness.context("tiny-batch", 6, 0.3, False, root=tiny_root, device="cpu")
    result, _ = harness.measure(ctx)
    assert not result["correct"]
    assert result["checks"][number]["value"] > 0 and result["failed"] > 0


SITECUSTOMIZE = '''
import os
fault = os.environ.get("SEQBENCH_TEST_FAULT")
if fault:
    from mpi_openmp_cuda_tpu_torch.serve import session

    real = session.Session.fill

    def fill(self, j, row):
        if fault == "altered":
            row = (int(row[0]) + 1, int(row[1]), int(row[2]))
        elif fault == "half" and j % 2:
            return
        real(self, j, row)

    session.Session.fill = fill
'''


@pytest.mark.parametrize("fault,number", [("altered", "wrong_lines"), ("half", "bad_answers")])
def test_a_broken_serve_path_is_not_correct(tiny_root, tmp_path, monkeypatch, fault, number):
    hook = tmp_path / "hook"
    hook.mkdir()
    (hook / "sitecustomize.py").write_text(SITECUSTOMIZE)
    monkeypatch.setenv("PYTHONPATH", str(hook))
    monkeypatch.setenv("SEQBENCH_TEST_FAULT", fault)
    ctx = harness.context("tiny-serve", 9, 1.0, False, root=tiny_root, device="cpu")
    if fault == "half":
        # Requests of one row complete whole; every warm-up request must too.
        ctx.traffic = {**ctx.traffic, "warm_requests": 0}
    result, _ = harness.measure(ctx)
    assert not result["correct"]
    assert result["checks"][number]["value"] > 0 and result["failed"] > 0
