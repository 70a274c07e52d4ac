"""launch_warp_fill on the CPU: the reader over hand-made windows, and a
traced tiny scan run, where the counter counts but no kernel launched."""

from __future__ import annotations

import importlib

import pytest

from seqbench import harness
from test_seqbench_scan import scan_root  # noqa: F401  (the tiny scan cell)

KEY = "dispatch_launched_warp_chars"


@pytest.mark.parametrize("telemetry,want", [
    ({"start": {KEY: 10}, "end": {KEY: 20}}, 100.0 * 300 / (128 * 10)),
    ({"end": {KEY: 3}}, 100.0 * 300 / (128 * 3)),
    ({"start": {KEY: 7}, "end": {KEY: 7}}, None),
    # a program without the counter: launched cells, no warp chars
    ({"start": {"dispatch_launched_cells": 100}, "end": {"dispatch_launched_cells": 500}}, None),
    ({}, None),  # another driver's run
])
def test_launch_warp_fill_reads_the_windows_warp_chars(telemetry, want):
    reader = importlib.import_module("seqbench.metrics.launch_warp_fill")
    jobs = [{"cells": 100}, {"cells": 200}]
    run = harness.Run("batch", 1.0, 1.0, 2, 0, {}, {}, jobs=jobs,
                      launches={"fused_scorer": 3, "packed_scorer": 1}, telemetry=telemetry)
    assert reader.read(run) == (None if want is None else pytest.approx(want))
    # No job, or no kernel launched (the CPU's plain versions): nothing.
    for other in ({"jobs": jobs}, {"launches": {"fused_scorer": 1}}):
        assert reader.read(harness.Run("batch", 1.0, 1.0, 0, 0, {}, {}, telemetry=telemetry,
                                       **other)) is None


def test_a_traced_scan_run_on_the_cpu_reads_no_warp_fill(scan_root):  # noqa: F811
    """The counter counts the plain versions' warp chars on the CPU too;
    the metric reads only where a kernel launched."""
    ctx = harness.context("tiny-scan", 2**31 + 11, 0.5, True, root=scan_root, device="cpu")
    result, run = harness.measure(ctx)
    assert result["correct"], result["checks"]
    assert "launch_warp_fill" not in result["metrics"]
    start, end = run.telemetry["start"], run.telemetry["end"]
    assert end[KEY] > start[KEY]
