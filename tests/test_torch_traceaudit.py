"""The port's launch audit (``analysis/traceaudit.py``): a traced dispatch's
launches held to the planner's declaration, one epilogue and one host
fetch a batch, the operand inventory and its findings, the entry points'
widenings, and the donation section that names eager PyTorch's absence of
donation.

The JAX twin (``tests/test_costmodel.py::TestTraceWalk``,
``TestDonationAudit``, ``TestScheduleTraceSlow``) walks jaxprs and reads
donation flags off a lowering; here the dispatch itself is traced with
its launches stubbed, and the conversions are counted by a
``TorchFunctionMode``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mpi_openmp_cuda_tpu_torch.analysis import (
    ScheduleDriftError, SeqcheckError, TraceAuditError, traceaudit)
from mpi_openmp_cuda_tpu_torch.io.parse import load_problem
from mpi_openmp_cuda_tpu_torch.models.workload import (
    MAX_SIZE, input3_class_problem, synthetic_codes)
from mpi_openmp_cuda_tpu_torch.obs.metrics import validate_report, wrap_report
from mpi_openmp_cuda_tpu_torch.ops import dispatch, schedule

REPO = Path(__file__).resolve().parent.parent
FIXTURES = sorted((REPO / "tests" / "fixtures").glob("*.txt"))
CPU = torch.device("cpu")


def _problem(args, weights=(10, 2, 3, 4)):
    seq1, seqs = synthetic_codes(*args)
    return SimpleNamespace(seq1_codes=seq1, seq2_codes=seqs, weights=list(weights))


PROBLEMS = {
    "input3-class": input3_class_problem,
    "max-size": lambda: _problem(MAX_SIZE),
    "short-rows": lambda: _problem((3000, 300, 5, 64, 7)),
    "mixed": lambda: _problem((600, 40, 5, 300, 9), (2, 2, 1, 10)),
    **{f.name: (lambda f=f: load_problem(str(f))) for f in FIXTURES},
}


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_traced_launches_equal_the_declaration(name):
    prob = PROBLEMS[name]()
    rep = traceaudit.audit_schedule(prob)
    declared = schedule.fused_schedule_config(prob)
    assert {k: rep["launches_by_kernel"][k] for k in declared.declared_launches} == \
        declared.declared_launches == rep["declared_launches"]
    assert rep["launches"] == declared.launches == len(rep["buckets"])
    has = rep["launches"] > 0
    assert (rep["epilogues"], rep["host_fetches"]) == ((0, 1) if has else (0, 0))
    assert rep["findings"] == []


def test_mm_backend_has_no_epilogue_and_no_kernel_launch():
    rep = traceaudit.audit_schedule(PROBLEMS["mixed"](), backend="mm")
    assert rep["epilogues"] == 0 and rep["host_fetches"] == 1
    assert rep["launches_by_kernel"]["fused_scorer"] == rep["launches_by_kernel"]["packed_scorer"] == 0
    assert rep["launches_by_kernel"]["mm"] == rep["launches"] > 0


def test_trace_restores_the_dispatch():
    from mpi_openmp_cuda_tpu_torch.ops import cuda_scorer

    saved = (dispatch.run_launch, cuda_scorer.finish_rows,
             dispatch.BucketedPending._start_copy)
    with pytest.raises(ZeroDivisionError):
        with traceaudit.trace_dispatch():
            assert dispatch.run_launch is not saved[0]
            raise ZeroDivisionError
    assert (dispatch.run_launch, cuda_scorer.finish_rows,
            dispatch.BucketedPending._start_copy) == saved


def test_traced_dispatch_runs_no_kernel():
    from mpi_openmp_cuda_tpu_torch.ops import cuda_scorer

    calls = []
    real = cuda_scorer.fused_scorer_plain
    cuda_scorer.fused_scorer_plain = lambda st: calls.append(st) or real(st)
    try:
        traceaudit.audit_schedule(PROBLEMS["max-size"]())
    finally:
        cuda_scorer.fused_scorer_plain = real
    assert calls == []


def test_drift_raises_schedule_drift_error(monkeypatch):
    real = schedule.fused_schedule_config

    def off_by_one(problem, backend="cuda"):
        cfg = real(problem, backend)
        return dataclasses.replace(cfg, declared_launches={
            **cfg.declared_launches, "fused_scorer": cfg.declared_launches["fused_scorer"] + 1})

    monkeypatch.setattr(schedule, "fused_schedule_config", off_by_one)
    with pytest.raises(ScheduleDriftError, match="drifted apart") as e:
        traceaudit.audit_schedule(input3_class_problem())
    assert isinstance(e.value, SeqcheckError) and isinstance(e.value, RuntimeError)


def test_a_second_epilogue_is_drift(monkeypatch):
    """The finish kernels write every finished row: a PyTorch epilogue
    beside them (here at the fetch, as the dispatch once ran one) is drift."""
    from mpi_openmp_cuda_tpu_torch.ops import cuda_scorer

    real = dispatch.BucketedPending._start_copy

    def twice(self):
        real(self)
        raw = torch.zeros((self.count, 4), dtype=torch.int32)
        cuda_scorer.finish_rows(raw, torch.ones(self.count, dtype=torch.int32), 5)

    monkeypatch.setattr(dispatch.BucketedPending, "_start_copy", twice)
    with pytest.raises(ScheduleDriftError, match="1 epilogue"):
        traceaudit.audit_schedule(input3_class_problem())


# -- the operand inventory -----------------------------------------------------------


def _launches(name="short-rows"):
    prob = PROBLEMS[name]()
    return dispatch.bucket_launches(prob.seq1_codes, prob.seq2_codes, prob.weights, CPU)


def test_operand_fields_come_from_the_state():
    assert traceaudit.operand_fields() == ("seq1ext", "rows", "lens", "val")


def test_inventory_rows_and_shared_table():
    launches = _launches()
    rows, findings = traceaudit.operand_inventory(launches)
    assert findings == []
    assert len(rows) == 4 * len(launches) and len(launches) == 4
    assert {(r["name"], r["dtype"]) for r in rows} == {
        ("seq1ext", "uint8"), ("rows", "uint8"), ("lens", "int32"), ("val", "int32")}
    for name in ("val", "seq1ext"):  # one table, one Seq1: views of one arena
        assert [r["shared"] for r in rows if r["name"] == name] == [False, True, True, True]


def _replace_state(launch, **kw):
    return dataclasses.replace(launch, state=dataclasses.replace(launch.state, **kw))


def test_seeded_widening_is_a_finding():
    launches = _launches()
    launches[1] = _replace_state(launches[1], rows=launches[1].state.rows.long())
    _, findings = traceaudit.operand_inventory(launches)
    assert [f["kind"] for f in findings] == ["widening"]
    assert "rows uploads as int64" in findings[0]["detail"]


def test_seeded_duplicate_upload_is_a_finding():
    launches = _launches("max-size")
    st = launches[0].state
    twin = _replace_state(launches[0], rows=st.rows.clone())
    _, findings = traceaudit.operand_inventory([launches[0], twin])
    assert "duplicate-upload" in [f["kind"] for f in findings]
    # The same bytes below 16 KiB are no finding (the short Seq1 of a class).
    small = _launches()
    _, findings = traceaudit.operand_inventory(
        [small[0], _replace_state(small[0], lens=small[0].state.lens.clone())])
    assert findings == []


def test_seeded_second_value_table_is_a_finding():
    launches = _launches()
    launches[2] = _replace_state(launches[2], val=launches[2].state.val.clone())
    _, findings = traceaudit.operand_inventory(launches)
    assert [f["kind"] for f in findings] == ["second-value-table"]
    with pytest.raises(TraceAuditError, match="second-value-table"):
        orig = traceaudit.operand_inventory
        traceaudit.operand_inventory = lambda ls: orig(
            [*ls, _replace_state(ls[0], val=ls[0].state.val.clone())])
        try:
            traceaudit.run_or_raise(PROBLEMS["short-rows"]())
        finally:
            traceaudit.operand_inventory = orig


def test_donation_is_absent_in_eager_torch():
    """Eager PyTorch has no donate_argnums: the section says so and pins
    every large operand live with the reason (ROADMAP Queue 1 item 4)."""
    rep = traceaudit.audit_schedule(PROBLEMS["max-size"]())
    don = rep["donation"]
    assert don["donation_supported"] is False and don["donated_large_buffers"] == 0
    # The uint8 rows; the uint8 Seq1 (5 KiB) is under LARGE_BUFFER_BYTES.
    assert don["large_buffers"] == len(don["pinned_live"]) == 1
    assert all(traceaudit.NO_DONATION in row for row in don["pinned_live"])
    assert don["undonated_large_buffers"] == 0 and don["covered"] is True
    body = {"cost_sheet": {"buckets": []}, "trace_audit": rep, "entry_points": []}
    validate_report(wrap_report("schedule-audit", body))


# -- the entry points ---------------------------------------------------------------


def test_entry_points_run_without_transfers():
    from mpi_openmp_cuda_tpu_torch.analysis.contracts import _AUDIT_BUCKETS, ENTRY_CONTRACTS

    rows = traceaudit.audit_entry_points()
    assert len(rows) == len(ENTRY_CONTRACTS) * len(_AUDIT_BUCKETS)
    assert all(r["transfers"] == 0 and r["out_dtype"] == "int32" for r in rows)
    assert all(r["widenings"] >= 1 for r in rows)  # the int64 gather indices


def test_conversion_counter_counts_widenings_and_skips_narrowings():
    counter = traceaudit._ConversionCounter()
    x = torch.ones(4, dtype=torch.int32)
    with counter.mode:
        x.long()
        x.to(torch.int8)
        x.float()
    assert (counter.widenings, counter.transfers) == (1, 0)


def test_empty_problem_makes_no_launch():
    prob = SimpleNamespace(seq1_codes=np.array([1, 2, 3], np.int8), seq2_codes=[],
                           weights=[1, 1, 1, 1])
    rep = traceaudit.audit_schedule(prob)
    assert rep["launches"] == rep["epilogues"] == rep["host_fetches"] == 0
