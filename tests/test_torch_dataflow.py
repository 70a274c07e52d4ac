"""The port's staging dataflow pass (``analysis/dataflow.py``): the staged
feed of ``ops/dispatch.py`` is made once, read once, stream-safe, and
re-staged from the host on every retry path; the plan in the JAX
``DonationPlan`` view shape; seeded hazards in copies of the package, as
``tests/test_dataflow.py`` seeds them; and the runtime the proof is about.

JAX tests with no counterpart here, and why:
``test_donate_argnums_proved_and_wired`` and
``TestDonationRuntime::test_donated_chunk_buffer_deleted_and_reuse_raises``
need ``jax.jit(donate_argnums)``; eager PyTorch donates nothing, which
``test_the_plan_donates_nothing`` names.  ``test_asarray_of_device_local_is_
aliasing_not_staging`` is about ``jnp.asarray`` aliasing a device array;
the port's operands go up from host numpy (``feed.put_feed``, the one upload), which
the re-staging rule holds.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from mpi_openmp_cuda_tpu_torch.analysis import DataflowError, dataflow, traceaudit
from mpi_openmp_cuda_tpu_torch.models.workload import input3_class_problem
from mpi_openmp_cuda_tpu_torch.obs.metrics import validate_report, wrap_report
from mpi_openmp_cuda_tpu_torch.ops import dispatch
from mpi_openmp_cuda_tpu_torch.ops.dispatch import AlignmentScorer

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "mpi_openmp_cuda_tpu_torch"
GOLDEN = REPO / "tests" / "golden" / "torch_donation_plan.json"


@pytest.fixture(scope="module")
def plan():
    return dataflow.build_plan()


class TestStagingPlan:
    def test_four_launch_entries_planned(self, plan):
        assert [e.wrapper for e in plan.entries] == [
            "fused_scorer", "packed_scorer", "mm_rows", "gather_rows"]

    def test_state_fields_derived_from_to_device(self, plan):
        assert plan.state_fields == traceaudit.operand_fields() == (
            "seq1ext", "rows", "lens", "val")

    def test_the_plan_donates_nothing(self, plan):
        """Eager PyTorch has no donate_argnums: every operand is pinned with
        the reason, none donated."""
        for e in plan.entries:
            assert e.donate == ()
            assert [p.name for p in e.pinned] == list(plan.state_fields)
            assert all(p.reason == traceaudit.NO_DONATION for p in e.pinned)
        assert plan.to_body()["plan"]["donation_supported"] is False

    def test_call_sites_cover_the_dispatch_and_the_ring(self, plan):
        by = {e.wrapper: e.call_sites for e in plan.entries}
        assert "ops/dispatch.py:run_launch" in by["fused_scorer"]
        assert "parallel/ring.py:RingSharding.score_async" in by["fused_scorer"]
        assert "ops/dispatch.py:run_launch" in by["packed_scorer"]

    def test_restage_paths_proven(self, plan):
        roots = {r["root"] for r in plan.restage_paths}
        assert roots == {dataflow._name(r) for r in dataflow._REDISPATCH_ROOTS}
        assert all(r["ok"] for r in plan.restage_paths)
        for r in plan.restage_paths:
            assert r["path"][0] == r["root"] and r["path"][-1] == r["leaf"]
            assert "ops/dispatch.py:bucket_launches" in r["path"]

    def test_zero_findings(self, plan):
        assert plan.findings == ()

    def test_the_feed_is_the_only_upload(self, plan):
        """``feed.put_feed`` is the one call that copies host operands to a
        device, and every re-dispatch root reaches it."""
        assert dataflow._UPLOAD_CALLS == {"put_feed"}
        assert {r["leaf"] for r in plan.restage_paths} == {"ops/dispatch.py:_upload"}

    def test_report_is_json_and_schema_valid(self, plan):
        from mpi_openmp_cuda_tpu.obs.metrics import validate_report as jvalidate

        body = json.loads(json.dumps(plan.to_body()))
        body["trace_audit"] = {"donation": {"undonated_large_buffers": 0, "pinned_live": []}}
        rec = wrap_report("donation-audit", body)
        validate_report(rec)
        jvalidate(rec)

    def test_run_or_raise_clean(self):
        assert dataflow.run_or_raise()["counts"]["findings"] == 0

    def test_golden_cross_check(self):
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "torch_donation_audit", REPO / "scripts" / "torch_donation_audit.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert mod.check(mod.build_report(), json.loads(GOLDEN.read_text())) == []


# -- seeded hazards in a copy of the package ---------------------------------------------


# The subpackages the staging paths run through (the rest only slows the parse).
_SEEDED_SUBPACKAGES = ("io", "ops", "parallel", "resilience", "serve")


def _copy(tmp_path):
    root = tmp_path / "pkg"
    for sub in _SEEDED_SUBPACKAGES:
        shutil.copytree(PKG / sub, root / sub, ignore=shutil.ignore_patterns("__pycache__"))
    return root


def _seeded(tmp_path, rel, old, new):
    root = _copy(tmp_path)
    path = root / rel
    text = path.read_text()
    assert old in text, old
    path.write_text(text.replace(old, new, 1))
    return dataflow.build_plan(root)


def _kinds(plan):
    return [(f["kind"], f["entry"]) for f in plan.findings]


def test_the_copied_subpackages_are_clean(tmp_path):
    assert dataflow.build_plan(_copy(tmp_path)).findings == ()


def test_feed_taken_twice(tmp_path):
    plan = _seeded(tmp_path, "ops/dispatch.py",
                   "        launches = staged.take(operand_digest(seq1_codes, seq2_codes, "
                   "weights, backend))\n",
                   "        launches = staged.take(operand_digest(seq1_codes, seq2_codes, "
                   "weights, backend))\n        launches = launches or staged.take(b'')\n")
    assert ("feed-taken-twice", "ops/dispatch.py:bucket_launches") in _kinds(plan)


def test_fifth_operand_without_record_stream(tmp_path):
    plan = _seeded(tmp_path, "ops/dispatch.py",
                   "        lens=view(feed, layout.lens[i], b, torch.int32),\n",
                   "        lens=view(feed, layout.lens[i], b, torch.int32),\n"
                   "        extra=view(feed, layout.lens[i], b, torch.int32),\n")
    assert "extra" in plan.state_fields
    (f,) = [f for f in plan.findings if f["kind"] == "missing-record-stream"]
    assert "'extra'" in f["detail"] and f["entry"] == "ops/dispatch.py:StagedFeed.take"


def test_take_without_the_stream_wait(tmp_path):
    plan = _seeded(tmp_path, "ops/dispatch.py", "            stream.wait_event(self._event)\n",
                   "")
    assert ("missing-wait-event", "ops/dispatch.py:StagedFeed.take") in _kinds(plan)


def test_take_that_keeps_its_launches(tmp_path):
    plan = _seeded(tmp_path, "ops/dispatch.py",
                   "        launches, self._launches = self._launches, None\n",
                   "        launches = self._launches\n")
    assert ("take-not-destructive", "ops/dispatch.py:StagedFeed.take") in _kinds(plan)


def test_retry_root_that_reads_a_staged_launch(tmp_path):
    plan = _seeded(tmp_path, "io/pipeline.py", "        def attempt():\n",
                   "        def attempt():\n"
                   "            rerun = staged._launches if staged is not None else None\n")
    assert ("feed-read", "io/pipeline.py:ChunkPipeline.dispatch") in _kinds(plan)


def test_retry_root_that_rebuilds_a_feed(tmp_path):
    plan = _seeded(tmp_path, "io/pipeline.py", "staged=feed.pop() if feed else None",
                   "staged=feed[0]")
    assert ("retry-rereads-feed", "io/pipeline.py:ChunkPipeline.dispatch") in _kinds(plan)


def test_feed_made_outside_prestage(tmp_path):
    plan = _seeded(tmp_path, "io/pipeline.py", "        feed = [staged]\n",
                   "        feed = [StagedFeed(b'', None, [])]\n")
    assert ("feed-origin", "io/pipeline.py:ChunkPipeline.dispatch") in _kinds(plan)


def test_upload_above_the_retry_boundary(tmp_path):
    plan = _seeded(tmp_path, "resilience/rescue.py",
                   "    publish(\"rescue.orphans\", count=len(orphan_codes))\n",
                   "    publish(\"rescue.orphans\", count=len(orphan_codes))\n"
                   "    from ..ops.feed import put_feed\n"
                   "    pinned = put_feed(ring, layout, plans, table, None, device)\n")
    assert ("stage-above-retry", "resilience/rescue.py:rescue_orphans") in _kinds(plan)


def test_missing_restage_root_fails_closed(tmp_path):
    root = _copy(tmp_path)
    plan = dataflow.build_plan(root, redispatch_roots=(("io/pipeline.py", "Gone.dispatch"),))
    assert ("restage-root-missing", "io/pipeline.py:Gone.dispatch") in _kinds(plan)


def test_root_reaching_no_upload_is_vacuous(tmp_path):
    plan = _seeded(tmp_path, "resilience/rescue.py",
                   "        lambda: scorer.score_codes(seq1_codes, orphan_codes, weights),\n",
                   "        lambda: None,\n")
    assert ("restage-unproven", "resilience/rescue.py:rescue_orphans") in _kinds(plan)
    with pytest.raises(DataflowError, match="restage-unproven"):
        dataflow.run_or_raise(tmp_path / "pkg")


# -- the runtime the proof is about -------------------------------------------------------


def _batch():
    rng = np.random.default_rng(5)
    seq1 = rng.integers(1, 27, size=300).astype(np.int8)
    seqs = [rng.integers(1, 27, size=n).astype(np.int8) for n in (20, 40, 150, 200, 7, 90)]
    return seq1, seqs, [10, 2, 3, 4]


def test_a_feed_feeds_one_dispatch():
    seq1, seqs, w = _batch()
    scorer = AlignmentScorer("cuda", device="cpu")
    feed = scorer.prestage_codes(seq1, seqs, w)
    want = scorer.score_codes(seq1, seqs, w)
    digest = dispatch.operand_digest(seq1, seqs, w, "cuda")
    assert feed.take(b"other") is None  # a digest mismatch spends it too
    feed = scorer.prestage_codes(seq1, seqs, w)
    first = feed.take(digest)
    assert first and feed.take(digest) is None
    assert np.array_equal(scorer.score_codes(seq1, seqs, w, staged=feed), want)


def test_a_retried_attempt_restages_from_the_host(monkeypatch):
    """The first attempt takes the feed, its result fails, the retry
    dispatches again with the spent feed and uploads from the host."""
    from mpi_openmp_cuda_tpu_torch.io.pipeline import ChunkPipeline
    from mpi_openmp_cuda_tpu_torch.resilience import faults
    from mpi_openmp_cuda_tpu_torch.resilience.degrade import BackendDegrader
    from mpi_openmp_cuda_tpu_torch.resilience.policy import RetryPolicy

    seq1, seqs, w = _batch()
    scorer = AlignmentScorer("cuda", device="cpu")
    want = scorer.score_codes(seq1, seqs, w)
    uploads = []
    real = dispatch._upload
    monkeypatch.setattr(dispatch, "_upload",
                        lambda v, p, d, r: uploads.append(1) or real(v, p, d, r))
    policy = RetryPolicy(retries=1, backoff_base=0.0)
    pipe = ChunkPipeline(policy, BackendDegrader(scorer, None, enabled=False))
    feed = scorer.prestage_codes(seq1, seqs, w)
    assert len(uploads) == 1
    faults.activate_faults("chunk_scoring:fail=1")
    try:
        budget = policy.new_budget()
        promise = pipe.dispatch(seq1, seqs, w, budget, staged=feed)
        rows = pipe.materialise(promise, seq1, seqs, w, budget)
    finally:
        faults.deactivate_faults()
    assert np.array_equal(np.asarray(rows), want)
    assert len(uploads) == 2  # the staged one, then the retry's from the host


# -- the donation-audit report against both packages' validators ---------------------------


@pytest.fixture(scope="module")
def report(plan):
    body = plan.to_body()
    body["trace_audit"] = {
        "donation": traceaudit.audit_schedule(input3_class_problem())["donation"]}
    return body


@pytest.mark.parametrize(
    "mutate",
    [
        lambda b: b.pop("plan"),
        lambda b: b.pop("findings"),
        lambda b: b.pop("restage_paths"),
        lambda b: b.pop("trace_audit"),
        lambda b: b["plan"].pop("entries"),
        lambda b: b["plan"]["entries"][0].pop("donate"),
        lambda b: b["trace_audit"]["donation"].pop("pinned_live"),
        lambda b: b["trace_audit"].__setitem__("donation", {}),
    ],
)
def test_malformed_reports_rejected_by_both_validators(mutate, report):
    from mpi_openmp_cuda_tpu.obs.metrics import validate_report as jvalidate

    body = json.loads(json.dumps(report))
    for validate in (validate_report, jvalidate):
        validate(wrap_report("donation-audit", body))
    mutate(body)
    for validate in (validate_report, jvalidate):
        with pytest.raises(ValueError, match="invalid run report"):
            validate(wrap_report("donation-audit", body))


def test_bench_donation_record_names_the_absence():
    from mpi_openmp_cuda_tpu_torch.bench import donation_record

    rec = donation_record(input3_class_problem())
    assert rec["donation_supported"] is False
    assert rec["large_buffers"] == rec["pinned_live"] == 1  # the [32, 1152] rows
    assert rec["findings"] == 0 and rec["restage_paths"] == len(dataflow.build_plan().restage_paths)


def test_a_hazard_on_a_retry_path_carries_its_blocking_path(tmp_path):
    plan = _seeded(tmp_path, "ops/dispatch.py",
                   "        launches = staged.take(operand_digest(seq1_codes, seq2_codes, "
                   "weights, backend))\n",
                   "        launches = staged.take(operand_digest(seq1_codes, seq2_codes, "
                   "weights, backend))\n        spent = staged._launches\n")
    (f,) = [f for f in plan.findings if f["kind"] == "feed-read-after-take"]
    assert f["path"][0] in {dataflow._name(r) for r in dataflow._REDISPATCH_ROOTS}
    assert f["path"][-1] == "ops/dispatch.py:bucket_launches"
