"""The port's cost sheet (``analysis/costmodel.py``), its launch configs
(``ops/schedule.py::kernel_configs``, ``fused_schedule_config``) and the warm
plane's hot-config source, held against ``tests/test_costmodel.py`` where
the contract carries over and against the JAX package's own
``kernel_configs`` and ``ring_plan`` on the same seeded inputs.

JAX tests with no counterpart here, and why:

* ``TestConfigCosts::test_config_cost_unpacked_and_packed`` prices MXU FLOPs
  and a VMEM footprint; the Hopper kernels issue no matrix operation and
  the shared memory is ``analysis/smem.py``'s (``tests/test_torch_analysis.py``).
* ``TestScheduleCostSheetGolden::test_predicted_mfu_pin`` /
  ``test_scalar_accessor`` pin a feed-roofline MFU; the port's sheet has no
  feed (``predicted_mfu_vs_feed_roofline`` is null) and pins its predicted
  wall and bound share in the golden instead.
* ``TestTraceWalk`` and ``TestDonationAudit`` walk jaxprs and lowered
  donation flags: the launch audit's counterparts are in
  ``tests/test_torch_traceaudit.py``.
* ``TestPredictedVsMeasuredTPU`` needs a TPU; ``chip_smoke.py`` phase 19
  prints the sheet beside the card's times.
"""

from __future__ import annotations

import importlib.util
import json
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from mpi_openmp_cuda_tpu.ops import schedule as jschedule
from mpi_openmp_cuda_tpu.parallel.ring import ring_plan as jring_plan
from mpi_openmp_cuda_tpu_torch.analysis import CostModelError, SeqcheckError, costmodel
from mpi_openmp_cuda_tpu_torch.analysis.smem import iter_chooser_space
from mpi_openmp_cuda_tpu_torch.aot.warmset import (
    WarmEntry, crosscheck_hot_configs, select_warmset)
from mpi_openmp_cuda_tpu_torch.io.parse import load_problem
from mpi_openmp_cuda_tpu_torch.models.workload import (
    MAX_SIZE, input3_class_problem, synthetic_codes)
from mpi_openmp_cuda_tpu_torch.obs.metrics import validate_report, wrap_report
from mpi_openmp_cuda_tpu_torch.ops import dispatch, schedule
from mpi_openmp_cuda_tpu_torch.parallel.ring import ring_plan

REPO = Path(__file__).resolve().parent.parent
FIXTURES = sorted((REPO / "tests" / "fixtures").glob("*.txt"))
GOLDEN = REPO / "tests" / "golden" / "torch_schedule_audit.json"


def _problem(seq1, seqs, weights):
    return SimpleNamespace(seq1_codes=seq1, seq2_codes=seqs, weights=list(weights))


def _synthetic(args, weights=(10, 2, 3, 4)):
    return _problem(*synthetic_codes(*args), weights)


PROBLEMS = {
    "input3-class": input3_class_problem,
    "max-size": lambda: _synthetic(MAX_SIZE),
    "short-rows": lambda: _synthetic((3000, 100, 5, 64, 7)),
    "mixed": lambda: _synthetic((600, 40, 5, 300, 9), (2, 2, 1, 10)),
    **{f.name: (lambda f=f: load_problem(str(f))) for f in FIXTURES},
}


@pytest.fixture(scope="module")
def sheet():
    return costmodel.schedule_cost_sheet(input3_class_problem())


# -- the launch-shape sweep ------------------------------------------------------


class TestConfigCosts:
    def test_sweep_prices_every_plannable_shape(self):
        costs = list(costmodel.sweep_config_costs())
        shapes = {(e.kind, e.l2p, e.l2s) for e in iter_chooser_space()}
        assert len(costs) == len(shapes) == 120
        assert {(c.kind, c.l2p, c.l2s) for c in costs} == shapes
        for c in costs:
            assert math.isfinite(c.model_kernel_us) and c.model_kernel_us > 0, c.describe()
            assert 0.0 < c.bound_share <= 1.0, c.describe()

    def test_audit_config_space(self):
        n, best = costmodel.audit_config_space()
        assert n == sum(1 for _ in costmodel.sweep_config_costs())
        assert best.bound_share == max(c.bound_share for c in costmodel.sweep_config_costs())
        assert "share<=" in best.describe()

    def test_fused_is_the_launch_model_packed_is_launch_plus_bound(self):
        fused = costmodel.config_cost("fused", 1152)
        assert fused.model == "launch-model" and fused.formulation == "cuda-fused"
        assert fused.model_kernel_us == pytest.approx(
            schedule.launch_us(fused.len1, [1152], 1152))
        packed = costmodel.config_cost("packed", 128, 32)
        assert packed.model == "launch+bound" and packed.rows == 4
        assert packed.model_kernel_us == pytest.approx(schedule.LAUNCH_US + packed.bound_us)

    def test_canonical_units(self):
        ring = costmodel.config_cost("ring", 12288)
        assert ring.len1 == 12288 + 128 and ring.rows == 1
        serve = costmodel.config_cost("serve", 128, 64)
        assert serve.rows == 64 and serve.len1 == 3000

    def test_unknown_kind_raises(self):
        with pytest.raises(CostModelError):
            costmodel.config_cost("megakernel", 128)
        assert issubclass(CostModelError, SeqcheckError)
        assert issubclass(CostModelError, RuntimeError)


# -- the launch configs and the declaration -----------------------------------------


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_sheet_declares_the_launches_launch_plans_makes(name):
    """The sheet's launches by kernel == ``fused_schedule_config``'s
    declaration == the plans ``dispatch.launch_plans`` makes, routed."""
    prob = PROBLEMS[name]()
    _, plans = dispatch.launch_plans(prob.seq1_codes, prob.seq2_codes, prob.weights)
    want = {"fused_scorer": sum(p.l2s is None for p in plans),
            "packed_scorer": sum(p.l2s is not None for p in plans)}
    declared = schedule.fused_schedule_config(prob)
    assert declared.declared_launches == want
    assert declared.launches == len(plans)
    assert list(declared.groups) == [p.keys for p in plans]
    sheet = costmodel.schedule_cost_sheet(prob)
    assert sheet["fused"]["declared_launches"] == want
    assert sheet["totals"]["launches"] == len(plans) == len(sheet["buckets"])
    assert sheet["totals"]["launches_by_kernel"] == {k: v for k, v in want.items() if v}


@pytest.mark.parametrize("name", ["input3-class", "max-size", "short-rows", "mixed"])
def test_buckets_hold_the_jax_bucket_keys_and_live_pairs(name):
    """The same bucket keys and live pairs as the JAX package's
    ``kernel_configs``; the launch groups may differ (the port plans them
    with the Hopper launch model: max-size is one launch here, three in
    JAX), and the sheet states its own count."""
    prob = PROBLEMS[name]()
    jcfgs = jschedule.kernel_configs(prob, "pallas")
    sheet = costmodel.schedule_cost_sheet(prob)
    assert (sorted(k for c in jcfgs for k in c.bucket_keys)
            == sorted(k for b in sheet["buckets"] for k in b["bucket_keys"]))
    jlive = sum(1 for c in jcfgs for chunk in c.chunk_lens for n in chunk if n > 0)
    assert jlive == sum(b["live_pairs"] for b in sheet["buckets"]) == len(prob.seq2_codes)


def test_launch_config_key_is_the_warm_manifest_key():
    for cfg in schedule.kernel_configs(PROBLEMS["mixed"]()):
        entry = cfg.warm_entry()
        assert isinstance(entry, WarmEntry)
        assert cfg.cache_key == entry.cache_key == (cfg.formulation, cfg.l2p, cfg.l2s)
        assert cfg.executable_key == entry.executable_key
        if cfg.formulation == "cuda-fused":
            assert cfg.cluster == schedule.cluster_shape(cfg.l2p, cfg.split) and cfg.l2s is None
        else:
            assert cfg.cluster is None and cfg.l2s in dispatch.pack_classes()


def test_launch_past_the_int32_window_routes_to_gather():
    prob = _problem(np.array([1, 2, 2, 1, 2], np.int8),
                    [np.array([1], np.int8), np.array([1, 2], np.int8)], (10**9, 1, 1, 1))
    (cfg,) = schedule.kernel_configs(prob)
    assert cfg.formulation == "gather" and cfg.kernel is None
    assert schedule.fused_schedule_config(prob).declared_launches == {
        "fused_scorer": 0, "packed_scorer": 0}
    off = costmodel.schedule_cost_sheet(prob)
    assert off["totals"] is None and off["buckets"] == [] and off["comms"] is None


@pytest.mark.parametrize("backend", ["oracle", "mm", "gather"])
def test_off_kernel_backends_get_the_empty_sheet(backend):
    sheet = costmodel.schedule_cost_sheet(input3_class_problem(), backend)
    assert sheet["totals"] is None and sheet["hot_configs"] == [] and sheet["fused"] is None
    assert sheet["predicted_mfu_vs_feed_roofline"] is None
    assert costmodel.predicted_wall_us(input3_class_problem(), backend) is None


# -- the input3-class sheet ---------------------------------------------------------


class TestScheduleSheet:
    def test_launch_cost_is_counted_once(self, sheet):
        t = sheet["totals"]
        assert t["predicted_wall_us"] == pytest.approx(t["model_kernel_us"])
        assert t["launch_overhead_us"] == pytest.approx(t["launches"] * schedule.LAUNCH_US)
        assert t["model_kernel_us"] == pytest.approx(
            sum(b["model_kernel_us"] for b in sheet["buckets"]))
        assert costmodel.predicted_wall_us(input3_class_problem()) == t["predicted_wall_us"]

    def test_bound_share_replaces_the_feed_roofline(self, sheet):
        assert sheet["predicted_mfu_vs_feed_roofline"] is None
        t = sheet["totals"]
        assert sheet["predicted_bound_share"] == pytest.approx(
            t["bound_us"] / t["predicted_wall_us"])
        assert 0 < sheet["predicted_bound_share"] < 1

    def test_work_counts_are_the_bounds(self, sheet):
        from mpi_openmp_cuda_tpu_torch.ops.costs import INT_OPS_PER_CELL

        (b,) = sheet["buckets"]
        assert b["int_ops"] == INT_OPS_PER_CELL * b["cells"] == 3 * b["lookups"]
        prob = input3_class_problem()
        launches = dispatch.bucket_launches(prob.seq1_codes, prob.seq2_codes, prob.weights,
                                            dispatch.resolve_device("cpu"))
        from mpi_openmp_cuda_tpu_torch.ops.costs import state_counts

        counts = state_counts(launches[0].state)
        assert (counts.cells, counts.bytes) == (b["cells"], b["bytes_moved_min"])

    def test_hot_configs_ranked(self):
        sheet = costmodel.schedule_cost_sheet(PROBLEMS["mixed"]())
        hot = sheet["hot_configs"]
        assert [r["rank"] for r in hot] == list(range(1, len(hot) + 1)) and len(hot) == 2
        shares = [r["wall_share"] for r in hot]
        assert shares == sorted(shares, reverse=True)
        assert sum(shares) == pytest.approx(1.0)

    def test_comms_rows_for_2_4_8_on_both_axes(self, sheet):
        comms = sheet["comms"]
        assert comms["measured"] is False and comms["link_gbytes_s"] == 450.0
        rows = comms["scaling"]
        assert [(r["mesh"], r["axis"]) for r in rows] == [
            (n, a) for n in (2, 4, 8) for a in ("batch", "seq")]
        for r in rows:
            for k in ("comms_wall_us", "predicted_wall_us", "predicted_scaling_efficiency"):
                assert math.isfinite(r[k]) and r[k] > 0, r
            if r["axis"] == "seq":
                (b,) = sheet["buckets"]
                assert r["ring_steps"] == [ring_plan(b["l1p"], b["l2p"], r["mesh"], True)[1]]

    def test_sheet_names_no_tpu_constant(self, sheet):
        words = set()

        def walk(x):
            if isinstance(x, dict):
                for k, v in x.items():
                    if k != "predicted_mfu_vs_feed_roofline":  # null, the JAX key
                        words.update(k.lower().split("_"))
                    walk(v)
            elif isinstance(x, list):
                for v in x:
                    walk(v)
            elif isinstance(x, str):
                words.update(x.lower().replace(",", " ").split())

        walk(sheet)
        for name in vars(costmodel):
            words.update(name.lower().split("_"))
        assert not words & {"ici", "mxu", "tpu", "vmem", "feed", "tflops"}, words

    def test_sheet_is_json_ready_and_schema_valid(self, sheet):
        from mpi_openmp_cuda_tpu.obs.metrics import validate_report as jvalidate

        rec = wrap_report("schedule-audit", {"cost_sheet": json.loads(json.dumps(sheet)),
                                             "trace_audit": {"buckets": [], "donation": {
                                                 "undonated_large_buffers": 0,
                                                 "pinned_live": []}},
                                             "entry_points": []})
        validate_report(rec)
        jvalidate(rec)

    def test_empty_batch_prices_nothing(self):
        sheet = costmodel.schedule_cost_sheet(_problem(np.array([1, 2], np.int8), [], (1, 1, 1, 1)))
        assert sheet["totals"]["launches"] == 0 and sheet["predicted_bound_share"] is None


@pytest.mark.parametrize("spec,sp", [("seq:2", 2), ("seq:4", 4), ("2x2", 2), ("seq:8", 8)])
def test_ring_plan_r_equals_the_jax_ring_plan(spec, sp):
    """The R the sheet's seq rows price is the JAX ring's with the kernel
    (128-wide blocks), at every mesh form's seq width."""
    for l1p, l2p in ((256, 128), (1536, 1152), (3072, 2048), (12288, 12288)):
        assert ring_plan(l1p, l2p, sp, kernel=True) == jring_plan(l1p, l2p, sp, pallas=True)
        assert ring_plan(l1p, l2p, sp, kernel=False) == jring_plan(l1p, l2p, sp, pallas=False)


def test_nvlink_model():
    assert costmodel.nvlink_collective_wall_s("shift", 0, 4) == costmodel.NVLINK_HOP_LATENCY_S
    one = costmodel.nvlink_collective_wall_s("all_gather", 4096, 2)
    assert costmodel.nvlink_collective_wall_s("all_gather", 4096, 8) == pytest.approx(7 * one)
    assert costmodel.nvlink_collective_wall_s("gather", 10**6, 1) == 0.0
    with pytest.raises(CostModelError):
        costmodel.nvlink_collective_wall_s("psum", 4, 4)


# -- the warm plane's hot configs ---------------------------------------------------


def test_warmset_takes_the_hot_configs_first():
    prob = PROBLEMS["mixed"]()
    entries = select_warmset(prob, "cuda")
    hot = costmodel.schedule_cost_sheet(prob)["hot_configs"]
    heads = [e for e in entries if e.source == "hot-config"]
    assert entries[: len(heads)] == heads and len(heads) == len(hot)
    assert [e.cache_key for e in heads] == [(r["formulation"], r["l2p"], r["l2s"]) for r in hot]


def test_max_size_warm_set_covers_its_hot_configs():
    prob = PROBLEMS["max-size"]()
    hot = costmodel.schedule_cost_sheet(prob)["hot_configs"]
    assert hot and crosscheck_hot_configs(select_warmset(prob, "cuda"), hot) == []


def test_crosscheck_lists_the_uncovered_rows():
    prob = PROBLEMS["mixed"]()
    hot = costmodel.schedule_cost_sheet(prob)["hot_configs"]
    entries = select_warmset(prob, "cuda")
    dropped = [e for e in entries if e.cache_key != entries[0].cache_key]
    assert crosscheck_hot_configs(dropped, hot) == [hot[0]]
    golden = json.loads(GOLDEN.read_text())["workloads"][0]["hot_configs"]
    assert crosscheck_hot_configs(select_warmset(input3_class_problem(), "cuda"), golden) == []


def test_golden_matches_the_script():
    spec = importlib.util.spec_from_file_location(
        "torch_schedule_audit", REPO / "scripts" / "torch_schedule_audit.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    report = mod.build_report()
    assert mod.check(report, json.loads(GOLDEN.read_text())) == []


def _audit_body():
    from mpi_openmp_cuda_tpu_torch.analysis.traceaudit import audit_schedule

    prob = input3_class_problem()
    return {"workload": "synthetic-input3-class",
            "cost_sheet": json.loads(json.dumps(costmodel.schedule_cost_sheet(prob))),
            "trace_audit": audit_schedule(prob), "entry_points": []}


@pytest.mark.parametrize(
    "mutate",
    [
        lambda b: b.pop("cost_sheet"),
        lambda b: b.pop("trace_audit"),
        lambda b: b.pop("entry_points"),
        lambda b: b["cost_sheet"].__setitem__("buckets", "nope"),
        lambda b: b["cost_sheet"]["totals"].__setitem__("launches", "1"),
        lambda b: b["cost_sheet"].__setitem__("predicted_mfu_vs_feed_roofline", "0.1"),
        lambda b: b["trace_audit"].__setitem__("donation", {}),
        lambda b: b["trace_audit"]["donation"].pop("pinned_live"),
    ],
)
def test_malformed_schedule_audits_rejected_by_both_validators(mutate):
    from mpi_openmp_cuda_tpu.obs.metrics import validate_report as jvalidate

    body = _audit_body()
    for validate in (validate_report, jvalidate):
        validate(wrap_report("schedule-audit", body))
    mutate(body)
    for validate in (validate_report, jvalidate):
        with pytest.raises(ValueError, match="invalid run report"):
            validate(wrap_report("schedule-audit", body))
