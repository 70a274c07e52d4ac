"""The port's launch contracts and ``--check`` (``mpi_openmp_cuda_tpu_torch/
analysis/{contracts,smem}.py``), case by case against
``tests/test_analysis.py``: the seeded violations (each its own subclass
with a message naming the bound and the fix), the concrete gates, the
shared-memory audit, the entry contracts, the env registry and the check
hook; then the CLI against the JAX CLI's ``--check`` (byte-identical
stdout on every fixture and a seeded batch of every packed class and a
multi-bucket group; a seeded violation's exit code and stderr shape under
``--retries`` and ``--degrade``), and the SIGUSR2 dump that no longer
takes the flight recorder's lock on the interrupted thread.  No numeric
tolerance anywhere: rows are exact int32."""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from conftest import run_cli_inproc
from mpi_openmp_cuda_tpu_torch.analysis import (
    ContractViolation,
    ExactnessViolation,
    FeedViolation,
    LintError,
    OperandViolation,
    RowpackViolation,
    SeqcheckError,
    SmemBudgetError,
    SuperblockViolation,
    contracts,
    smem,
)
from mpi_openmp_cuda_tpu_torch.io import cli as tcli
from mpi_openmp_cuda_tpu_torch.ops import bounds, cuda_scorer, dispatch

REPO = Path(__file__).resolve().parent.parent
FIXTURES = sorted((REPO / "tests" / "fixtures").glob("*.txt"), key=lambda p: p.name)
IDS = [p.stem for p in FIXTURES]


def _launch(l2p=128, rows=4, lens=None, len1=100, l1p=128, code=3):
    """Host arrays of one padded launch."""
    lens = np.asarray(lens if lens is not None else [min(l2p, 40)] * rows, dtype=np.int32)
    seq1ext = np.zeros(l1p + l2p + 1, dtype=np.int32)
    seq1ext[:len1] = 5
    seq2 = np.zeros((lens.size, l2p), dtype=np.int32)
    for i, n in enumerate(lens):
        seq2[i, :n] = code
    return seq1ext, seq2, lens


def _validate(**over):
    seq1ext, rows, lens = _launch(**{k: over.pop(k) for k in
                                      ("l2p", "rows", "lens", "l1p", "code")
                                      if k in over})
    args = dict(backend="cuda", route="cuda", maxv=10, keys=(rows.shape[1],),
                l1p=seq1ext.size - rows.shape[1] - 1, l2s=None, seq1ext=seq1ext,
                len1=100, rows=rows, lens=lens, max_scored=int(lens.max()))
    args.update(over)
    contracts.validate_launch(**args)


# --------------------------------------------------------------------------
# Seeded contract violations: each its subclass, each naming bound and fix.
# --------------------------------------------------------------------------


class TestSeededViolations:
    def test_mm_past_its_fp32_window(self):
        # 2 * 2048 * 5000 > 2^24: mm's prefix partials round in fp32.
        with pytest.raises(ExactnessViolation) as ei:
            contracts.check_exactness("mm", 5000, 2000, 2048)
        msg = str(ei.value)
        assert "mm_max_exact_value" in msg and "4095" in msg
        assert "gather" in msg  # names the fix, not just the breach

    def test_kernels_past_their_int32_window(self):
        # 2 * 2000 * 600000 > 2^31 - 1: the kernels' delta prefix wraps.
        with pytest.raises(FeedViolation) as ei:
            contracts.check_formulation("cuda", "cuda", 600000, 2000)
        msg = str(ei.value)
        assert "600000" in msg and "gather" in msg and "kernel_fits" in msg

    def test_rowpack_class_narrower_than_a_live_row(self):
        with pytest.raises(RowpackViolation) as ei:
            contracts.check_rowpack(128, 16, [10, 40], 5)
        msg = str(ei.value)
        assert "narrower" in msg and "40" in msg and "choose_rowpack" in msg

    def test_rowpack_int32_bound_breach(self):
        # 2 * 64 * 20000000 > 2^31 - 1: the packed kernel's prefix wraps.
        with pytest.raises(RowpackViolation) as ei:
            contracts.check_rowpack(128, 64, [60, 64], 20000000)
        assert str(20000000 * 128) in str(ei.value)

    def test_group_key_wider_than_its_l2p(self):
        with pytest.raises(SuperblockViolation) as ei:
            contracts.check_launch_group((1024, 2048), 3072, 1024, None)
        assert "wider than its L2P=1024" in str(ei.value)

    def test_codes_outside_the_alphabet(self):
        with pytest.raises(OperandViolation) as ei:
            _validate(code=27)
        assert "alphabet" in str(ei.value)

    def test_smem_over_budget(self):
        with pytest.raises(SmemBudgetError) as ei:
            smem.check_launch(2048, None, budget=16 * 1024)
        msg = str(ei.value)
        assert "shared memory" in msg and "L2P=" in msg and "--mesh seq" in msg

    def test_violations_are_distinct_contract_subclasses(self):
        kinds = {ExactnessViolation, FeedViolation, RowpackViolation,
                 SuperblockViolation, OperandViolation}
        assert len(kinds) == 5
        for k in kinds:
            assert issubclass(k, ContractViolation)
            assert issubclass(k, SeqcheckError)
        assert issubclass(SmemBudgetError, SeqcheckError)
        assert not issubclass(SmemBudgetError, ContractViolation)
        assert issubclass(LintError, SeqcheckError)

    def test_violations_classify_as_the_jax_package_does(self):
        # RuntimeErrors, so both packages' retry policies retry them.
        from mpi_openmp_cuda_tpu.analysis import ContractViolation as JaxViolation
        from mpi_openmp_cuda_tpu.resilience.policy import RetryPolicy as JaxPolicy
        from mpi_openmp_cuda_tpu_torch.resilience.policy import RetryPolicy

        assert issubclass(SeqcheckError, RuntimeError)
        for exc in (RowpackViolation("x"), SmemBudgetError("x")):
            assert RetryPolicy.is_fatal(exc) is False
        assert RetryPolicy.is_fatal(RowpackViolation("x")) == JaxPolicy.is_fatal(
            JaxViolation("x")) is False


class TestConcreteGates:
    def test_chooser_emitted_launches_pass(self):
        # What the dispatch plans sails through: its choices are
        # contract-clean by construction.
        rng = np.random.default_rng(11)
        seq1 = rng.integers(1, 27, size=700).astype(np.int8)
        seqs = [rng.integers(1, 27, size=n).astype(np.int8)
                for n in (5, 9, 17, 33, 64, 100, 130, 260, 400) * 8]
        val_flat, plans = dispatch.launch_plans(seq1, seqs, [4, 3, 2, 1])
        assert any(p.l2s for p in plans) and any(p.l2s is None for p in plans)
        contracts.validate_plans(val_flat, plans, "cuda")
        for p in plans:
            if p.l2s is None:
                est = smem.check_launch(p.batch.l2p, None)
                assert est.headroom_bytes > 0

    def test_rowpack_requires_single_block_bucket(self):
        with pytest.raises(RowpackViolation) as ei:
            contracts.check_rowpack(256, 32, [10, 20], 100)
        assert "L2P == 128" in str(ei.value)

    def test_rowpack_requires_two_rows(self):
        with pytest.raises(RowpackViolation) as ei:
            contracts.check_rowpack(128, 8, [5], 1)
        assert "at least 2 rows" in str(ei.value)

    def test_illegal_class_rejected(self):
        with pytest.raises(RowpackViolation) as ei:
            contracts.check_rowpack(128, 24, [10, 20], 1)
        assert "(8, 16, 32, 64)" in str(ei.value)

    def test_rowpack_none_is_always_legal(self):
        contracts.check_rowpack(2048, None, [2000], 30000)

    def test_unknown_formulation_rejected(self):
        with pytest.raises(FeedViolation):
            contracts.check_formulation("pallas", "cuda", 1, 10)
        with pytest.raises(FeedViolation):
            contracts.check_formulation("mm", "cuda", 1, 10)

    def test_length_aware_windows(self):
        contracts.check_exactness("mm", bounds.mm_max_exact_value(128), 100, 128)
        with pytest.raises(ExactnessViolation):
            contracts.check_exactness("mm", bounds.mm_max_exact_value(128) + 1, 100, 128)
        contracts.check_formulation("cuda", "cuda", bounds.max_exact_value(2000), 2000)
        with pytest.raises(FeedViolation):
            contracts.check_formulation(
                "cuda", "cuda", bounds.max_exact_value(2000) + 1, 2000)

    def test_gather_is_exact_inside_the_admission_window(self):
        contracts.check_formulation("gather", "cuda", 1073741, 2000)
        with pytest.raises(ExactnessViolation):
            contracts.check_exactness("gather", 1073742, 2000, 2048)

    def test_packed_bound_is_the_kernels_window_at_its_class(self):
        for c in dispatch.pack_classes():
            assert contracts.packed_max_exact_value(c) == bounds.INT32_MAX // (2 * c)

    @pytest.mark.parametrize("len1_eff", [-500, 0, 6144, 2**31 - 1])
    def test_ring_windows_in_range(self, len1_eff):
        contracts.check_ring_window(len1_eff, 1536, 1024)

    def test_ring_window_past_int32(self):
        with pytest.raises(SuperblockViolation):
            contracts.check_ring_window(-(2**31) + 100, 1536, 1024)

    def test_tile_split_covers_every_width(self):
        for l2p in range(128, 12288 + 1, 128):
            contracts.check_launch_group((l2p,), 128, l2p, None)

    def test_bad_widths_rejected(self):
        with pytest.raises(SuperblockViolation):
            contracts.check_launch_group((100,), 128, 100, None)
        with pytest.raises(SuperblockViolation):
            contracts.check_launch_group((128,), 200, 128, None)

    def test_serve_block_contract(self):
        from mpi_openmp_cuda_tpu_torch.serve.batcher import SuperBlock

        def block(sizes):
            codes = [np.ones(n, dtype=np.int8) for n in sizes]
            return SuperBlock([1, 1, 1, 1], np.ones(10, np.int8), codes,
                              [None] * len(codes), len(codes))

        contracts.check_serve_block(block([100] * 64), 64)
        with pytest.raises(SuperblockViolation):
            contracts.check_serve_block(block([100] * 63), 64)
        with pytest.raises(SuperblockViolation):
            contracts.check_serve_block(block([100] * 63 + [300]), 64)

    @pytest.mark.parametrize("over,exc", [
        (dict(len1=200), OperandViolation),
        (dict(lens=[3, 200]), OperandViolation),
        (dict(seq1ext=np.zeros(10, np.int32)), OperandViolation),
        (dict(l2s=8, lens=[3, 5], rows=np.zeros((2, 128), np.int32), max_scored=5),
         None),
    ])
    def test_operand_contract(self, over, exc):
        if "lens" in over and "rows" not in over:
            seq1ext, rows, _ = _launch(rows=2)
            over = dict(over, lens=np.asarray(over["lens"], np.int32), rows=rows,
                        seq1ext=seq1ext)
        if "lens" in over:
            over["lens"] = np.asarray(over["lens"], np.int32)
        if exc is None:
            _validate(**over)
        else:
            with pytest.raises(exc):
                _validate(**over)


# --------------------------------------------------------------------------
# The shared-memory audit: the whole chooser space inside the budget.
# --------------------------------------------------------------------------


class TestSmemAudit:
    def test_exhaustive_sweep_is_clean(self):
        n, worst = smem.audit_chooser_space()
        assert n == 240  # 16 + 80 widths x 2 kernels, 4 classes x 2, twice for serve
        assert worst.headroom_bytes >= 0
        assert worst.kernel == "fused_tile" and worst.l2p == 12288
        assert "KiB" in worst.describe()

    def test_tiny_budget_reports_offenders(self):
        with pytest.raises(SmemBudgetError) as ei:
            smem.audit_chooser_space(budget=8 * 1024)
        msg = str(ei.value)
        assert "exceed" in msg and "L2P=" in msg and "tile_shape" in msg

    def test_known_pressure_config_rejected(self):
        # Past L2P 84,224 a tile block outgrows the H100's 227 KB.
        assert smem.max_fused_l2p() == 84224
        smem.check_launch(84224, None)
        with pytest.raises(SmemBudgetError):
            smem.check_launch(84352, None)

    def test_ring_widths_past_the_cap_are_swept(self):
        kinds = {e.kind for e in smem.iter_chooser_space()}
        assert kinds == {"fused", "ring", "packed", "serve"}
        assert max(e.l2p for e in smem.iter_chooser_space()) == smem.MAX_L2P_RING

    def test_estimate_matches_the_launch_arithmetic(self):
        # csrc/fused_kernels.cuh::tile_shape: 52,528 B at L2P 12288,
        # 26,928 B at the Seq2 cap's bucket (2 x 8 segments).
        assert smem.fused_tile_shape(12288).smem == 52528
        shape = smem.fused_tile_shape(2048)
        assert (shape.nblk, shape.nseg, shape.smem) == (2, 8, 26928)
        smem_128 = 4 * (732 + 176 + 4 * 9 * 32) + 128 + 176
        assert smem.fused_tile_shape(128) == smem.TileShape(4, 1, 4, 176, smem_128)
        packed = smem.estimate_packed(32)[0]
        assert packed.static_bytes == 4 * 732 + 4 * 4 * 32 + 128 + 32
        assert packed.threads == 128 and packed.dynamic_bytes == 0

    def test_opt_in_threshold(self):
        assert not smem.estimate_fused(2048)[0].opt_in
        assert smem.estimate_fused(12288)[0].opt_in
        assert smem.DEFAULT_SMEM == cuda_scorer.DEFAULT_SMEM

    def test_budget_off_the_card_is_the_h100s(self):
        assert smem.card_budget(None) == smem.card_budget("cpu") == 232448

    def test_attributes_held_against_the_model(self):
        attrs = {"fused_tile": {"registers": 56, "static_bytes": 0, "max_threads": 256},
                 "fused_finish": {"registers": 40, "static_bytes": 2976, "max_threads": 128}}
        for c in smem.PACK_CLASSES:
            attrs[f"packed_tile_{c}"] = {"registers": 40, "max_threads": 128,
                                         "static_bytes": smem.packed_static_bytes(c)}
            attrs[f"packed_finish_{c}"] = {"registers": 31 if c == 64 else 32,
                                           "static_bytes": 2916, "max_threads": 256}
        rows = smem.audit_attributes(attrs)
        assert len(rows) == 10
        assert {r["kernel"]: r["register_cap"] for r in rows}["fused_tile"] == 128
        assert {r["kernel"]: r["register_cap"] for r in rows}["packed_tile_8"] == 42
        drift = dict(attrs, fused_tile={"registers": 64, "static_bytes": 0, "max_threads": 256})
        with pytest.raises(SmemBudgetError, match="fused_tile: 64 registers"):
            smem.audit_attributes(drift)
        spill = dict(attrs, packed_tile_8={"registers": 48, "static_bytes": 3192,
                                           "max_threads": 128})
        with pytest.raises(SmemBudgetError, match="launch-bounds cap 42"):
            smem.audit_attributes(spill)


# --------------------------------------------------------------------------
# Entry-point contracts: the plain versions at a tiny CPU size.
# --------------------------------------------------------------------------


class TestEntryContracts:
    def test_audit_entry_points_passes(self):
        rows = contracts.audit_entry_points()
        assert len(rows) == len(contracts.ENTRY_CONTRACTS) * 2
        assert all(r.endswith("OK") for r in rows)

    def test_contract_mismatch_is_reported(self, monkeypatch):
        bad = dataclasses.replace(contracts.ENTRY_CONTRACTS[0],
                                  out_shape=lambda b, l1p, l2p: (b, 99))
        monkeypatch.setattr(contracts, "ENTRY_CONTRACTS", (bad,))
        with pytest.raises(ContractViolation) as ei:
            contracts.audit_entry_points(buckets=((4, 128, 128),))
        assert "contract mismatch" in str(ei.value)

    def test_failing_entry_is_reported_with_its_bucket(self, monkeypatch):
        def boom(b, l1p, l2p):
            raise RuntimeError("nope")

        bad = dataclasses.replace(contracts.ENTRY_CONTRACTS[0], run=boom)
        monkeypatch.setattr(contracts, "ENTRY_CONTRACTS", (bad,))
        with pytest.raises(ContractViolation, match="b=4, l1p=128"):
            contracts.audit_entry_points(buckets=((4, 128, 128),))


class TestCheckedOperands:
    """The checkified body's facts, checked on the host arrays."""

    def test_clean_inputs_pass(self):
        _validate()

    def test_alphabet_violation_caught(self):
        with pytest.raises(OperandViolation, match="alphabet"):
            _validate(code=31)

    def test_negative_code_caught(self):
        with pytest.raises(OperandViolation, match="alphabet"):
            _validate(code=-1)


# --------------------------------------------------------------------------
# Env registry (SEQ002).
# --------------------------------------------------------------------------


class TestEnvRegistry:
    def test_typed_accessors(self, monkeypatch):
        from mpi_openmp_cuda_tpu_torch.utils.env import env_flag, env_int, env_str

        monkeypatch.setenv("TPU_SEQALIGN_STREAM_DEPTH", "9")
        assert env_int("TPU_SEQALIGN_STREAM_DEPTH", 4) == 9
        monkeypatch.delenv("TPU_SEQALIGN_STREAM_DEPTH", raising=False)
        assert env_int("TPU_SEQALIGN_STREAM_DEPTH", 4) == 4
        monkeypatch.setenv("SEQALIGN_FAULTS", "site:fail=1")
        assert env_str("SEQALIGN_FAULTS") == "site:fail=1"
        for raw, want in (("1", True), ("off", False), ("YES", True)):
            monkeypatch.setenv("SEQALIGN_CHECK", raw)
            assert env_flag("SEQALIGN_CHECK") is want

    def test_uniform_parse_errors(self, monkeypatch):
        from mpi_openmp_cuda_tpu_torch.utils.env import env_flag, env_int

        monkeypatch.setenv("SEQALIGN_FAULT_RETRIES", "three")
        with pytest.raises(ValueError, match="must be a number"):
            env_int("SEQALIGN_FAULT_RETRIES")
        monkeypatch.setenv("SEQALIGN_CHECK", "maybe")
        with pytest.raises(ValueError, match="boolean flag"):
            env_flag("SEQALIGN_CHECK")

    def test_undeclared_var_rejected(self):
        from mpi_openmp_cuda_tpu_torch.utils.env import env_int, env_str

        with pytest.raises(KeyError, match="utils/env.py"):
            env_str("SEQALIGN_NOT_A_KNOB")
        with pytest.raises(KeyError, match="utils/env.py"):
            env_int("SEQALIGN_FAULTS")  # declared, as the wrong kind

    def test_registry_docs_complete(self):
        from mpi_openmp_cuda_tpu_torch.utils.env import ENV_VARS

        assert len(ENV_VARS) >= 10
        for var in ENV_VARS:
            assert var.doc, f"{var.name} has no doc line"
            assert var.kind in ("str", "int", "float", "flag")

    @pytest.mark.parametrize("name,kind", [
        ("SEQALIGN_CHECK", "flag"), ("BENCH_INPUT", "str"), ("BENCH_WEIGHTS", "str"),
        ("BENCH_BACKEND", "str"), ("BENCH_ATTEMPTS", "int"), ("BENCH_REPS", "int"),
        ("CUDA_HOME", "str"), ("CUDA_PATH", "str"),
    ])
    def test_the_cleared_reads_are_declared(self, name, kind):
        from mpi_openmp_cuda_tpu_torch.utils.env import ENV_VARS

        var = {v.name: v for v in ENV_VARS}[name]
        assert var.kind == kind and var.doc

    def test_nvcc_honours_cuda_home_through_the_registry(self, monkeypatch, tmp_path):
        from mpi_openmp_cuda_tpu_torch.ops import _build

        (tmp_path / "bin").mkdir()
        (tmp_path / "bin" / "nvcc").write_text("")
        monkeypatch.delenv("CUDA_HOME", raising=False)
        monkeypatch.setenv("CUDA_PATH", str(tmp_path))
        assert _build._nvcc() == str(tmp_path / "bin" / "nvcc")


# --------------------------------------------------------------------------
# The --check / SEQALIGN_CHECK dispatch hook.
# --------------------------------------------------------------------------


def _spy_launches(monkeypatch):
    """Count the wrapper calls the dispatch makes (the plain versions on
    the CPU; on a card each is a launch)."""
    calls = []
    real_f, real_p = dispatch.fused_scorer, dispatch.packed_scorer
    monkeypatch.setattr(dispatch, "fused_scorer",
                        lambda st, *done: calls.append("fused") or real_f(st, *done))
    monkeypatch.setattr(dispatch, "packed_scorer",
                        lambda st, c, *done: calls.append("packed") or real_p(st, c, *done))
    return calls


def _short_problem():
    rng = np.random.default_rng(7)
    seq1 = rng.integers(1, 27, size=300).astype(np.int8)
    seqs = [rng.integers(1, 27, size=n).astype(np.int8) for n in (5, 12, 30, 60) * 8]
    return seq1, seqs, [3, 2, 1, 4]


class TestDispatchCheckHook:
    def test_env_flag_resolution(self, monkeypatch):
        from mpi_openmp_cuda_tpu_torch.ops.dispatch import AlignmentScorer

        monkeypatch.delenv("SEQALIGN_CHECK", raising=False)
        assert AlignmentScorer(backend="oracle").check is False
        monkeypatch.setenv("SEQALIGN_CHECK", "1")
        assert AlignmentScorer(backend="oracle").check is True
        # An explicit argument beats the env var.
        assert AlignmentScorer(backend="oracle", check=False).check is False

    def test_cli_flag_parses(self):
        args = tcli.build_arg_parser().parse_args(["--check"])
        assert args.check is True
        assert tcli.build_arg_parser().parse_args([]).check is False

    def test_off_costs_no_validation(self, monkeypatch):
        from mpi_openmp_cuda_tpu_torch.analysis import contracts as c

        def boom(*a, **k):
            raise AssertionError("validated with the check off")

        monkeypatch.setattr(c, "validate_plans", boom)
        monkeypatch.setattr(c, "validate_sharded", boom)
        scorer = dispatch.AlignmentScorer("cuda", device="cpu", check=False)
        seq1, seqs, w = _short_problem()
        assert scorer.score_codes(seq1, seqs, w).shape == (len(seqs), 3)

    def test_on_validates_every_plan(self, monkeypatch):
        from mpi_openmp_cuda_tpu_torch.analysis import contracts as c

        seen = []
        real = c.validate_plans
        monkeypatch.setattr(c, "validate_plans",
                            lambda v, plans, *a: seen.append(len(plans)) or real(v, plans, *a))
        scorer = dispatch.AlignmentScorer("cuda", device="cpu", check=True)
        seq1, seqs, w = _short_problem()
        scorer.score_codes(seq1, seqs, w)
        assert seen == [len(dispatch.launch_plans(seq1, seqs, w)[1])]

    def test_seeded_broken_chooser_raises_before_any_launch(self, monkeypatch):
        calls = _spy_launches(monkeypatch)
        choose = dispatch.choose_rowpack
        monkeypatch.setattr(dispatch, "choose_rowpack",
                            lambda l2p, lens: 8 if choose(l2p, lens) else None)
        cuda_scorer.reset_launch_counts()
        scorer = dispatch.AlignmentScorer("cuda", device="cpu", check=True)
        seq1, seqs, w = _short_problem()
        with pytest.raises(RowpackViolation):
            scorer.score_codes(seq1, seqs, w)
        assert calls == []
        assert cuda_scorer.launch_counts == {"fused_scorer": 0, "packed_scorer": 0}

    def test_seeded_wide_group_key_raises_before_any_launch(self, monkeypatch):
        calls = _spy_launches(monkeypatch)
        plans = dispatch.launch_plans

        def wide(*a, **k):
            v, got = plans(*a, **k)
            return v, [dataclasses.replace(p, keys=p.keys + (p.batch.l2p + 128,))
                       if p.l2s is None else p for p in got]

        monkeypatch.setattr(dispatch, "launch_plans", wide)
        seq1, seqs, w = _short_problem()
        seqs = seqs + [np.full(200, 3, np.int8)] * 8
        with pytest.raises(SuperblockViolation):
            dispatch.AlignmentScorer("cuda", device="cpu", check=True).score_codes(
                seq1, seqs, w)
        assert calls == []

    def test_seeded_formulation_past_its_window(self, monkeypatch):
        calls = _spy_launches(monkeypatch)
        monkeypatch.setattr(dispatch, "effective_backend", lambda b, *a: b)
        seq1, seqs, _ = _short_problem()
        with pytest.raises(FeedViolation):
            dispatch.AlignmentScorer("cuda", device="cpu", check=True).score_codes(
                seq1, seqs, [20000000, 1, 1, 1])
        assert calls == []

    def test_codes_past_the_alphabet_through_the_scorer(self, monkeypatch):
        calls = _spy_launches(monkeypatch)
        seq1, seqs, w = _short_problem()
        with pytest.raises(OperandViolation):
            dispatch.AlignmentScorer("cuda", device="cpu", check=True).score_codes(
                seq1, [np.array([1, 2, 27], np.int8), *seqs], w)
        assert calls == []

    def test_ring_window_past_the_opt_in_limit(self):
        from mpi_openmp_cuda_tpu_torch.parallel.ring import RingSharding

        ring = RingSharding.over_devices(2, device="cpu", devices=["cpu", "cpu"])
        scorer = dispatch.AlignmentScorer("cuda", device="cpu", check=True, sharding=ring)
        rng = np.random.default_rng(3)
        with pytest.raises(SmemBudgetError):
            scorer.score_codes(rng.integers(1, 27, 86000).astype(np.int8),
                               [rng.integers(1, 27, 85000).astype(np.int8)], [1, 1, 1, 1])

    def test_prestaged_feed_is_validated(self, monkeypatch):
        choose = dispatch.choose_rowpack
        monkeypatch.setattr(dispatch, "choose_rowpack",
                            lambda l2p, lens: 8 if choose(l2p, lens) else None)
        seq1, seqs, w = _short_problem()
        with pytest.raises(RowpackViolation):
            dispatch.AlignmentScorer("cuda", device="cpu", check=True).prestage_codes(
                seq1, seqs, w)

    @pytest.mark.parametrize("mesh", ["batch:2", "seq:2", "2x2"])
    def test_meshes_pass_and_match(self, mesh):
        from mpi_openmp_cuda_tpu_torch.parallel.specs import build_sharding

        seq1, seqs, w = _short_problem()
        os.environ["SEQALIGN_HOST_DEVICES"] = "4"
        try:
            sharding = build_sharding(mesh, device="cpu")
        finally:
            os.environ.pop("SEQALIGN_HOST_DEVICES")
        plain = dispatch.AlignmentScorer("cuda", device="cpu").score_codes(seq1, seqs, w)
        checked = dispatch.AlignmentScorer("cuda", device="cpu", check=True,
                                           sharding=sharding).score_codes(seq1, seqs, w)
        assert np.array_equal(plain, checked)

    def test_prewarm_entry_is_validated(self, monkeypatch):
        from mpi_openmp_cuda_tpu_torch.aot import compile as aot_compile
        from mpi_openmp_cuda_tpu_torch.aot.warmset import WarmEntry

        from mpi_openmp_cuda_tpu_torch.aot import prewarm as aot_prewarm

        entry = WarmEntry("cuda-packed", 128, 8, 4, 256)
        aot_compile.validate_entry(entry, "cpu")
        monkeypatch.setattr(dispatch, "effective_backend", lambda b, *a: "mm")
        with pytest.raises(FeedViolation):
            aot_compile.validate_entry(entry, "cpu")
        # Through the prewarm: a violation raises, never a cold entry.
        monkeypatch.setattr(aot_prewarm, "select_warmset", lambda *a, **k: [entry])
        with pytest.raises(FeedViolation):
            aot_prewarm.prewarm(problem=object(), backend="cuda", device="cpu",
                                manifest_path=None, check=True)

    def test_serve_loop_checks_its_blocks(self, monkeypatch):
        from mpi_openmp_cuda_tpu_torch.io.pipeline import ChunkPipeline
        from mpi_openmp_cuda_tpu_torch.resilience.degrade import BackendDegrader
        from mpi_openmp_cuda_tpu_torch.resilience.policy import RetryPolicy
        from mpi_openmp_cuda_tpu_torch.serve.loop import ServeLoop

        for check in (False, True):
            deg = BackendDegrader(dispatch.AlignmentScorer("cuda", device="cpu", check=check),
                                  lambda b: dispatch.AlignmentScorer(b, device="cpu"))
            loop = ServeLoop(ChunkPipeline(RetryPolicy(), deg), RetryPolicy())
            assert loop.check is check


# --------------------------------------------------------------------------
# The CLI against the JAX CLI's --check.
# --------------------------------------------------------------------------


def _port(argv, capfd, env=None, monkeypatch=None):
    if env:
        for k, v in env.items():
            monkeypatch.setenv(k, v)
    rc = tcli.run(list(argv))
    cap = capfd.readouterr()
    return rc, cap.out, cap.err


def _seeded_batch(tmp_path) -> Path:
    """Every packed class (>= 8 rows each) and a multi-bucket fused group."""
    rng = np.random.default_rng(2024)
    letters = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"))
    seq1 = "".join(rng.choice(letters, 700))
    sizes = [n for lo, hi in ((3, 8), (9, 16), (17, 32), (33, 64), (100, 128),
                              (129, 256), (257, 384)) for n in rng.integers(lo, hi + 1, 8)]
    rows = ["".join(rng.choice(letters, n)) for n in sizes]
    path = tmp_path / "seeded.txt"
    path.write_text(f"3 -2 1 5\n{seq1}\n{len(rows)}\n" + "\n".join(rows) + "\n")
    return path


class TestCliAgainstJax:
    @pytest.mark.parametrize("path", FIXTURES, ids=IDS)
    def test_fixture_check_matches_golden_and_jax(self, path, capfd, monkeypatch):
        rc, out, err = _port(["--check", "--device", "cpu", "--input", str(path)], capfd)
        assert rc == 0, err
        assert out == path.with_suffix(".out").read_text()
        rc, env_out, err = _port(["--device", "cpu", "--input", str(path)], capfd,
                                 {"SEQALIGN_CHECK": "1"}, monkeypatch)
        assert rc == 0 and env_out == out, err
        jax_out, _ = run_cli_inproc("--check", "--input", str(path), capsys=capfd)
        assert jax_out == out

    def test_seeded_batch_matches_jax_and_the_oracle(self, tmp_path, capfd):
        path = _seeded_batch(tmp_path)
        prob = tcli.load_problem(str(path))
        _, plans = dispatch.launch_plans(prob.seq1_codes, prob.seq2_codes, prob.weights)
        assert {p.l2s for p in plans} >= {8, 16, 32, 64}
        assert any(p.l2s is None and len(p.keys) > 1 for p in plans)
        rc, out, err = _port(["--check", "--device", "cpu", "--input", str(path)], capfd)
        assert rc == 0, err
        rc, oracle, _ = _port(["--backend", "oracle", "--input", str(path)], capfd)
        assert rc == 0 and out == oracle
        jax_out, _ = run_cli_inproc("--check", "--input", str(path), capsys=capfd)
        assert jax_out == out

    @pytest.mark.parametrize("extra", [[], ["--retries", "2"], ["--retries", "1", "--degrade"]],
                             ids=["plain", "retries", "degrade"])
    def test_seeded_violation_exit_matches_the_jax_cli(self, extra, capfd, monkeypatch):
        # The JAX CLI's own seeded violation (its pallas rowpack gate), and
        # the port's (its packed-class gate): the same exit code, the same
        # stderr lines but for the program name and the violation's text.
        from mpi_openmp_cuda_tpu.io import cli as jcli
        from mpi_openmp_cuda_tpu.ops import dispatch as jdispatch

        monkeypatch.setenv("SEQALIGN_BACKOFF_BASE", "0")
        tiny = str(REPO / "tests" / "fixtures" / "tiny.txt")
        monkeypatch.setattr(jdispatch, "choose_rowpack", lambda *a, **k: 24)
        jrc = jcli.run(["--backend", "pallas", "--check", "--input", tiny, *extra])
        jcap = capfd.readouterr()
        monkeypatch.setattr(dispatch, "choose_rowpack", lambda *a, **k: 24)
        rc = tcli.run(["--check", "--device", "cpu", "--input", tiny, *extra])
        cap = capfd.readouterr()

        def shape(err, prog):
            out = []
            for line in err.strip().splitlines():
                assert line.startswith(prog + ": "), line
                head = line[len(prog) + 2:]
                out.append(head.split(" (")[0])
            return out

        assert rc == jrc == (0 if "--degrade" in extra else 65)
        assert cap.out == jcap.out
        jshape = shape(jcap.err, "mpi_openmp_cuda_tpu")
        tshape = shape(cap.err, "mpi_openmp_cuda_tpu_torch")
        assert len(tshape) == len(jshape)
        for t, j in zip(tshape, jshape):
            assert t == j.replace("'pallas'", "'cuda'").replace("'xla'", "'mm'"), (t, j)
        if "--degrade" not in extra:
            assert tshape[-1].startswith("error: scoring: retry budget exhausted")
            assert "rowpack class l2s=24" in cap.err


# --------------------------------------------------------------------------
# SIGUSR2: the dump never takes the recorder's lock on the interrupted
# thread.
# --------------------------------------------------------------------------


_USR2_SCRIPT = r"""
import os, signal, sys, time
sys.path.insert(0, sys.argv[1])
from mpi_openmp_cuda_tpu_torch import obs
from mpi_openmp_cuda_tpu_torch.io import cli
from mpi_openmp_cuda_tpu_torch.obs import events, flightrec

obs.arm_observability(flightrec_depth=8)
events.publish("retry.attempt")
rec = flightrec.active_flightrec()
cli._usr2 = cli._Usr2Dumper()
signal.signal(signal.SIGUSR2, cli._sigusr2_dump)
with rec._lock:  # the main thread inside record_event's critical section
    os.kill(os.getpid(), signal.SIGUSR2)
    time.sleep(0.2)  # the handler has run by now, with the lock held
events.publish("retry.attempt")  # record_event takes the lock again
cli._usr2.stop()
cli._usr2 = None
obs.disarm_observability()
print(rec.dump_paths)
"""


def test_sigusr2_while_the_recorder_lock_is_held(tmp_path):
    env = dict(os.environ, SEQALIGN_CACHE_DIR=str(tmp_path / "cache"))
    env.pop("TPU_SEQALIGN_COMPILE_CACHE", None)
    proc = subprocess.run(
        [sys.executable, "-c", _USR2_SCRIPT, str(REPO)], env=env, capture_output=True,
        text=True, timeout=60,
    )
    assert proc.returncode == 0, proc.stderr
    (dump,) = (tmp_path / "cache" / "flightrec").glob("*-sigusr2.json")
    rec = json.loads(dump.read_text())
    assert rec["reason"] == "sigusr2" and rec["events"][0]["name"] == "retry.attempt"


def test_sigusr2_dumper_drains_pending_requests_on_stop(tmp_path, monkeypatch):
    from mpi_openmp_cuda_tpu_torch import obs

    monkeypatch.setenv("SEQALIGN_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("TPU_SEQALIGN_COMPILE_CACHE", raising=False)
    obs.arm_observability(flightrec_depth=4)
    try:
        dumper = tcli._Usr2Dumper()
        monkeypatch.setattr(tcli, "_usr2", dumper)
        assert tcli._sigusr2_dump(signal.SIGUSR2, None) is None
        dumper.stop()
        assert not dumper._thread.is_alive()
    finally:
        obs.disarm_observability()
    assert len(list((tmp_path / "flightrec").glob("*-sigusr2.json"))) == 1
