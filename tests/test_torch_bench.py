"""The port's bench harness (``mpi_openmp_cuda_tpu_torch/bench.py``)
against the JAX package's root ``bench.py``: the same workload and cost
model, records that both packages' validators read, the probe-gated
attempt protocol's branches (the fakes of ``tests/test_bench.py``), the
work counts of ``ops/costs.py``, and the command line on the CPU."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import bench as jbench  # noqa: E402  (the JAX package's harness)
from mpi_openmp_cuda_tpu.models import workload as jworkload  # noqa: E402
from mpi_openmp_cuda_tpu.obs import metrics as jmetrics  # noqa: E402
from mpi_openmp_cuda_tpu_torch import bench as tbench  # noqa: E402
from mpi_openmp_cuda_tpu_torch.io.parse import load_problem  # noqa: E402
from mpi_openmp_cuda_tpu_torch.models import workload as tworkload  # noqa: E402
from mpi_openmp_cuda_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from mpi_openmp_cuda_tpu_torch.ops import costs  # noqa: E402
from mpi_openmp_cuda_tpu_torch.ops import schedule as tschedule  # noqa: E402
from mpi_openmp_cuda_tpu_torch.ops.dispatch import bucket_launches  # noqa: E402

Attempt = tbench.Attempt
FIXTURES = sorted((REPO / "tests" / "fixtures").glob("*.txt"), key=lambda p: p.name)
IDS = [p.stem for p in FIXTURES]
RATE_FIELDS = ("gelems", "tflops", "tops", "floor", "wall_vs", "bound", "device_wall")


def test_input3_class_problem_is_byte_equal_to_jax():
    got, want = tworkload.input3_class_problem(), jworkload.input3_class_problem()
    assert got.weights == want.weights == [2, 2, 1, 10]
    assert got.seq1 == want.seq1 and got.seq2 == want.seq2
    assert got.seq1_codes.tobytes() == want.seq1_codes.tobytes()
    assert [c.tobytes() for c in got.seq2_codes] == [c.tobytes() for c in want.seq2_codes]
    assert (tworkload.INPUT3_CLASS_NAME, tworkload.INPUT3_CLASS_LEN1) == (
        jworkload.INPUT3_CLASS_NAME, jworkload.INPUT3_CLASS_LEN1)


def test_synthetic_codes_draw_the_max_size_problem():
    """The max-size workload as ``scripts/bench_table.py::synthetic_max``
    and ``scripts/kernel_ablate.py --synthetic 3000x64x1200-1999`` draw it."""
    seq1, seqs = tworkload.synthetic_codes(*tworkload.MAX_SIZE)
    rng = np.random.default_rng(7)
    assert seq1.tobytes() == rng.integers(1, 27, size=3000).astype(np.int8).tobytes()
    lens = rng.integers(1200, 2000, size=64)
    assert [s.size for s in seqs] == lens.tolist()
    assert seqs[5].tobytes() == [rng.integers(1, 27, size=int(n)) for n in lens][5].astype(
        np.int8).tobytes()


@pytest.mark.parametrize("path", FIXTURES, ids=IDS)
def test_brute_force_elements_matches_root_bench(path):
    prob = load_problem(str(path))
    sizes = [c.size for c in prob.seq2_codes]
    assert tbench.brute_force_elements(prob.seq1_codes.size, sizes) == (
        jbench.brute_force_elements(prob.seq1_codes.size, sizes))


def test_brute_force_elements_on_input3_class():
    prob = tworkload.input3_class_problem()
    sizes = [c.size for c in prob.seq2_codes]
    got = tbench.brute_force_elements(prob.seq1_codes.size, sizes)
    assert got == jbench.brute_force_elements(prob.seq1_codes.size, sizes) > 0


def _record(**extra):
    return tmetrics.wrap_report("bench", {
        "metric": "equivalent brute-force char comparisons/s/chip, x",
        "value": 1.5e12, "unit": "elements/s/chip", "device": "NVIDIA H100 80GB HBM3",
        "floor_us": 12.5, **extra,
    })


def test_record_validates_under_both_packages():
    rec = _record()
    assert rec["schema"] == jmetrics.RUN_REPORT_SCHEMA == tmetrics.RUN_REPORT_SCHEMA
    assert tmetrics.RUN_REPORT_VERSION == jmetrics.RUN_REPORT_VERSION
    tmetrics.validate_report(rec)
    jmetrics.validate_report(rec)
    tmetrics.validate_report(json.loads(json.dumps(rec)))


@pytest.mark.parametrize(
    "broken",
    [
        {"value": None, "__drop": "value"},
        {"__drop": "metric"},
        {"schema": "other.schema"},
        {"schema_version": 0},
        {"kind": ""},
    ],
    ids=["no-value", "no-metric", "schema", "version", "kind"],
)
def test_broken_record_fails_both_validators(broken):
    rec = _record()
    drop = broken.pop("__drop", None)
    rec.update(broken)
    if drop:
        del rec[drop]
    for validate in (tmetrics.validate_report, jmetrics.validate_report):
        with pytest.raises(ValueError, match="invalid run report"):
            validate(rec)
    with pytest.raises(ValueError, match="JSON object"):
        tmetrics.validate_report([rec])


@pytest.mark.parametrize("backend", ["cuda", "oracle"])
def test_bench_cpu_prints_one_line_without_rate_fields(backend):
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_INPUT=str(REPO / "tests" / "fixtures" / "stress_small.txt"),
               BENCH_REPS="1", BENCH_BACKEND=backend)
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_openmp_cuda_tpu_torch.bench", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr
    lines = [line for line in proc.stdout.splitlines() if line.strip()]
    assert len(lines) == 1, lines
    rec = json.loads(lines[0])
    tmetrics.validate_report(rec)
    jmetrics.validate_report(rec)
    assert rec["kind"] == "bench" and rec["device"] == "cpu"
    assert rec["value"] is None
    assert rec["formulation"] == ("plain" if backend == "cuda" else "oracle")
    assert "stress_small.txt" in rec["metric"] and rec["unit"] == "elements/s/chip"
    assert not [k for k in rec if any(f in k for f in RATE_FIELDS)], rec
    assert "power_limit_w" not in rec and "probe_gated" not in rec
    stress = load_problem(str(REPO / "tests" / "fixtures" / "stress_small.txt"))
    want = len(tschedule.production_schedule(stress, "cpu")) if backend == "cuda" else 0
    assert rec["launches"] == want
    assert rec["kernel_launches"] == {"fused_scorer": 0, "packed_scorer": 0, "issue_probe": 0}
    assert rec["cold_start_s"] >= rec["e2e_first_run_s"] > 0


def test_bench_without_card_exits_nonzero_with_message():
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_openmp_cuda_tpu_torch.bench"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120,
    )
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr and "--device cpu" in proc.stderr


def test_bench_weights_override(monkeypatch):
    """BENCH_WEIGHTS overrides the workload's weights with the stdin
    contract's validation, as the root bench does."""
    monkeypatch.setenv("BENCH_INPUT", str(REPO / "tests" / "fixtures" / "stress_small.txt"))
    monkeypatch.setenv("BENCH_WEIGHTS", "300,7,1,2")
    problem, name = tbench.load_workload()
    jproblem, jname = jbench.load_workload()
    assert problem.weights == jproblem.weights == [300, 7, 1, 2]
    assert name == jname == "stress_small.txt+w=300,7,1,2"
    assert [c.tobytes() for c in problem.seq2_codes] == [
        c.tobytes() for c in jproblem.seq2_codes]
    monkeypatch.delenv("BENCH_INPUT")
    problem, name = tbench.load_workload()
    assert name == "synthetic-input3-class+w=300,7,1,2"
    assert problem.weights == [300, 7, 1, 2]
    monkeypatch.setenv("BENCH_WEIGHTS", "300,7,1")
    with pytest.raises(ValueError, match="4 weights"):
        tbench.load_workload()
    monkeypatch.setenv("BENCH_WEIGHTS", "3000000000,1,1,1")
    with pytest.raises(ValueError, match="32-bit"):
        tbench.load_workload()


def test_pick_backend(monkeypatch):
    monkeypatch.delenv("BENCH_BACKEND", raising=False)
    assert tbench.pick_backend() == "cuda"
    monkeypatch.setenv("BENCH_BACKEND", "oracle")
    assert tbench.pick_backend() == "oracle"
    monkeypatch.setenv("BENCH_BACKEND", "pallas")
    with pytest.raises(ValueError, match="cuda or oracle"):
        tbench.pick_backend()


def test_gemm_probe_and_gate_refuse_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA device"):
        tbench.gemm_probe_tflops("bf16", "cpu")
    assert tbench.probe_gate(torch.device("cpu")) == (False, None, None)


# ---------------------------------------------------------------------------
# The attempt protocol, off the card (the fakes of tests/test_bench.py).
# ---------------------------------------------------------------------------

GATE = 180.0


class Seq:
    """Deterministic probe/measure fake reading from a value sequence."""

    def __init__(self, values):
        self.values = list(values)

    def __call__(self):
        return self.values.pop(0)


def test_attempts_gated_first_try_stops_immediately():
    sleeps = []
    attempts = tbench.run_attempts(
        Seq([1e-4]), Seq([200.0, 199.0]), gate=GATE, max_attempts=12,
        sleep=sleeps.append,
    )
    assert attempts == [Attempt(1e-4, 200.0, 199.0)] and sleeps == []
    chosen, gated = tbench.select_attempt(attempts, GATE)
    assert gated and chosen is attempts[0]


def test_attempts_gated_late_with_exponential_backoff():
    sleeps = []
    attempts = tbench.run_attempts(
        Seq([2e-4, 2e-4, 1.6e-4]), Seq([120.0, 130.0, 150.0, 140.0, 195.0, 188.0]),
        gate=GATE, max_attempts=12, sleep=sleeps.append,
    )
    assert len(attempts) == 3 and sleeps == [5.0, 10.0]
    chosen, gated = tbench.select_attempt(attempts, GATE)
    assert gated and chosen.wall == 1.6e-4 and chosen.pmin == 188.0


def test_attempts_backoff_caps_at_60s():
    n = 8
    sleeps = []
    attempts = tbench.run_attempts(
        Seq([1e-4] * n), Seq([100.0] * (2 * n)), gate=GATE, max_attempts=n,
        sleep=sleeps.append,
    )
    assert len(attempts) == n
    assert sleeps == [5.0, 10.0, 20.0, 40.0, 60.0, 60.0, 60.0]


def test_never_gated_selects_closest_to_quiet_not_min_wall():
    walls = [1.58e-4, 1.60e-4, 1.56e-4, 1.61e-4, 1.28e-4]
    probes = [293, 137, 134, 206, 137, 134, 133, 173, 189, 141]
    sleeps = []
    attempts = tbench.run_attempts(
        Seq(walls), Seq([float(p) for p in probes]), gate=GATE, max_attempts=5,
        sleep=sleeps.append,
    )
    assert len(attempts) == 5 and len(sleeps) == 4
    chosen, gated = tbench.select_attempt(attempts, GATE)
    assert not gated and chosen.pmin == 141.0
    shuffled = [Attempt(1.28e-4, 140.0, 137.0), Attempt(1.60e-4, 170.0, 171.0),
                Attempt(1.55e-4, 150.0, 150.0)]
    chosen, gated = tbench.select_attempt(shuffled, GATE)
    assert not gated and chosen.wall == 1.60e-4 and chosen.pmin == 170.0


def test_mid_measurement_burst_is_not_gated():
    a = Attempt(1e-4, 200.0, 120.0)
    assert a.pmin == 120.0
    assert tbench.select_attempt([a], GATE)[1] is False


def test_probe_failure_breaks_loop_and_labels_record():
    sleeps = []
    attempts = tbench.run_attempts(
        Seq([1e-4, 1e-4]), Seq([None, None]), gate=GATE, max_attempts=12,
        sleep=sleeps.append,
    )
    assert len(attempts) == 1 and sleeps == []
    chosen, gated = tbench.select_attempt(attempts, GATE)
    assert not gated and chosen.pmin is None
    rec, warn = tbench.probe_record_fields(chosen, gated, GATE, 700.0, True, 1)
    assert rec == {"probe_failed": True} and warn is None


def test_half_failed_probe_attempt_keeps_looping():
    attempts = tbench.run_attempts(
        Seq([1e-4, 1e-4]), Seq([200.0, None, 195.0, 199.0]), gate=GATE,
        max_attempts=12, sleep=lambda s: None,
    )
    assert len(attempts) == 2
    assert attempts[0].pmin is None and attempts[1].pmin == 195.0


def test_median_wall_fallback_when_no_probes_usable():
    attempts = [Attempt(3e-4, None, None), Attempt(1e-4, None, None),
                Attempt(2e-4, 150.0, None)]
    chosen, gated = tbench.select_attempt(attempts, GATE)
    assert not gated and chosen.wall == 2e-4


def test_ungated_card_single_attempt_no_probe_fields():
    attempts = tbench.run_attempts(Seq([1e-4]), None, gate=None, max_attempts=12)
    assert attempts == [Attempt(1e-4, None, None)]
    chosen, gated = tbench.select_attempt(attempts, None)
    assert not gated
    assert tbench.probe_record_fields(chosen, gated, None, None, False, 1) == ({}, None)


def test_gated_pool_prefers_fastest_gated_wall():
    attempts = [Attempt(1.2e-4, 130.0, 130.0), Attempt(1.6e-4, 195.0, 190.0),
                Attempt(1.5e-4, 185.0, 186.0)]
    chosen, gated = tbench.select_attempt(attempts, GATE)
    assert gated and chosen.wall == 1.5e-4


def test_gated_record_fields():
    rec, warn = tbench.probe_record_fields(
        Attempt(1.5e-4, 195.0, 185.0), True, GATE, 197.0, True, 1)
    assert rec == {"gemm_probe_bf16_tflops": 185.0, "probe_quiet_ref_tflops": 197.0,
                   "probe_gated": True}
    assert warn is None


def test_ungated_record_carries_no_quiet_band_estimate():
    rec, warn = tbench.probe_record_fields(
        Attempt(1.6e-4, 140.0, 137.0), False, GATE, 197.0, True, 12)
    assert rec == {"gemm_probe_bf16_tflops": 137.0, "probe_quiet_ref_tflops": 197.0,
                   "probe_gated": False}
    assert not [k for k in rec if "band" in k or "normalized" in k]
    assert warn and "closest-to-quiet" in warn


def test_probe_gate_reads_the_card_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "Card X")
    monkeypatch.setitem(tbench.QUIET_BF16_BY_KIND, "Card X", 600.0)
    on_card, ref, gate = tbench.probe_gate(torch.device("cuda"))
    assert on_card and ref == 600.0 and gate == pytest.approx(600.0 * tbench.PROBE_GATE_FRACTION)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "Card Y")
    assert tbench.probe_gate(torch.device("cuda")) == (True, None, None)


# ---------------------------------------------------------------------------
# Work counts and the floor.
# ---------------------------------------------------------------------------


def _old_chip_smoke_counts(state):
    """The per-launch counts as chip_smoke.py once kept them itself: bytes,
    and the 3 int ops and 1 lookup the function needs per needed cell."""
    nbytes = 4 * (state.seq1ext.numel() + state.rows.numel() + state.lens.numel()
                  + state.val.numel() + 4 * state.rows.shape[0])
    len1 = state.len1
    cells = sum(max(len1 - int(n), 0) * int(n) for n in state.lens.tolist()
                if 0 < int(n) < len1)
    return nbytes, 3 * cells, cells


@pytest.mark.parametrize("path", FIXTURES, ids=IDS)
def test_schedule_counts_equal_old_per_launch_sums(path):
    prob = load_problem(str(path))
    launches = bucket_launches(prob.seq1_codes, prob.seq2_codes, prob.weights,
                               torch.device("cpu"))
    got = costs.schedule_counts(launches)
    old = [_old_chip_smoke_counts(b.state) for b in launches]
    assert (got.bytes, got.int_ops, got.lookups) == tuple(
        sum(c[i] for c in old) for i in range(3))
    assert got.int_ops == 3 * got.cells and got.lookups == got.cells
    assert (costs.INT_OPS_PER_CELL, costs.LOOKUPS_PER_CELL) == (3, 1)


def test_bound_and_floor_terms():
    prob = tworkload.input3_class_problem()
    launches = bucket_launches(prob.seq1_codes, prob.seq2_codes, prob.weights,
                               torch.device("cpu"))
    counts = costs.schedule_counts(launches)
    assert counts.cells == costs.needed_cells(
        prob.seq1_codes.size, [c.size for c in prob.seq2_codes])
    ms = sum(costs.bound_ms(b.state)[0] for b in launches)
    assert ms == pytest.approx(3 * counts.cells / costs.INT32_OPS_PER_S * 1e3)
    assert costs.bound_ms(launches[0].state)[1:] == ("operations", "int ops")
    rates = {"arith": costs.INT32_OPS_PER_S / 2, "lookup": costs.SMEM_WORDS_PER_S / 8}
    rec = tbench.floor_fields(counts, rates, wall_s=1e-3)
    assert rec["floor_by"] == "lookups"
    assert rec["floor_us"] == pytest.approx(counts.lookups / rates["lookup"] * 1e6)
    assert rec["wall_vs_floor"] == pytest.approx(1e-3 / (rec["floor_us"] / 1e6))
    sp = tbench.floor_fields(counts, rates, 2e-3, "_single_program")
    assert set(sp) == {"floor_us_single_program", "floor_by_single_program",
                       "wall_vs_floor_single_program"}
    assert costs.PEAK_PER_S == {"fma": 132 * 128 * 1.98e9, "arith": 132 * 64 * 1.98e9,
                                "lookup": 132 * 32 * 1.98e9}


def test_single_program_pads_the_whole_batch():
    prob = tworkload.input3_class_problem()
    st = tbench.single_program(prob, torch.device("cpu"))
    assert st.rows.shape == (32, 1152) and st.len1 == 1489
    assert costs.state_counts(st).cells == costs.needed_cells(
        1489, [c.size for c in prob.seq2_codes])
