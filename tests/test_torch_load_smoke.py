"""``scripts/torch_load_smoke.py`` (the port's counterpart of
``scripts/load_smoke.py``), phase by phase in this process at small
counts: its ``--small`` schedules are the JAX script's, its card profile
is sized by duration with no rate clamp, a captured schedule reloads
unchanged, a 5x phase against a port server survives answered-or-typed,
its ``serve-load`` record validates and the refit prices the trace's gap
rows.  The whole drill's b2 < b1 p99 gate is one timing comparison: it
runs on the card (``chip_smoke.py`` phase 22), not here."""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import load_smoke as jls  # noqa: E402  (the JAX package's drill)
import torch_load_smoke as tls  # noqa: E402

from mpi_openmp_cuda_tpu.load import arrival as jarrival  # noqa: E402
from mpi_openmp_cuda_tpu.load import replay as jreplay  # noqa: E402
from mpi_openmp_cuda_tpu.load import workload as jworkload  # noqa: E402
from mpi_openmp_cuda_tpu_torch.load import gates, refit, replay  # noqa: E402
from mpi_openmp_cuda_tpu_torch.load.report import serve_load_record  # noqa: E402
from mpi_openmp_cuda_tpu_torch.obs.metrics import validate_report  # noqa: E402

SCRIPT = REPO / "scripts" / "torch_load_smoke.py"
# A 5x phase small enough for the plain versions on the CPU.
TINY = dataclasses.replace(tls.SMALL, workload=dict(problem_keys=2, pairs_per_request=(2, 4),
                                                    seq1_len=64),
                           len_mix=((4, 60, 1.0),), clients=4)


def jax_schedule(process, n, rate, seed, prefix, **kw):
    times = jarrival.arrival_times(process, n, rate, seed=jls.SEED,
                                   **({"burst_size": 8} if "burst_size" in kw else {}))
    kw.pop("burst_size", None)
    return jreplay.build_schedule(times, jworkload.synth_requests(
        n, seed=seed, id_prefix=prefix, **jls.WORKLOAD, **kw))


def test_small_schedules_are_the_jax_scripts():
    """Under ``--small`` every phase's arrivals and requests are the JAX
    drill's, the calibrated rate clamped to its 60 req/s and the 2x and
    5x phases capped at its 120 and 80 requests."""
    p = tls.SMALL
    assert p.len_mix == jls.LEN_MIX and p.clients == jls.CLIENTS
    assert tls.SHED_WAIT_S == jls.SHED_WAIT_S and tls.TARGET_WAIT_S == jls.TARGET_WAIT_S
    assert tls.calibration_schedule(p) == jax_schedule("burst", 16, 200.0, jls.SEED + 1, "c")
    for i, (lo, hi, _) in enumerate(jls.LEN_MIX):
        want = jreplay.build_schedule(
            jarrival.arrival_times("burst", 4, 50.0, seed=jls.SEED),
            jworkload.synth_requests(4, seed=jls.SEED + i, id_prefix=f"w{i}",
                                     **dict(jls.WORKLOAD, len_mix=((lo, hi, 1.0),))))
        assert tls.warm_schedules(p)[i] == want
    c0 = tls.calibrated_rate(p, 500.0)
    assert c0 == 60.0
    rate, sched = tls.plateau_schedule(p, c0)
    assert sched == jax_schedule("constant", 24, max(3.0, 0.9 * c0), jls.SEED + 2, "p")
    plateau = 40.0
    rate2, sched2 = tls.schedule_2x(p, plateau)
    n2 = int(min(120, max(24, 2 * plateau * 2.5)))
    assert rate2 == 80.0 and sched2 == jax_schedule("constant", n2, 80.0, jls.SEED + 3, "a")
    rate5, sched5 = tls.schedule_5x(p, plateau)
    n5 = int(min(80, max(16, 5 * plateau * 1.2)))
    assert sched5 == jax_schedule("burst", n5, rate5, jls.SEED + 4, "b", burst_size=8,
                                  deadline_mix=0.4, deadline_s=2.0)


def test_card_profile_is_sized_by_duration_without_a_clamp():
    p = tls.card_profile()
    assert tls.calibrated_rate(p, 650.0) == 650.0  # no 60 req/s clamp
    assert p.cal_n == tls.SERVE_CAL_N
    rate, sched = tls.plateau_schedule(p, 10.0)
    assert len(sched) == max(24, int(0.9 * 10.0 * tls.PLATEAU_S))
    rate2, sched2 = tls.schedule_2x(p, 6.0)
    assert len(sched2) == int(2 * 6.0 * tls.SERVE_LOAD_S)
    rate5, sched5 = tls.schedule_5x(p, 6.0)
    assert len(sched5) == int(5 * 6.0 * tls.FIVE_X_S)
    # Past the JAX drill's 120 and 80 caps, up to SERVE_LOAD_MAX.
    assert tls._count(1e6, *p.two_x) == tls._count(1e6, *p.five_x) == tls.SERVE_LOAD_MAX
    assert tls._count(20.0, *p.two_x) == 200 > 120 and tls._count(20.0, *p.five_x) == 40
    # Both kernels' rows: Seq1 3000, Seq2 of 1200-1999 or 5-64.
    raws = [raw for _, raw in sched2]
    lens = {len(s) for raw in raws for s in raw["seq2"]}
    assert {len(raw["seq1"]) for raw in raws} == {3000}
    assert min(lens) <= 64 and max(lens) >= 1200
    assert not [n for n in lens if 64 < n < 1200]


def test_prior_budget_is_the_registry_default():
    from mpi_openmp_cuda_tpu_torch.utils.env import env_float

    assert tls.prior_budget_s() == env_float("SEQALIGN_SERVE_COST_BUDGET_S") == \
        jls.PRIOR_BUDGET_S


def test_captured_schedule_reloads_unchanged(tmp_path):
    _, sched = tls.schedule_2x(TINY, 20.0)
    path = tmp_path / "schedule_2x.jsonl"
    replay.save_schedule(str(path), sched)
    assert replay.load_schedule(str(path)) == [(round(t, 9), raw) for t, raw in sched]
    assert jreplay.load_schedule(str(path)) == replay.load_schedule(str(path))


def test_5x_phase_record_and_refit_against_a_port_server(tmp_path, monkeypatch):
    """One bursty 5x phase with its deadline mix against ``--serve
    --device cpu``: answered-or-typed, SIGTERM -> 75 with a valid report
    and trace, the ``serve-load`` record valid, and the refit reads the
    trace's gap rows."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    srv = tls.Server("cpu", "a", str(tmp_path), TINY)
    assert srv.port is not None, "".join(srv.stderr_lines)
    try:
        rate5, sched5 = tls.schedule_5x(TINY, 2.0)
        result = tls.drive(srv, sched5, TINY)
    finally:
        rc, report, trace, problems = srv.stop()
    assert rc == 75 and problems == [], problems
    assert gates.survival_problems(result, phase="5x") == []
    assert result.offered == len(sched5) == 16
    assert gates.transition_problems(trace["traceEvents"]) == []
    rec = serve_load_record(result, report, process="burst", rate_rps=rate5, seed=tls.SEED,
                            clients=TINY.clients, plateau_rps=2.0)
    validate_report(rec)
    assert rec["requests"]["offered"] == 16
    fit = tls.refit_from(trace, report)
    assert fit.launches >= refit.MIN_LAUNCHES
    assert fit.launches == len(trace["gap_attribution"]["launches"])
    assert fit.scale > 0 and fit.budget_s > 0 and fit.prior_budget_s == tls.prior_budget_s()
    assert set(fit.env()) == {"SEQALIGN_SERVE_COST_SCALE", "SEQALIGN_SERVE_COST_BUDGET_S"}


def test_without_a_card_it_exits_non_zero(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device can score")
    proc = subprocess.run([sys.executable, str(SCRIPT), "--small"], cwd=REPO,
                          env={**os.environ, "TMPDIR": str(tmp_path)},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert "no CUDA device is available" in proc.stderr
    assert proc.stdout == ""
