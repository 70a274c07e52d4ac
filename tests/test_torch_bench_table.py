"""``scripts/torch_bench_table.py`` against the JAX package's
``scripts/bench_table.py``: the synthetic rows draw the same bytes, the
input4-class row is the draw ``chip_smoke.py`` always made, ``--from-json``
prints the same tables, the reference rows are named as skipped, the CPU
row runs, and without a card the script refuses.  Also: no
``scripts/torch_*.py`` imports jax or the JAX package."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import bench_table as jtable  # noqa: E402  (the JAX package's table)
import sb_refit  # noqa: E402
import torch_bench_table as ttable  # noqa: E402

from mpi_openmp_cuda_tpu.obs import metrics as jmetrics  # noqa: E402
from mpi_openmp_cuda_tpu_torch.io.parse import load_problem  # noqa: E402
from mpi_openmp_cuda_tpu_torch.models import workload as tworkload  # noqa: E402
from mpi_openmp_cuda_tpu_torch.obs import metrics as tmetrics  # noqa: E402


def _same_problem(got, want):
    assert got.weights == want.weights
    assert got.seq1 == want.seq1 and got.seq2 == want.seq2
    assert got.seq1_codes.tobytes() == want.seq1_codes.tobytes()
    assert [c.tobytes() for c in got.seq2_codes] == [c.tobytes() for c in want.seq2_codes]


@pytest.mark.parametrize("name", ["synthetic_max", "synthetic_skew"])
def test_synthetic_rows_are_byte_equal_to_jax(name):
    got, want = getattr(ttable, name)(), getattr(jtable, name)()
    _same_problem(got, want)
    assert len(got.seq2) == 64


def _old_chip_smoke_input4(np):
    """``chip_smoke.py``'s ``input4_problem`` as it was before it moved to
    ``models/workload.py``."""
    rng = np.random.default_rng(7)

    def mk(len1, lens):
        s1 = rng.integers(1, 27, size=len1)
        return s1, [rng.integers(1, 27, size=int(n)) for n in lens]

    mk(1489, rng.integers(56, 1153, size=32))
    mk(3000, rng.integers(1200, 2000, size=64))
    mk(1489, rng.integers(1460, 1490, size=64))
    mk(2976, rng.integers(5, 83, size=30))
    s1, seqs = mk(2976, rng.integers(5, 65, size=30))
    return s1.astype(np.int8), [s.astype(np.int8) for s in seqs]


def test_input4_class_is_chip_smokes_old_draw_and_sb_refits():
    seq1, seqs = tworkload.input4_problem()
    old1, old = _old_chip_smoke_input4(np)
    assert seq1.tobytes() == old1.tobytes()
    assert [s.tobytes() for s in seqs] == [s.tobytes() for s in old]
    ref1, refs, _, l2s = sb_refit.workloads("i8")["input4-class-packed"]
    assert seq1.tolist() == ref1.tolist() and [s.tolist() for s in seqs] == [
        s.tolist() for s in refs]
    assert (seq1.size, len(seqs), l2s) == (2976, 30, 64)
    assert all(5 <= s.size <= 64 for s in seqs)
    row = ttable.input4_class()
    assert row.seq1_codes.tobytes() == seq1.tobytes() and row.weights == [10, 2, 3, 4]


@pytest.mark.parametrize("row", ["input3-class", "gather", "cpu", "input4-class",
                                 "max-size", "skew"])
def test_row_input_files_parse_back(row, tmp_path):
    path, env, args = ttable.row_spec(row, tmp_path)
    problem = load_problem(str(path))
    want = {"input3-class": tworkload.input3_class_problem,
            "gather": tworkload.input3_class_problem,
            "cpu": tworkload.input3_class_problem, "input4-class": ttable.input4_class,
            "max-size": ttable.synthetic_max, "skew": ttable.synthetic_skew}[row]()
    _same_problem(problem, want)
    assert env == ({"BENCH_WEIGHTS": "1000000,1,1,1"} if row == "gather" else {})
    assert args == (["--device", "cpu"] if row == "cpu" else [])


@pytest.mark.parametrize("ref_dir", ["unset", "empty"])
def test_reference_rows_are_named_as_skipped(ref_dir, tmp_path, monkeypatch, capsys):
    if ref_dir == "unset":
        monkeypatch.delenv("REFERENCE_DIR", raising=False)
    else:
        monkeypatch.setenv("REFERENCE_DIR", str(tmp_path))
    out = ttable.measure(list(ttable.REFERENCE_ROWS), procs=1)
    printed = capsys.readouterr().out
    assert out["rows"] == [] and [s["row"] for s in out["skipped"]] == list(
        ttable.REFERENCE_ROWS)
    for row in ttable.REFERENCE_ROWS:
        (line,) = [ln for ln in printed.splitlines() if ln.startswith(f"| {row} |")]
        assert "skipped" in line and not re.search(r"\d+\.\d", line), line


def test_reference_row_reads_its_file_when_present(tmp_path, monkeypatch):
    (tmp_path / "input5.txt").write_text("1 1 1 1\nAB\n1\nA\n")
    monkeypatch.setenv("REFERENCE_DIR", str(tmp_path))
    assert ttable.row_spec("input5", tmp_path / "x") == (tmp_path / "input5.txt", {}, [])
    with pytest.raises(FileNotFoundError, match="input6"):
        ttable.row_spec("input6", tmp_path)


def _wrap(body):
    return tmetrics.wrap_report("bench", body)


def _records() -> list[dict]:
    """One kernel bench record, one ``serve-load`` record and one fleet
    coordinator's run report with a ``gap_attribution``."""
    bench_rec = _wrap({
        "metric": "equivalent brute-force char comparisons/s/chip, input3-class.txt",
        "value": 1.7e14, "unit": "elements/s/chip", "formulation": "cuda",
        "device_wall_us": 53.7})
    serve = _wrap({
        "metric": "serve goodput", "value": 464.7, "unit": "requests/s",
        "formulation": "serve-load", "goodput_rps": 464.7, "offered_rps": 1303.0,
        "duration_s": 10.0,
        "requests": {"offered": 13030, "done": 4647, "rejected": 8000, "failed": 0,
                     "missing": 383, "reset": 0},
        "latency_s": {"p50": 0.5, "p90": 1.2, "p99": 1.452},
        "queue_wait_s": {"p50": 0.1, "p90": 0.4, "p99": 0.9},
        "shed_rate": 0.61, "deadline_miss_rate": 0.0, "batch_fill_ratio": 0.83,
        "arrival": {"process": "poisson", "rate_rps": 1303.0, "speedup_k": 2.0,
                    "clients": 16},
        "goodput_retention": 0.73})
    phases = ("offer_to_claim", "claim_to_score", "score_to_post", "post_to_demux")
    rows = [{"worker": w, "phases": {**{p: 0.001 * (i + 1) * (j + 1) for j, p in
                                        enumerate(phases)}, "total": 0.01 * (i + 1)}}
            for i, w in enumerate(["w1", "w2", "w1"])]
    fleet = tmetrics.wrap_report("run", {
        "counters": {}, "gauges": {}, "histograms": {}, "uptime_s": 3.0,
        "gap_attribution": {
            "board_phases": rows,
            "clock_offsets": {"w1": {"offset_s": 0.0002, "rtt_s": 0.001}},
            "board_phase_totals": {"total": 0.04}}})
    return [bench_rec, serve, fleet]


def test_from_json_prints_the_jax_tables(tmp_path, monkeypatch, capsys):
    path = tmp_path / "records.ndjson"
    recs = _records()
    for rec in recs:
        tmetrics.validate_report(rec)
        jmetrics.validate_report(rec)
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    monkeypatch.setattr(sys, "argv", ["bench_table.py", "--from-json", str(path)])
    jtable.main()
    want = capsys.readouterr().out
    assert ttable.main(["--from-json", str(path)]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert "| poisson @ 1303.0 req/s" in got and "| w1 | 2 |" in got
    assert "| equivalent brute-force" in got and "n/a |" in got
    assert ttable.load_bench_records(str(path)) == jtable.load_bench_records(str(path))


@pytest.mark.parametrize("shape", ["object", "list"])
def test_from_json_reads_one_document(shape, tmp_path):
    recs = _records()
    doc = recs[0] if shape == "object" else recs
    path = tmp_path / "doc.json"
    path.write_text(json.dumps(doc, indent=2))
    assert ttable.load_bench_records(str(path)) == jtable.load_bench_records(str(path))


def test_from_json_refuses_a_broken_wrapped_record(tmp_path):
    rec = _records()[0]
    del rec["metric"]
    path = tmp_path / "bad.ndjson"
    path.write_text(json.dumps(rec) + "\n")
    with pytest.raises(ValueError, match="metric and value"):
        ttable.load_bench_records(str(path))


def test_cpu_row_runs_the_bench_and_records(tmp_path):
    records = tmp_path / "rec.ndjson"
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env["BENCH_REPS"] = "1"
    proc = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "torch_bench_table.py"), "--device", "cpu",
         "--procs", "1", "--records", str(records)],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "card: cpu"
    summary = json.loads(lines[-1])
    (row,) = summary["rows"]
    assert row["row"] == "cpu" and row["formulation"] == ["plain"] and row["procs"] == 1
    assert row["device_wall_us_median"] is None and row["e2e_warm_s_median"] > 0
    assert any(ln.startswith("| cpu | cpu (plain) | n/a") for ln in lines)
    (rec,) = ttable.load_bench_records(str(records))
    assert rec["device"] == "cpu" and rec["metric"].endswith("input3-class.txt")


def test_summary_of_card_records():
    recs = [{"metric": "m", "formulation": "gather", "device": "NVIDIA H100 80GB HBM3",
             "power_limit_w": 700.0, "device_wall_us": w, "e2e_warm_s": e}
            for w, e in ((50.0, 0.003), (40.0, 0.002), (60.0, 0.004))]
    s = ttable.summarize("gather", recs, elements=10**9)
    assert (s["device_wall_us_min"], s["device_wall_us_median"],
            s["device_wall_us_max"]) == (40.0, 50.0, 60.0)
    assert s["elements_per_s_at_median"] == pytest.approx(10**9 / 50e-6)
    assert s["e2e_warm_s_median"] == 0.003 and s["formulation"] == ["gather"]
    line = ttable.row_line(s)
    assert "40.000 / 50.000 / 60.000" in line and "(gather)" in line
    assert line.endswith("| 3 | n/a |")


def test_without_card_exits_1():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, str(REPO / "scripts" / "torch_bench_table.py")],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 1 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr and "--device cpu" in proc.stderr


TORCH_SCRIPTS = sorted((REPO / "scripts").glob("torch_*.py"))
JAX_IMPORT = re.compile(
    r"^\s*(?:import\s+(?:jax|jaxlib|mpi_openmp_cuda_tpu)\b"
    r"|from\s+(?:jax|jaxlib|mpi_openmp_cuda_tpu)(?![\w])(?:\.\S+)?\s+import)", re.M)


@pytest.mark.parametrize("path", TORCH_SCRIPTS, ids=[p.name for p in TORCH_SCRIPTS])
def test_torch_scripts_import_no_jax(path):
    """A text search (the AST walk of ``test_torch_cli.py`` beside it):
    no ``scripts/torch_*.py`` imports jax or the JAX package."""
    text = path.read_text()
    assert not JAX_IMPORT.findall(text), path


def test_jax_import_pattern_catches_imports():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "    from mpi_openmp_cuda_tpu.ops import dispatch",
                 "import mpi_openmp_cuda_tpu"):
        assert JAX_IMPORT.search(line), line
    for line in ("import jaxtyping", "from mpi_openmp_cuda_tpu_torch.ops import x",
                 "import mpi_openmp_cuda_tpu_torch", "# the jax package"):
        assert not JAX_IMPORT.search(line), line
