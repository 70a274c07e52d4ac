"""The harness on the CPU, through its test entry (``harness.measure``, which
prints no result line): found by name, free of JAX, and refusing to
measure without a card."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from conftest import REPO

from seqbench import harness
from seqbench.run import emit


def digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "seqbench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_config_traffic_and_metric_are_found_by_name(tiny_root):
    before = digests(tiny_root)
    seq = tiny_root / "seqbench"
    config = json.loads((seq / "configs" / "spec-batch.json").read_text())
    (seq / "configs" / "two-weights.json").write_text(json.dumps(
        {**config, "name": "two-weights", "weights": [[3, 1, 1, 1], [7, 2, 2, 2]]}))
    (seq / "traffic" / "two-jobs.json").write_text(json.dumps(
        {"seq1_len": 40, "seq2_per_job": 3, "seq2_len": [2, 30], "pool_jobs": 2,
         "warm_jobs": 1, "check_jobs": 2}))
    (seq / "metrics" / "jobs_done.py").write_text(
        '"""jobs_done: jobs the window completed."""\n\n\ndef read(run):\n'
        '    return len(run.jobs) or None\n')
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "two-weights", "source": "a test",
                             "file": "seqbench/configs/two-weights.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "two", "config": "two-weights", "traffic": "two-jobs",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "jobs_done", "unit": "jobs", "better": "higher",
                                "bound": 0.1, "source": "host_clock", "workloads": ["two"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    ctx = harness.context("two", 3, 0.3, False, root=tiny_root, device="cpu")
    result, run = harness.measure(ctx)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"jobs_done", "setup_s"}
    assert result["metrics"]["jobs_done"]["value"] == len(run.jobs) > 0
    assert run.jobs[0]["cells"] > 0
    assert list(result)[-1] == "checks"
    after = digests(tiny_root)
    assert {k: after[k] for k in before} == before


def test_traced_batch_run_reports_its_per_layer_metrics(tiny_root):
    ctx = harness.context("tiny-batch", 8, 0.5, True, root=tiny_root, device="cpu")
    result, run = harness.measure(ctx)
    assert result["correct"], result["checks"]
    # On the CPU no kernel runs: the roofline has nothing to read.
    assert {"batch_cells_per_s.wall", "batch_job_p95_ms.wall", "cli_parse_ms", "cli_print_ms",
            "dispatch_setup_ms", "launches_per_job", "device_idle_share.batch"} == set(result["metrics"])
    assert result["device"]["window_s"] > 0 and "breakdown" in result
    assert len(run.spans) == len(run.jobs) and all("parse" in s for s in run.spans)


NO_JAX = """
import json, sys
from pathlib import Path
from seqbench import harness
from seqbench.run import emit
out = {}
for cell in ("tiny-batch", "tiny-serve"):
    ctx = harness.context(cell, 5, 0.5, False, root=Path(sys.argv[1]), device="cpu")
    result, run = harness.measure(ctx)
    out[cell] = [result["correct"], result["attempted"], run.held]
out["held"] = harness.forbidden_modules()
print(json.dumps(out))
"""


def test_no_jax_after_a_batch_job_and_a_served_request(tiny_root):
    proc = subprocess.run([sys.executable, "-c", NO_JAX, str(tiny_root)], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.splitlines()[-1])
    assert out["tiny-batch"][0] and out["tiny-batch"][1] > 0
    assert out["tiny-serve"][0] and out["tiny-serve"][1] > 0
    assert out["held"] == [] and out["tiny-serve"][2] == []


def test_a_server_that_holds_jax_is_refused(tiny_root, tmp_path, monkeypatch, capsys):
    plant = tmp_path / "plant"
    plant.mkdir()
    (plant / "sitecustomize.py").write_text(
        "import sys, types\nsys.modules['jaxlib'] = types.ModuleType('jaxlib')\n")
    monkeypatch.setenv("PYTHONPATH", str(plant))
    ctx = harness.context("tiny-serve", 6, 0.5, False, root=tiny_root, device="cpu")
    result, run = harness.measure(ctx)
    assert result["correct"] and run.held == ["jaxlib"]
    assert "jaxlib" not in sys.modules
    assert emit(result, run) == 1
    out = capsys.readouterr()
    assert "{" not in out.out and "jaxlib" in out.err


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mpi_openmp_cuda_tpu_torch_lookalike", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mpi_openmp_cuda_tpu.ops", sys)
    assert harness.forbidden_modules() == ["mpi_openmp_cuda_tpu"]


def run_cell(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", "seqbench.run", "--workload", "batch-long",
                           "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_the_measurement_refuses_without_a_card():
    proc = run_cell(REPO)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "needs 1 CUDA card" in proc.stderr


def test_the_benchmark_alone_is_no_program(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "seqbench", tmp_path / "seqbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = run_cell(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""
