"""The port's batch CLI: byte-identical goldens on the CPU, the JAX CLI's
stdout, the exit-code contract, and the rule that no port module (nor
``chip_smoke.py`` nor a ``scripts/torch_*.py`` script) imports jax or the
JAX package."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from conftest import run_cli_inproc
from mpi_openmp_cuda_tpu_torch.io import cli as tcli

REPO = Path(__file__).resolve().parent.parent
FIXTURES = sorted((REPO / "tests" / "fixtures").glob("*.txt"), key=lambda p: p.name)
IDS = [p.stem for p in FIXTURES]


def _port(args, capfd, rc_want):
    rc = tcli.run(list(args))
    cap = capfd.readouterr()
    assert rc == rc_want, cap.err
    return cap.out, cap.err


@pytest.mark.parametrize("path", FIXTURES, ids=IDS)
def test_module_entry_matches_golden_and_jax_cli(path, capsys):
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_openmp_cuda_tpu_torch", "--device", "cpu"],
        stdin=path.open("rb"),
        capture_output=True,
        cwd=REPO,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr.decode()
    assert proc.stdout == path.with_suffix(".out").read_bytes()
    jax_out, _ = run_cli_inproc("--input", str(path), capsys=capsys)
    assert proc.stdout.decode() == jax_out


@pytest.mark.parametrize("path", FIXTURES, ids=IDS)
def test_oracle_backend_matches_golden(path, capfd):
    out, _ = _port(["--input", str(path), "--backend", "oracle"], capfd, 0)
    assert out == path.with_suffix(".out").read_text()


def test_json_sidecar(tmp_path, capfd):
    side = tmp_path / "r.json"
    fixture = REPO / "tests" / "fixtures" / "tiny.txt"
    out, _ = _port(
        ["--input", str(fixture), "--device", "cpu", "--json", str(side)], capfd, 0
    )
    assert out == fixture.with_suffix(".out").read_text()
    payload = json.loads(side.read_text())
    assert [r["score"] for r in payload["results"]] == [-1, 3, -2]
    assert payload["meta"] == {"backend": "cuda", "device": "cpu"}


@pytest.mark.parametrize(
    "args", [["--bogus"], ["--device", "tpu"], ["--backend", "pallas"], ["--input"]]
)
def test_usage_errors_exit_64(args, capfd):
    """A command line argparse rejects exits with argparse's own 2 and the
    usage text on stderr, as the JAX CLI does (64 is kept for rejected
    flag combinations and malformed --faults specs)."""
    out, err = _port(args, capfd, 2)
    assert out == ""
    assert "usage" in err


# The gate fault's two inputs: weights the reference scores exactly (the
# JAX CLI exits 0 on both) that the port once refused with 65.
GATE_CASES = {
    "C": "1000000000 1 1 1\nABBAB\n3\nA\nAB\nBA\n",
    "D": "16777216 1 1 1\nABBAB\n2\nAB\n" + "AB" * 32 + "\n",
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_cases_match_the_jax_cli_and_the_oracle(case, tmp_path, capfd):
    from mpi_openmp_cuda_tpu.io.parse import load_problem
    from mpi_openmp_cuda_tpu.ops.oracle import prefix_best

    path = tmp_path / f"case{case}.txt"
    path.write_text(GATE_CASES[case])
    out, _ = _port(["--input", str(path), "--device", "cpu"], capfd, 0)
    jax_out, _ = run_cli_inproc("--input", str(path), capsys=capfd)
    assert out == jax_out
    prob = load_problem(str(path))
    assert out == "".join(
        f"#{i}: score: {s}, n: {n}, k: {k}\n"
        for i, (s, n, k) in enumerate(
            prefix_best(prob.seq1_codes, q, prob.weights) for q in prob.seq2_codes))


@pytest.mark.parametrize(
    "text,msg",
    [
        ("1 2 3", "too short"),
        ("1 2 3 4 AB1 1 A", "invalid sequence character"),
        ("1 2 3 4 ABC 2 A", "declared 2"),
        ("2147483647 1 1 1 ABCDEF 1 ABC", "2^31"),
    ],
)
def test_fatal_errors_exit_65_with_empty_stdout(text, msg, tmp_path, capfd):
    path = tmp_path / "in.txt"
    path.write_text(text)
    out, err = _port(["--input", str(path), "--device", "cpu"], capfd, tcli.EX_FATAL)
    assert out == ""
    assert msg in err


def test_missing_input_exits_65(tmp_path, capfd):
    out, err = _port(["--input", str(tmp_path / "nope.txt"), "--device", "cpu"],
                     capfd, tcli.EX_FATAL)
    assert out == "" and "error" in err


def test_no_gpu_without_device_cpu_is_fatal(monkeypatch, capfd):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fixture = REPO / "tests" / "fixtures" / "tiny.txt"
    out, err = _port(["--input", str(fixture)], capfd, tcli.EX_FATAL)
    assert out == ""
    assert "no CUDA device" in err and "--device cpu" in err


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


PORT_FILES = (
    sorted((REPO / "mpi_openmp_cuda_tpu_torch").rglob("*.py"))
    + sorted((REPO / "scripts").glob("torch_*.py"))
    + [REPO / "chip_smoke.py"]
)


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(REPO)) for p in PORT_FILES]
)
def test_port_imports_neither_jax_nor_jax_package(path):
    for name in _imports(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "mpi_openmp_cuda_tpu"), (path, name)


def test_port_import_loads_no_jax():
    code = (
        "import sys, mpi_openmp_cuda_tpu_torch, mpi_openmp_cuda_tpu_torch.io.cli, "
        "mpi_openmp_cuda_tpu_torch.ops.cuda_scorer, mpi_openmp_cuda_tpu_torch.bench, "
        "mpi_openmp_cuda_tpu_torch.ops.probe, mpi_openmp_cuda_tpu_torch.ops.schedule, "
        "mpi_openmp_cuda_tpu_torch.ops.gather_scorer, "
        "mpi_openmp_cuda_tpu_torch.ops.matmul_scorer, "
        "mpi_openmp_cuda_tpu_torch.io.pipeline, mpi_openmp_cuda_tpu_torch.utils.journal, "
        "mpi_openmp_cuda_tpu_torch.utils.selfcheck, "
        "mpi_openmp_cuda_tpu_torch.resilience.watchdog, "
        "mpi_openmp_cuda_tpu_torch.parallel.specs, mpi_openmp_cuda_tpu_torch.parallel.mesh, "
        "mpi_openmp_cuda_tpu_torch.parallel.comm, mpi_openmp_cuda_tpu_torch.parallel.sharding, "
        "mpi_openmp_cuda_tpu_torch.parallel.ring, "
        "mpi_openmp_cuda_tpu_torch.parallel.distributed, "
        "mpi_openmp_cuda_tpu_torch.serve.loop, mpi_openmp_cuda_tpu_torch.serve.slo, "
        "mpi_openmp_cuda_tpu_torch.serve.fleet, "
        "mpi_openmp_cuda_tpu_torch.resilience.membership, "
        "mpi_openmp_cuda_tpu_torch.resilience.rescue, "
        "mpi_openmp_cuda_tpu_torch.resilience.breaker, "
        "mpi_openmp_cuda_tpu_torch.obs.telemetry, mpi_openmp_cuda_tpu_torch.load.driver, "
        "mpi_openmp_cuda_tpu_torch.load.gates, mpi_openmp_cuda_tpu_torch.load.refit, "
        "mpi_openmp_cuda_tpu_torch.load.report, mpi_openmp_cuda_tpu_torch.aot.prewarm, "
        "mpi_openmp_cuda_tpu_torch.native_bridge, "
        "mpi_openmp_cuda_tpu_torch.analysis.contracts, "
        "mpi_openmp_cuda_tpu_torch.analysis.smem, "
        "mpi_openmp_cuda_tpu_torch.analysis.ranges, "
        "mpi_openmp_cuda_tpu_torch.analysis.seqlint, "
        "mpi_openmp_cuda_tpu_torch.analysis.lockgraph, "
        "mpi_openmp_cuda_tpu_torch.analysis.exitflow, "
        "mpi_openmp_cuda_tpu_torch.analysis.interleave; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'mpi_openmp_cuda_tpu')]; print(bad); sys.exit(bool(bad))"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_chip_smoke_fails_without_card_or_repo(alone, tmp_path):
    """Without a CUDA device, or copied away from the repo, the smoke test
    exits non-zero and prints no result line."""
    script = REPO / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    proc = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True,
        cwd=script.parent, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
