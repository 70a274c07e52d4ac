"""``scripts/torch_stream_bench.py`` against the JAX package's
``scripts/stream_bench.py``: the same input bytes, one JSON line with all
three modes from a CPU run, and no timing published when a mode's bytes
differ."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import stream_bench as jstream  # noqa: E402  (the JAX package's stream bench)
import torch_stream_bench as tstream  # noqa: E402

STRESS = REPO / "tests" / "fixtures" / "stress_small.txt"


@pytest.mark.parametrize("replicas", [1, 8])
@pytest.mark.parametrize("source", ["synthetic", "file"])
def test_build_input_writes_the_jax_bytes(source, replicas, monkeypatch, tmp_path):
    if source == "file":
        monkeypatch.setenv("BENCH_INPUT", str(STRESS))
        jpath, jn = jstream.build_input(replicas)
    else:
        # The JAX script falls back to the synthetic text when its input
        # file is missing; the port's falls back when BENCH_INPUT is unset.
        monkeypatch.setenv("BENCH_INPUT", str(tmp_path / "missing.txt"))
        jpath, jn = jstream.build_input(replicas)
        monkeypatch.delenv("BENCH_INPUT")
    tpath, tn = tstream.build_input(replicas)
    try:
        assert Path(tpath).read_bytes() == Path(jpath).read_bytes()
        assert tn == jn
        if source == "synthetic":
            assert tn == 32 * replicas
    finally:
        os.unlink(jpath)
        os.unlink(tpath)


def test_cpu_run_prints_one_line_with_every_mode():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BENCH_", "STREAM_BENCH_"))}
    env.update(STREAM_BENCH_REPLICAS="1", STREAM_BENCH_ROUNDS="1", STREAM_BENCH_CHUNK="8")
    proc = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "torch_stream_bench.py"), "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 1, lines
    rec = json.loads(lines[0])
    assert sorted(rec["e2e_s"]) == ["batch", "stream", "stream+journal"]
    assert all(v > 0 for v in rec["e2e_s"].values())
    assert rec["stream_vs_batch"] == rec["e2e_s"]["stream"] / rec["e2e_s"]["batch"]
    assert rec["journal_vs_stream"] == (rec["e2e_s"]["stream+journal"]
                                        / rec["e2e_s"]["stream"])
    assert rec["rounds"] == 1 and rec["card"] == "cpu"
    assert "probe_gated" not in rec and "gemm_probe_bf16_tflops" not in rec
    assert "32 sequences" in rec["metric"]


def test_run_mode_captures_the_cli_stdout():
    out = tstream.run_mode(["--input", str(STRESS), "--device", "cpu"])
    assert out == STRESS.with_suffix(".out").read_bytes()
    with pytest.raises(RuntimeError, match="rc 64"):
        tstream.run_mode(["--input", str(STRESS), "--device", "cpu", "--resume"])


def test_a_mode_whose_bytes_differ_raises():
    with pytest.raises(RuntimeError, match="stream output diverges"):
        tstream.check_identical({"batch": b"#0: score: 1\n", "stream": b"#0: score: 2\n",
                                 "stream+journal": b"#0: score: 1\n"})
    tstream.check_identical(dict.fromkeys(tstream.MODES, b"same"))

    def run(argv):
        return b"other" if "--journal" in argv else b"golden"

    def mode_args(mode):
        return {"batch": [], "stream": ["--stream", "2"],
                "stream+journal": ["--stream", "2", "--journal", "j"]}[mode]

    with pytest.raises(RuntimeError, match=r"stream\+journal output diverges"):
        tstream.measure_modes(mode_args, 2, b"golden", run=run)
    walls = tstream.measure_modes(mode_args, 3, b"golden", run=lambda argv: b"golden")
    assert sorted(walls) == sorted(tstream.MODES) and all(w >= 0 for w in walls.values())


def test_without_card_exits_1():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, str(REPO / "scripts" / "torch_stream_bench.py")],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 1 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr
