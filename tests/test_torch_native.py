"""The port's native driver ``final_torch`` (``native/main.cpp`` over
``mpi_openmp_cuda_tpu_torch/native/torch_backend.cpp``) and its Python
bridge, on the CPU.

The bridge is held to the JAX bridge byte for byte on seeded strided
batches.  The driver tests build ``final_torch`` with ``make`` (skipped
without ``g++``, ``make`` or ``python3-config --embed``, as
``tests/test_native.py`` skips) and run the fixtures through it under
``TPU_SEQALIGN_DEVICE=cpu``; every driver run that scores imports torch
once, so the runs are few.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mpi_openmp_cuda_tpu import native_bridge as jax_bridge
from mpi_openmp_cuda_tpu_torch import native_bridge as bridge

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"

# The driver's substitution groups (native/main.cpp, spec PDF p.1-2).
CONSERVATIVE = ["NDEQ", "NEQK", "STA", "MILV", "QHRK", "NHQK", "FYW", "HY", "MILF"]
SEMI_CONSERVATIVE = ["SAG", "ATV", "CSA", "SGND", "STPA", "STNK", "NEQHRK", "NDEQHK",
                     "SNDEQK", "HFY", "FVLIM"]


def group_matrix(groups) -> bytes:
    """``build_group_matrix`` of ``native/main.cpp``: a 729-byte blob."""
    mat = np.zeros((27, 27), dtype=np.int8)
    for g in groups:
        for a in g:
            for b in g:
                mat[ord(a) - 64, ord(b) - 64] = 1
    return mat.tobytes()


MAT1, MAT2 = group_matrix(CONSERVATIVE), group_matrix(SEMI_CONSERVATIVE)


def test_value_table_from_levels_matches_jax_bridge():
    rng = np.random.default_rng(11)
    for _ in range(8):
        m1 = rng.integers(0, 2, size=(27, 27)).astype(np.int8)
        m2 = rng.integers(0, 2, size=(27, 27)).astype(np.int8)
        w = [int(x) for x in rng.integers(0, 50, size=4)]
        np.testing.assert_array_equal(
            bridge.value_table_from_levels(m1, m2, w),
            jax_bridge.value_table_from_levels(m1, m2, w),
        )


def _strided(seqs, stride) -> bytes:
    """The driver's batch buffer: NUL-terminated records, ``stride``
    bytes each (a record of ``stride`` chars has no room for its NUL)."""
    buf = bytearray(len(seqs) * stride)
    for r, s in enumerate(seqs):
        buf[r * stride : r * stride + len(s)] = s.encode()
    return bytes(buf)


def test_score_strided_matches_jax_bridge():
    """Seeded strided batches (one record filling its stride, without its
    NUL, and a batch of no rows) give the JAX bridge's bytes."""
    rng = np.random.default_rng(3)
    alpha = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    seq1 = "".join(rng.choice(alpha, size=300))
    seqs = ["".join(rng.choice(alpha, size=int(n))) for n in rng.integers(1, 90, size=30)]
    seqs += ["".join(rng.choice(alpha, size=n)) for n in (299, 300, 301)]
    stride = max(len(s) for s in seqs)  # the longest record fills its stride: no NUL
    seq2_all = _strided(seqs, stride)
    weights = (10, 2, 3, 4)
    want = jax_bridge.score_strided(seq1.encode(), seq2_all, stride, len(seqs), MAT1, MAT2,
                                    weights, "xla", "")
    got = bridge.score_strided(seq1.encode(), seq2_all, stride, len(seqs), MAT1, MAT2,
                               weights, "auto", "", "cpu")
    assert got == want and len(got) == 12 * len(seqs)
    assert bridge.score_strided(seq1.encode(), b"", 1, 0, MAT1, MAT2, weights, "auto", "",
                                "cpu") == b""
    assert jax_bridge.score_strided(seq1.encode(), b"", 1, 0, MAT1, MAT2, weights, "xla",
                                    "") == b""


def test_score_strided_refuses_other_matrices_and_short_buffers():
    seq2_all = b"ACGT\0"
    with pytest.raises(ValueError, match="substitution groups"):
        bridge.score_strided(b"ACGTACGT", seq2_all, 5, 1, MAT2, MAT1, (10, 2, 3, 4), "auto",
                             "", "cpu")
    with pytest.raises(ValueError, match="too small"):
        bridge.score_strided(b"ACGTACGT", seq2_all, 5, 2, MAT1, MAT2, (1, 1, 1, 1), "auto", "",
                             "cpu")


# -- the binary -------------------------------------------------------------------


@pytest.fixture(scope="module")
def final_torch():
    if shutil.which("g++") is None or shutil.which("make") is None:
        pytest.skip("native toolchain (g++/make) not available")
    config = f"python{sys.version_info.major}.{sys.version_info.minor}-config"
    try:
        probe = subprocess.run([config, "--embed", "--ldflags"], capture_output=True)
    except FileNotFoundError:
        pytest.skip("python-config not available")
    if probe.returncode != 0:
        pytest.skip("python-config --embed not available")
    build = subprocess.run(["make", "-C", str(REPO), "final_torch"], capture_output=True,
                           text=True, timeout=300)
    if build.returncode != 0:
        pytest.fail(f"native build failed:\n{build.stdout}\n{build.stderr}")
    return str(REPO / "final_torch")


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPU_SEQALIGN_")}
    env["TPU_SEQALIGN_PYROOT"] = str(REPO)
    env.update(extra)
    return env


def _run(binary, stdin_text, env):
    return subprocess.run([binary], input=stdin_text, capture_output=True, text=True, env=env,
                          timeout=300)


@pytest.mark.parametrize("name", ["tiny", "mixedcase", "dup_and_k0", "empty_batch"])
def test_fixtures_byte_exact_on_cpu(final_torch, name):
    proc = _run(final_torch, (FIXTURES / f"{name}.txt").read_text(),
                _env(TPU_SEQALIGN_DEVICE="cpu"))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == (FIXTURES / f"{name}.out").read_text()


def test_fixture_with_batch_mesh(final_torch):
    """TPU_SEQALIGN_MESH=4 over four host devices: the MPI_Scatter tier."""
    proc = _run(final_torch, (FIXTURES / "stress_small.txt").read_text(),
                _env(TPU_SEQALIGN_DEVICE="cpu", TPU_SEQALIGN_MESH="4",
                     SEQALIGN_HOST_DEVICES="4"))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == (FIXTURES / "stress_small.out").read_text()


@pytest.mark.parametrize(
    "text", ["1 2 3\n", "1 2 3 4\nACGT\n3\nAC\n", "1 2 3 4\nACGT\n1\nA9\n"],
    ids=["weights", "short-stream", "bad-char"])
def test_malformed_input_fails_stop(final_torch, text):
    proc = _run(final_torch, text, _env(TPU_SEQALIGN_DEVICE="cpu"))
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "error" in proc.stderr


def test_no_card_without_device_cpu_exits_1(final_torch):
    """No GPU and no TPU_SEQALIGN_DEVICE: exit 1 with the diagnostic and
    no result line; the driver never moves to the CPU by itself."""
    proc = _run(final_torch, (FIXTURES / "tiny.txt").read_text(),
                _env(CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 1
    assert proc.stdout == ""
    assert "torch_backend: error" in proc.stderr and "no CUDA device" in proc.stderr
