"""``scripts/torch_conformance.py`` on the CPU: its case generators are
deterministic, every regime sits on the side of the Hopper bounds its
name claims, its CPU run of a small sweep equals the JAX package's
oracle, the seam inputs that ``chip_smoke.py`` phases 2-3 import from it
are the cases those phases always ran, and without a card it refuses."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import torch_conformance as conf  # noqa: E402

from mpi_openmp_cuda_tpu.ops.oracle import score_batch_oracle  # noqa: E402
from mpi_openmp_cuda_tpu_torch.ops.bounds import (  # noqa: E402
    kernel_fits, max_exact_value, mm_max_exact_value)
from mpi_openmp_cuda_tpu_torch.ops.values import max_abs_value, value_table  # noqa: E402


def _bytes(cases):
    """Every array and value of a list of cases, for equality."""
    out = []
    for case in cases:
        out.append(tuple(
            (x.tobytes() if isinstance(x, np.ndarray)
             else tuple(s.tobytes() for s in x) if isinstance(x, list) and x
             and isinstance(x[0], np.ndarray) else repr(x)) for x in case))
    return out


@pytest.mark.parametrize("gen", ["problems", "seam_problems", "packed_seam_problems"])
def test_fixed_generators_are_deterministic(gen):
    fn = getattr(conf, gen)
    assert _bytes(list(fn())) == _bytes(list(fn()))


@pytest.mark.parametrize("seed", [0, 20743])
def test_sweep_is_deterministic_for_a_seed(seed):
    a, b = list(conf.sweep_cases(seed, 2)), list(conf.sweep_cases(seed, 2))
    assert _bytes(a) == _bytes(b)
    assert _bytes(a) != _bytes(list(conf.sweep_cases(seed + 1, 2)))


def test_sweep_covers_every_axis():
    cases = list(conf.sweep_cases(3, 2))
    tags = [c[0] for c in cases]
    assert len(cases) == 2 * (3 + 4 + 2)
    for l2s in (8, 16, 32, 64):
        mine = [c for c in cases if c[0].startswith(f"sweep pack l2s<={l2s} ")]
        assert len(mine) == 2 and all(0 < s.size <= l2s for c in mine for s in c[3])
    assert sum(t.startswith("sweep fused") for t in tags) == 6
    ring = [c for c in cases if c[1] == "ring"]
    assert len(ring) == 4 and all(t.split()[2].startswith("R=") for t, *_ in ring)
    assert {c[1] for c in cases} == {"cuda", "ring"}


LONGEST = sorted({conf.longest_scored(s1, seqs) for _, s1, seqs in conf.problems()}
                 | {1, 700, 1073, 1074, 2000})


@pytest.mark.parametrize("longest", LONGEST)
def test_regimes_sit_where_their_names_say(longest):
    regimes = conf.regimes(longest)
    assert len({r.name for r in regimes}) == len(regimes) == 13
    for r in regimes:
        kernel, mm = conf.regime_sides(r, longest)
        maxv = max_abs_value(value_table(r.weights))
        assert kernel == kernel_fits(maxv, longest)
        assert mm == {l2p: maxv <= mm_max_exact_value(l2p) for l2p in (128, 2048)}
        if r.kernel is not None:
            assert kernel == r.kernel, r
        assert mm == r.mm, r
        if "inside" in r.name or "past" in r.name:
            assert ("inside" in r.name) == (kernel if "kernel" in r.name
                                            else mm[128 if "128" in r.name else 2048]), r
    by = {r.name.split(" (")[0]: r for r in regimes}
    fit = max_exact_value(longest)
    assert by["kernel window inside"].weights[0] == fit
    assert by["kernel window past"].weights[0] == fit + 1
    assert by["mm window at L2P 128 past"].weights[0] == mm_max_exact_value(128) + 1
    assert by["mm window at L2P 2048 past"].weights[0] == mm_max_exact_value(2048) + 1
    gather = by["1000000 1 1 1: long rows to gather"]
    assert conf.regime_sides(gather, longest)[0] == (longest <= 1073)


def test_caps_case_splits_routes():
    """The caps case's launches take both routes at 1000000 1 1 1 on cuda
    and at the L2P-128 mm bound's far side on mm."""
    (_, s1, seqs), = [c for c in conf.problems() if c[0] == "caps"]
    assert conf.local_routes("cuda", s1, seqs, [1000000, 1, 1, 1]) == {"cuda", "gather"}
    assert conf.local_routes("mm", s1, seqs, [4096, 1, 1, 1]) == {"mm", "gather"}
    assert conf.local_routes("gather", s1, seqs, [10, 2, 3, 4]) == {"gather"}


def _jax_rows(seq1, seqs, weights):
    return [tuple(int(x) for x in r) for r in score_batch_oracle(seq1, seqs, weights)]


def test_cpu_sweep_equals_jax_oracle():
    """A small seeded sweep through the CPU scorers (plain versions; the
    ring over four CPU slots) == the JAX package's oracle."""
    scorers = conf.scorers("cpu")
    for tag, key, seq1, seqs, weights in conf.sweep_cases(11, 1):
        got = [tuple(int(x) for x in r)
               for r in scorers[key].score_codes(seq1, seqs, weights)]
        assert got == _jax_rows(seq1, seqs, weights), tag


@pytest.mark.parametrize("name", ["cuda", "mm", "gather", "batch mesh [cpu] x 4", "ring"])
def test_cpu_scorers_equal_jax_oracle_on_the_tie_storm(name):
    (_, s1, seqs), = [c for c in conf.problems() if c[0] == "tie storm"]
    scorer = conf.scorers("cpu")[name]
    for r in conf.regimes(conf.longest_scored(s1, seqs)):
        got = [tuple(int(x) for x in row) for row in scorer.score_codes(s1, seqs, r.weights)]
        assert got == _jax_rows(s1, seqs, r.weights), r.name


def test_main_on_the_cpu_with_small_sections(monkeypatch, capsys):
    """The whole script on the CPU, its sections cut to a case each:
    every row exact, every route taken, the CPU caveat on stderr."""
    tie = [c for c in conf.problems() if c[0] == "tie storm"]
    seams, packed = conf.seam_problems()[:1], conf.packed_seam_problems()[:1]
    monkeypatch.setattr(conf, "problems", lambda: iter(tie))
    monkeypatch.setattr(conf, "seam_problems", lambda: seams)
    monkeypatch.setattr(conf, "packed_seam_problems", lambda: packed)
    monkeypatch.setenv("TORCH_CONFORMANCE_SEED", "5")
    monkeypatch.setenv("TORCH_CONFORMANCE_SWEEP_N", "1")
    assert conf.main(["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert "proves nothing about the kernels" in err
    assert "seed=5 n=1: 9 cases" in out
    assert "cuda->gather" in out and "mm->gather" in out
    assert "every row exact on cpu" in out


def test_failures_are_listed_and_exit_1(monkeypatch, capsys):
    tie = [c for c in conf.problems() if c[0] == "tie storm"]
    monkeypatch.setattr(conf, "problems", lambda: iter(tie))
    monkeypatch.setattr(conf, "seam_problems", lambda: [])
    monkeypatch.setattr(conf, "packed_seam_problems", lambda: [])
    monkeypatch.setattr(conf, "sweep_cases", lambda seed, n: iter(()))
    real = conf.Checker.oracle

    def off_by_one(self, seq1, seqs, weights):
        rows = real(self, seq1, seqs, weights)
        return [(rows[0][0] + 1, *rows[0][1:]), *rows[1:]]

    monkeypatch.setattr(conf.Checker, "oracle", off_by_one)
    assert conf.main(["--device", "cpu"]) == 1
    out, err = capsys.readouterr()
    assert out.count("FAIL ") == 13 * 5 and "rows [0]" in out
    assert "65 FAILURES" in err


def test_without_card_exits_1():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, str(REPO / "scripts" / "torch_conformance.py")],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 1 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr


SEAM_COUNTS = {"seam_problems": (5, 83), "packed_seam_problems": (11, 156)}


@pytest.mark.parametrize("gen", sorted(SEAM_COUNTS))
def test_chip_smoke_phases_keep_their_seam_cases(gen):
    """chip_smoke.py phases 2-3 (and 10) run the seam cases they always
    ran: one copy, imported from this script, with the same case and row
    counts."""
    cases = getattr(conf, gen)()
    assert (len(cases), sum(len(c[2]) for c in cases)) == SEAM_COUNTS[gen]
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    defs = {n.name for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}
    assert gen not in defs and "input4_problem" not in defs
    src = (REPO / "chip_smoke.py").read_text()
    assert f"conformance.{gen}()" in src
