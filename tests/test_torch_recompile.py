"""The port's build counter (``analysis/recompile.py``) over
``ops/_build.build_count``: deltas, the frozen tally, and the pins, held to
the JAX harness's contract (``mpi_openmp_cuda_tpu/analysis/recompile.py``:
exactly one of ``expected`` / ``at_most``, a ``SeqcheckError`` naming the
breach).  The JAX harness counts XLA compiles; the port's counts kernel
builds, library loads and per-width setups, which a CPU run never makes.
"""

from __future__ import annotations

import numpy as np
import pytest

from mpi_openmp_cuda_tpu.analysis import recompile as jrecompile
from mpi_openmp_cuda_tpu_torch.analysis import SeqcheckError, recompile
from mpi_openmp_cuda_tpu_torch.ops import _build
from mpi_openmp_cuda_tpu_torch.ops.dispatch import AlignmentScorer


def test_compile_count_is_the_build_count():
    assert recompile.compile_count() == _build.build_count()


def test_tally_counts_deltas_and_freezes():
    with recompile.count_compiles() as tally:
        assert tally.count == 0
        _build.note_setup()
        _build.note_setup()
        assert tally.count == 2  # live inside the block
    _build.note_setup()
    assert tally.count == 2  # frozen after it


def test_assert_compiles_zero_passes_on_a_cpu_scoring_run():
    scorer = AlignmentScorer("cuda", device="cpu")
    seq1 = np.array([1, 2, 3, 4, 5, 6, 7, 8], np.int8)
    seqs = [np.array([1, 2], np.int8), np.array([3, 4, 5], np.int8)]
    with recompile.assert_compiles(0) as tally:
        scorer.score_codes(seq1, seqs, [10, 2, 3, 4])
    assert tally.count == 0


def test_assert_compiles_names_the_breach():
    with pytest.raises(SeqcheckError, match="made 1 kernel build"):
        with recompile.assert_compiles(0):
            _build.note_setup()
    with pytest.raises(SeqcheckError, match="pinned expectation is 2"):
        with recompile.assert_compiles(2):
            _build.note_setup()
    with recompile.assert_compiles(1):
        _build.note_setup()


def test_at_most_bound():
    with recompile.assert_compiles(at_most=2):
        _build.note_setup()
    with pytest.raises(SeqcheckError, match="bound is 1"):
        with recompile.assert_compiles(at_most=1):
            _build.note_setup()
            _build.note_setup()


@pytest.mark.parametrize("mod", [recompile, jrecompile], ids=["port", "jax"])
@pytest.mark.parametrize("kw", [{}, {"expected": 0, "at_most": 1}])
def test_exactly_one_pin_in_both_packages(mod, kw):
    with pytest.raises(ValueError, match="exactly one"):
        with mod.assert_compiles(**kw):
            pass


def test_the_breach_is_a_runtime_error_in_both_packages():
    from mpi_openmp_cuda_tpu.analysis import SeqcheckError as JSeqcheckError

    assert issubclass(SeqcheckError, RuntimeError) and issubclass(JSeqcheckError, RuntimeError)


def test_build_events_are_counted(monkeypatch, tmp_path):
    """A build counts once per compiled source (``_build._compile``), as the
    serve loop's ``serve_steady_compiles`` reads it."""
    import subprocess

    class Done:
        returncode = 0

        def __init__(self, cmd, **kw):
            self.out = cmd[cmd.index("-o") + 1]

        def communicate(self):
            open(self.out, "w").close()
            return "ptxas info", None

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", Done)
    with recompile.count_compiles() as tally:
        _build.build(["fused_scorer", "packed_scorer"])
        _build.build(["fused_scorer", "packed_scorer"])  # built: no second count
    assert tally.count == 2
