"""Canonical synthetic workloads: the deterministic problem factories of
the bench harness and its table, the ablation and floor scripts and
``chip_smoke.py``.

:func:`input3_class_problem` is a copy of the JAX package's
``models/workload.py`` factory: the same rng stream, sizes and weights,
so both packages bench byte-identical codes.
"""

from __future__ import annotations

import numpy as np

#: The input3-class synthetic workload's shape: one ~1.5k Seq1 against
#: 32 Seq2s spanning the bucketed schedule's length range.
INPUT3_CLASS_SEED = 3
INPUT3_CLASS_LEN1 = 1489
INPUT3_CLASS_N_SEQ2 = 32
INPUT3_CLASS_LEN2_RANGE = (56, 1153)
INPUT3_CLASS_WEIGHTS = (2, 2, 1, 10)
INPUT3_CLASS_NAME = "synthetic-input3-class"

#: The max-size workload (``scripts/bench_table.py::synthetic_max``):
#: Seq1 at its 3000-char cap against 64 Seq2 of 1200..1999 chars, seed 7.
MAX_SIZE = (3000, 64, 1200, 1999)


def input3_class_problem():
    """The deterministic input3-class synthetic :class:`~..io.parse.Problem`
    (uppercase sequences from ``default_rng(3)``, weights [2, 2, 1, 10])."""
    from ..io.parse import Problem
    from .encoding import decode, encode_normalized

    rng = np.random.default_rng(INPUT3_CLASS_SEED)
    lo, hi = INPUT3_CLASS_LEN2_RANGE
    seq1 = decode(rng.integers(1, 27, size=INPUT3_CLASS_LEN1))
    lens2 = [int(x) for x in rng.integers(lo, hi, size=INPUT3_CLASS_N_SEQ2)]
    seqs = [decode(rng.integers(1, 27, size=l)) for l in lens2]
    return Problem(
        weights=list(INPUT3_CLASS_WEIGHTS),
        seq1=seq1,
        seq2=seqs,
        seq1_codes=encode_normalized(seq1),
        seq2_codes=[encode_normalized(s) for s in seqs],
    )


def input4_problem():
    """``(seq1_codes, [seq2_codes])`` int8 of the input4-class packed set:
    the fifth draw of ``scripts/sb_refit.py::workloads()``'s seed-7
    generator (``'input4-class-packed'``), Seq1 2976 against 30 Seq2 of
    5..64 chars, every row inside a packing class."""
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


def synthetic_codes(len1: int, count: int, lo: int, hi: int, seed: int = 7):
    """``(seq1_codes, [seq2_codes])`` int8: Seq1 of ``len1`` random codes
    and ``count`` Seq2 of lengths drawn in ``lo..hi`` (inclusive), from
    ``default_rng(seed)`` in the order of ``scripts/kernel_ablate.py
    --synthetic L1xNxLO-HI``; :data:`MAX_SIZE` is the max-size workload."""
    rng = np.random.default_rng(seed)
    seq1 = rng.integers(1, 27, size=len1).astype(np.int8)
    lens = rng.integers(lo, hi + 1, size=count)
    return seq1, [rng.integers(1, 27, size=int(n)).astype(np.int8) for n in lens]
