"""Result self-check (``--selfcheck``; the port of ``mpi_openmp_cuda_tpu/
utils/selfcheck.py``): after a batch is scored, a deterministic sample
of sequences is rescored on the host oracle (``ops/oracle.py``) and
compared exactly.  A mismatch is a bug, never noise, so it is fatal.
"""

from __future__ import annotations

import numpy as np

from ..ops.oracle import score_batch_oracle

# Bounded sample: the oracle is O(L1*L2) per sequence on the host, so a
# full-batch check would dwarf the accelerated run it validates.
DEFAULT_SAMPLE = 8


class SelfCheckError(RuntimeError):
    """Accelerated result disagrees with the host oracle."""


def sample_indices(total: int, sample: int = DEFAULT_SAMPLE) -> list[int]:
    """Deterministic spread over the batch: first, last, and evenly between.

    Deterministic (not random) so a failure reproduces exactly on rerun.
    """
    if total <= 0:
        return []
    n = min(total, max(1, sample))
    return sorted({int(i) for i in np.linspace(0, total - 1, n)})


def verify_results(
    problem, results: np.ndarray, sample: int = DEFAULT_SAMPLE
) -> int:
    """Rescore a sample on the host oracle; raise SelfCheckError on mismatch.

    Returns the number of sequences checked.
    """
    idx = sample_indices(len(problem.seq2_codes), sample)
    if not idx:
        return 0
    expected = score_batch_oracle(
        problem.seq1_codes,
        [problem.seq2_codes[i] for i in idx],
        problem.weights,
    )
    for i, exp in zip(idx, expected):
        got = tuple(int(v) for v in results[i])
        if got != tuple(exp):
            raise SelfCheckError(
                f"selfcheck: sequence #{i}: accelerated result "
                f"(score, n, k)={got} != oracle {tuple(exp)}"
            )
    return len(idx)
