"""Reference oracles for the alignment search (SURVEY Appendix A semantics).

Two independent host-side (numpy) implementations of the clean behavioural
contract, used as the ground truth the accelerated paths are property-tested
against (the test pyramid the reference lacks, SURVEY §4):

* ``brute_force_best`` — literal transcription of the spec: O((L1-L2)*L2^2),
  the same asymptotic shape as the reference kernel's serial candidate-grid
  loop (cudaFunctions.cu:116-168), minus its races.
* ``prefix_best`` — the O(L1*L2) diagonal prefix-sum formulation (SURVEY
  §7.2) that the XLA/Pallas device paths vectorise.

Both implement the exact reference semantics:
* mutant k: hyphen inserted after the k-th character; chars i < k pair with
  seq1[n+i], chars i >= k with seq1[n+i+1]; k = 0 encodes hyphen-after-end
  (all chars unshifted) — the reference's encoding of spec-k = len2
  (cudaFunctions.cu:118,132; SURVEY A.2/§7.4.3).
* offsets n in [0, len1-len2) (cudaFunctions.cu:116).
* tie-break: first maximum in offset-major, k-ascending-with-0-first order
  (strict-> update, cudaFunctions.cu:161; SURVEY A.3).
* len2 == len1: direct positional score, n = 0, k = 0 (branch A,
  cudaFunctions.cu:74-106); len2 > len1: (INT32_MIN, 0, 0) (SURVEY B12).
"""

from __future__ import annotations

import numpy as np

from ..utils.constants import INT32_MIN
from .values import value_table

Result = tuple[int, int, int]  # (score, n, k)


def _as_codes(seq) -> np.ndarray:
    return np.asarray(seq, dtype=np.int64)


def equal_length_score(seq1, seq2, weights) -> int:
    """Positional score of two equal-length code vectors (branch A)."""
    seq1, seq2 = _as_codes(seq1), _as_codes(seq2)
    if seq1.size != seq2.size:
        # Runtime path: must survive python -O (seqlint SEQ004).
        raise RuntimeError(
            f"equal_length_score needs equal-length inputs, got "
            f"{seq1.size} vs {seq2.size}"
        )
    val = value_table(weights)
    return int(val[seq2, seq1].sum())


def brute_force_best(seq1, seq2, weights) -> Result:
    """Exhaustive search over all (n, k) candidates. Small inputs only."""
    seq1, seq2 = _as_codes(seq1), _as_codes(seq2)
    l1, l2 = seq1.size, seq2.size
    if l2 > l1:
        return INT32_MIN, 0, 0
    if l2 == l1:
        return equal_length_score(seq1, seq2, weights), 0, 0
    val = value_table(weights)
    best, best_n, best_k = INT32_MIN, 0, 0
    for n in range(l1 - l2):
        for k in range(l2):  # k=0 (hyphen after end) first, then 1..l2-1
            s = 0
            for i in range(l2):
                j = n + i if (k == 0 or i < k) else n + i + 1
                s += int(val[seq2[i], seq1[j]])
            if s > best:
                best, best_n, best_k = s, n, k
    return best, best_n, best_k


def prefix_best(seq1, seq2, weights) -> Result:
    """Diagonal prefix-sum search, O(L1*L2). Exact same results as brute force."""
    seq1, seq2 = _as_codes(seq1), _as_codes(seq2)
    l1, l2 = seq1.size, seq2.size
    if l2 > l1:
        return INT32_MIN, 0, 0
    if l2 == l1:
        return equal_length_score(seq1, seq2, weights), 0, 0
    if l2 == 0:
        # Empty candidate: the (n, k) grid has no k values (k ranges over
        # 0..l2-1), so no candidate is ever scored — INT_MIN sentinel, same
        # as the reference's never-updated best (cudaFunctions.cu:113).
        return INT32_MIN, 0, 0
    val = value_table(weights).astype(np.int64)
    n = np.arange(l1 - l2)[:, None]
    i = np.arange(l2)[None, :]
    v0 = val[seq2[None, :], seq1[n + i]]  # pair values on the unshifted diagonal
    v1 = val[seq2[None, :], seq1[n + i + 1]]  # ... and the hyphen-shifted diagonal
    c0 = v0.cumsum(axis=1)
    c1 = v1.cumsum(axis=1)
    t0, t1 = c0[:, -1:], c1[:, -1:]
    # Column j holds k=j: k=0 -> full unshifted sum; k>=1 -> prefix(k) + shifted suffix(k).
    scores = np.concatenate([t0, c0[:, :-1] + (t1 - c1[:, :-1])], axis=1)
    flat = int(scores.argmax())  # first max in n-major, k=0,1,.. order == reference order
    return int(scores.reshape(-1)[flat]), flat // l2, flat % l2


def score_batch_oracle(seq1, seq2_list, weights) -> list[Result]:
    """prefix_best over a ragged batch (the whole program, as one pure function)."""
    return [prefix_best(seq1, s2, weights) for s2 in seq2_list]
