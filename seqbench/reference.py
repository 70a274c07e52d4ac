"""The plain reference: the course spec's scoring (SURVEY.md Appendix A) in
NumPy, written from the spec alone.

For each Seq2 the best ``(score, n, k)`` over offsets ``n = 0 .. len1 -
len2 - 1`` and hyphen positions ``k``: the mutant ``MS(k)`` has a hyphen
after its k-th character, chars ``i < k`` meet ``seq1[n + i]`` and chars
``i >= k`` meet ``seq1[n + i + 1]``; the hyphen at the end is reported as
``k = 0``.  Ties go to the first candidate in offset-major order with
``k = 0`` first, then ``k = 1 .. len2 - 1``.  ``len2 == len1`` scores
positionally at ``n = k = 0``; ``len2 > len1`` or ``len2 == 0`` give
``(INT32_MIN, 0, 0)``.

A pair's candidates come from prefix sums along diagonals: with
``P[m, i]`` the sum of the first ``i + 1`` values of diagonal ``m`` and
``T[m]`` its total, ``score(n, 0) = T[n]`` and ``score(n, k) = P[n, k - 1]
+ T[n + 1] - P[n + 1, k - 1]``.  Sums are exact: int32 where no candidate
can pass its range, else int64.  ``acc`` forces a narrower accumulator,
which is how the benchmark's control computes in a precision below the
configuration's.

Nothing here imports the program under test.
"""

from __future__ import annotations

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

INT32_MIN = -(2**31)

# Appendix A.1: the 9 conservative and the 11 semi-conservative groups.
CONSERVATIVE = ("NDEQ", "NEQK", "STA", "MILV", "QHRK", "NHQK", "FYW", "HY", "MILF")
SEMI_CONSERVATIVE = ("SAG", "ATV", "CSA", "SGND", "STPA", "STNK", "NEQHRK", "NDEQHK",
                     "SNDEQK", "HFY", "FVLIM")


def _same_group(groups) -> np.ndarray:
    out = np.zeros((26, 26), bool)
    for g in groups:
        idx = [ord(c) - 65 for c in g]
        out[np.ix_(idx, idx)] = True
    return out


_CONS = _same_group(CONSERVATIVE)
_SEMI = _same_group(SEMI_CONSERVATIVE)


def value_table(weights) -> np.ndarray:
    """[26, 26] int64 value of a (Seq2 char, Seq1 char) pair: ``w1`` if
    equal, else ``-w2`` in a conservative group, else ``-w3`` in a
    semi-conservative one, else ``-w4``."""
    w1, w2, w3, w4 = (int(w) for w in weights)
    table = np.full((26, 26), -w4, np.int64)
    table[_SEMI] = -w3
    table[_CONS] = -w2
    np.fill_diagonal(table, w1)
    return table


def encode(seq: str) -> np.ndarray:
    """Uppercase A-Z -> uint8 codes 0..25; anything else is refused."""
    codes = np.frombuffer(seq.upper().encode("ascii"), np.uint8) - 65
    if codes.size and int(codes.max()) > 25:
        raise ValueError(f"not a letter sequence: {seq[:32]!r}")
    return codes


def exact_acc(table: np.ndarray, len2: int):
    """The narrowest exact accumulator: every prefix sum and candidate of a
    pair is within ``3 * len2 * max|value|``."""
    return np.int32 if 3 * max(len2, 1) * int(np.abs(table).max()) < 2**31 else np.int64


def best(s1: np.ndarray, s2: np.ndarray, table: np.ndarray, acc=None,
         last_hit: bool = False) -> tuple[int, int, int]:
    """``(score, n, k)`` of one pair of code arrays under ``table``; ``acc``
    is the accumulator type (default: exact).  ``last_hit`` breaks ties
    toward the last candidate instead of the first (a control only)."""
    len1, len2 = len(s1), len(s2)
    if len2 == 0 or len2 > len1:
        return INT32_MIN, 0, 0
    tab = table.astype(acc or exact_acc(table, len2))
    if len2 == len1:
        return int(tab[s2, s1].sum(dtype=tab.dtype)), 0, 0
    noff = len1 - len2
    # diag[m, i] = value(s2[i], s1[m + i]): one flat lookup in s2's rows.
    idx = sliding_window_view(s1, len2)[: noff + 1].astype(np.int32)
    idx += np.arange(0, 26 * len2, 26, dtype=np.int32)
    diag = np.take(tab[s2].ravel(), idx)
    prefix = np.cumsum(diag, axis=1, dtype=tab.dtype)
    total = prefix[:, -1]
    cand = np.empty((noff, len2), tab.dtype)
    cand[:, 0] = total[:noff]
    np.subtract(prefix[:noff, :-1], prefix[1:, :-1], out=cand[:, 1:])
    cand[:, 1:] += total[1:, None]
    flat = cand.size - 1 - int(np.argmax(cand.ravel()[::-1])) if last_hit else int(np.argmax(cand))
    return int(cand.flat[flat]), flat // len2, flat % len2


def parse(text: str) -> tuple[list[int], str, list[str]]:
    """The spec's stdin: four weights, Seq1, N, then N Seq2s."""
    tokens = text.split()
    weights = [int(t) for t in tokens[:4]]
    seq1, n = tokens[4], int(tokens[5])
    seqs = tokens[6 : 6 + n]
    if len(seqs) != n:
        raise ValueError(f"declared {n} sequences but found {len(seqs)}")
    return weights, seq1, seqs


def rows(weights, seq1: str, seqs, **variant) -> list[tuple[int, int, int]]:
    """``(score, n, k)`` for each Seq2 of one problem (``variant``: the
    keywords of :func:`best`)."""
    table = value_table(weights)
    s1 = encode(seq1)
    return [best(s1, encode(s), table, **variant) for s in seqs]


def line(i: int, row) -> str:
    """One result line of the spec's stdout."""
    return f"#{i}: score: {row[0]}, n: {row[1]}, k: {row[2]}"


def stdout(text: str, **variant) -> str:
    """The spec's whole stdout for one stdin text."""
    weights, seq1, seqs = parse(text)
    return "".join(line(i, r) + "\n" for i, r in enumerate(rows(weights, seq1, seqs, **variant)))
