"""Input reader / normaliser (reference parity: C5, main.c:76-108).

The reference reads whitespace-delimited tokens from stdin with fscanf —
4 weights, Seq1, a count N, then N Seq2 strings — and uppercases them with
(racy) OpenMP loops.  Here parsing is token-based on the whole stream and
normalisation is vectorised in numpy during encoding; the race is designed
out because nothing is shared-mutable.
"""

from __future__ import annotations

import contextlib
import sys
from dataclasses import dataclass, field
from typing import TextIO

import numpy as np

from ..models.encoding import encode_normalized
from ..utils.constants import INT32_MIN


class InputFormatError(ValueError):
    """Raised when stdin does not follow the A.4 input contract."""


@dataclass
class Problem:
    """One batch scoring problem (the program's entire runtime config, A.4).

    Carries both the raw text and the integer encodings: sequences are
    normalised+encoded exactly once, at parse time.
    """

    weights: list[int]
    seq1: str
    seq2: list[str] = field(default_factory=list)
    seq1_codes: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int8))
    seq2_codes: list[np.ndarray] = field(default_factory=list)

    @property
    def num_seq2(self) -> int:
        return len(self.seq2)


def _parse_header_tokens(head: list[str]) -> tuple[list[int], str, int]:
    """Validate the 6 header tokens: 4 weights, Seq1, N."""
    if len(head) < 6:
        raise InputFormatError(
            "input too short: expected 'w1 w2 w3 w4  Seq1  N  Seq2...'"
        )
    try:
        weights = [int(t) for t in head[:4]]
    except ValueError as e:
        raise InputFormatError(f"bad weight token: {e}") from e
    for w in weights:
        # The reference reads weights as C int (main.c:76); out-of-range
        # values must fail here, not as an opaque overflow downstream.
        # INT32_MIN itself is excluded: weights w2..w4 are negated into an
        # int32 table (values.signed_weights), and -INT32_MIN overflows.
        if not INT32_MIN < w < 2**31:
            raise InputFormatError(f"weight {w} outside 32-bit integer range")
    seq1 = head[4]
    try:
        n = int(head[5])
    except ValueError as e:
        raise InputFormatError(f"bad sequence count token {head[5]!r}") from e
    if n < 0:
        raise InputFormatError(f"negative sequence count {n}")
    return weights, seq1, n


def parse_problem(stream: TextIO) -> Problem:
    """Parse the reference stdin format into a Problem."""
    tokens = stream.read().split()
    weights, seq1, n = _parse_header_tokens(tokens[:6])
    seqs = tokens[6 : 6 + n]
    if len(seqs) != n:
        raise InputFormatError(
            f"declared {n} sequences but found {len(seqs)}"
        )
    # Encode once here: validates characters early (fail-stop before any
    # device work, §5) and hands ready-to-pad code arrays downstream.
    seq1_codes = encode_normalized(seq1)
    seq2_codes = [encode_normalized(s) for s in seqs]
    return Problem(
        weights=weights,
        seq1=seq1,
        seq2=list(seqs),
        seq1_codes=seq1_codes,
        seq2_codes=seq2_codes,
    )


def load_problem(path: str | None = None) -> Problem:
    """Load a problem from a file path, or stdin when path is None/'-'."""
    with open_input(path) as f:
        return parse_problem(f)


@contextlib.contextmanager
def open_input(path: str | None = None):
    """Context manager yielding the input stream (stdin for None/'-')."""
    if path is None or path == "-":
        yield sys.stdin
    else:
        with open(path, "r", encoding="ascii") as f:
            yield f
