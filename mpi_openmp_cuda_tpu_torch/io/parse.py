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
    """Context manager yielding the input stream (stdin for None/'-');
    the streaming parse holds it open across the whole scoring loop."""
    if path is None or path == "-":
        yield sys.stdin
    else:
        with open(path, "r", encoding="ascii") as f:
            yield f


# ---- streaming parse (the --stream pipeline's input side) -----------------


def _iter_tokens(stream: TextIO, bufsize: int = 1 << 20):
    """Yield whitespace-delimited tokens without reading the whole stream."""
    leftover = ""
    while True:
        block = stream.read(bufsize)
        if not block:
            if leftover:
                yield leftover
            return
        if leftover:
            block = leftover + block
        parts = block.split()
        # A block ending mid-token holds that token back for the next read.
        leftover = parts.pop() if parts and not block[-1].isspace() else ""
        yield from parts


@dataclass
class StreamHeader:
    """Parsed header of a streaming problem; Seq2s are pulled on demand.

    The reference reads the whole batch before computing (main.c:96-108).
    Streaming keeps host memory bounded by the chunk size and lets the CLI
    overlap parsing chunk i+1 with device compute on chunk i — the host-IO
    / device-compute pipelining tier (SURVEY §2.4 PP row).
    """

    weights: list[int]
    seq1: str
    seq1_codes: np.ndarray
    num_seq2: int
    _tokens: object  # token iterator positioned at the first Seq2

    def iter_chunks(self, chunk_size: int):
        """Yield ``(start_index, [seq2_codes...])`` of <= chunk_size
        sequences each, encoding (and validating) lazily.  Raises
        InputFormatError if the stream ends before ``num_seq2`` sequences.
        """
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        done = 0
        while done < self.num_seq2:
            take = min(chunk_size, self.num_seq2 - done)
            codes: list[np.ndarray] = []
            for _ in range(take):
                tok = next(self._tokens, None)
                if tok is None:
                    raise InputFormatError(
                        f"declared {self.num_seq2} sequences but stream "
                        f"ended at {done + len(codes)}"
                    )
                codes.append(encode_normalized(tok))
            yield done, codes
            done += take


def parse_stream_header(stream: TextIO) -> StreamHeader:
    """Parse weights/Seq1/N and return a header whose chunks stream."""
    tokens = _iter_tokens(stream)
    head = [t for _, t in zip(range(6), tokens)]
    weights, seq1, n = _parse_header_tokens(head)
    return StreamHeader(
        weights=weights,
        seq1=seq1,
        seq1_codes=encode_normalized(seq1),
        num_seq2=n,
        _tokens=tokens,
    )
