"""Sequence text <-> integer-code encoding (part of reference C5's job).

The reference uppercases input in-place with OpenMP loops (`main.c:82-96`)
and keeps sequences as C strings.  The TPU build normalises once on the host
and encodes to small integer codes: 0 = pad (reserved, like the reference's
unused matrix index 0, `main.c:38`), 1..26 = 'A'..'Z'.  Codes index directly
into the 27x27 class matrix.
"""

from __future__ import annotations

import numpy as np

from ..utils.constants import PAD_CODE


class InvalidSequenceError(ValueError):
    """Raised when a sequence contains characters outside A-Z after uppercasing."""


def normalize(text: str) -> str:
    """Uppercase a raw sequence string (the OpenMP-parallel-for's job)."""
    return text.strip().upper()


def encode(seq: str) -> np.ndarray:
    """Encode an (already normalised) A-Z string to int8 codes 1..26."""
    try:
        raw = seq.encode("ascii", errors="strict")
    except UnicodeEncodeError as e:
        raise InvalidSequenceError(
            f"invalid sequence character {seq[e.start]!r}; expected A-Z"
        ) from e
    buf = np.frombuffer(raw, dtype=np.uint8)
    codes = buf.astype(np.int8) - (ord("A") - 1)
    if codes.size and (codes.min() < 1 or codes.max() > 26):
        bad = seq[int(np.argmax((codes < 1) | (codes > 26)))]
        raise InvalidSequenceError(f"invalid sequence character {bad!r}; expected A-Z")
    return codes


def encode_normalized(text: str) -> np.ndarray:
    """normalize + encode in one step."""
    return encode(normalize(text))


def decode(codes: np.ndarray) -> str:
    """Inverse of encode (pads are dropped)."""
    codes = np.asarray(codes)
    codes = codes[codes != PAD_CODE]
    return bytes((codes + (ord("A") - 1)).astype(np.uint8)).decode("ascii")


def pad_to(codes: np.ndarray, length: int) -> np.ndarray:
    """Right-pad a code vector with PAD_CODE to a fixed length."""
    if codes.size > length:
        raise InvalidSequenceError(
            f"sequence length {codes.size} exceeds buffer size {length}"
        )
    out = np.full(length, PAD_CODE, dtype=np.int8)
    out[: codes.size] = codes
    return out
