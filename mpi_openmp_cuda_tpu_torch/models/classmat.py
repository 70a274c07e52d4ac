"""Pair-classification matrix builder (reference parity: C4).

The reference flattens group membership into two 27x27 0/1 lookup matrices
(`build_mat`, main.c:14-44 — buggily, see SURVEY B1) and tests them in
precedence order inside the kernel (cudaFunctions.cu:88-95).  The TPU build
collapses both matrices and the precedence chain into ONE dense int8 27x27
matrix of class ids (0='$', 1='%', 2='#', 3=space), built host-side once and
replicated to devices — the `__constant__`-memory analogue (C10).

Index 0 of both axes is reserved for pad/hyphen (main.c:38 "do not use
index 0"); its class is irrelevant because pad positions are masked to a
zero score contribution before any reduction.
"""

from __future__ import annotations

import functools

import numpy as np

from ..utils.constants import (
    ALPHABET_SIZE,
    CLASS_DOLLAR,
    CLASS_HASH,
    CLASS_PERCENT,
    CLASS_SPACE,
)
from .groups import CONSERVATIVE_GROUPS, SEMI_CONSERVATIVE_GROUPS


def _code(ch: str) -> int:
    return ord(ch) - ord("A") + 1


@functools.cache
def build_class_matrix() -> np.ndarray:
    """Dense [27, 27] int8 matrix of class ids with '$'>'%'>'#'>space precedence.

    Cached: the matrix is a pure function of the hard-coded spec group tables.
    Returned array is read-only to keep the cache safe.
    """
    mat = np.full((ALPHABET_SIZE, ALPHABET_SIZE), CLASS_SPACE, dtype=np.int8)
    # Lowest precedence first so later writes implement the precedence chain.
    for group in SEMI_CONSERVATIVE_GROUPS:
        codes = [_code(c) for c in group]
        for a in codes:
            for b in codes:
                mat[a, b] = CLASS_HASH
    for group in CONSERVATIVE_GROUPS:
        codes = [_code(c) for c in group]
        for a in codes:
            for b in codes:
                mat[a, b] = CLASS_PERCENT
    for a in range(1, ALPHABET_SIZE):
        mat[a, a] = CLASS_DOLLAR
    mat.setflags(write=False)
    return mat


def classify_pair(a: str, b: str) -> int:
    """Class id for a single uppercase character pair (unit-test helper)."""
    return int(build_class_matrix()[_code(a), _code(b)])
