"""Amino-acid substitution groups (reference parity: C3).

The spec (parallel_finalEx2021_summer.pdf p.1-2) defines 9 conservative and
11 semi-conservative amino-acid groups; the reference hard-codes them as two
string arrays (`main.c:59-60`).  Two characters in the same conservative
group classify as '%'; in the same semi-conservative group (and not
conservative / identical) as '#'.
"""

from __future__ import annotations

CONSERVATIVE_GROUPS: tuple[str, ...] = (
    "NDEQ",
    "NEQK",
    "STA",
    "MILV",
    "QHRK",
    "NHQK",
    "FYW",
    "HY",
    "MILF",
)

SEMI_CONSERVATIVE_GROUPS: tuple[str, ...] = (
    "SAG",
    "ATV",
    "CSA",
    "SGND",
    "STPA",
    "STNK",
    "NEQHRK",
    "NDEQHK",
    "SNDEQK",
    "HFY",
    "FVLIM",
)
