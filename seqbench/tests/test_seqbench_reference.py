"""The plain reference against the fixture goldens, hand cases for the
sentinels and the tie-break, and a brute-force search of the spec."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from seqbench import reference

FIXTURES = Path(__file__).resolve().parents[2] / "tests" / "fixtures"
GOLDENS = sorted(p.stem for p in FIXTURES.glob("*.txt"))


def brute(s1: str, s2: str, weights) -> tuple[int, int, int]:
    """Appendix A searched literally: each offset, then k = 0 (the hyphen
    at the end), then k = 1 .. len2 - 1, the first strict maximum kept."""
    table = reference.value_table(weights)
    a, b = reference.encode(s1), reference.encode(s2)
    if len(b) == 0 or len(b) > len(a):
        return reference.INT32_MIN, 0, 0
    if len(b) == len(a):
        return int(sum(table[y, x] for x, y in zip(a, b))), 0, 0
    best = None
    for n in range(len(a) - len(b)):
        for k in [0, *range(1, len(b))]:
            cut = len(b) if k == 0 else k
            s = sum(int(table[b[i], a[n + i if i < cut else n + i + 1]]) for i in range(len(b)))
            if best is None or s > best[0]:
                best = (s, n, k)
    return best


def test_seven_goldens_are_all_there():
    assert len(GOLDENS) == 7


@pytest.mark.parametrize("name", GOLDENS)
def test_fixture_golden(name):
    text = (FIXTURES / f"{name}.txt").read_text()
    assert reference.stdout(text) == (FIXTURES / f"{name}.out").read_text()


@pytest.mark.parametrize("s1,s2,want", [
    ("ABC", "ABCD", (reference.INT32_MIN, 0, 0)),  # len2 > len1
    ("ABC", "", (reference.INT32_MIN, 0, 0)),  # len2 = 0
    ("ABC", "ABD", (10 + 10 - 4, 0, 0)),  # len2 = len1: positional, n = k = 0
])
def test_sentinels(s1, s2, want):
    table = reference.value_table([10, 2, 3, 4])
    assert reference.best(reference.encode(s1), reference.encode(s2), table) == want


def test_k0_wins_a_tie_at_its_offset():
    # "AA" against "AAA": at n = 0 the hyphen at the end (k = 0) and after
    # the first char (k = 1) both score 2; k = 0 comes first.
    table = reference.value_table([1, 1, 1, 1])
    assert reference.best(reference.encode("AAA"), reference.encode("AA"), table) == (2, 0, 0)
    assert reference.best(reference.encode("AAA"), reference.encode("AA"), table,
                          last_hit=True) == (2, 0, 1)


def test_first_offset_wins_a_tie():
    table = reference.value_table([5, 1, 1, 1])
    assert reference.best(reference.encode("ZAZAZ"), reference.encode("A"), table) == (5, 1, 0)


def test_prefix_sums_equal_the_literal_search():
    rng = np.random.default_rng(3)
    for trial in range(40):
        len1 = int(rng.integers(1, 24))
        len2 = int(rng.integers(0, len1 + 2))
        s1 = "".join(chr(65 + c) for c in rng.integers(0, 26, len1))
        s2 = "".join(chr(65 + c) for c in rng.integers(0, 26, len2))
        w = [int(x) for x in rng.integers(-5, 12, 4)]
        table = reference.value_table(w)
        got = reference.best(reference.encode(s1), reference.encode(s2), table)
        assert got == brute(s1, s2, w), (trial, s1, s2, w)


def test_int16_accumulation_wraps_where_int32_does_not():
    # A 400-char exact copy at weight 100 scores 40000 > 2**15 - 1.
    rng = np.random.default_rng(4)
    s1 = rng.integers(0, 26, 500).astype(np.uint8)
    s2 = s1[10:410].copy()
    table = reference.value_table([100, 2, 3, 4])
    exact = reference.best(s1, s2, table)
    assert exact[0] == 40000
    assert reference.best(s1, s2, table, acc=np.int16) != exact
