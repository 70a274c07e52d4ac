"""What decides ``correct``: the program's answers against the plain
reference (:mod:`.reference`), each number compared beside its limit.

A batch job's answer is its whole stdout; a served request's is its
streamed lines, in order, and its ``done`` count.  Every answer is checked
for its form; a sample drawn from the seed, of the pool jobs or of the
done requests (the longest request always among them), is checked
against the reference, which is computed in threads (NumPy releases the
interpreter lock inside its loops).

Every limit is 0: the comparison is exact.
"""

from __future__ import annotations

import re
from concurrent.futures import ThreadPoolExecutor

from . import reference
from .generate import rng_for

LINE = re.compile(r"#(\d+): score: (-?\d+), n: (\d+), k: (\d+)")
THREADS = 8


def limits(numbers: dict) -> dict:
    """``{name: {"value": v, "limit": 0}}`` for each compared count."""
    return {k: {"value": int(v), "limit": 0} for k, v in numbers.items()}


def well_formed(lines, count: int) -> bool:
    """``count`` result lines numbered ``0 .. count - 1`` in order."""
    if len(lines) != count:
        return False
    for i, text in enumerate(lines):
        m = LINE.fullmatch(text)
        if m is None or int(m.group(1)) != i:
            return False
    return True


def sample(seed: int, candidates, count: int, always=()) -> list:
    """``count`` of ``candidates`` drawn from the seed, plus ``always``."""
    cand = sorted(set(candidates) - set(always))
    rng = rng_for(seed, 9)
    picked = rng.choice(len(cand), size=min(count, len(cand)), replace=False) if cand else []
    return sorted({*always, *(cand[int(i)] for i in picked)})


def parallel(fn, items) -> list:
    """``fn`` over ``items`` in threads, in order."""
    with ThreadPoolExecutor(THREADS) as ex:
        return list(ex.map(fn, items))


def wrong_lines(got: str, want: str) -> int:
    """Lines of ``got`` that differ from ``want``, plus any missing."""
    g, w = got.splitlines(), want.splitlines()
    return sum(a != b for a, b in zip(g, w)) + abs(len(g) - len(w))


def judge_batch(texts: dict, outputs: dict, malformed: int, unstable: int) -> tuple[dict, set]:
    """Checks of a batch window, and the sampled jobs found wrong.
    ``texts``/``outputs``: the sampled pool jobs' stdin and the program's
    stdout for each; ``malformed``: jobs that failed or printed the wrong
    form; ``unstable``: repeats of a pool job whose stdout differed from
    its first."""
    keys = sorted(texts)
    want = parallel(lambda i: reference.stdout(texts[i]), keys)
    wrong = {i: wrong_lines(outputs[i], w) for i, w in zip(keys, want)}
    checks = limits({"wrong_lines": sum(wrong.values()), "malformed_jobs": malformed,
                     "unstable_jobs": unstable})
    return checks, {i for i, n in wrong.items() if n}


def request_rows(raw: dict, **variant) -> list[str]:
    """The reference's lines for one served request."""
    rows = reference.rows(raw["weights"], raw["seq1"], raw["seq2"], **variant)
    return [reference.line(j, r) for j, r in enumerate(rows)]


def judge_serve(raws: dict, lines: dict, bad_answers: int) -> tuple[dict, set]:
    """Checks of a serve window, and the sampled requests found wrong.
    ``raws``/``lines``: the sampled done requests and their streamed
    lines; ``bad_answers``: requests missing, reset, failed untyped or
    done with lines of the wrong form."""
    keys = sorted(raws)
    want = parallel(lambda rid: request_rows(raws[rid]), keys)
    wrong = {rid: sum(a != b for a, b in zip(lines[rid], w)) + abs(len(lines[rid]) - len(w))
             for rid, w in zip(keys, want)}
    checks = limits({"wrong_lines": sum(wrong.values()), "bad_answers": bad_answers})
    return checks, {rid for rid, n in wrong.items() if n}
