"""A database scan's jobs, made from ``--seed`` and a traffic file's numbers:
one query (Seq1) against a database of Seq2s whose lengths follow a law of
the traffic's (``seq2_len_law``), truncated to ``seq2_len``.

The law is log-normal, ``{"law": "lognormal", "median": m, "sigma": s}``.
A job's ``seq2_per_job`` lengths are its truncated law's quantiles at the
midpoints of equal strata, shuffled: every job of every seed holds the
same multiset of lengths, in another order, so every seed does the same
work.  Letters, homologs of the query (``homolog_share``, with
``homolog_mutation`` of their chars replaced) and the text of a job are
:mod:`.generate`'s; job ``j`` uses the configuration's weight tuple ``j
mod len(weights)``.

Nothing here reads a clock or the program under test.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

from .generate import Job, rng_for, seq2_set, text_of
from .roofline import input_bytes, needed_cells


def quantile_lengths(count: int, law: dict, lo: int, hi: int) -> np.ndarray:
    """The law's ``count`` stratum midpoints in ``[lo, hi]``, ascending."""
    if law.get("law") != "lognormal":
        raise ValueError(f"unknown length law {law!r}")
    norm = NormalDist(math.log(float(law["median"])), float(law["sigma"]))
    p_lo, p_hi = norm.cdf(math.log(lo)), norm.cdf(math.log(hi + 1))
    ps = p_lo + (np.arange(count) + 0.5) / count * (p_hi - p_lo)
    lens = np.array([int(math.exp(norm.inv_cdf(float(p)))) for p in ps], dtype=np.int64)
    return np.clip(lens, lo, hi)


def jobs(seed: int, config: dict, traffic: dict) -> list[Job]:
    """The cell's pool of ``pool_jobs`` distinct scan jobs."""
    weights = config["weights"]
    len1 = int(traffic["seq1_len"])
    count = int(traffic["seq2_per_job"])
    lo, hi = (int(x) for x in traffic["seq2_len"])
    base = quantile_lengths(count, traffic["seq2_len_law"], lo, hi)
    out = []
    for j in range(int(traffic["pool_jobs"])):
        rng = rng_for(seed, 5, j)
        seq1 = rng.integers(0, 26, len1)
        lens = rng.permutation(base)
        seqs = seq2_set(rng, seq1, lens, traffic)
        w = " ".join(str(x) for x in weights[j % len(weights)])
        text = f"{w}\n{text_of(seq1)}\n{count}\n" + "\n".join(seqs) + "\n"
        out.append(Job(text, count, needed_cells(len1, lens), input_bytes(len1, lens)))
    return out
