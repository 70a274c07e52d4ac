"""The benchmark's traffic, made from ``--seed`` and a traffic file's numbers
(adapted from the port's ``load/workload.py`` to the spec's shapes).

Every seed gets the same multiset of sizes, in another order, so runs of
different seeds do the same amount of work:

* lengths are stratified: ``count`` lengths from ``[lo, hi]`` take one
  value from each of ``count`` equal strata, then are shuffled;
* shares (homologs, problems) are exact counts, placed by a seeded
  permutation.

Sequences are uppercase A-Z.  A **homolog** is a slice of its Seq1 with
one character deleted (where the best hyphen goes) and a share of its
characters replaced, as a share of the reference fixtures' Seq2s are
(input2's one Seq2 is its Seq1 less one char; 8 of input3's 32 score far
above the rest): such a best score is large (past 2**15 at weight 100 and
1200 chars) and ``(n, k)`` is a real optimum rather than a tie among
noise.

Nothing here reads a clock or the program under test.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np

from .arrival import arrival_times
from .roofline import input_bytes, needed_cells


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of one seed (any whole number)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64, *stream]))


def stratified(rng: np.random.Generator, count: int, lo: int, hi: int) -> np.ndarray:
    """``count`` lengths in ``[lo, hi]``, one from each equal stratum,
    shuffled."""
    width = (hi - lo + 1) / count
    lens = lo + ((np.arange(count) + rng.random(count)) * width).astype(np.int64)
    return rng.permutation(np.minimum(lens, hi))


def exact_mask(rng: np.random.Generator, count: int, share: float) -> np.ndarray:
    """A shuffled boolean mask with ``round(share * count)`` true."""
    mask = np.zeros(count, bool)
    mask[: int(round(share * count))] = True
    return rng.permutation(mask)


def text_of(codes: np.ndarray) -> str:
    return (codes.astype(np.uint8) + 65).tobytes().decode("ascii")


def homolog(rng: np.random.Generator, seq1: np.ndarray, length: int, mutation: float) -> np.ndarray:
    """A ``length``-char slice of ``seq1`` with one char deleted and
    ``mutation`` of its chars replaced by random letters."""
    off = int(rng.integers(0, len(seq1) - length))
    piece = seq1[off : off + length + 1]
    cut = int(rng.integers(1, length + 1))
    out = np.concatenate([piece[:cut], piece[cut + 1 :]])
    swap = rng.random(length) < mutation
    out[swap] = rng.integers(0, 26, int(swap.sum()))
    return out


def seq2_set(rng, seq1: np.ndarray, lens, traffic: dict) -> list[str]:
    """Seq2 strings of the given lengths; ``traffic``'s ``homolog_share``
    of them homologs of ``seq1`` (where they fit), ``homolog_mutation``
    of each homolog's chars replaced."""
    share = traffic.get("homolog_share", 0.0)
    mutation = traffic.get("homolog_mutation", 0.0)
    hom = exact_mask(rng, len(lens), share)
    out = []
    for n, h in zip(lens, hom):
        n = int(n)
        codes = homolog(rng, seq1, n, mutation) if h and n < len(seq1) else rng.integers(0, 26, n)
        out.append(text_of(codes))
    return out


@dataclass(frozen=True)
class Job:
    """One batch job: the spec's stdin text and its work."""

    text: str
    rows: int
    cells: int
    bytes: int


def jobs(seed: int, config: dict, traffic: dict) -> list[Job]:
    """The cell's pool of ``pool_jobs`` distinct batch jobs.  Job ``j``
    uses the config's weight tuple ``j mod len(weights)``."""
    weights = config["weights"]
    len1 = int(traffic["seq1_len"])
    count = int(traffic["seq2_per_job"])
    lo, hi = traffic["seq2_len"]
    out = []
    for j in range(int(traffic["pool_jobs"])):
        rng = rng_for(seed, 1, j)
        seq1 = rng.integers(0, 26, len1)
        lens = stratified(rng, count, lo, hi)
        seqs = seq2_set(rng, seq1, lens, traffic)
        w = " ".join(str(x) for x in weights[j % len(weights)])
        text = f"{w}\n{text_of(seq1)}\n{count}\n" + "\n".join(seqs) + "\n"
        out.append(Job(text, count, needed_cells(len1, lens), input_bytes(len1, lens)))
    return out


@dataclass(frozen=True)
class Request:
    """One served request: its wire line and its work."""

    id: str
    raw: dict
    payload: bytes
    cells: int


def _request(rid: str, weights, seq1: str, seqs: list[str]) -> Request:
    raw = {"id": rid, "weights": list(weights), "seq1": seq1, "seq2": seqs}
    lens = [len(s) for s in seqs]
    return Request(rid, raw, (json.dumps(raw) + "\n").encode(), needed_cells(len(seq1), lens))


def problems(seed: int, traffic: dict) -> list[tuple[dict, np.ndarray]]:
    """One Seq1 a problem of the traffic's ``problems`` (the fixture
    shapes): ``(problem, seq1 codes)``, drawn from the seed."""
    rng = rng_for(seed, 2)
    return [(p, rng.integers(0, 26, int(p["seq1_len"]))) for p in traffic["problems"]]


def requests(seed: int, config: dict, traffic: dict, count: int, prefix: str, stream: int = 3) -> list[Request]:
    """``count`` requests, each one problem of the traffic's ``problems``
    (its weights and Seq1, and ``seq2_count`` fresh Seq2s), every problem
    equally often in a seeded order; a problem's Seq2 lengths are
    stratified over all its rows in the list."""
    keys = problems(seed, traffic)
    rng = rng_for(seed, stream)
    which = rng.permutation(np.arange(count) % len(keys))
    lens_of = []
    for k, (p, _) in enumerate(keys):
        rows = int((which == k).sum()) * int(p["seq2_count"])
        lens_of.append(list(stratified(rng, rows, *p["seq2_len"])) if rows else [])
    out = []
    for i in range(count):
        p, seq1 = keys[int(which[i])]
        lens = [lens_of[int(which[i])].pop() for _ in range(int(p["seq2_count"]))]
        seqs = seq2_set(rng, seq1, lens, p)
        out.append(_request(f"{prefix}{i:06d}", p["weights"], text_of(seq1), seqs))
    return out


def arrivals(seed: int, traffic: dict, seconds: float) -> list[float]:
    """Send offsets over ``[0, seconds)`` at the traffic's ``rate_rps`` and
    by its ``arrival`` process."""
    count = int(round(float(traffic["rate_rps"]) * seconds))
    return arrival_times(traffic.get("arrival", "poisson"), count, seconds, seed=int(seed) % 2**64)
