"""Seeded request synthesis: WHAT each arrival carries (the port of
``mpi_openmp_cuda_tpu/load/workload.py``).

Production traffic is diverse along exactly the axes the serve plane
batches, prices, and deadline-checks on, so the generator controls each
one explicitly:

* **length mix** — seq2 lengths drawn from weighted ``(lo, hi)``
  buckets: the length-bucket batcher and the cost model both key on
  these, so the mix decides batch-fill and admission pressure;
* **problem-key diversity** — distinct ``(weights, seq1)`` combos: each
  is a separate scoring problem (and a separate superblock group), so
  diversity decides how much coalescing the batcher can do;
* **deadline mix** — the fraction of requests carrying ``deadline_s``:
  under overload these convert queue waits into typed deadline misses,
  the SLO surface the record reports on.

Same seed → byte-identical requests: ids are sequential, sequences come from one
``random.Random(seed)``, and nothing reads a clock.
"""

from __future__ import annotations

import random

_ALPHABET = "ACGT"

#: Default seq2 length mix: mostly short interactive-sized queries with
#: a heavier tail — the shape that makes cost-aware admission matter
#: (a depth cap would starve the tail or admit hours of it).
DEFAULT_LEN_MIX = ((4, 24, 0.7), (24, 96, 0.25), (96, 256, 0.05))

#: Weight tables the problem keys cycle through (match/mismatch/gap
#: open/gap extend, the reference's parameter shape).
_WEIGHT_TABLES = (
    [1, -3, -5, -2],
    [2, -1, -3, -1],
    [1, -2, -2, -1],
    [3, -2, -4, -2],
)


def _seq(rng: random.Random, length: int) -> str:
    return "".join(rng.choice(_ALPHABET) for _ in range(length))


def synth_requests(
    n: int,
    *,
    seed: int,
    problem_keys: int = 2,
    len_mix: tuple = DEFAULT_LEN_MIX,
    pairs_per_request: tuple[int, int] = (1, 2),
    seq1_len: int = 64,
    deadline_mix: float = 0.0,
    deadline_s: float = 30.0,
    id_prefix: str = "q",
) -> list[dict]:
    """``n`` raw ndjson request dicts, deterministically from ``seed``.

    ``problem_keys`` distinct (weights, seq1) combos are synthesised
    first, then each request picks one round-robin (so diversity is
    exact, not stochastic); seq2 count and lengths, and whether the
    request carries a deadline, come from the seeded RNG.
    """
    n = int(n)
    if n < 0:
        raise ValueError(f"request count must be >= 0, got {n}")
    keys = max(1, int(problem_keys))
    lo_pairs, hi_pairs = (
        max(1, int(pairs_per_request[0])),
        max(1, int(pairs_per_request[1])),
    )
    if hi_pairs < lo_pairs:
        raise ValueError(
            f"pairs_per_request range is inverted: {pairs_per_request}"
        )
    frac = float(deadline_mix)
    if not 0.0 <= frac <= 1.0:
        raise ValueError(f"deadline_mix must be in [0, 1], got {deadline_mix}")
    buckets = [(int(lo), int(hi), float(w)) for lo, hi, w in len_mix]
    if not buckets or any(
        lo <= 0 or hi < lo or w <= 0 for lo, hi, w in buckets
    ):
        raise ValueError(f"bad len_mix {len_mix!r}: want (lo, hi, weight>0)")
    weights = [w for _, _, w in buckets]

    rng = random.Random(int(seed))
    problems = [
        {
            "weights": list(_WEIGHT_TABLES[k % len(_WEIGHT_TABLES)]),
            "seq1": _seq(rng, max(1, int(seq1_len))),
        }
        for k in range(keys)
    ]
    out = []
    for i in range(n):
        prob = problems[i % keys]
        lo, hi, _ = rng.choices(buckets, weights=weights)[0]
        raw = {
            "id": f"{id_prefix}{i:05d}",
            "weights": list(prob["weights"]),
            "seq1": prob["seq1"],
            "seq2": [
                _seq(rng, rng.randint(lo, hi))
                for _ in range(rng.randint(lo_pairs, hi_pairs))
            ],
        }
        if frac > 0.0 and rng.random() < frac:
            raw["deadline_s"] = float(deadline_s)
        out.append(raw)
    return out
