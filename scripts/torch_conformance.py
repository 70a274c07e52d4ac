#!/usr/bin/env python3
"""Conformance check of the port on the card: every backend and route
against the numpy oracle, exact.

    python3 scripts/torch_conformance.py               # on the card
    python3 scripts/torch_conformance.py --device cpu  # the plain versions

Run it after any kernel or numerics change.  Every case is scored through
the public scorer (``ops/dispatch.AlignmentScorer``, as the CLI scores)
and each row held equal to ``ops/oracle.py::score_batch_oracle``:

* backends ``cuda`` (the fused and packed kernels, and the ``cuda ->
  gather`` route of a launch past the kernels' int32 window), ``mm``,
  ``gather``, a ``BatchSharding`` over ``[cuda:0] x 4`` and a
  ``RingSharding`` over ``[cuda:0] x 4`` (the host has one card; a mesh
  may repeat it);
* weight regimes derived from Hopper's bounds (``ops/bounds.py``), not
  from the TPU's feeds (:func:`regimes`): the fixtures' 10 2 3 4, max |v|
  127, 128 and 3000, ties, negative weights, one value on each side of
  ``kernel_fits`` for the case's longest scored row, one on each side of
  ``mm_max_exact_value`` at L2P 128 and at L2P 2048, and 1000000 1 1 1,
  where long rows route to gather;
* shapes: the fixed :func:`problems`, the fused kernel's seams
  (:func:`seam_problems`) and the packed kernel's
  (:func:`packed_seam_problems`), through every backend, and a seeded
  random sweep (:func:`sweep_cases`) over the fused buckets, each packing
  class 8/16/32/64 and ring windows.  The seed defaults to the day and is
  printed; ``TORCH_CONFORMANCE_SEED`` and ``TORCH_CONFORMANCE_SWEEP_N``
  (cases an axis value, default 1) override it.

Every failure is listed at the end; exit 0 when every row is exact, 1
otherwise.  On the card the script also fails when a kernel never
launched, or when the ``cuda -> gather`` or ``mm -> gather`` route was
never taken.  Without a card it exits 1 unless ``--device cpu`` is given,
which runs the kernels' plain PyTorch versions and so proves nothing
about the kernels.  The TPU script's perf floor is not ported: its
threshold was a TPU number.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path
from typing import NamedTuple

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

PROG = "torch_conformance"
WEIGHTS = [10, 2, 3, 4]
# Devices of the two meshes: the host's one card, repeated.
MESH_SLOTS = 4


class Regime(NamedTuple):
    """A weight regime and the side of each bound its name claims:
    ``kernel`` inside the kernels' int32 window at the case's longest
    scored row (None: depends on the row, long rows route to gather),
    ``mm`` inside the fp32 window of ``mm`` at each L2P."""

    name: str
    weights: list
    kernel: bool | None
    mm: dict


def regimes(longest: int) -> list[Regime]:
    """The weight regimes of a case whose longest scored row has
    ``longest`` chars."""
    from mpi_openmp_cuda_tpu_torch.ops.bounds import max_exact_value, mm_max_exact_value

    fit = max_exact_value(longest)
    mm128, mm2048 = mm_max_exact_value(128), mm_max_exact_value(2048)
    both = {128: True, 2048: True}
    return [
        Regime("10 2 3 4", [10, 2, 3, 4], True, both),
        Regime("127", [127, 2, 3, 4], True, both),
        Regime("128", [128, 2, 3, 4], True, both),
        Regime("3000", [3000, 7, 1, 2], True, both),
        Regime("ties 1 1 1 1", [1, 1, 1, 1], True, both),
        Regime("negative 1 -3 -5 -2", [1, -3, -5, -2], True, both),
        Regime(f"kernel window inside ({fit})", [fit, 1, 1, 1], True,
               {128: False, 2048: False}),
        Regime(f"kernel window past ({fit + 1})", [fit + 1, 1, 1, 1], False,
               {128: False, 2048: False}),
        Regime(f"mm window at L2P 128 inside ({mm128})", [mm128, 1, 1, 1], True,
               {128: True, 2048: False}),
        Regime(f"mm window at L2P 128 past ({mm128 + 1})", [mm128 + 1, 1, 1, 1], True,
               {128: False, 2048: False}),
        Regime(f"mm window at L2P 2048 inside ({mm2048})", [mm2048, 1, 1, 1], True, both),
        Regime(f"mm window at L2P 2048 past ({mm2048 + 1})", [mm2048 + 1, 1, 1, 1], True,
               {128: True, 2048: False}),
        Regime("1000000 1 1 1: long rows to gather", [1000000, 1, 1, 1], None,
               {128: False, 2048: False}),
    ]


def regime_sides(regime: Regime, longest: int) -> tuple[bool, dict]:
    """The sides the regime's weights really sit on: (``kernel_fits`` at
    ``longest``, {l2p: inside ``mm_max_exact_value(l2p)``})."""
    from mpi_openmp_cuda_tpu_torch.ops.bounds import kernel_fits, mm_max_exact_value
    from mpi_openmp_cuda_tpu_torch.ops.values import max_abs_value, value_table

    maxv = max_abs_value(value_table(regime.weights))
    return kernel_fits(maxv, longest), {
        l2p: maxv <= mm_max_exact_value(l2p) for l2p in regime.mm}


def longest_scored(seq1, seqs) -> int:
    """The longest row with ``0 < len2 <= len1``: the one the bounds see."""
    return max((s.size for s in seqs if 0 < s.size <= seq1.size), default=0)


def problems():
    """The fixed cases, as ``(tag, seq1, seqs)``: the TPU script's two
    (every bucket to 768, equal length, overlong and empty rows; a
    two-letter tie storm), then a caps case (Seq1 3000) with a packed
    class, an L2P 128 bucket and L2P 2048 rows, so a regime can split
    its launches between routes."""
    rng = np.random.default_rng(11)
    seq1 = rng.integers(1, 27, size=700).astype(np.int8)
    seqs = [rng.integers(1, 27, size=int(n)).astype(np.int8)
            for n in (60, 250, 512, 699, 30)]
    seqs.append(seq1.copy())  # equal length
    seqs.append(rng.integers(1, 27, size=701).astype(np.int8))  # overlong
    seqs.append(np.zeros(0, dtype=np.int8))  # empty
    yield "mixed buckets", seq1, seqs
    seq1b = rng.integers(1, 3, size=300).astype(np.int8)
    yield "tie storm", seq1b, [rng.integers(1, 3, size=n).astype(np.int8)
                               for n in (7, 150, 299)]
    rng = np.random.default_rng(5)
    seq1c = rng.integers(1, 27, size=3000).astype(np.int8)
    lens = [1999, 900, 40, *rng.integers(5, 65, size=7), *rng.integers(65, 129, size=8),
            *rng.integers(1921, 2000, size=3)]
    yield "caps", seq1c, [rng.integers(1, 27, size=int(n)).astype(np.int8) for n in lens]


def seam_problems():
    """Inputs that try the seams of ``csrc/fused_scorer.cu``, as (tag, seq1,
    seqs, weights, {row: (field, value)} the oracle's answer must show).
    Fields: 1 = n, 2 = k."""
    rng = np.random.default_rng(23)
    s1 = rng.integers(1, 27, size=700).astype(np.int8)
    skip = np.concatenate([s1[40:290], s1[291:441]])  # a hyphen after 250 chars
    edges = [
        s1[127:427],  # best offset: the last of tile 0 (its redundant edge column)
        s1[128:428],  # the first of tile 1
        s1[383:684], s1[5:338],  # lengths 301, 333: no multiple of 4 or of 6 segments
        skip,
        s1[:1], s1[1:], s1.copy(),  # len2 = 1, len1 - 1, len1
        np.concatenate([s1, s1[:5]]),  # len2 > len1
    ]
    want = {0: (1, 127), 1: (1, 128), 2: (1, 383), 3: (1, 5), 4: (2, 250)}
    out = [("tile edges and edge lengths", s1, edges, WEIGHTS, want)]
    # Seq1 of period 150: offsets 20, 170, ..., 620 tie exactly, in five
    # different tiles; the first must win.
    block = rng.integers(1, 27, size=150).astype(np.int8)
    out.append(("ties across tiles", np.tile(block, 5),
                [block[20:140], np.tile(block, 2)[20:290]], WEIGHTS,
                {0: (1, 20), 1: (1, 20)}))
    # Two letters: ties between offsets and between hyphen positions in
    # different char segments; with all-equal and all-zero weights too.
    lo1 = rng.integers(1, 3, size=700).astype(np.int8)
    lo = [rng.integers(1, 3, size=int(n)).astype(np.int8)
          for n in rng.integers(2, 650, size=24)]
    out.append(("two-letter ties", lo1, lo, [5, 1, 1, 1], {}))
    out.append(("all-equal weights", lo1, lo, [1, 1, 1, 1], {}))
    out.append(("all-zero weights", lo1, lo, [0, 0, 0, 0],
                {i: (f, 0) for i in range(len(lo)) for f in (1, 2)}))
    return out


def packed_seam_problems():
    """Inputs that try the seams of ``csrc/packed_scorer.cu``, as (tag, seq1,
    seqs, weights, {row: (field, value)} the oracle's answer must show); every
    row fits a packing class.  Fields: 1 = n, 2 = k."""
    rng = np.random.default_rng(29)
    s1 = rng.integers(1, 27, size=3000).astype(np.int8)
    out = []
    for l2s in (8, 16, 32, 64):  # each class at its boundary lengths
        lens = [l2s, l2s // 2 + 1, l2s, 1, l2s - 1] * 4
        out.append((f"class {l2s} at its boundary lengths", s1,
                    [rng.integers(1, 27, size=n).astype(np.int8) for n in lens],
                    WEIGHTS, {}))
    # Pairs of every length, 0 included, side by side in one block.
    lens = [0, 64, 1, 33, 0, 5, 17, 48, 2, 0, 63, 9, 31, 0, 40, 7]
    out.append(("mixed lengths in one block, len2 = 0 rows", s1,
                [s1[100 + 7 * i: 100 + 7 * i + n] for i, n in enumerate(lens)],
                WEIGHTS, {1: (1, 107), 3: (1, 121)}))
    short = s1[:40]
    out.append(("len2 = len1 and len2 > len1", short,
                [short.copy(), np.concatenate([short, s1[:5]]), s1[3:30], s1[:39]],
                WEIGHTS, {2: (1, 3)}))
    # A run of one letter 61 long at offset 4 * 401 + 3: offsets 1607 and
    # 1608 (lanes 401 % 32 and the next) tie exactly, and at 1607 k = 0 ties
    # every k >= 1.
    run = s1.copy()
    run[1607:1668] = 1
    out.append(("ties across lanes and between k = 0 and k >= 1", run,
                [run[1607:1667], run[1608:1640]], WEIGHTS,
                {0: (1, 1607), 1: (1, 1607)}))
    # Seq1 of period 1000: offsets 30, 1030 and 2030 tie, in tiles 0, 8, 15.
    block = rng.integers(1, 27, size=1000).astype(np.int8)
    out.append(("ties across tiles", np.tile(block, 3),
                [block[30:90], block[30:62], block[30:46]], WEIGHTS,
                {i: (1, 30) for i in range(3)}))
    # The last valid offset, mid-tile (tile 23 holds 2944..3071).
    out.append(("valid offsets end mid-tile", s1,
                [s1[2962:2999], s1[2989:2997], s1[2943:2999]], WEIGHTS,
                {0: (1, 2962), 1: (1, 2989), 2: (1, 2943)}))
    lo1 = rng.integers(1, 3, size=3000).astype(np.int8)
    lo = [rng.integers(1, 3, size=int(n)).astype(np.int8)
          for n in rng.integers(1, 65, size=24)]
    out.append(("two-letter ties", lo1, lo, [5, 1, 1, 1], {}))
    out.append(("all-zero weights", lo1, lo, [0, 0, 0, 0],
                {i: (f, 0) for i in range(len(lo)) for f in (1, 2)}))
    return out


def sweep_cases(seed: int, n: int, ring_sp: int = MESH_SLOTS):
    """Seeded random problems, ``n`` an axis value, as ``(tag, scorer key,
    seq1, seqs, weights)``: fused buckets at three regimes (``cuda``),
    each packing class 8/16/32/64 (``cuda``: every row of a case fits
    its class) and ring windows of a shallow and a deep Seq2 over
    ``ring_sp`` shards (``ring``; R from ``parallel.ring.ring_plan``).
    The seed is printed by :func:`main`, so a failure reproduces."""
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import round_up
    from mpi_openmp_cuda_tpu_torch.parallel.ring import ring_plan
    from mpi_openmp_cuda_tpu_torch.utils.constants import BUF_SIZE_SEQ2

    rng = np.random.default_rng(seed)

    def rand_seq(k):
        return rng.integers(1, 27, size=int(k)).astype(np.int8)

    for tag, w in (("10 2 3 4", [10, 2, 3, 4]), ("3000", [3000, 7, 1, 2]),
                   ("negative", [1, -3, -5, -2])):
        for i in range(n):
            len1 = int(rng.integers(150, 2800))
            hi = min(len1 + 2, BUF_SIZE_SEQ2 + 1)  # overlong rows where the cap allows
            seqs = [rand_seq(x) for x in rng.integers(1, hi, size=int(rng.integers(2, 7)))]
            yield f"sweep fused w={tag} #{i}", "cuda", rand_seq(len1), seqs, w
    for lo, l2s in ((1, 8), (9, 16), (17, 32), (33, 64)):
        for i in range(n):
            len1 = int(rng.integers(100, 2900))
            seqs = [rand_seq(x) for x in rng.integers(lo, l2s + 1, size=int(rng.integers(3, 9)))]
            yield f"sweep pack l2s<={l2s} #{i}", "cuda", rand_seq(len1), seqs, WEIGHTS
    for deep, (frac_lo, frac_hi) in ((False, (0.1, 0.5)), (True, (0.6, 0.9))):
        for i in range(n):
            len1 = int(rng.integers(300, 2000))
            l1p = round_up(len1, 128)
            lens2 = [max(1, int(x * len1)) for x in rng.uniform(frac_lo, frac_hi, size=3)]
            if deep:
                # One row in (l1p - 128, len1]: L2P == L1P, the deepest window.
                lens2[0] = int(rng.integers(max(1, l1p - 127), len1 + 1))
            _, r = ring_plan(l1p, round_up(max(lens2), 128), ring_sp, kernel=True)
            yield (f"sweep ring R={r} #{i}", "ring", rand_seq(len1),
                   [rand_seq(x) for x in lens2], WEIGHTS)


def scorers(device) -> dict:
    """The public scorers the check runs, by name."""
    import torch

    from mpi_openmp_cuda_tpu_torch.ops.dispatch import AlignmentScorer
    from mpi_openmp_cuda_tpu_torch.parallel.ring import RingSharding
    from mpi_openmp_cuda_tpu_torch.parallel.sharding import BatchSharding

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    slots = [dev] * MESH_SLOTS
    return {
        "cuda": AlignmentScorer("cuda", device=dev),
        "mm": AlignmentScorer("mm", device=dev),
        "gather": AlignmentScorer("gather", device=dev),
        f"batch mesh [{dev}] x {MESH_SLOTS}": AlignmentScorer(
            "cuda", device=dev,
            sharding=BatchSharding.over_devices(devices=slots, device=dev.type)),
        "ring": AlignmentScorer(
            "cuda", device=dev,
            sharding=RingSharding.over_devices(seq=MESH_SLOTS, devices=slots,
                                               device=dev.type)),
    }


def local_routes(backend: str, seq1, seqs, weights) -> set[str]:
    """The routes the local scorer's launches take (``effective_backend``
    on each planned launch, as ``dispatch.run_launch`` routes it)."""
    from mpi_openmp_cuda_tpu_torch.ops.dispatch import (
        effective_backend, launch_plans, max_scored)
    from mpi_openmp_cuda_tpu_torch.ops.values import max_abs_value

    val_flat, plans = launch_plans(seq1, seqs, weights, backend)
    maxv = max_abs_value(val_flat)
    return {effective_backend(backend, maxv, p.batch.l2p, max_scored(p.batch)) for p in plans}


class Checker:
    """Scores cases and tallies failures, checks and routes taken."""

    def __init__(self, scorers: dict):
        self.scorers = scorers
        self.failures: list[str] = []
        self.checks = 0
        self.routes: set[tuple[str, str]] = set()
        self._want: dict = {}

    def oracle(self, seq1, seqs, weights) -> list[tuple]:
        """The oracle's rows, computed once a (case, weights)."""
        from mpi_openmp_cuda_tpu_torch.ops.oracle import score_batch_oracle

        key = (seq1.tobytes(), tuple(s.tobytes() for s in seqs), tuple(weights))
        if key not in self._want:
            self._want[key] = [tuple(int(x) for x in r)
                               for r in score_batch_oracle(seq1, seqs, weights)]
        return self._want[key]

    def check(self, name: str, seq1, seqs, weights, tag: str) -> bool:
        """One case through one scorer against the oracle."""
        self.checks += 1
        if name in ("cuda", "mm", "gather"):
            self.routes.update((name, r) for r in local_routes(name, seq1, seqs, weights))
        want = self.oracle(seq1, seqs, weights)
        try:
            got = [tuple(int(x) for x in r)
                   for r in self.scorers[name].score_codes(seq1, seqs, weights)]
        except Exception as e:
            # listed with the rest: the check reports every failure at its end.
            self.failures.append(f"{name} {tag} w={weights}: raised {e!r}")
            return False
        if got == want:
            return True
        if len(got) != len(want):
            self.failures.append(f"{name} {tag} w={weights}: {len(got)} rows, want "
                                 f"{len(want)}")
            return False
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w][:8]
        self.failures.append(f"{name} {tag} w={weights}: rows {bad}: "
                             f"got={[got[i] for i in bad]} want={[want[i] for i in bad]}")
        return False

    def seam(self, tag, seq1, seqs, weights, want) -> None:
        """A seam case: the oracle must show its seam, then every scorer
        must match it."""
        rows = self.oracle(seq1, seqs, weights)
        for i, (field, value) in want.items():
            if rows[i][field] != value:
                self.failures.append(f"seam {tag!r}, row {i}: oracle {rows[i]} does not "
                                     f"try its seam (field {field} != {value})")
        for name in self.scorers:
            self.check(name, seq1, seqs, weights, f"seam {tag!r}")


def run(device, seed: int, sweep_n: int, log=print) -> Checker:
    """Every section on ``device``; returns the checker with its tallies."""
    checker = Checker(scorers(device))
    for tag, seq1, seqs in problems():
        longest = longest_scored(seq1, seqs)
        for regime in regimes(longest):
            kernel, mm = regime_sides(regime, longest)
            if (regime.kernel is not None and kernel != regime.kernel) or mm != regime.mm:
                checker.failures.append(f"regime {regime.name!r} at longest row {longest} "
                                        f"sits at kernel_fits {kernel}, mm windows {mm}")
            for name in checker.scorers:
                checker.check(name, seq1, seqs, regime.weights, f"{tag} [{regime.name}]")
        log(f"{tag}: Seq1 {seq1.size}, {len(seqs)} rows, longest scored {longest}: "
            f"{len(regimes(longest))} regimes x {len(checker.scorers)} scorers")
    for kind, cases in (("fused", seam_problems()), ("packed", packed_seam_problems())):
        for tag, seq1, seqs, weights, want in cases:
            checker.seam(tag, seq1, seqs, weights, want)
        log(f"{kind} seams: {len(cases)} cases x {len(checker.scorers)} scorers")
    n_sweep = 0
    for tag, key, seq1, seqs, weights in sweep_cases(seed, sweep_n):
        checker.check(key, seq1, seqs, weights, f"{tag} [seed={seed}]")
        n_sweep += 1
    log(f"random sweep: seed={seed} n={sweep_n}: {n_sweep} cases")
    return checker


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG, description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to score on (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    import torch

    from mpi_openmp_cuda_tpu_torch.ops import cuda_scorer

    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print(f"{PROG}: FAIL: no CUDA device is available; this check exists to "
              "run the kernels on the card (--device cpu runs their plain versions)",
              file=sys.stderr)
        return 1
    if on_card:
        from mpi_openmp_cuda_tpu_torch.utils.timing import card_line

        print(f"card: {card_line()}", flush=True)
    else:
        print(f"{PROG}: --device cpu runs the kernels' plain PyTorch versions: it "
              "proves nothing about the kernels on the card", file=sys.stderr)
    seed = int(os.environ.get("TORCH_CONFORMANCE_SEED", str(int(time.time() // 86400))))
    sweep_n = int(os.environ.get("TORCH_CONFORMANCE_SWEEP_N", "1"))
    t0 = time.perf_counter()
    cuda_scorer.reset_launch_counts()
    checker = run(args.device, seed, sweep_n, log=lambda m: print(m, flush=True))
    failures = checker.failures
    for want in (("cuda", "gather"), ("mm", "gather"), ("cuda", "cuda"), ("mm", "mm")):
        if want not in checker.routes:
            failures.append(f"the {want[0]} -> {want[1]} route was never taken")
    counts = dict(cuda_scorer.launch_counts)
    if on_card:
        failures += [f"{name} never launched" for name, n in counts.items() if n < 1]
    wall = time.perf_counter() - t0
    routes = ", ".join(f"{a}->{b}" for a, b in sorted(checker.routes))
    print(f"{checker.checks} checks, routes {routes}, kernel launches {counts}, "
          f"wall {wall:.1f} s (seed {seed})", flush=True)
    if failures:
        for f in failures:
            print(f"FAIL {f}", flush=True)
        print(f"{PROG}: {len(failures)} FAILURES", file=sys.stderr)
        return 1
    print(f"{PROG}: every row exact on {args.device} in {wall:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
