"""Work counts of the scorer kernels, the H100's data-sheet peaks, and the
bound and floor built from them (the accounting role of the JAX package's
``pallas_scorer.kernel_vpu_pass_elems``).

A launch's work is counted from what its data needs, not from its padded
shapes: the (offset, char) cells of every searchable pair, the three
int32 ops and the one value-table lookup that the function needs for each
(derived at :data:`INT_OPS_PER_CELL`), and its operand bytes.  The
**bound** prices those counts at the published peaks; the **floor**
(:func:`floor_terms`) prices them at rates measured on the card by the
issue-rate probe (``ops/probe.py``).  Either is the largest of its terms:
a Hopper SM issues the int32 pipe and the shared-memory pipe side by side.
"""

from __future__ import annotations

from dataclasses import dataclass

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM 3.35 TB/s; 67 TFLOP/s
# fp32 off the tensor cores = 132 SMs x 128 fp32 lanes x 2 (fma) x
# 1.98 GHz.  An SM issues int32 on 64 lanes, and its shared memory
# (LSU/MIO pipe, beside the int pipe) serves 32 words per clock.
HBM_BYTES_PER_S = 3.35e12
FP32_FMA_PER_S = 132 * 128 * 1.98e9
INT32_OPS_PER_S = 132 * 64 * 1.98e9
SMEM_WORDS_PER_S = 132 * 32 * 1.98e9
# The data-sheet peak of each issue-rate probe op, in elements/s.
PEAK_PER_S = {"fma": FP32_FMA_PER_S, "arith": INT32_OPS_PER_S, "lookup": SMEM_WORDS_PER_S}
# The least work per needed (offset, char) cell on the int32 and the
# shared-memory pipes.  With e(n, i) = val[s2[i]][s1[n + i]] and A(n, kappa)
# its prefix sum over i < kappa, the hyphen-shifted diagonal of offset n is
# the unshifted one of offset n + 1, so G[kappa](n) = A(n, kappa) -
# A(n + 1, kappa), t1(n) = A(n + 1, len2), and, k = 0 winning every tie, an
# offset's best score is t1(n) + max_kappa G[kappa](n).  Each cell (n, i)
# is therefore one lookup e(n, i), one prefix add into A(n), one difference
# A(n) - A(n + 1) and one max: 3 int ops and 1 lookup, however they are
# tiled; k is recovered for one offset per pair, O(len2), and is not
# counted.  A kernel issues more (address adds, window and Seq2 loads).  A
# formulation on the tensor cores (one-hot rows times the table) would do
# other operations at another peak and have another bound.
INT_OPS_PER_CELL = 3
LOOKUPS_PER_CELL = 1


def needed_cells(len1, lens, noff: int | None = None) -> int:
    """(offset, char) cells the data needs: valid offsets x chars.  A
    launch that scores only ``noff`` offsets (a Seq1 ring window, whose
    block-local len1 may pass its L1P) counts at most ``noff`` a pair."""
    cells = 0
    for n in lens:
        n = int(n)
        if 0 < n < len1:
            cells += (len1 - n if noff is None else min(len1 - n, noff)) * n
    return cells


@dataclass(frozen=True)
class WorkCounts:
    """What one launch, or a sum of launches, must do: ``cells`` needed
    cells, ``int_ops`` int32 ops, ``lookups`` table lookups, ``bytes``
    operand bytes (each input read once, the [B, 4] output written once)."""

    cells: int = 0
    int_ops: int = 0
    lookups: int = 0
    bytes: int = 0

    def __add__(self, other: WorkCounts) -> WorkCounts:
        return WorkCounts(
            self.cells + other.cells, self.int_ops + other.int_ops,
            self.lookups + other.lookups, self.bytes + other.bytes,
        )


def shape_counts(len1: int, lens, l1p: int, l2p: int) -> WorkCounts:
    """The work of one launch of ``len(lens)`` rows padded to ``l2p``
    against a Seq1 of ``len1`` chars padded to ``l1p``: the needed cells
    over ``n < l1p`` and the bytes of its operands (``[L1P + L2P + 1]``
    Seq1, ``[B, L2P]`` rows, ``[B]`` lens, the ``[27, 27]`` table) and its
    ``[B, 4]`` output, all int32."""
    b = len(lens)
    nbytes = 4 * ((l1p + l2p + 1) + b * l2p + b + 27 * 27 + 4 * b)
    cells = needed_cells(len1, lens, l1p)
    return WorkCounts(cells, INT_OPS_PER_CELL * cells, LOOKUPS_PER_CELL * cells, nbytes)


def state_counts(state) -> WorkCounts:
    """The work of one launch on a ``cuda_scorer.ScorerState``."""
    return shape_counts(state.len1, state.lens.tolist(), state.l1p, state.rows.shape[1])


def bound_seconds(counts: WorkCounts) -> tuple[float, str]:
    """(least time in seconds, binding term) of ``counts`` at the
    data-sheet peaks."""
    return binding(floor_terms(counts, INT32_OPS_PER_S, SMEM_WORDS_PER_S))


def schedule_counts(launches) -> WorkCounts:
    """The work of a batch: :func:`state_counts` summed over its
    ``dispatch.bucket_launches``."""
    return sum((state_counts(b.state) for b in launches), WorkCounts())


def floor_terms(counts: WorkCounts, int_rate: float, lookup_rate: float) -> dict[str, float]:
    """Seconds per term: int ops at ``int_rate`` (ops/s), lookups at
    ``lookup_rate`` (words/s), bytes at the HBM rate."""
    return {
        "int ops": counts.int_ops / int_rate,
        "lookups": counts.lookups / lookup_rate,
        "bytes": counts.bytes / HBM_BYTES_PER_S,
    }


def binding(terms: dict[str, float]) -> tuple[float, str]:
    """(the largest term, its name)."""
    name = max(terms, key=terms.get)
    return terms[name], name


def bound_ms(state) -> tuple[float, str, str]:
    """(least time in ms, "bytes" or "operations", the binding term) of one
    launch at the data-sheet peaks."""
    sec, term = bound_seconds(state_counts(state))
    return sec * 1e3, "bytes" if term == "bytes" else "operations", term
