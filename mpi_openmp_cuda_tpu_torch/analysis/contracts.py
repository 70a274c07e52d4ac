"""The launch contracts of the Hopper scorers: the ``--check`` gates and
the entry points' output contracts.

The port of ``mpi_openmp_cuda_tpu/analysis/contracts.py``, translated into
the port's own decisions (Mosaic's feeds, superblocks and packed keys do
not exist here).  Two tiers:

* **Concrete** (:func:`validate_plans`, :func:`validate_sharded`) — every
  dispatch decision is checked where it is concrete, on the host arrays
  of each planned launch, before its operands are copied to the device:
  after ``dispatch.launch_plans`` for every launch group, in
  ``AlignmentScorer._dispatch_sharded`` for every mesh shard and ring
  window, on each serve superblock and on each prewarm entry.  Enabled by
  ``--check`` / ``SEQALIGN_CHECK``; off, the dispatch pays one attribute
  check.  Each gate raises its own :class:`~.ContractViolation` subclass
  naming the violated bound and the fix.  The checks read host arrays
  only: no device sync, no copy (seqlint SEQ001 polices the hook).
* **Entry contracts** (:func:`audit_entry_points`) — every scoring entry
  point's plain PyTorch version runs at a tiny CPU size and its output is
  held to the declared ``[B, 3]`` / ``[B, 4]`` int32 contract (the
  counterpart of the JAX package's ``jax.eval_shape`` tier).

The gates, against the JAX ones:

============================  ===============================================
JAX gate                      port gate
============================  ===============================================
``check_feed``                :func:`check_formulation`: a backend's own
                              formulation or ``gather``, ``cuda`` only
                              inside ``bounds.kernel_fits``
``check_exactness``           :func:`check_exactness`: the int32 window over
                              the launch's scored rows; ``mm``'s fp32 window
``check_rowpack``             :func:`check_rowpack`: L2P 128, a legal class,
                              every live row within it, >= 2 rows, the packed
                              kernel's int32 bound ``2 * l2s * max|v|``
``check_superblock``          :func:`check_launch_group`,
                              :func:`check_ring_window`,
                              :func:`check_serve_block`
``checked_pallas_body``       :func:`check_operands` (codes, lengths, the
                              extended Seq1's length) on the host arrays
VMEM model                    ``smem.check_launch`` (shared memory a block)
``validate_dispatch``         :func:`validate_launch` (one launch), called for
                              each plan by :func:`validate_plans`
============================  ===============================================
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from ..ops import bounds
from ..utils.constants import ALPHABET_SIZE
from . import (
    ContractViolation,
    ExactnessViolation,
    FeedViolation,
    OperandViolation,
    RowpackViolation,
    SuperblockViolation,
)

_LANE = 128
FORMULATIONS = ("cuda", "mm", "gather")


# --------------------------------------------------------------------------
# The concrete gates (the --check tier).
# --------------------------------------------------------------------------


def check_formulation(route: str, backend: str, maxv: int, max_scored: int) -> None:
    """``route`` must be a backend's own formulation or the ``gather`` it
    falls back to, and the kernels (``cuda``) only inside their int32
    window ``2 * len2 * max|v| < 2^31`` (``bounds.kernel_fits``); ``mm``'s
    fp32 window is :func:`check_exactness`'s."""
    if route not in FORMULATIONS:
        raise FeedViolation(
            f"unknown formulation {route!r}: legal formulations are "
            f"{', '.join(FORMULATIONS)} (dispatch.effective_backend)"
        )
    if route not in (backend, "gather"):
        raise FeedViolation(
            f"backend {backend!r} routed a launch to {route!r}: a backend "
            f"runs its own formulation or gather past its window "
            "(dispatch.effective_backend)"
        )
    if route == "cuda" and not bounds.kernel_fits(maxv, max_scored):
        raise FeedViolation(
            f"formulation 'cuda' cannot score max|v|={maxv} over a scored "
            f"row of {max_scored} chars exactly: the kernels form 2*len2*"
            f"max|v| = {2 * max_scored * maxv} in int32, past "
            f"{bounds.INT32_MAX}; route the launch to 'gather' "
            "(dispatch.effective_backend, bounds.kernel_fits)"
        )


def check_exactness(route: str, maxv: int, max_scored: int, l2p: int) -> None:
    """Every formulation forms true partial scores in int32, so the
    launch's scored rows must keep ``len2 * max|v|`` inside int32
    (``bounds.check_int32_window``); ``mm`` additionally sums in IEEE fp32
    with TF32 off, exact while ``2 * L2P * max|v| < 2^24``."""
    if max_scored and maxv > bounds.max_admitted_value(max_scored):
        raise ExactnessViolation(
            f"max|v|={maxv} exceeds the int32 window "
            f"max_admitted_value({max_scored})="
            f"{bounds.max_admitted_value(max_scored)}: a score of "
            f"{max_scored}*{maxv} leaves int32. Such a batch is refused "
            "before launch (dispatch.admit, bounds.check_int32_window)"
        )
    if route == "mm" and maxv > bounds.mm_max_exact_value(l2p):
        raise ExactnessViolation(
            f"max|v|={maxv} exceeds the fp32 window mm_max_exact_value("
            f"l2p={l2p})={bounds.mm_max_exact_value(l2p)}: prefix partials up "
            f"to 2*{l2p}*{maxv} would round in fp32. Route this launch to "
            "the gather formulation (dispatch.effective_backend)"
        )


def packed_max_exact_value(l2s: int) -> int:
    """Largest max |table value| the packed kernel scores exactly in
    class ``l2s``: ``csrc/packed_scorer.cu`` forms the delta prefix over
    at most ``l2s`` chars in int32, ``2 * l2s * max|v| <= 2^31 - 1``
    (its argmax keeps ``(score, n)`` as two int32 words, no packed key)."""
    return bounds.max_exact_value(l2s)


def check_rowpack(l2p: int, l2s: int | None, lens, maxv: int) -> None:
    """The packed launch's preconditions: one 128-wide char block (L2P ==
    128), a class of ``dispatch.pack_classes``, every live row within the
    class, at least 2 rows (``dispatch.choose_rowpack``), and the packed
    kernel's int32 bound ``2 * l2s * max|v| < 2^31``."""
    from ..ops.dispatch import pack_classes

    if l2s is None:
        return
    classes = pack_classes()
    if l2p != _LANE:
        raise RowpackViolation(
            f"row packing (l2s={l2s}) requires a single char-block bucket "
            f"(L2P == {_LANE}), got L2P={l2p}: the packed kernel stages a "
            f"{_LANE}+l2s window a tile (dispatch.choose_rowpack)"
        )
    if l2s not in classes:
        raise RowpackViolation(
            f"rowpack class l2s={l2s} is not a class of the packed kernel: "
            f"legal classes are {tuple(classes)} (dispatch.pack_classes, "
            "csrc/packed_scorer.cu's template instances)"
        )
    lens = np.asarray(lens)
    if lens.size < 2:
        raise RowpackViolation(
            f"rowpack class l2s={l2s} on a launch of {lens.size} row(s): "
            "packing needs at least 2 rows (dispatch.choose_rowpack); score "
            "a single row on the fused kernel"
        )
    longest = int(lens.max())
    if longest > l2s:
        raise RowpackViolation(
            f"rowpack class l2s={l2s} is narrower than a live row of "
            f"{longest} chars: the packed kernel reads only the first l2s "
            "chars of a row. Choose the smallest class >= the longest row "
            "(dispatch.choose_rowpack)"
        )
    limit = packed_max_exact_value(l2s)
    if maxv > limit:
        raise RowpackViolation(
            f"rowpack class l2s={l2s} breaches the packed kernel's int32 "
            f"bound: 2*{l2s}*{maxv} = {2 * l2s * maxv} > {bounds.INT32_MAX} "
            f"(max|v| <= {limit} at this class); route the launch to "
            "'gather' (dispatch.effective_backend)"
        )


def _key_width(key: int) -> int:
    """The Seq2 width a bucket key stands for: a packing class (< 128)
    lies in the 128-wide bucket, an L2P key is its own width."""
    return _LANE if key < _LANE else int(key)


def check_launch_group(keys, l1p: int, l2p: int, l2s: int | None) -> None:
    """A launch group the fused (or packed) kernel can run as
    ``ops/cuda_scorer.py`` launches it: every member bucket's width within
    the group's L2P, L2P a multiple of 128 (the fused kernel's 16-byte
    loads need a multiple of 4), L1P whole 128-offset tiles, and the
    kernel's segment and cluster split (``smem.fused_tile_shape``)
    covering every char of L2P."""
    from .smem import fused_tile_shape

    if l2p <= 0 or l2p % _LANE:
        raise SuperblockViolation(
            f"launch width L2P={l2p} is not a positive multiple of {_LANE} "
            "(dispatch.pad_problem rounds every bucket up)"
        )
    if l1p <= 0 or l1p % _LANE:
        raise SuperblockViolation(
            f"Seq1 padding L1P={l1p} is not whole {_LANE}-offset tiles: the "
            f"kernels launch L1P/{_LANE} tiles a pair (cuda_scorer.TILE)"
        )
    for key in keys:
        if _key_width(key) > l2p:
            raise SuperblockViolation(
                f"launch group {tuple(keys)} holds bucket {key} wider than "
                f"its L2P={l2p}: a row would be cut. The group pads to its "
                "widest member (schedule.plan_fusion_groups)"
            )
    if l2s is None:
        shape = fused_tile_shape(l2p)
        if shape.nblk * shape.nseg < shape.nsegt or shape.nblk * shape.s2n < l2p:
            raise SuperblockViolation(
                f"the fused kernel's split at L2P={l2p} (clusters of "
                f"{shape.nblk} blocks x {shape.nseg} segments, {shape.s2n} "
                f"chars a block) does not cover the row: fix "
                "csrc/fused_kernels.cuh::tile_shape"
            )


def check_ring_window(len1_eff: int, bs: int, l2p: int) -> None:
    """A ring window's launch: L1P = Bs whole tiles, and a block-local Seq1
    length ``len1_eff = len1 - d * Bs`` whose offset mask ``n < len1_eff
    - len2`` the kernel forms in int32 without wrapping."""
    check_launch_group((l2p,), bs, l2p, None)
    lo = -bounds.INT32_MAX + l2p  # len1_eff - len2 must stay > INT32_MIN
    if not lo <= len1_eff <= bounds.INT32_MAX:
        raise SuperblockViolation(
            f"ring window Seq1 length len1_eff={len1_eff} leaves the int32 "
            f"range the kernel's offset mask needs ([{lo}, "
            f"{bounds.INT32_MAX}] at L2P={l2p}); shorten Seq1 or widen the "
            "ring (parallel/ring.py::ring_plan)"
        )


def check_serve_block(block, rows_per_block: int) -> None:
    """A serve superblock: exactly ``rows_per_block`` rows (real and pad),
    all of one 128-wide L2P bucket (``serve/batcher.py::plan_blocks``), so
    the launch shapes the warm plane prewarms are the ones it runs."""
    n = len(block.codes)
    if n != rows_per_block:
        raise SuperblockViolation(
            f"serve superblock of {n} rows, not the {rows_per_block} a block "
            "holds (serve/batcher.py::plan_blocks pads the tail block)"
        )
    widths = {max(_LANE, -(-int(c.size) // _LANE) * _LANE) for c in block.codes}
    if len(widths) > 1:
        raise SuperblockViolation(
            f"serve superblock mixes L2P buckets {sorted(widths)}: a block is "
            "one bucket (serve/batcher.py::plan_blocks)"
        )


def check_operands(seq1ext: np.ndarray, len1: int, rows: np.ndarray,
                   lens: np.ndarray, l1p: int, l2p: int) -> None:
    """The kernels' input contract on the padded host arrays (the facts
    the JAX package checkifies inside its traced body): codes in
    ``0..26``, every len2 in ``0..L2P``, rows ``[B, L2P]``, and the
    extended Seq1 ``L1P + L2P + 1`` codes with ``0 <= len1 <= L1P``."""
    if seq1ext.shape != (l1p + l2p + 1,):
        raise OperandViolation(
            f"extended Seq1 of shape {seq1ext.shape}, not ({l1p + l2p + 1},) = "
            f"L1P + L2P + 1: the kernels read offsets up to L1P + L2P "
            "(dispatch.pad_problem)"
        )
    if rows.ndim != 2 or rows.shape[1] != l2p or lens.shape != (rows.shape[0],):
        raise OperandViolation(
            f"rows {rows.shape} / lens {lens.shape} are not [B, {l2p}] / [B] "
            "(dispatch.pad_problem)"
        )
    if not 0 <= len1 <= l1p:
        raise OperandViolation(
            f"Seq1 length {len1} outside 0..L1P={l1p} (dispatch.pad_problem)")
    if lens.size and (int(lens.min()) < 0 or int(lens.max()) > l2p):
        raise OperandViolation(
            f"a Seq2 length outside 0..L2P={l2p} (min {int(lens.min())}, max "
            f"{int(lens.max())}): rows would read past the bucket"
        )
    for name, codes in (("Seq1", seq1ext), ("Seq2", rows)):
        if codes.size and (int(codes.min()) < 0 or int(codes.max()) >= ALPHABET_SIZE):
            raise OperandViolation(
                f"{name} codes outside the alphabet [0, {ALPHABET_SIZE}) (min "
                f"{int(codes.min())}, max {int(codes.max())}): the kernels index "
                f"the [{ALPHABET_SIZE}, {ALPHABET_SIZE}] table with them "
                "(models/encoding.py)"
            )


def validate_launch(*, backend: str, route: str, maxv: int, keys, l1p: int,
                    l2s: int | None, seq1ext: np.ndarray, len1: int,
                    rows: np.ndarray, lens: np.ndarray, max_scored: int,
                    smem_budget: int | None = None) -> None:
    """Validate ONE concrete launch decision on its host arrays; raises a
    distinct :class:`ContractViolation` subclass (or
    :class:`~.SmemBudgetError`) per violated gate."""
    from . import smem

    l2p = int(rows.shape[1]) if rows.ndim == 2 else 0
    check_operands(seq1ext, len1, rows, lens, l1p, l2p)
    check_formulation(route, backend, maxv, max_scored)
    check_exactness(route, maxv, max_scored, l2p)
    if route == "cuda":
        check_rowpack(l2p, l2s, lens, maxv)
        check_launch_group(keys, l1p, l2p, l2s)
        smem.check_launch(l2p, l2s, budget=smem_budget)


def validate_plans(val_flat, plans, backend: str, device=None) -> None:
    """The ``--check`` hook of ``dispatch.bucket_launches`` and
    ``AlignmentScorer.prestage_codes``: every planned launch of a batch
    validated before any of its operands is uploaded."""
    from ..ops import dispatch
    from ..ops.values import max_abs_value
    from .smem import card_budget

    maxv = max_abs_value(val_flat)
    budget = card_budget(device)
    for plan in plans:
        b = plan.batch
        longest = dispatch.max_scored(b)
        route = dispatch.effective_backend(backend, maxv, b.l2p, longest)
        validate_launch(
            backend=backend, route=route, maxv=maxv, keys=plan.keys, l1p=b.l1p,
            l2s=plan.l2s if backend == "cuda" else None, seq1ext=b.seq1ext,
            len1=b.len1, rows=b.seq2, lens=b.len2, max_scored=longest,
            smem_budget=budget,
        )


def validate_sharded(sharding, val_flat, plans, backend: str, device=None) -> None:
    """The ``--check`` hook of ``AlignmentScorer._dispatch_sharded``: the
    launches the sharding makes of ``plans``, before any is made.  A batch
    mesh launches each launch group's shards (``sharding.shard_plans``),
    each validated as :func:`validate_plans` validates a launch (every
    member bucket within the group's L2P, :func:`check_launch_group`);
    the ring launches one window a Seq1 shard (L1P = Bs, ``len1_eff =
    len1 - d * Bs``) on the fused kernel, or the gather window body.  Every slot of
    the mesh is checked on every process, its local slots and the others'
    alike, so in a job of several processes a violation stops every rank
    before any upload and no rank is left waiting in a collective."""
    from ..ops import dispatch
    from ..ops.values import max_abs_value
    from ..parallel.ring import RingSharding, ring_plan
    from ..parallel.sharding import shard_plans
    from .smem import card_budget

    if not isinstance(sharding, RingSharding):
        n = sharding.n_devices
        validate_plans(val_flat, [s for p in plans for s in shard_plans(p, n)], backend, device)
        return
    maxv = max_abs_value(val_flat)
    budget = card_budget(device)
    for plan in plans:
        b = plan.batch
        longest = dispatch.max_scored(plan)
        route = dispatch.effective_backend(backend, maxv, b.l2p, longest)
        check_formulation(route, backend, maxv, longest)
        check_exactness(route, maxv, longest, b.l2p)
        check_operands(b.seq1ext, b.len1, b.seq2, b.len2, b.l1p, b.l2p)
        bs, _ = ring_plan(b.l1p, b.l2p, sharding.sp, route == "cuda")
        if route == "cuda":
            for d in range(sharding.sp):
                check_ring_window(b.len1 - d * bs, bs, b.l2p)
            from . import smem

            smem.check_launch(b.l2p, None, budget=budget)


# --------------------------------------------------------------------------
# Entry-point contracts: the plain versions at a tiny CPU size.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EntryContract:
    """One scoring entry point and its declared output contract.

    ``run(b, l1p, l2p)`` scores a seeded tiny problem on the CPU through
    the entry's plain version and returns its output; ``out_shape``
    declares the shape, ``out_dtype`` the dtype."""

    name: str
    run: Callable[[int, int, int], object]
    out_shape: Callable[[int, int, int], tuple]
    out_dtype: str = "int32"
    doc: str = ""


def _operands(b: int, l1p: int, l2p: int, live: int | None = None):
    """A seeded tiny problem as int32 CPU tensors: Seq1 of L1P - 3 codes,
    ``b`` rows of up to ``live`` (default L2P) chars, the spec table."""
    import torch

    from ..ops.values import value_table

    rng = np.random.default_rng(b * 7919 + l1p + l2p)
    len1 = l1p - 3
    seq1ext = np.zeros(l1p + l2p + 1, dtype=np.int32)
    seq1ext[:len1] = rng.integers(1, ALPHABET_SIZE, size=len1)
    top = min(live or l2p, l2p)
    lens = rng.integers(1, top + 1, size=b).astype(np.int32)
    rows = np.zeros((b, l2p), dtype=np.int32)
    for i, n in enumerate(lens):
        rows[i, :n] = rng.integers(1, ALPHABET_SIZE, size=n)
    val = value_table((3, 2, 1, 5)).astype(np.int32).reshape(-1)
    t = torch.from_numpy
    return t(seq1ext), len1, t(rows), t(lens), t(val)


def _state(b, l1p, l2p, live=None):
    from ..ops.cuda_scorer import state_from_numpy

    s1, len1, rows, lens, val = _operands(b, l1p, l2p, live)
    return state_from_numpy(s1.numpy(), len1, rows.numpy(), lens.numpy(),
                            val.numpy(), "cpu")


def _run_fused(b, l1p, l2p):
    from ..ops.cuda_scorer import fused_scorer_plain

    return fused_scorer_plain(_state(b, l1p, l2p))


def _run_packed(b, l1p, l2p):
    from ..ops.cuda_scorer import packed_scorer_plain

    return packed_scorer_plain(_state(b, l1p, l2p, live=8), 8)


def _run_finish(b, l1p, l2p):
    from ..ops.cuda_scorer import finish_rows, fused_scorer_plain

    st = _state(b, l1p, l2p)
    return finish_rows(fused_scorer_plain(st), st.lens, st.len1)


def _run_chunks(b, l1p, l2p):
    from ..ops.cuda_scorer import score_chunks_cuda_body

    s1, len1, rows, lens, val = _operands(b, l1p, l2p)
    return score_chunks_cuda_body(s1, len1, rows.reshape(1, b, l2p),
                                  lens.reshape(1, b), val)


def _run_mm(b, l1p, l2p):
    from ..ops.matmul_scorer import mm_rows

    return mm_rows(*_operands(b, l1p, l2p))


def _run_gather(b, l1p, l2p):
    from ..ops.gather_scorer import gather_rows

    return gather_rows(*_operands(b, l1p, l2p))


def _run_scorer(b, l1p, l2p):
    from ..ops.dispatch import AlignmentScorer

    s1, len1, rows, lens, _ = _operands(b, l1p, l2p)
    seqs = [rows[i, : int(lens[i])].numpy() for i in range(b)]
    return AlignmentScorer("cuda", device="cpu").score_codes(
        s1[:len1].numpy(), seqs, (3, 2, 1, 5))


def _rows3(b, l1p, l2p):
    return (b, 3)


def _rows4(b, l1p, l2p):
    return (b, 4)


ENTRY_CONTRACTS: tuple[EntryContract, ...] = (
    EntryContract("cuda_scorer.fused_scorer_plain", _run_fused, _rows4,
                  doc="the fused kernel's plain version, [B,L2P] -> [B,4] int32"),
    EntryContract("cuda_scorer.packed_scorer_plain", _run_packed, _rows4,
                  doc="the packed kernel's plain version (class 8), [B,4] int32"),
    EntryContract("cuda_scorer.finish_rows", _run_finish, _rows3,
                  doc="the O(B) epilogue, [B,4] -> [B,3] int32"),
    EntryContract("cuda_scorer.score_chunks_cuda_body", _run_chunks,
                  lambda b, l1p, l2p: (1, b, 3),
                  doc="the chunked entry, [NC,CB,L2P] -> [NC,CB,3] int32"),
    EntryContract("matmul_scorer.mm_rows", _run_mm, _rows3,
                  doc="the fp32 one-hot matmul formulation, [B,3] int32"),
    EntryContract("gather_scorer.gather_rows", _run_gather, _rows3,
                  doc="the int32 gather formulation, [B,3] int32"),
    EntryContract("dispatch.AlignmentScorer.score_codes", _run_scorer, _rows3,
                  doc="the front door on the CPU, [B,3] int32 host array"),
)

# Tiny buckets (b, l1p, l2p): one 128-wide bucket and a two-block one.
_AUDIT_BUCKETS: tuple[tuple[int, int, int], ...] = ((4, 128, 128), (3, 256, 256))


def audit_entry_points(buckets=_AUDIT_BUCKETS) -> list[str]:
    """Run every registered entry point over the audit buckets and verify
    its output's shape and dtype.  Returns human-readable report rows;
    raises :class:`ContractViolation` on the first mismatch."""
    rows = []
    for contract in ENTRY_CONTRACTS:
        for b, l1p, l2p in buckets:
            try:
                out = contract.run(b, l1p, l2p)
            except ContractViolation:
                raise
            except Exception as exc:  # noqa: BLE001 - re-raised with context
                raise ContractViolation(
                    f"{contract.name} failed at bucket (b={b}, l1p={l1p}, "
                    f"l2p={l2p}): {exc!r}"
                ) from exc
            want_shape = tuple(contract.out_shape(b, l1p, l2p))
            got_shape = tuple(out.shape)
            got_dtype = str(out.dtype).replace("torch.", "")
            if got_shape != want_shape or got_dtype != contract.out_dtype:
                raise ContractViolation(
                    f"{contract.name}: output contract mismatch at bucket (b={b}, "
                    f"l1p={l1p}, l2p={l2p}): declared {want_shape} "
                    f"{contract.out_dtype}, got {got_shape} {got_dtype}"
                )
            rows.append(
                f"{contract.name:<40s} (b={b:>3d}, l1p={l1p:>5d}, "
                f"l2p={l2p:>5d}) -> {got_shape} {got_dtype} OK"
            )
    return rows
