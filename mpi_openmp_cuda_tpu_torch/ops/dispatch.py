"""Batch dispatch: length buckets, launch groups, padding, backend choice,
asynchronous results.

The port of ``mpi_openmp_cuda_tpu/ops/dispatch.py``'s single-device path.
Rows are grouped by their 128-wide L2P bucket (rows of at most 64 chars
by their packing class 8/16/32/64, on the ``cuda`` backend), the fused
buckets are partitioned into launch groups (``ops/schedule.py``), every
group's operands go to the scorer's device in one byte arena and one
copy (``ops/feed.py``: codes as uint8, padded to rectangles in the
arena), each group is scored by one launch whose finish kernel writes
its finished rows straight into the batch's one ``[count, 3]`` buffer at
their input positions (no PyTorch epilogue, no scatter), and the whole
batch comes back to the host in one copy, in input order.

Backends:

* ``cuda`` — the Hopper kernels (``ops/cuda_scorer.py``; their plain
  PyTorch versions on a CPU device), a launch past the kernels' int32
  window routed to ``gather`` (:func:`effective_backend`);
* ``mm`` — the one-hot fp32 matmul formulation (``ops/matmul_scorer.py``),
  a bucket past its fp32 window routed to ``gather``
  (:func:`effective_backend`);
* ``gather`` — the int32 gather formulation (``ops/gather_scorer.py``);
* ``oracle`` — the host numpy reference.

``auto`` is ``cuda``, always: a kernel that fails to build or launch is
an error (``KernelUnavailableError``), never a quiet move to another
backend; the CLI's ``--degrade`` is the opt-in chain.

A scorer given a sharding (``parallel/``) plans each dispatch as above,
with no packing classes and each launch group priced at one device's
shard of its rows, and hands the plans to it: a batch mesh scores every
launch group in one sharded dispatch, one launch a group a device, the
Seq1 ring the whole batch as one launch, with the caps lifted there.

Obs hooks (each one module-attribute check when the plane is off): the
``chunk_dispatch`` span (plan, copies in, launches queued: enqueue time
only), the ``chunk_prefetch`` detail span (the copy back enqueued ahead of
the gather, by a window of results in flight) and the ``chunk_gather``
span (the same enqueue when nothing prefetched, then its ``device_wait``
detail span: the host's block on the copy's event, where the wait on the
card is measured), the ``chunks_dispatched``, ``feed_prestages``,
``feed_prestage_hits``, ``feed_h2d_copies``, ``feed_h2d_bytes`` and
``epilogue_torch_rows`` (the rows of an ``mm`` or ``gather`` route;
``ops/cuda_scorer.py`` counts the others) counters, the
``dispatch_launched_cells`` counter (:data:`dispatch_counts`, kept in
every run), the
``config_fused_groups`` and ``config_rowpack`` gauges, and one trace
launch per launch group, from its dispatch to the batch's rows on the
host.
"""

from __future__ import annotations

import contextlib
import hashlib
import math
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..models.encoding import encode_normalized
from ..obs.metrics import gauge as _obs_gauge, inc as _obs_inc
from ..obs.spans import span as _obs_span
from ..obs.trace import active_trace, trace_launch_begin, trace_launch_end
from ..resilience import watchdog
from ..resilience.faults import fire as _fault
from ..utils.constants import BUF_SIZE_SEQ1, BUF_SIZE_SEQ2
from .bounds import check_int32_window, kernel_fits, mm_max_exact_value
from .cuda_scorer import (
    PACK_CLASSES, TILE, ScorerState, fused_scorer, kernel_table, packed_scorer, put_rows,
)
from .feed import FeedLayout, FeedRing, put_feed, view, write_rows
from .gather_scorer import gather_rows
from .matmul_scorer import mm_rows
from .oracle import score_batch_oracle
from .values import max_abs_value, value_table

BACKENDS = ("cuda", "mm", "gather", "oracle")

_LANE = 128

# Length buckets smaller than this merge into the next wider bucket:
# below it, a separate launch and copy cost more than padding.
MIN_BUCKET_ROWS = 8

# Seconds between polls of a result's CUDA event while a watchdog runs.
_POLL_S = 50e-6

# The cells the kernels computed, in every run (as ``cuda_scorer.launch_counts``
# counts launches): ``dispatch_launched_cells`` sums each launch's
# :attr:`PlannedLaunch.launched_cells` as the kernels run it; with the obs
# plane armed the run report and the serve ``metrics`` verb count it too.
dispatch_counts = {"dispatch_launched_cells": 0}
_count_lock = threading.Lock()


def round_up(x: int, mult: int) -> int:
    return max(mult, mult * math.ceil(x / mult))


@dataclass(frozen=True)
class PaddedBatch:
    """A rectangular, bucket-padded encoding of one scoring problem."""

    seq1ext: np.ndarray  # [L1P + L2P + 1] uint8 codes
    len1: int
    seq2: np.ndarray  # [B, L2P] uint8 codes
    len2: np.ndarray  # [B] int32
    l1p: int
    l2p: int

    @property
    def batch_size(self) -> int:
        return self.seq2.shape[0]


def check_caps(seq1_codes: np.ndarray, seq2_codes: list[np.ndarray]) -> None:
    """The reference's buffer caps (``BUF_SIZE_SEQ1``, ``BUF_SIZE_SEQ2``);
    an error names the caller's index of the row past its cap."""
    if seq1_codes.size > BUF_SIZE_SEQ1:
        raise ValueError(
            f"Seq1 length {seq1_codes.size} exceeds BUF_SIZE_SEQ1={BUF_SIZE_SEQ1}"
        )
    for idx, codes in enumerate(seq2_codes):
        if codes.size > BUF_SIZE_SEQ2:
            raise ValueError(
                f"Seq2[{idx}] length {codes.size} exceeds BUF_SIZE_SEQ2={BUF_SIZE_SEQ2}"
            )


def pad_problem(seq1_codes: np.ndarray, seq2_codes: list[np.ndarray], *,
                enforce_caps: bool = True) -> PaddedBatch:
    """Encode a ragged problem into bucket-padded rectangular arrays; the
    caps give way (``enforce_caps=False``) only on the Seq1 ring."""
    if enforce_caps:
        check_caps(seq1_codes, seq2_codes)
    lens = np.array([c.size for c in seq2_codes], dtype=np.int32)
    l2p = round_up(int(lens.max()) if lens.size else 1, _LANE)
    return _padded(seq1_codes, seq2_codes, lens, round_up(seq1_codes.size, _LANE), l2p)


def _padded(seq1_codes, seq2_codes, lens: np.ndarray, l1p: int, l2p: int) -> PaddedBatch:
    """The padded uint8 host arrays of a problem at the widths given."""
    seq1ext = np.zeros(l1p + l2p + 1, dtype=np.uint8)
    seq1ext[: seq1_codes.size] = seq1_codes
    rows = np.empty((lens.size, l2p), dtype=np.uint8)
    write_rows(rows, seq2_codes, lens)
    return PaddedBatch(seq1ext, int(seq1_codes.size), rows, lens, l1p, l2p)


def pack_classes() -> tuple[int, ...]:
    """Row-packing classes the packed kernel admits.  Its scores are plain
    int32 words (no packed score/key word as on the TPU), so the kernels'
    one window of ``ops/bounds.py`` covers it and every class is legal at
    every weight inside that window."""
    return PACK_CLASSES


def plan_buckets(sizes, *, packable: bool = True,
                 min_rows: int = MIN_BUCKET_ROWS) -> dict[int, list[int]]:
    """Input indices grouped by L2P shape bucket, rows of at most 64 chars
    by their packing class when ``packable`` (the ``cuda`` backend), with
    groups of fewer than ``min_rows`` rows merged into the next wider one
    (on a batch mesh :data:`MIN_BUCKET_ROWS` times its device count: each
    bucket pads to the device count)."""
    classes = pack_classes()

    def bucket_key(size: int) -> int:
        l2p = round_up(max(size, 1), _LANE)
        if packable and l2p == _LANE and size <= classes[-1]:
            return next(s for s in classes if s >= size)
        return l2p

    groups: dict[int, list[int]] = {}
    for i, size in enumerate(sizes):
        groups.setdefault(bucket_key(int(size)), []).append(i)
    keys = sorted(groups)
    for j, k in enumerate(keys[:-1]):
        if len(groups[k]) < min_rows:
            groups[keys[j + 1]].extend(groups.pop(k))
    return groups


def choose_rowpack(l2p: int, lens) -> int | None:
    """Packing class for one bucket, or None for the fused kernel: the
    smallest class that holds every live row, when the bucket is one
    128-wide char block with >= 2 rows.  The JAX package's rule, on the
    card as off it: scripts/torch_rowpack_sweep.py measured the packed
    kernel faster than the fused one on an H100 at every batch size it
    swept (8 to 4096 rows, 0.05 to 47 waves of the fused grid), in every
    class, at Seq1 3000 and 1489 (PERF.md)."""
    lens = [int(x) for x in lens]
    live = [x for x in lens if x > 0]
    classes = pack_classes()
    if l2p != _LANE or len(lens) < 2 or not live or max(live) > classes[-1]:
        return None
    return next(s for s in classes if s >= max(live))


def kernel_cells(len1: int, len2, l2s: int | None) -> int:
    """The (offset, char) cells the kernels compute for one launch of rows
    ``len2`` against a Seq1 of ``len1``, as their loop bounds set them
    (``csrc/fused_kernels.cuh``, ``csrc/packed_scorer.cu``): a row walks
    its chars rounded up to 4 over the offsets its live tiles run (tile 0
    always, tile t while ``128 t < len1 - len2``): in the fused kernel
    (``l2s`` None) the lanes' 4 offsets up to the last candidate (offset 0
    always), in the packed kernel every offset of each live tile.  At least
    the needed cells of every searchable row; none for an empty row."""
    len2 = np.asarray(len2, dtype=np.int64)
    chars = (len2 + 3) // 4 * 4
    step = 4 if l2s is None else TILE
    offsets = -(-np.maximum(len1 - len2, 1) // step) * step
    return int((offsets * chars).sum())


def effective_backend(backend: str, maxv: int, l2p: int, max_len2: int = 0) -> str:
    """The formulation a backend runs on a launch of width ``l2p`` at max
    |table value| ``maxv`` whose longest scored row has ``max_len2``
    chars: ``mm`` becomes ``gather`` past the fp32 window there
    (``bounds.mm_max_exact_value``), ``cuda`` past the kernels' int32
    window (``bounds.kernel_fits``: ``2 * len2 * max|v| < 2^31``)."""
    if backend == "mm" and maxv > mm_max_exact_value(l2p):
        return "gather"
    if backend == "cuda" and not kernel_fits(maxv, max_len2):
        return "gather"
    return backend


def admit(seq1_codes, seq2_codes, weights, *, caps: bool = True) -> np.ndarray:
    """The batch's [729] int32 value table, once the batch has passed the
    caps (unless ``caps=False``: the Seq1 ring) and the int32 admission
    gate over its scored rows; checked on the whole batch before anything
    is launched, so an error names the caller's input index."""
    if caps:
        check_caps(seq1_codes, seq2_codes)
    val_flat = value_table(weights).astype(np.int32).reshape(-1)
    scored = [c.size for c in seq2_codes if 0 < c.size <= seq1_codes.size]
    if scored:
        check_int32_window(max_abs_value(val_flat), max(scored))
    return val_flat


@dataclass(frozen=True)
class PlannedLaunch:
    """One launch planned on the host: its bucket keys, the input rows it
    scores (ascending), their codes and lengths, its row width and its
    packing class.  The feed writes the codes straight into its arena
    (``ops/feed.py``); :attr:`batch` pads them into host arrays for
    ``--check``.  A mesh shard's plan (``parallel/sharding.py::shard_plans``)
    ends in padding rows of length 0, which have no input row: its ``idx``
    holds its real rows only."""

    keys: tuple
    idx: np.ndarray
    seq1: np.ndarray  # the batch's Seq1 codes
    rows: tuple  # the launch's Seq2 codes, in ``idx`` order
    len2: np.ndarray  # [B] int32
    l2p: int
    l2s: int | None

    @property
    def len1(self) -> int:
        return int(self.seq1.size)

    @property
    def l1p(self) -> int:
        return round_up(self.len1, _LANE)

    @property
    def batch(self) -> PaddedBatch:
        """The launch's padded uint8 host arrays (made on each read)."""
        return _padded(self.seq1, self.rows, self.len2, self.l1p, self.l2p)

    @property
    def launched_cells(self) -> int:
        """The cells its kernel computes (:func:`kernel_cells`; made on
        each read, once a plan when it is sent to its device)."""
        return kernel_cells(self.len1, self.len2, self.l2s)


def launch_plans(seq1_codes, seq2_codes, weights, backend: str = "cuda", *,
                 fuse: bool = True, packable: bool = True,
                 min_rows: int = MIN_BUCKET_ROWS, caps: bool = True, devices: int = 1):
    """``(val_flat, [PlannedLaunch])`` of one batch: caps (unless
    ``caps=False``: the Seq1 ring) and the int32 admission gate checked on
    the whole batch, over its scored rows (an error names the caller's
    input index before anything is launched), rows grouped by
    :func:`plan_buckets` (``packable`` and ``min_rows`` passed on), fused
    buckets partitioned into launch groups by
    ``schedule.plan_fusion_groups`` (``cuda`` only; ``fuse=False`` keeps
    one launch a bucket, the schedule the groups are held against; each
    group priced at one of ``devices`` cards' shard of its rows), each
    group's row width that of its longest row and its kernel chosen by
    :func:`choose_rowpack` (``cuda`` and ``packable`` only).  A mesh plans
    with ``packable=False``, its sharding's ``min_rows`` and its device
    count.  Records nothing: the warm plane plans launches it does not
    dispatch (``aot/warmset.py``)."""
    from .schedule import plan_fusion_groups

    val_flat = admit(seq1_codes, seq2_codes, weights, caps=caps)
    if not seq2_codes:
        return val_flat, []
    sizes = [int(c.size) for c in seq2_codes]
    lens = np.asarray(sizes, dtype=np.int32)
    cuda = backend == "cuda"
    pack = cuda and packable
    groups = plan_buckets(sizes, packable=pack, min_rows=min_rows)
    group_keys = (plan_fusion_groups(groups, sizes, int(seq1_codes.size), devices)
                  if cuda and fuse else [(k,) for k in sorted(groups)])
    plans = []
    for keys in group_keys:
        idx = np.asarray(sorted(i for k in keys for i in groups[k]), dtype=np.int64)
        len2 = lens[idx]
        l2p = round_up(int(len2.max()), _LANE)
        l2s = choose_rowpack(l2p, len2) if pack else None
        plans.append(PlannedLaunch(tuple(keys), idx, seq1_codes,
                                   tuple(seq2_codes[i] for i in idx), len2, l2p, l2s))
    return val_flat, plans


def plan_launches(seq1_codes, seq2_codes, weights, backend: str = "cuda", **kw):
    """:func:`launch_plans` of a batch about to be dispatched, recorded
    in the ``config_fused_groups`` and ``config_rowpack`` gauges."""
    val_flat, plans = launch_plans(seq1_codes, seq2_codes, weights, backend, **kw)
    if plans:
        _obs_gauge("config_fused_groups", len(plans))
    if backend == "cuda":
        for plan in plans:
            _obs_gauge("config_rowpack", plan.l2s if plan.l2s is not None else 0)
    return val_flat, plans


@dataclass(frozen=True)
class BucketLaunch:
    """One kernel launch of a batch: the input rows it scores (ascending),
    its operands on the device, its packing class (None: the fused
    kernel), the bucket keys of its launch group, the table's max |value|
    and the longest scored row (``0 < len2 <= len1``), both known on the
    host, and where its finished rows go in the batch's ``[count, 3]``
    buffer: ``dst``, its input rows on the device (int64 [B], a view of
    the dispatch's scatter index into input order), or, when None, the
    rows ``row0 ..`` (the dispatch's launches are in input order), and
    the cells its kernel computes (:attr:`PlannedLaunch.launched_cells`)."""

    idx: np.ndarray
    state: ScorerState
    l2s: int | None
    keys: tuple = ()
    maxv: int = 0  # max |table value|
    max_scored: int = 0
    dst: torch.Tensor | None = None
    row0: int = 0
    cells: int = 0


def max_scored(batch: PaddedBatch | PlannedLaunch) -> int:
    """The longest scored row (``0 < len2 <= len1``) of a padded batch or
    a planned launch."""
    live = batch.len2[(batch.len2 > 0) & (batch.len2 <= batch.len1)]
    return int(live.max()) if live.size else 0


def _to_device(plan: PlannedLaunch, feed: torch.Tensor, layout: FeedLayout, i: int,
               val: torch.Tensor, maxv: int, order, row0: int) -> BucketLaunch:
    """Launch ``i`` of a dispatch, its operands views of the dispatch's
    arena ``feed`` on the device (``ops/feed.py``), its rows ``row0 ..``
    of the dispatch's ``order`` (the scatter index; None: input order)."""
    b, l2p = plan.len2.size, plan.l2p
    state = ScorerState(
        seq1ext=view(feed, layout.seq1, plan.l1p + l2p + 1, torch.uint8),
        len1=plan.len1,
        rows=view(feed, layout.rows[i], b * l2p, torch.uint8).view(b, l2p),
        lens=view(feed, layout.lens[i], b, torch.int32),
        val=val,
        max_len2=int(plan.len2.max()),
    )
    dst = None if order is None else order.narrow(0, row0, b)
    return BucketLaunch(plan.idx, state, plan.l2s, plan.keys, maxv, max_scored(plan), dst,
                        row0, plan.launched_cells)


def operand_digest(seq1_codes, seq2_codes, weights, backend: str) -> bytes:
    """A digest of one dispatch's operands (backend, weights, Seq1, every
    row's length and codes): a :class:`StagedFeed` feeds only a dispatch
    with the same digest."""
    h = hashlib.blake2b(digest_size=16)
    h.update(backend.encode())
    h.update(np.asarray(weights, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(seq1_codes, dtype=np.int8).tobytes())
    h.update(np.array([c.size for c in seq2_codes], dtype=np.int64).tobytes())
    for c in seq2_codes:
        h.update(np.ascontiguousarray(c, dtype=np.int8).tobytes())
    return h.digest()


class StagedFeed:
    """The launches of ONE upcoming dispatch whose host-to-device copies
    were started early (:meth:`AlignmentScorer.prestage_codes`), planned
    once for the operands of ``digest``.  On a CUDA device the copies run
    on a side stream and ``event`` marks their end; :meth:`take` makes the
    current stream wait on it before handing the launches out, so nothing
    reads a staged tensor before its copy has landed.  ``take`` empties
    the feed: it feeds at most one attempt, and a retried dispatch plans
    and copies again from the host."""

    def __init__(self, digest: bytes, event, launches: list[BucketLaunch]):
        self.digest = digest
        self._event = event
        self._launches = launches

    def take(self, digest: bytes) -> list[BucketLaunch] | None:
        """The staged launches when ``digest`` is the one they were staged
        for (None otherwise, or once taken)."""
        launches, self._launches = self._launches, None
        if launches is None or digest != self.digest:
            return None
        _obs_inc("feed_prestage_hits", len(launches))
        if self._event is not None:
            stream = torch.cuda.current_stream(launches[0].state.rows.device)
            stream.wait_event(self._event)
            for b in launches:
                st = b.state
                for t in (st.seq1ext, st.rows, st.lens, st.val):
                    t.record_stream(stream)
        return launches


def _upload(val_flat, plans, device: torch.device, ring: FeedRing, row0=None,
            table=None) -> list[BucketLaunch]:
    """The plans' operands on ``device``: one arena written into a slot of
    ``ring`` and sent in one copy (:func:`feed.put_feed`), every launch's
    operands and the one table (``table``, by default the kernels') views
    of it.  ``row0`` gives each launch's first row in its result buffer (a
    mesh slot's, or a ring window's own); when None the launches fill the
    batch's one buffer, and the arena carries the scatter index into
    input order (when the launches are not in it; each launch's ``dst``
    its slice)."""
    order = None
    if row0 is None:
        order = np.concatenate([p.idx for p in plans])
        if np.array_equal(order, np.arange(order.size)):
            order = None
        row0 = np.cumsum([0] + [p.idx.size for p in plans])
    layout = FeedLayout.of(plans, order)
    feed = put_feed(ring, layout, plans, kernel_table(val_flat) if table is None else table,
                    order, device)
    val = view(feed, layout.val, 27 * 27, torch.int32).view(27, 27)
    scatter = None if order is None else view(feed, layout.order, order.size, torch.int64)
    maxv = max_abs_value(val_flat)
    return [_to_device(plan, feed, layout, i, val, maxv, scatter, int(row0[i]))
            for i, plan in enumerate(plans)]


def bucket_launches(
    seq1_codes: np.ndarray, seq2_codes: list[np.ndarray], weights, device: torch.device,
    *, backend: str = "cuda", staged: StagedFeed | None = None, fuse: bool = True,
    check: bool = False, ring: FeedRing | None = None,
) -> list[BucketLaunch]:
    """The launches that score one batch on ``device``: the plans of
    :func:`plan_launches` with their operands on the device, sent through
    a slot of ``ring`` (the scorer's; a ring of its own when None), or
    those of ``staged`` when it was staged for the same operands (checked
    by :func:`operand_digest`; the production schedule only).
    :class:`AlignmentScorer` launches exactly these.  With ``check``
    (``--check``) every plan is validated on its host arrays
    (``analysis/contracts.py::validate_plans``) before any is uploaded; a
    staged feed was validated when it was staged."""
    if staged is not None and fuse:
        launches = staged.take(operand_digest(seq1_codes, seq2_codes, weights, backend))
        if launches is not None:
            return launches
    val_flat, plans = plan_launches(seq1_codes, seq2_codes, weights, backend, fuse=fuse)
    if check:
        _validate(val_flat, plans, backend, device)
    if not plans:
        return []
    return _upload(val_flat, plans, device, ring or FeedRing(device.type == "cuda"))


def _validate(val_flat, plans, backend: str, device) -> None:
    """The ``--check`` hook: every planned launch through the launch
    contracts (``analysis/contracts.py``); raises before any upload."""
    from ..analysis.contracts import validate_plans

    validate_plans(val_flat, plans, backend, device)


def run_launch(launch: BucketLaunch, backend: str, done=None) -> torch.Tensor:
    """One launch on ``backend``, its finished [B, 3] rows written into
    ``done``, the batch's int32 [count, 3] buffer on the launch's device,
    at the launch's input rows (``launch.dst``, or ``launch.row0 ..``);
    returns ``done``.  With ``done`` None the rows go, in launch order,
    into a buffer of the launch's own B rows (a mesh shard, the warm
    plane).  On ``cuda`` the kernels' finish kernels write them
    (``ops/cuda_scorer.py``'s finished mode); a ``cuda`` launch past the
    kernels' window runs ``gather`` (:func:`effective_backend`), whose
    rows, like ``mm``'s, are finished already and are put in place by one
    copy (``epilogue_torch_rows``).  A launch on the kernels counts its
    cells (``dispatch_launched_cells``)."""
    st = launch.state
    b = st.rows.shape[0]
    if done is None:
        done, dst, row0 = torch.empty((b, 3), dtype=torch.int32, device=st.rows.device), None, 0
    else:
        dst, row0 = launch.dst, launch.row0
    route = effective_backend(backend, launch.maxv, st.rows.shape[1], launch.max_scored)
    if route == "cuda":
        if launch.l2s is None:
            fused_scorer(st, done, dst, row0)
        else:
            packed_scorer(st, launch.l2s, done, dst, row0)
        _count_cells(launch.cells)
        return done
    val_flat = st.val.reshape(-1)
    if route == "mm":
        rows = mm_rows(st.seq1ext, st.len1, st.rows, st.lens, val_flat)
    else:
        rows = gather_rows(st.seq1ext, st.len1, st.rows, st.lens, val_flat)
    _obs_inc("epilogue_torch_rows", b)
    put_rows(done, rows, dst, row0)
    return done


def _count_cells(n: int) -> None:
    with _count_lock:  # an in-process fleet launches from several threads
        dispatch_counts["dispatch_launched_cells"] += n
    _obs_inc("dispatch_launched_cells", n)


def launch_batch(launches: list[BucketLaunch], backend: str, count: int,
                 device: torch.device) -> "BucketedPending":
    """Every launch of one batch of ``count`` rows queued on ``backend``
    (:func:`run_launch`), each writing its finished rows into the batch's
    one [count, 3] buffer at their input rows: its pending result."""
    done = torch.empty((count, 3), dtype=torch.int32, device=device)
    for b in launches:
        run_launch(b, backend, done)
    return BucketedPending(done)


def wait_event(event) -> None:
    """Block until ``event`` has completed: polled while the run's
    watchdog runs (a CUDA wait cannot be interrupted by its deadline),
    else a plain wait."""
    if watchdog.active_watchdog() is None:
        event.synchronize()
        return
    while not event.query():
        watchdog.check_expired("the device result wait")
        time.sleep(_POLL_S)


class PendingResult:
    """A result that is already on the host (the oracle path, an empty
    batch), with the same ``prefetch``/``result`` contract as
    :class:`BucketedPending`."""

    def __init__(self, raw, count: int):
        self.raw = raw
        self.count = count

    def prefetch(self) -> None:
        _fault("device_transfer")

    def result(self) -> np.ndarray:
        with watchdog.guard("chunk result gather"):
            _fault("chunk_scoring")
            with _obs_span("chunk_gather"):
                return np.asarray(self.raw).reshape(-1, 3)[: self.count]


class BucketedPending:
    """The launched, not yet fetched result of a batch.

    ``rows`` is the batch's int32 [count, 3] buffer on the scorer's device,
    into which every launch of the batch, all queued before any is
    fetched, writes its finished rows at their input positions
    (:func:`launch_batch`).  Materialising is one copy to the host:
    :meth:`prefetch` starts it into pinned memory (``non_blocking``) and
    records a CUDA event, :meth:`result` waits for the event under the
    deadline guard."""

    def __init__(self, rows: torch.Tensor):
        self.rows = rows
        self.count = rows.shape[0]
        self.trace_keys = ()  # the trace launches this result closes
        self._host = None
        self._event = None

    def _start_copy(self) -> None:
        if self.rows.device.type == "cuda":
            host = torch.empty((self.count, 3), dtype=torch.int32, pin_memory=True)
            host.copy_(self.rows, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            host = self.rows
        self._host = host

    def prefetch(self) -> None:
        """Start the device-to-host copy (the ``device_transfer`` fault
        site; advisory: a copy not started here starts in ``result``)."""
        _fault("device_transfer")
        if self._host is None:
            with _obs_span("chunk_prefetch", detail=True):
                self._start_copy()

    def result(self) -> np.ndarray:
        with watchdog.guard("bucketed result gather"):
            _fault("chunk_scoring")
            with _obs_span("chunk_gather"):
                if self._host is None:
                    self._start_copy()
                if self._event is not None:
                    with _obs_span("device_wait", detail=True):
                        wait_event(self._event)
            for key in self.trace_keys:
                trace_launch_end(key)
            return self._host.numpy()


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device; a CUDA device
    that is not there is an error, never a silent move to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu "
            "on the command line) to score on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class AlignmentScorer:
    """Front door to the scoring paths.

    backend: 'auto' or 'cuda' (the Hopper kernels; on a CPU device their
    plain PyTorch versions), 'mm' (one-hot fp32 matmul), 'gather' (int32
    gather) or 'oracle' (host numpy reference).
    device: 'cuda' by default; 'cpu' only when asked for.
    sharding: None (one device), or a ``parallel.sharding.BatchSharding``
    or ``parallel.ring.RingSharding`` that scores each dispatch over its
    mesh (no packing and no staged feed there; launch groups priced at
    one device's shard; the caps give way on the ring,
    ``sharding.unbounded``).
    check: validate every launch against ``analysis/contracts.py`` before
    it is made (``--check``); None reads ``SEQALIGN_CHECK``.
    """

    def __init__(self, backend: str = "auto", device=None, sharding=None,
                 check: bool | None = None):
        if backend == "auto":
            backend = "cuda"
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        # The oracle scores on the host and touches no device.
        self.device = None if backend == "oracle" else resolve_device(device)
        self.sharding = sharding
        self._side = None  # the staging stream (CUDA, made at first use)
        # The feed's host slots (ops/feed.py), pinned on a CUDA device.
        self._ring = None if self.device is None else FeedRing(self.device.type == "cuda")
        if check is None:
            from ..utils.env import env_flag

            check = env_flag("SEQALIGN_CHECK")
        # --check / SEQALIGN_CHECK: validate every concrete dispatch
        # decision against the launch contracts before it launches.
        self.check = bool(check)

    def score_codes(self, seq1_codes, seq2_codes, weights, *, staged=None,
                    links=(), trace_ctx=None) -> np.ndarray:
        """[B, 3] int32 array of (score, n, k) rows, input order."""
        return self.score_codes_async(seq1_codes, seq2_codes, weights, staged=staged,
                                      links=links, trace_ctx=trace_ctx).result()

    def score_codes_async(
        self, seq1_codes: np.ndarray, seq2_codes: list[np.ndarray], weights, *,
        staged: StagedFeed | None = None, links=(), trace_ctx=None,
    ) -> PendingResult | BucketedPending:
        """``score_codes`` without waiting for the device-to-host copy.
        ``staged`` is an optional :class:`StagedFeed` from
        :meth:`prestage_codes` (single-use); ``links`` are the request ids
        riding this dispatch (the serve plane's) and ``trace_ctx`` a fleet
        worker's stamp (trace ids, worker, lease epoch), both recorded on
        each of its trace launch rows."""
        with watchdog.guard("chunk dispatch"):
            _fault("chunk_dispatch")
        _obs_inc("chunks_dispatched")
        if not seq2_codes:
            return PendingResult(np.zeros((0, 3), dtype=np.int32), 0)
        if self.backend == "oracle":
            out = np.array(
                score_batch_oracle(seq1_codes, seq2_codes, weights), dtype=np.int32
            ).reshape(-1, 3)
            return PendingResult(out, out.shape[0])
        if self.sharding is not None:
            with _obs_span("chunk_dispatch"):
                return self._dispatch_sharded(seq1_codes, seq2_codes, weights)
        with _obs_span("chunk_dispatch"):
            launches = bucket_launches(
                seq1_codes, seq2_codes, weights, self.device, backend=self.backend,
                staged=staged, check=self.check, ring=self._ring,
            )
            pending = launch_batch(launches, self.backend, len(seq2_codes), self.device)
        if active_trace() is not None:
            # One trace launch per launch group, keyed by the pending
            # result that closes it.
            pending.trace_keys = [(id(pending), i) for i in range(len(launches))]
            for key, b in zip(pending.trace_keys, launches):
                trace_launch_begin(key, links=links, len1=b.state.len1,
                                   lens=[seq2_codes[j].size for j in b.idx],
                                   ctx=trace_ctx)
        return pending

    def _dispatch_sharded(self, seq1_codes, seq2_codes, weights):
        """A dispatch over the sharding's mesh, planned by
        :func:`plan_launches` as the sharding asks (no packing classes,
        buckets of fewer than its ``min_rows`` merged, launch groups
        priced at one device's shard of their rows; the caps lifted on the
        ring, which takes the batch as one launch), validated under
        ``--check`` before anything is sent, and scored by the sharding.
        Returns a ``ShardedPending``."""
        sharding = self.sharding
        val_flat, plans = plan_launches(
            seq1_codes, seq2_codes, weights, self.backend, packable=False,
            min_rows=sharding.min_rows, caps=not sharding.unbounded,
            devices=sharding.n_devices)
        if self.check:
            from ..analysis.contracts import validate_sharded

            validate_sharded(sharding, val_flat, plans, self.backend, self.device)
        return sharding.score_async(plans, val_flat, backend=self.backend)

    def prestage_codes(self, seq1_codes, seq2_codes, weights) -> StagedFeed | None:
        """Plan a future :meth:`score_codes_async` of the same operands and
        start its host-to-device copy (one arena), on a side CUDA stream
        that records one event at its end.  None where staging does not
        apply (the oracle, an empty batch, a mesh: its shards are placed
        at dispatch)."""
        if self.backend == "oracle" or not seq2_codes or self.sharding is not None:
            return None
        val_flat, plans = plan_launches(seq1_codes, seq2_codes, weights, self.backend)
        if self.check:
            _validate(val_flat, plans, self.backend, self.device)
        cuda = self.device.type == "cuda"
        if cuda and self._side is None:
            self._side = torch.cuda.Stream(self.device)
        event = None
        with torch.cuda.stream(self._side) if cuda else contextlib.nullcontext():
            launches = _upload(val_flat, plans, self.device, self._ring)
            if cuda:
                event = torch.cuda.Event()
                event.record(self._side)
        _obs_inc("feed_prestages")
        return StagedFeed(operand_digest(seq1_codes, seq2_codes, weights, self.backend),
                          event, launches)

    def score(self, seq1: str, seq2_list: list[str], weights) -> np.ndarray:
        return self.score_codes(
            encode_normalized(seq1),
            [encode_normalized(s) for s in seq2_list],
            weights,
        )

