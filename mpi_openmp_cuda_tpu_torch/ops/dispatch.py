"""Batch dispatch: length buckets, launch groups, padding, backend choice,
asynchronous results.

The port of ``mpi_openmp_cuda_tpu/ops/dispatch.py``'s single-device path.
Rows are grouped by their 128-wide L2P bucket (rows of at most 64 chars
by their packing class 8/16/32/64, on the ``cuda`` backend), the fused
buckets are partitioned into launch groups (``ops/schedule.py``), each
group is padded into rectangular int32 operands on the scorer's device
and scored by one launch, and the whole batch comes back to the host in
one copy, in input order.

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

A scorer given a sharding (``parallel/``) hands each dispatch to it
instead: on a batch mesh one sharded dispatch a length bucket, on the
Seq1 ring one for the whole batch, with the caps lifted there.

Obs hooks (each one module-attribute check when the plane is off): the
``chunk_dispatch`` span (plan, copies in, launches queued: enqueue time
only) and the ``chunk_gather`` span (epilogue, copy back and the wait for
it: the device time), the ``chunks_dispatched``, ``feed_prestages`` and
``feed_prestage_hits`` counters, the ``config_fused_groups`` and
``config_rowpack`` gauges, and one trace launch per launch group, from
its dispatch to the batch's rows on the host.
"""

from __future__ import annotations

import contextlib
import hashlib
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..models.encoding import encode_normalized, pad_to
from ..obs.metrics import gauge as _obs_gauge, inc as _obs_inc
from ..obs.spans import fence as _obs_fence, span as _obs_span
from ..obs.trace import active_trace, trace_launch_begin, trace_launch_end
from ..resilience import watchdog
from ..resilience.faults import fire as _fault
from ..utils.constants import BUF_SIZE_SEQ1, BUF_SIZE_SEQ2
from .bounds import check_int32_window, kernel_fits, mm_max_exact_value
from .cuda_scorer import (
    PACK_CLASSES, ScorerState, finish_rows, fused_scorer, kernel_table, packed_scorer,
)
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


def round_up(x: int, mult: int) -> int:
    return max(mult, mult * math.ceil(x / mult))


@dataclass(frozen=True)
class PaddedBatch:
    """A rectangular, bucket-padded encoding of one scoring problem."""

    seq1ext: np.ndarray  # [L1P + L2P + 1] int32
    len1: int
    seq2: np.ndarray  # [B, L2P] int32
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
    len1 = int(seq1_codes.size)
    if enforce_caps:
        check_caps(seq1_codes, seq2_codes)
    l1p = round_up(len1, _LANE)
    max_l2 = max((c.size for c in seq2_codes), default=1)
    l2p = round_up(max_l2, _LANE)
    seq1ext = np.zeros(l1p + l2p + 1, dtype=np.int32)
    seq1ext[:len1] = seq1_codes
    rows = (
        np.stack([pad_to(c, l2p).astype(np.int32) for c in seq2_codes])
        if seq2_codes
        else np.zeros((0, l2p), dtype=np.int32)
    )
    lens = np.array([c.size for c in seq2_codes], dtype=np.int32)
    return PaddedBatch(seq1ext, len1, rows, lens, l1p, l2p)


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


def pad_batch_rows(batch: PaddedBatch, bp: int) -> tuple[np.ndarray, np.ndarray]:
    """Zero-pad the batch rows/lengths to ``bp`` rows (zero rows are len-0
    pairs, dropped on output)."""
    rows = np.zeros((bp, batch.l2p), dtype=np.int32)
    rows[: batch.batch_size] = batch.seq2
    lens = np.zeros(bp, dtype=np.int32)
    lens[: batch.batch_size] = batch.len2
    return rows, lens


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
    scores (ascending), its padded operands and its packing class."""

    keys: tuple
    idx: np.ndarray
    batch: PaddedBatch
    l2s: int | None


def plan_launches(seq1_codes, seq2_codes, weights, backend: str = "cuda", *,
                  fuse: bool = True):
    """``(val_flat, [PlannedLaunch])`` of one batch: caps and the int32
    admission gate checked on the whole batch, over its scored rows (an
    error names the caller's input index before anything is launched),
    rows grouped by
    :func:`plan_buckets`, fused buckets partitioned into launch groups by
    ``schedule.plan_fusion_groups`` (``cuda`` only; ``fuse=False`` keeps
    one launch a bucket, the schedule the groups are held against), each
    group padded by :func:`pad_problem` and its kernel chosen by
    :func:`choose_rowpack`."""
    from .schedule import plan_fusion_groups

    val_flat = admit(seq1_codes, seq2_codes, weights)
    if not seq2_codes:
        return val_flat, []
    sizes = [int(c.size) for c in seq2_codes]
    cuda = backend == "cuda"
    groups = plan_buckets(sizes, packable=cuda)
    group_keys = (plan_fusion_groups(groups, sizes, int(seq1_codes.size))
                  if cuda and fuse else [(k,) for k in sorted(groups)])
    _obs_gauge("config_fused_groups", len(group_keys))
    plans = []
    for keys in group_keys:
        idx = np.asarray(sorted(i for k in keys for i in groups[k]), dtype=np.int64)
        batch = pad_problem(seq1_codes, [seq2_codes[i] for i in idx])
        l2s = choose_rowpack(batch.l2p, batch.len2) if cuda else None
        if cuda:
            _obs_gauge("config_rowpack", l2s if l2s is not None else 0)
        plans.append(PlannedLaunch(tuple(keys), idx, batch, l2s))
    return val_flat, plans


@dataclass(frozen=True)
class BucketLaunch:
    """One kernel launch of a batch: the input rows it scores (ascending),
    its operands on the device, its packing class (None: the fused
    kernel), the bucket keys of its launch group, the table's max |value|
    and the longest scored row (``0 < len2 <= len1``), both known on the
    host."""

    idx: np.ndarray
    state: ScorerState
    l2s: int | None
    keys: tuple = ()
    maxv: int = 0  # max |table value|
    max_scored: int = 0


def put(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: on a CUDA device copied from pinned
    memory without blocking the host."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def max_scored(batch: PaddedBatch) -> int:
    """The longest scored row (``0 < len2 <= len1``) of a padded batch."""
    live = batch.len2[(batch.len2 > 0) & (batch.len2 <= batch.len1)]
    return int(live.max()) if live.size else 0


def _to_device(plan: PlannedLaunch, val: torch.Tensor, maxv: int,
               device: torch.device) -> BucketLaunch:
    """The plan's operands on ``device`` (:func:`put`)."""
    b = plan.batch
    state = ScorerState(
        seq1ext=put(b.seq1ext, device),
        len1=b.len1,
        rows=put(b.seq2, device),
        lens=put(b.len2, device),
        val=val,
        max_len2=int(b.len2.max()),
    )
    return BucketLaunch(plan.idx, state, plan.l2s, plan.keys, maxv, max_scored(b))


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


def _upload(val_flat, plans, device: torch.device) -> list[BucketLaunch]:
    """The plans' operands on ``device`` (one value table for all)."""
    val = put(kernel_table(val_flat), device)
    maxv = max_abs_value(val_flat)
    return [_to_device(plan, val, maxv, device) for plan in plans]


def bucket_launches(
    seq1_codes: np.ndarray, seq2_codes: list[np.ndarray], weights, device: torch.device,
    *, backend: str = "cuda", staged: StagedFeed | None = None, fuse: bool = True,
) -> list[BucketLaunch]:
    """The launches that score one batch on ``device``: the plans of
    :func:`plan_launches` with their operands on the device, or those of
    ``staged`` when it was staged for the same operands (checked by
    :func:`operand_digest`; the production schedule only).
    :class:`AlignmentScorer` launches exactly these."""
    if staged is not None and fuse:
        launches = staged.take(operand_digest(seq1_codes, seq2_codes, weights, backend))
        if launches is not None:
            return launches
    val_flat, plans = plan_launches(seq1_codes, seq2_codes, weights, backend, fuse=fuse)
    return _upload(val_flat, plans, device) if plans else []


def run_launch(launch: BucketLaunch, backend: str) -> torch.Tensor:
    """One launch on ``backend``: the kernels' raw [B, 4] rows for
    ``cuda`` (``finish_rows`` runs once for the whole batch), finished
    [B, 3] rows for ``mm`` and ``gather``.  A ``cuda`` launch past the
    kernels' window runs ``gather`` and hands back its rows in the raw
    layout, the score repeated as ``eq``: ``finish_rows`` maps them back
    unchanged, since gather already applied the equal-length and
    unsearchable rules."""
    st = launch.state
    route = effective_backend(backend, launch.maxv, st.rows.shape[1], launch.max_scored)
    if route == "cuda":
        return fused_scorer(st) if launch.l2s is None else packed_scorer(st, launch.l2s)
    val_flat = st.val.reshape(-1)
    if route == "mm":
        return mm_rows(st.seq1ext, st.len1, st.rows, st.lens, val_flat)
    rows = gather_rows(st.seq1ext, st.len1, st.rows, st.lens, val_flat)
    return torch.cat([rows, rows[:, :1]], dim=1) if backend == "cuda" else rows


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
                _obs_fence(self.raw)
                return np.asarray(self.raw).reshape(-1, 3)[: self.count]


class BucketedPending:
    """The launched, not yet fetched result of a batch.

    ``parts`` are ``(input rows, [B, 4] raw kernel rows or [B, 3] finished
    rows, lens)`` on the scorer's device; every launch was queued before
    any is fetched.  Materialising concatenates the parts on the device,
    runs ``finish_rows`` once over all raw rows, scatters them into input
    order and copies the [count, 3] result to the host once:
    :meth:`prefetch` starts that copy into pinned memory
    (``non_blocking``) and records a CUDA event, :meth:`result` waits for
    the event under the deadline guard."""

    def __init__(self, parts: list, count: int, len1: int, finish: bool):
        self.parts = parts
        self.count = count
        self.len1 = len1
        self.finish = finish
        self.trace_keys = ()  # the trace launches this result closes
        self._host = None
        self._event = None

    def _start_copy(self) -> None:
        def cat(k):
            return self.parts[0][k] if len(self.parts) == 1 else torch.cat(
                [p[k] for p in self.parts])

        rows = cat(1)
        if self.finish:
            rows = finish_rows(rows, cat(2), self.len1)
        dev = rows.device
        cuda = dev.type == "cuda"
        order = np.concatenate([p[0] for p in self.parts])
        if np.array_equal(order, np.arange(self.count)):
            out = rows  # already in input order (one launch, or sorted parts)
        else:
            # The scatter's index goes up from pinned memory: a pageable
            # copy would wait for the device.
            idx = put(order, dev)
            out = torch.empty((self.count, 3), dtype=torch.int32, device=dev)
            out[idx] = rows
        if cuda:
            host = torch.empty((self.count, 3), dtype=torch.int32, pin_memory=True)
            host.copy_(out, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            host = out
        self._host = host

    def prefetch(self) -> None:
        """Start the device-to-host copy (the ``device_transfer`` fault
        site; advisory: a copy not started here starts in ``result``)."""
        _fault("device_transfer")
        if self._host is None:
            self._start_copy()

    def result(self) -> np.ndarray:
        with watchdog.guard("bucketed result gather"):
            _fault("chunk_scoring")
            with _obs_span("chunk_gather"):
                if self._host is None:
                    self._start_copy()
                if self._event is not None:
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
    mesh (no packing, no launch groups, no staged feed there; the caps
    give way on the ring, ``sharding.unbounded``).
    """

    def __init__(self, backend: str = "auto", device=None, sharding=None):
        if backend == "auto":
            backend = "cuda"
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        # The oracle scores on the host and touches no device.
        self.device = None if backend == "oracle" else resolve_device(device)
        self.sharding = sharding
        self._side = None  # the staging stream (CUDA, made at first use)

    def score_codes(self, seq1_codes, seq2_codes, weights, *, staged=None) -> np.ndarray:
        """[B, 3] int32 array of (score, n, k) rows, input order."""
        return self.score_codes_async(seq1_codes, seq2_codes, weights, staged=staged).result()

    def score_codes_async(
        self, seq1_codes: np.ndarray, seq2_codes: list[np.ndarray], weights, *,
        staged: StagedFeed | None = None,
    ) -> PendingResult | BucketedPending:
        """``score_codes`` without waiting for the device-to-host copy.
        ``staged`` is an optional :class:`StagedFeed` from
        :meth:`prestage_codes` (single-use)."""
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
                staged=staged,
            )
            parts = [(b.idx, run_launch(b, self.backend), b.state.lens) for b in launches]
            pending = BucketedPending(parts, len(seq2_codes), int(seq1_codes.size),
                                      finish=self.backend == "cuda")
        if active_trace() is not None:
            # One trace launch per launch group, keyed by the pending
            # result that closes it.
            pending.trace_keys = [(id(pending), i) for i in range(len(launches))]
            for key, b in zip(pending.trace_keys, launches):
                trace_launch_begin(key, len1=b.state.len1,
                                   lens=[seq2_codes[j].size for j in b.idx])
        return pending

    def _dispatch_sharded(self, seq1_codes, seq2_codes, weights):
        """A dispatch over the sharding's mesh: on a batch mesh one
        sharded dispatch a length bucket (at least :data:`MIN_BUCKET_ROWS`
        rows a device), in key order, as in the JAX package; on the ring
        one for the whole batch.  Returns a ``ShardedPending``."""
        from ..parallel.sharding import ShardedPending

        sharding = self.sharding
        unbounded = bool(getattr(sharding, "unbounded", False))
        val_flat = admit(seq1_codes, seq2_codes, weights, caps=not unbounded)
        if not getattr(sharding, "bucketed", False):
            batch = pad_problem(seq1_codes, seq2_codes, enforce_caps=not unbounded)
            return sharding.score_async(batch, val_flat, backend=self.backend)
        groups = plan_buckets([c.size for c in seq2_codes], packable=False,
                              min_rows=MIN_BUCKET_ROWS * sharding.n_devices)
        _obs_gauge("config_fused_groups", len(groups))
        parts = []
        for key in sorted(groups):
            idx = np.asarray(groups[key], dtype=np.int64)
            sub = pad_problem(seq1_codes, [seq2_codes[i] for i in idx])
            parts.append((idx, sharding.score_async(sub, val_flat, backend=self.backend)))
        return ShardedPending.merge(parts, len(seq2_codes))

    def prestage_codes(self, seq1_codes, seq2_codes, weights) -> StagedFeed | None:
        """Plan a future :meth:`score_codes_async` of the same operands and
        start its host-to-device copies, on a side CUDA stream that
        records one event at their end.  None where staging does not apply
        (the oracle, an empty batch, a mesh: its shards are placed at
        dispatch)."""
        if self.backend == "oracle" or not seq2_codes or self.sharding is not None:
            return None
        val_flat, plans = plan_launches(seq1_codes, seq2_codes, weights, self.backend)
        cuda = self.device.type == "cuda"
        if cuda and self._side is None:
            self._side = torch.cuda.Stream(self.device)
        event = None
        with torch.cuda.stream(self._side) if cuda else contextlib.nullcontext():
            launches = _upload(val_flat, plans, self.device)
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

