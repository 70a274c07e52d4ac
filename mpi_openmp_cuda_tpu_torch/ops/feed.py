"""The feed: one dispatch's operands in one byte arena, sent to the device
in one copy; the port's only way of moving host operands onto a device.

A dispatch on one device (``dispatch.bucket_launches``,
``AlignmentScorer.prestage_codes``) writes every launch's operands into one
host buffer, a slot of the scorer's :class:`FeedRing`, and
:func:`put_feed` moves the whole slot to the device in one non-blocking
copy.  A batch mesh sends one arena a device a dispatch, every shard its
slots take, and the Seq1 ring one a slot, each from a ring of that
device (``parallel/``).  Each operand of each launch is then a view of
that one device buffer.  The arena holds, each segment at a
:data:`SEGMENT_BYTES` offset:

* ``seq1`` — [L1P + L2P + 1] uint8 Seq1 codes, zero-padded, for the widest
  launch (every launch shares its L1P; a narrower launch reads a prefix);
* ``val`` — the kernels' [27, 27] int32 value table, once;
* ``rows[i]`` — launch i's [B, L2P] uint8 Seq2 codes, zero-padded;
* ``lens[i]`` — launch i's [B] int32 lengths;
* ``order`` — the [count] int64 scatter index of the batch's rows into
  input order, when its launches are not already in it.

Codes are 0..26, exact in one byte: the kernels read them as bytes and
compute in int32 as before, and the host link carries a quarter of the
code bytes int32 would take.  On a CUDA device a slot is pinned memory,
and is handed out again only once the event recorded after its copy has
completed; on a CPU device it is plain memory and the copy is done when
:func:`put_feed` returns.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..obs.metrics import inc as _obs_inc

#: Alignment of every segment in the arena, in bytes.
SEGMENT_BYTES = 256

#: Bytes of the [27, 27] int32 value table.
_VAL_BYTES = 27 * 27 * 4


def _align(n: int) -> int:
    return -(-n // SEGMENT_BYTES) * SEGMENT_BYTES


@dataclass(frozen=True)
class FeedLayout:
    """Byte offsets of one dispatch's segments in its arena (see the module
    docstring), and the arena's size."""

    seq1: int
    seq1_len: int
    val: int
    rows: tuple[int, ...]
    lens: tuple[int, ...]
    order: int | None
    nbytes: int

    @classmethod
    def of(cls, plans, order: np.ndarray | None) -> FeedLayout:
        """The layout of ``plans`` (``dispatch.PlannedLaunch``, every one of
        one Seq1), with a scatter segment when ``order`` is given."""
        seq1_len = plans[0].l1p + max(p.l2p for p in plans) + 1
        off = _align(seq1_len)
        val, off = off, off + _align(_VAL_BYTES)
        rows, lens = [], []
        for p in plans:
            b = int(p.len2.size)
            rows.append(off)
            off += _align(b * p.l2p)
            lens.append(off)
            off += _align(4 * b)
        at = None
        if order is not None:
            at, off = off, off + _align(8 * order.size)
        return cls(0, seq1_len, val, tuple(rows), tuple(lens), at, off)


def write_rows(dst: np.ndarray, rows, lens: np.ndarray) -> None:
    """Zero-pad the ragged code rows ``rows`` (their sizes ``lens``) into
    ``dst`` [B, L2P] in place: one concatenate and one scatter, whatever
    the number of rows."""
    dst.fill(0)
    total = int(lens.sum())
    if total == 0:
        return
    sizes = lens.astype(np.int64)
    ends = np.cumsum(sizes)
    pos = np.repeat(np.arange(sizes.size) * dst.shape[1] - (ends - sizes), sizes)
    pos += np.arange(total)
    dst.reshape(-1)[pos] = np.concatenate(rows)


def write_feed(host: np.ndarray, layout: FeedLayout, plans, table: np.ndarray,
               order: np.ndarray | None) -> None:
    """Write one dispatch's operands into the uint8 host arena ``host``
    at ``layout``: the codes straight from the plans' ragged rows."""
    seq1 = plans[0].seq1
    s1 = host[layout.seq1 : layout.seq1 + layout.seq1_len]
    s1[seq1.size :] = 0
    s1[: seq1.size] = seq1
    host[layout.val : layout.val + _VAL_BYTES].view(np.int32)[:] = table.reshape(-1)
    for p, r_off, l_off in zip(plans, layout.rows, layout.lens):
        b = p.len2.size
        dst = host[r_off : r_off + b * p.l2p].reshape(b, p.l2p)
        write_rows(dst, p.rows, p.len2)
        host[l_off : l_off + 4 * b].view(np.int32)[:] = p.len2
    if order is not None:
        host[layout.order : layout.order + 8 * order.size].view(np.int64)[:] = order


def view(feed: torch.Tensor, offset: int, count: int, dtype: torch.dtype) -> torch.Tensor:
    """``count`` elements of ``dtype`` at byte ``offset`` of the device
    arena ``feed`` (a view: no copy)."""
    return feed.narrow(0, offset, count * dtype.itemsize).view(dtype)


class _Slot:
    """One host buffer of the ring: held while a dispatch writes it, then
    busy until ``event`` (recorded after its copy) has completed."""

    __slots__ = ("host", "held", "event")

    def __init__(self):
        self.host = None
        self.held = False
        self.event = None

    def free(self) -> bool:
        if self.held:
            return False
        if self.event is not None and not self.event.query():
            return False
        self.event = None
        return True


class FeedRing:
    """The host slots of one scorer's feed.  :meth:`acquire` hands out a
    slot that no copy still reads, growing it to the size asked for (its
    capacity doubles, so a slot stops growing once it holds the largest
    dispatch); :meth:`release` returns it with the event that marks the
    end of its copy.  The ring grows by a slot when every slot is held or
    still being copied: it holds as many slots as copies were ever in
    flight at once.  Slots are handed out under a lock (an in-process
    fleet dispatches from several threads)."""

    def __init__(self, pin: bool):
        self.pin = pin
        self._slots: list[_Slot] = []
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._slots)

    def acquire(self, nbytes: int) -> _Slot:
        with self._lock:
            slot = next((s for s in self._slots if s.free()), None)
            if slot is None:
                slot = _Slot()
                self._slots.append(slot)
            slot.held = True
        if slot.host is None or slot.host.numel() < nbytes:
            cap = max(SEGMENT_BYTES, 1 << (nbytes - 1).bit_length())
            try:
                slot.host = torch.empty(cap, dtype=torch.uint8, pin_memory=self.pin)
            except BaseException:
                self.release(slot, None)
                raise
        return slot

    def release(self, slot: _Slot, event) -> None:
        """Hand ``slot`` back; it is reused once ``event`` (None: at once)
        has completed."""
        with self._lock:
            slot.event = event
            slot.held = False


def put_feed(ring: FeedRing, layout: FeedLayout, plans, table: np.ndarray,
             order: np.ndarray | None, device: torch.device) -> torch.Tensor:
    """The dispatch's arena on ``device``: written into a slot of ``ring``
    (:func:`write_feed`) and sent in one copy, non-blocking on a CUDA
    device (on the device's current stream, which an event marks for the
    slot's reuse).  Counted in ``feed_h2d_copies`` and ``feed_h2d_bytes``."""
    nbytes = layout.nbytes
    slot = ring.acquire(nbytes)
    event = None
    try:
        host = slot.host[:nbytes]
        write_feed(host.numpy(), layout, plans, table, order)
        feed = torch.empty(nbytes, dtype=torch.uint8, device=device)
        if device.type == "cuda":
            feed.copy_(host, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
        else:
            feed.copy_(host)
    finally:
        ring.release(slot, event)
    _obs_inc("feed_h2d_copies")
    _obs_inc("feed_h2d_bytes", nbytes)
    return feed
