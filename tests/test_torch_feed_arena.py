"""The feed's byte arena (``ops/feed.py``): a dispatch on one device sends
every launch's operands in one copy, its codes as uint8.

Held here on the CPU: every operand of a dispatch is a view of one buffer
at a 256-byte offset; the views read back equal to the int32 operands a
dispatch padded before the arena (:func:`_int32_operands`, a row loop) at
the benchmark's two batch shapes, cut to test size; a ring slot whose
copy is still in flight is never handed out; ``feed_h2d_copies`` counts
one copy a dispatch.  On the card: the kernel wrappers refuse int32 codes
(this file imports no JAX, so that test can run there).
"""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import pytest
import torch

from mpi_openmp_cuda_tpu_torch.obs import metrics
from mpi_openmp_cuda_tpu_torch.obs.telemetry import answer_cmd
from mpi_openmp_cuda_tpu_torch.ops import cuda_scorer as cs
from mpi_openmp_cuda_tpu_torch.ops import dispatch, feed
from mpi_openmp_cuda_tpu_torch.ops.values import value_table

CPU = torch.device("cpu")
W = [10, 2, 3, 4]


def _long_batch():
    """batch-long at test size: one Seq1 and rows of one fused launch."""
    rng = np.random.default_rng(11)
    seq1 = rng.integers(1, 27, size=300).astype(np.int8)
    seqs = [rng.integers(1, 27, size=int(n)).astype(np.int8)
            for n in rng.integers(130, 250, size=16)]
    return seq1, seqs


def _short_batch():
    """batch-short at test size: 64 rows of 5-64 chars, 16 in each packing
    class, shuffled, so the four class launches are out of input order."""
    rng = np.random.default_rng(12)
    seq1 = rng.integers(1, 27, size=296).astype(np.int8)
    lens = np.concatenate([rng.integers(lo, hi + 1, size=16)
                           for lo, hi in ((5, 8), (9, 16), (17, 32), (33, 64))])
    rng.shuffle(lens)
    return seq1, [rng.integers(1, 27, size=int(n)).astype(np.int8) for n in lens]


SHAPES = {"batch-long": (_long_batch, 1), "batch-short": (_short_batch, 4)}


@pytest.fixture
def registry():
    reg = metrics.activate_metrics()
    yield reg
    metrics.deactivate_metrics()


def _operands(st):
    return (st.seq1ext, st.rows, st.lens, st.val)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_views_alias_one_buffer_at_segment_offsets(shape):
    make, n_launches = SHAPES[shape]
    seq1, seqs = make()
    launches = dispatch.bucket_launches(seq1, seqs, W, CPU)
    assert len(launches) == n_launches
    tensors = [t for b in launches for t in _operands(b.state)]
    if launches[0].dst is not None:  # the scatter index: launch 0's rows first
        tensors.append(launches[0].dst)
    base = tensors[0].untyped_storage().data_ptr()
    assert {t.untyped_storage().data_ptr() for t in tensors} == {base}
    assert all((t.data_ptr() - base) % feed.SEGMENT_BYTES == 0 for t in tensors)
    # Every launch's destination rows: its slice of the one scatter index.
    if launches[0].dst is None:
        assert all(b.dst is None for b in launches)
    else:
        assert [b.dst.data_ptr() for b in launches] == [
            launches[0].dst.data_ptr() + 8 * b.row0 for b in launches]
        assert all(b.dst.untyped_storage().data_ptr() == base for b in launches)
    assert [t.dtype for t in _operands(launches[0].state)] == [
        torch.uint8, torch.uint8, torch.int32, torch.int32]


def _int32_operands(seq1, rows):
    """``(seq1ext, rows, lens)`` of one launch as int32, padded row by row
    to the bucket widths (the operands a dispatch uploaded before)."""
    l1p = -(-seq1.size // 128) * 128
    l2p = max(128, -(-max(r.size for r in rows) // 128) * 128)
    seq1ext = np.zeros(l1p + l2p + 1, dtype=np.int32)
    seq1ext[: seq1.size] = seq1
    padded = np.zeros((len(rows), l2p), dtype=np.int32)
    for i, r in enumerate(rows):
        padded[i, : r.size] = r
    return seq1ext, padded, np.array([r.size for r in rows], dtype=np.int32)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_views_read_back_the_int32_operands(shape):
    make, _ = SHAPES[shape]
    seq1, seqs = make()
    launches = dispatch.bucket_launches(seq1, seqs, W, CPU)
    table = cs.kernel_table(value_table(W).reshape(-1))
    for b in launches:
        seq1ext, rows, lens = _int32_operands(seq1, [seqs[i] for i in b.idx])
        st = b.state
        assert np.array_equal(st.seq1ext.numpy().astype(np.int32), seq1ext)
        assert np.array_equal(st.rows.numpy().astype(np.int32), rows)
        assert np.array_equal(st.lens.numpy(), lens)
        assert np.array_equal(st.val.numpy(), table)
        assert st.len1 == seq1.size
    order = np.concatenate([b.idx for b in launches])
    if shape == "batch-long":
        assert launches[0].dst is None and np.array_equal(order, np.arange(len(seqs)))
    else:
        assert np.array_equal(torch.cat([b.dst for b in launches]).numpy(), order)
        assert not np.array_equal(order, np.arange(len(seqs)))


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_arena_rows_score_as_the_oracle(shape):
    make, _ = SHAPES[shape]
    seq1, seqs = make()
    got = dispatch.AlignmentScorer("cuda", device="cpu").score_codes(seq1, seqs, W)
    want = dispatch.AlignmentScorer("oracle").score_codes(seq1, seqs, W)
    assert np.array_equal(got, want)


def test_write_rows_equals_the_row_loop():
    rng = np.random.default_rng(3)
    rows = [rng.integers(0, 27, size=int(n)).astype(np.int8)
            for n in (0, 5, 128, 1, 0, 77)]
    lens = np.array([r.size for r in rows], dtype=np.int32)
    got = np.full((len(rows), 128), 99, dtype=np.uint8)
    feed.write_rows(got, rows, lens)
    want = np.zeros((len(rows), 128), dtype=np.uint8)
    for i, r in enumerate(rows):
        want[i, : r.size] = r
    assert np.array_equal(got, want)
    empty = np.full((2, 128), 7, dtype=np.uint8)
    feed.write_rows(empty, [rows[0], rows[0]], np.zeros(2, np.int32))
    assert not empty.any()


class FakeEvent:
    def __init__(self):
        self.done = False

    def query(self):
        return self.done


def test_a_slot_in_flight_is_never_reused():
    ring = feed.FeedRing(pin=False)
    first = ring.acquire(1000)
    assert first.host.numel() >= 1000
    event = FakeEvent()
    ring.release(first, event)
    second = ring.acquire(10)
    assert second is not first and len(ring) == 2
    ring.release(second, None)
    assert ring.acquire(10) is second  # free at once: no event
    ring.release(second, None)
    event.done = True
    got = [ring.acquire(10), ring.acquire(10)]
    assert set(map(id, got)) == {id(first), id(second)} and len(ring) == 2


def test_a_held_slot_is_never_handed_out_twice():
    """Sixteen threads acquire, write their mark, yield, read it back and
    release with an event that completes on their next round: a slot
    handed to two threads at once, or reused in flight, shows as a foreign
    mark."""
    ring = feed.FeedRing(pin=False)
    errors = []

    def worker(k):
        last = None
        for _ in range(200):
            slot = ring.acquire(64)
            slot.host[:64].fill_(k)
            time.sleep(0)
            if not bool((slot.host[:64] == k).all()):
                errors.append(k)
            if last is not None:
                last.done = True
            last = FakeEvent()
            ring.release(slot, last)
            time.sleep(0)
            if not bool((slot.host[:64] == k).all()):  # in flight: untouched
                errors.append(k)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    assert len(ring) <= 2 * 16  # each thread holds one slot and one in flight


def test_one_copy_a_dispatch_is_counted(registry):
    seq1, seqs = _short_batch()
    scorer = dispatch.AlignmentScorer("cuda", device="cpu")
    scorer.score_codes(seq1, seqs, W)
    scorer.score_codes(seq1, seqs[:40], W)
    counters = registry.snapshot()["counters"]
    assert counters["chunks_dispatched"] == counters["feed_h2d_copies"] == 2
    _, plans = dispatch.launch_plans(seq1, seqs, W)
    order = np.concatenate([p.idx for p in plans])
    nbytes = feed.FeedLayout.of(plans, order).nbytes
    assert nbytes % feed.SEGMENT_BYTES == 0
    assert nbytes < counters["feed_h2d_bytes"] < 2 * nbytes
    # A staged feed is the dispatch's one copy: none more when it is taken.
    staged = scorer.prestage_codes(seq1, seqs, W)
    scorer.score_codes(seq1, seqs, W, staged=staged)
    counters = answer_cmd("metrics")["metrics"]["counters"]
    assert counters["feed_h2d_copies"] == 3 and counters["feed_prestage_hits"] == 4


def test_wrappers_refuse_codes_that_are_not_uint8_on_the_cpu():
    seq1, seqs = _long_batch()
    st = dispatch.bucket_launches(seq1, seqs, W, CPU)[0].state
    wide = cs.ScorerState(**{**st.__dict__, "rows": st.rows.to(torch.int32)})
    with pytest.raises(ValueError, match="rows must be a contiguous torch.uint8"):
        cs.fused_scorer(wide)
    wide = cs.ScorerState(**{**st.__dict__, "seq1ext": st.seq1ext.to(torch.int32)})
    with pytest.raises(ValueError, match="seq1ext must be a contiguous torch.uint8"):
        cs.packed_scorer(wide, 8)


@pytest.mark.gpu
def test_kernel_wrappers_refuse_int32_codes_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(4)
    seq1 = rng.integers(1, 27, size=200).astype(np.int8)
    seqs = [rng.integers(1, 27, size=int(n)).astype(np.int8) for n in (8, 5, 7)]
    st = dispatch.bucket_launches(seq1, seqs, W, torch.device("cuda"))[0].state
    before = dict(cs.launch_counts)
    for name in ("seq1ext", "rows"):
        wide = cs.ScorerState(**{**st.__dict__, name: getattr(st, name).to(torch.int32)})
        with pytest.raises(ValueError, match=f"{name} must be a contiguous torch.uint8"):
            cs.fused_scorer(wide)
        with pytest.raises(ValueError, match=f"{name} must be a contiguous torch.uint8"):
            cs.packed_scorer(wide, 8)
        with pytest.raises(ValueError, match=f"{name} must be a contiguous torch.uint8"):
            cs.call_entry(cs._entry("fused_scorer"), wide)
    assert cs.launch_counts == before
