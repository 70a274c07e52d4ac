"""The port's scorer kernels (their plain PyTorch versions on the CPU)
against the JAX package's Pallas kernels in interpret mode and the numpy
oracle, with exact equality.  Both packages get the same numpy-seeded
bytes: the JAX ``pad_problem`` output goes through ``state_from_numpy``.

Shapes reuse the interpret-mode buckets of ``test_pallas_scorer.py``: the
(L1P, L2P) = (128, 128) fused bucket, the 260-long Seq1 row-packed bucket,
and one 250-long Seq1 fused bucket (two offset tiles) for the cross-tile
walk.  Tests marked ``gpu`` need a CUDA device and skip without one."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from mpi_openmp_cuda_tpu.ops import dispatch as jdispatch
from mpi_openmp_cuda_tpu.ops.oracle import prefix_best
from mpi_openmp_cuda_tpu.ops.values import value_table
from mpi_openmp_cuda_tpu.utils.constants import INT32_MIN
from mpi_openmp_cuda_tpu_torch.ops import bounds as tbounds
from mpi_openmp_cuda_tpu_torch.ops import cuda_scorer as cs
from mpi_openmp_cuda_tpu_torch.ops import dispatch as tdispatch

W = [10, 2, 3, 4]


def _rows(arr) -> list[tuple[int, int, int]]:
    return [tuple(int(x) for x in r) for r in np.asarray(arr)]


def _jax_pallas(seq1, seqs, weights):
    return _rows(jdispatch.AlignmentScorer("pallas").score_codes(seq1, seqs, weights))


def _oracle(seq1, seqs, weights):
    return [prefix_best(seq1, s, weights) for s in seqs]


def _state(seq1, seqs, weights, device="cpu"):
    batch = jdispatch.pad_problem(seq1, seqs)
    return cs.state_from_numpy(
        batch.seq1ext, batch.len1, batch.seq2, batch.len2,
        value_table(weights).reshape(-1), device,
    )


def _port_plain(seq1, seqs, weights, l2s=None):
    st = _state(seq1, seqs, weights)
    raw = cs.fused_scorer_plain(st) if l2s is None else cs.packed_scorer_plain(st, l2s)
    return _rows(cs.finish_rows(raw, st.lens, st.len1))


def _assert_three_way(seq1, seqs, weights, l2s=None):
    got = _port_plain(seq1, seqs, weights, l2s)
    assert got == _oracle(seq1, seqs, weights)
    assert got == _jax_pallas(seq1, seqs, weights)


@pytest.mark.parametrize("seed", [0, 2])
def test_fused_plain_matches_pallas_random(seed):
    rng = np.random.default_rng(seed)
    l1 = int(rng.integers(60, 127))
    seq1 = rng.integers(1, 27, size=l1).astype(np.int8)
    seqs = [
        rng.integers(1, 27, size=int(rng.integers(1, l1 + 2))).astype(np.int8)
        for _ in range(5)
    ]
    _assert_three_way(seq1, seqs, W)


def test_fused_plain_tie_break_low_entropy():
    rng = np.random.default_rng(5)
    seq1 = rng.integers(1, 3, size=120).astype(np.int8)
    seqs = [rng.integers(1, 3, size=int(rng.integers(1, 119))) for _ in range(6)]
    _assert_three_way(seq1, seqs, [5, 1, 1, 1])


def test_fused_plain_edge_lengths():
    """len2 == len1 (positional score), len2 > len1 and len2 == 0
    (INT32_MIN sentinels), len2 == len1 - 1 (one offset) and len2 == 1."""
    rng = np.random.default_rng(11)
    seq1 = rng.integers(1, 27, size=100).astype(np.int8)
    seqs = [rng.integers(1, 27, size=n).astype(np.int8) for n in (100, 101, 0, 99, 1, 64)]
    got = _port_plain(seq1, seqs, W)
    assert got[1] == got[2] == (INT32_MIN, 0, 0)
    assert got[0][1:] == (0, 0)
    _assert_three_way(seq1, seqs, W)


def test_fused_plain_multi_tile_walk():
    """Two 128-offset tiles (Seq1 250): low-entropy ties whose first hit
    must resolve across the tile boundary in offset order; one 70-char row
    keeps the bucket on the fused (unpacked) kernel."""
    rng = np.random.default_rng(5)
    seq1 = rng.integers(1, 3, size=250).astype(np.int8)
    seqs = [rng.integers(1, 3, size=int(rng.integers(1, 14))) for _ in range(6)]
    seqs.append(rng.integers(1, 3, size=70).astype(np.int8))
    st = _state(seq1, seqs, [5, 1, 1, 1])
    assert st.l1p // cs.TILE == 2
    assert tdispatch.choose_rowpack(128, [s.size for s in seqs]) is None
    _assert_three_way(seq1, seqs, [5, 1, 1, 1])


@pytest.mark.parametrize("l2s", [8, 16, 32, 64])
def test_packed_plain_each_class(l2s):
    rng = np.random.default_rng(l2s)
    seq1 = rng.integers(1, 27, size=260).astype(np.int8)
    lens = [int(rng.integers(max(1, l2s // 2 + 1), l2s + 1)) for _ in range(7)]
    lens[0] = l2s  # the class boundary
    seqs = [rng.integers(1, 27, size=n).astype(np.int8) for n in lens]
    assert tdispatch.choose_rowpack(128, lens) == l2s
    assert jdispatch.choose_rowpack("i8", 128, lens) == l2s
    _assert_three_way(seq1, seqs, W, l2s=l2s)
    st = _state(seq1, seqs, W)
    assert torch.equal(cs.packed_scorer_plain(st, l2s), cs.fused_scorer_plain(st))


@pytest.mark.parametrize("l2s", [8, 16, 32, 64])
def test_rowpack_on_the_card_needs_the_fused_grid_to_fill_it(l2s):
    """On the card a bucket packs only when the fused grid, B x ntiles
    blocks, reaches PACK_MIN_WAVES x the resident blocks; off it (wave 0)
    every admissible bucket packs, as the TPU rule does."""
    wave, ntiles = 132 * 16, 24
    need = math.ceil(tdispatch.PACK_MIN_WAVES * wave / ntiles)
    fills, short = [l2s] * need, [l2s] * (need - 1)
    assert tdispatch.choose_rowpack(128, fills, ntiles, wave) == l2s
    assert tdispatch.choose_rowpack(128, short, ntiles, wave) is None
    assert tdispatch.choose_rowpack(128, short) == l2s
    assert tdispatch.resident_blocks(torch.device("cpu")) == 0


def test_bucket_launches_cover_every_row_once():
    rng = np.random.default_rng(12)
    seq1 = rng.integers(1, 27, size=300).astype(np.int8)
    lens = [5] * 9 + [30] * 8 + [100] * 8 + [0, 301]
    seqs = [rng.integers(1, 27, size=n).astype(np.int8) for n in lens]
    launches = tdispatch.bucket_launches(seq1, seqs, W, torch.device("cpu"))
    assert [b.l2s for b in launches] == [8, 32, None, None]
    assert sorted(np.concatenate([b.idx for b in launches]).tolist()) == list(range(len(seqs)))
    for b in launches:
        assert b.state.rows.shape[0] == b.idx.size  # no padded rows
        assert b.state.lens.tolist() == [lens[i] for i in b.idx]
    assert tdispatch.bucket_launches(seq1, [], W, torch.device("cpu")) == []


def test_packed_plain_tie_break_low_entropy():
    rng = np.random.default_rng(9)
    seq1 = rng.integers(1, 3, size=260).astype(np.int8)
    seqs = [rng.integers(1, 3, size=int(rng.integers(1, 60))) for _ in range(7)]
    l2s = tdispatch.choose_rowpack(128, [s.size for s in seqs])
    assert l2s == 64
    _assert_three_way(seq1, seqs, [5, 1, 1, 1], l2s=l2s)


def test_packed_rejects_rows_past_class():
    rng = np.random.default_rng(3)
    seq1 = rng.integers(1, 27, size=100).astype(np.int8)
    seqs = [rng.integers(1, 27, size=n).astype(np.int8) for n in (5, 20)]
    st = _state(seq1, seqs, W)
    with pytest.raises(ValueError, match="cannot hold"):
        cs.packed_scorer(st, 16)
    with pytest.raises(ValueError, match="packing class"):
        cs.packed_scorer(st, 12)


@pytest.mark.parametrize("weights", [[127, 2, 3, 4], [128, 2, 3, 4], [3000, 7, 1, 2]])
def test_plain_exact_across_tpu_feed_regimes(weights):
    """max |v| = 127, 128, 3000 (the TPU kernel's i8/bf16/f32 feeds) all run
    the one int32 path; checked against the oracle in the 128 bucket."""
    rng = np.random.default_rng(21)
    seq1 = rng.integers(1, 27, size=120).astype(np.int8)
    seqs = [rng.integers(1, 27, size=int(n)).astype(np.int8) for n in (3, 40, 64, 90, 119)]
    assert _port_plain(seq1, seqs, weights) == _oracle(seq1, seqs, weights)
    assert _port_plain(seq1, seqs[:3], weights, l2s=64) == _oracle(seq1, seqs[:3], weights)


def test_int32_gate_edge_is_exact_and_past_it_raises():
    """At the largest admitted max|v| the int32 paths still equal the int64
    oracle; one past it the scorer refuses the batch."""
    rng = np.random.default_rng(4)
    seq1 = rng.integers(1, 27, size=40).astype(np.int8)
    seqs = [rng.integers(1, 27, size=n).astype(np.int8) for n in (9, 12, 16)]
    m = tbounds.max_exact_value(16)
    assert 2 * 16 * m <= 2**31 - 1 < 2 * 16 * (m + 1)
    for weights in ([m, m, 1, m], [1, m, m, m]):
        got = tdispatch.AlignmentScorer("cuda", device="cpu").score_codes(
            seq1, seqs, weights
        )
        assert _rows(got) == _oracle(seq1, seqs, weights)
    with pytest.raises(ValueError, match="2\\^31"):
        tdispatch.AlignmentScorer("cuda", device="cpu").score_codes(
            seq1, seqs, [m + 1, 1, 1, 1]
        )


def test_scorer_cpu_bucketed_batch_matches_oracle():
    """A mixed batch: two packing classes, a 128 bucket and a 256 bucket,
    scattered back to input order."""
    rng = np.random.default_rng(8)
    seq1 = rng.integers(1, 27, size=300).astype(np.int8)
    lens = [5] * 9 + [30] * 8 + [100] * 8 + [200] * 8 + [0, 300, 301]
    rng.shuffle(lens)
    seqs = [rng.integers(1, 27, size=int(n)).astype(np.int8) for n in lens]
    groups = tdispatch.plan_buckets([s.size for s in seqs])
    assert sorted(groups) == [8, 32, 128, 256, 384]
    got = tdispatch.AlignmentScorer(device="cpu").score_codes(seq1, seqs, W)
    assert _rows(got) == _oracle(seq1, seqs, W)
    oracle_backend = tdispatch.AlignmentScorer("oracle").score_codes(seq1, seqs, W)
    assert _rows(oracle_backend) == _rows(got)


def test_chunk_body_contract():
    rng = np.random.default_rng(6)
    seq1 = rng.integers(1, 27, size=90).astype(np.int8)
    seqs = [rng.integers(1, 27, size=int(n)).astype(np.int8) for n in rng.integers(1, 80, 6)]
    batch = tdispatch.pad_problem(seq1, seqs)
    rows, lens = tdispatch.pad_batch_rows(batch, 8)
    out = cs.score_chunks_cuda_body(
        torch.from_numpy(batch.seq1ext), batch.len1,
        torch.from_numpy(rows.reshape(2, 4, batch.l2p)),
        torch.from_numpy(lens.reshape(2, 4)),
        torch.from_numpy(value_table(W).reshape(-1)),
    )
    assert out.shape == (2, 4, 3) and out.dtype == torch.int32
    flat = _rows(out.reshape(8, 3))
    assert flat[:6] == _oracle(seq1, seqs, W)
    assert flat[6:] == [(INT32_MIN, 0, 0)] * 2


def test_wrappers_take_plain_path_only_on_cpu():
    rng = np.random.default_rng(1)
    seq1 = rng.integers(1, 27, size=70).astype(np.int8)
    seqs = [rng.integers(1, 27, size=n).astype(np.int8) for n in (7, 8, 3)]
    st = _state(seq1, seqs, W)
    before = dict(cs.launch_counts)
    assert torch.equal(cs.fused_scorer(st), cs.fused_scorer_plain(st))
    assert torch.equal(cs.packed_scorer(st, 8), cs.packed_scorer_plain(st, 8))
    assert cs.launch_counts == before  # no kernel launched on the CPU
    meta = cs.ScorerState(**{
        **st.__dict__,
        "seq1ext": st.seq1ext.to("meta"), "rows": st.rows.to("meta"),
        "lens": st.lens.to("meta"), "val": st.val.to("meta"),
    })
    with pytest.raises(ValueError, match="cpu or cuda"):
        cs.fused_scorer(meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        cs.packed_scorer(meta, 8)


def test_state_from_numpy_validates():
    seq1ext = np.zeros(128 + 128 + 1, np.int32)
    rows = np.zeros((2, 128), np.int32)
    lens = np.array([3, 4], np.int32)
    val = value_table(W).reshape(-1)
    st = cs.state_from_numpy(seq1ext, 10, rows, lens, val, "cpu")
    assert st.val[0].abs().sum() == 0 and st.val[:, 0].abs().sum() == 0
    assert st.val[1:, 1:].equal(torch.from_numpy(value_table(W)[1:, 1:]))
    assert (st.l1p, st.max_len2) == (128, 4)
    bad = rows.copy()
    bad[0, 0] = 27
    with pytest.raises(ValueError, match="codes"):
        cs.state_from_numpy(seq1ext, 10, bad, lens, val, "cpu")
    with pytest.raises(ValueError, match="shapes"):
        cs.state_from_numpy(seq1ext[:-1], 10, rows, lens, val, "cpu")


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdispatch.AlignmentScorer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdispatch.AlignmentScorer("cuda", device="cuda")
    assert tdispatch.AlignmentScorer(device="cpu").device.type == "cpu"


@pytest.mark.gpu
@pytest.mark.parametrize("l2s", [None, 8, 16, 32, 64])
def test_kernels_match_plain_on_card(l2s):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(13)
    seq1 = rng.integers(1, 27, size=700).astype(np.int8)
    hi = 300 if l2s is None else l2s
    seqs = [rng.integers(1, 27, size=int(n)).astype(np.int8)
            for n in rng.integers(1, hi + 1, size=24)]
    seqs += [seq1[:0]] if l2s else [seq1[:0], seq1.copy()]
    st = _state(seq1, seqs, [3000, 7, 1, 2], device="cuda")
    before = dict(cs.launch_counts)
    if l2s is None:
        got, want = cs.fused_scorer(st), cs.fused_scorer_plain(st)
        name = "fused_scorer"
    else:
        got, want = cs.packed_scorer(st, l2s), cs.packed_scorer_plain(st, l2s)
        name = "packed_scorer"
    torch.cuda.synchronize()
    assert cs.launch_counts[name] == before[name] + 1
    assert torch.equal(got, want)
    assert _rows(cs.finish_rows(got, st.lens, st.len1).cpu()) == _oracle(
        seq1, seqs, [3000, 7, 1, 2]
    )
