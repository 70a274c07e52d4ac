"""The port's scorer kernels (their plain PyTorch versions on the CPU)
against the JAX package's Pallas kernels in interpret mode and the numpy
oracle, with exact equality.  Both packages get the same numpy-seeded
bytes: the JAX ``pad_problem`` output goes through ``state_from_numpy``.

Shapes reuse the interpret-mode buckets of ``test_pallas_scorer.py``: the
(L1P, L2P) = (128, 128) fused bucket, the 260-long Seq1 row-packed bucket,
and 250- and 300-long Seq1 fused buckets (two and three offset tiles) for
the cross-tile walk and the seams of the fused kernel's design.  The fused
kernel's plain version, written in the kernel's own formulation (shared
diagonals, a max without an index, k recovered for the winner), is also
held against the masked-argmax ``_plain_rows`` and, by hypothesis, against
the port's own oracle.  Tests marked ``gpu`` need a CUDA device and skip
without one."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

from mpi_openmp_cuda_tpu.ops import dispatch as jdispatch
from mpi_openmp_cuda_tpu.ops.oracle import prefix_best
from mpi_openmp_cuda_tpu.ops.values import value_table
from mpi_openmp_cuda_tpu.utils.constants import INT32_MIN
from mpi_openmp_cuda_tpu_torch.ops import bounds as tbounds
from mpi_openmp_cuda_tpu_torch.ops import cuda_scorer as cs
from mpi_openmp_cuda_tpu_torch.ops import dispatch as tdispatch
from mpi_openmp_cuda_tpu_torch.ops import oracle as toracle
from mpi_openmp_cuda_tpu_torch.ops import schedule as tschedule
from mpi_openmp_cuda_tpu_torch.ops import values as tvalues

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


def _assert_fused_formulations_agree(seq1, seqs, weights):
    """The kernel's formulation (shared diagonals, max without an index, k
    recovered for the winner) against the masked-argmax one, raw [B, 4]
    rows and all: exact int32 equality."""
    st = _state(seq1, seqs, weights)
    old = cs._plain_rows(st.seq1ext, st.len1, st.rows, st.lens, st.val, st.l1p)
    new = cs.fused_scorer_plain(st)
    assert new.dtype == torch.int32 and torch.equal(new, old)


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


def _seam_cases():
    """(id, seq1, seqs, weights, {row: n the oracle must find}) for the
    seams of the fused kernel's design, at interpret-mode sizes: Seq1 of
    300 (three 128-offset tiles)."""
    rng = np.random.default_rng(23)
    s1 = rng.integers(1, 27, size=300).astype(np.int8)
    block = rng.integers(1, 27, size=70).astype(np.int8)
    periodic = np.tile(block, 4)  # offsets 5, 75, 145 tie exactly
    lo1 = rng.integers(1, 3, size=300).astype(np.int8)
    lo = [rng.integers(1, 3, size=int(n)).astype(np.int8) for n in (2, 37, 90, 141, 255)]
    skip = np.concatenate([s1[20:70], s1[71:131]])  # a hyphen after 50 chars
    return [
        ("last offset of a tile", s1, [s1[127:227]], W, {0: 127}),
        ("first offset of the next tile", s1, [s1[128:228]], W, {0: 128}),
        ("tie across tiles", periodic, [block[5:65], np.tile(block, 2)[5:135]], W,
         {0: 5, 1: 5}),
        ("hyphen in a late segment", s1, [skip], W, {0: 20}),
        ("len2 of 1, len1 - 1, len1 and above", s1,
         [s1[:1], s1[1:], s1.copy(), np.concatenate([s1, s1[:3]])], W, {}),
        ("lengths no multiple of 4 or of the segments", s1,
         [s1[3:4 + n] for n in (5, 33, 101, 131, 257)], W, {}),
        ("two letters: ties between offsets and between k", lo1, lo, [5, 1, 1, 1], {}),
        ("all-equal weights", lo1, lo, [1, 1, 1, 1], {}),
        ("all-zero weights: every candidate ties", lo1, lo, [0, 0, 0, 0],
         dict.fromkeys(range(len(lo)), 0)),
    ]


@pytest.mark.parametrize("case", _seam_cases(), ids=lambda c: c[0])
def test_fused_plain_at_the_kernel_seams(case):
    """The new plain version against the JAX Pallas kernel (interpret
    mode), the JAX oracle and the masked-argmax ``_plain_rows``."""
    _, seq1, seqs, weights, want_n = case
    _assert_fused_formulations_agree(seq1, seqs, weights)
    _assert_three_way(seq1, seqs, weights)
    got = _port_plain(seq1, seqs, weights)
    for row, n in want_n.items():
        assert got[row][1] == n
    if weights == [0, 0, 0, 0]:
        assert all(r == (0, 0, 0) for r in got)  # k = 0 wins every tie


def test_fused_plain_hyphen_position_is_recovered():
    """Seq2 = Seq1 with one char skipped: the hyphen belongs after 50
    chars, in a later char segment than the first."""
    rng = np.random.default_rng(23)
    s1 = rng.integers(1, 27, size=300).astype(np.int8)
    skip = np.concatenate([s1[20:70], s1[71:131]])
    assert _port_plain(s1, [skip], W) == [(10 * 110, 20, 50)]


@pytest.mark.parametrize("seed", [1, 4, 6])
def test_fused_formulations_agree_on_mixed_batches(seed):
    """Raw rows, eq column and unsearchable sentinels included, on a batch
    that mixes lengths 0, 1, len1 - 1, len1 and above in one launch."""
    rng = np.random.default_rng(seed)
    l1 = int(rng.integers(130, 300))
    alpha = (2, 4, 26)[seed % 3]
    seq1 = rng.integers(1, alpha + 1, size=l1).astype(np.int8)
    lens = [0, 1, l1 - 1, l1, l1 + 2, *rng.integers(2, l1, size=5).tolist()]
    seqs = [rng.integers(1, alpha + 1, size=int(n)).astype(np.int8) for n in lens]
    for weights in (W, [1, 1, 1, 1], [3000, 7, 1, 2]):
        _assert_fused_formulations_agree(seq1, seqs, weights)
    assert _port_plain(seq1, seqs, W) == _oracle(seq1, seqs, W)


def _shared_diagonal_best(seq1, seq2, weights):
    """The identity the kernel is built on, in numpy: e(n, i) =
    val[s2[i], s1[n + i]] is d0 of offset n and d1 of offset n - 1, so with
    A = cumsum(e): G = A(n) - A(n + 1), t1 = A(n + 1, len2), the best score
    of an offset is t1 + max G, and k is recovered for the winner alone."""
    val = tvalues.value_table(weights).astype(np.int64)
    l1, l2 = len(seq1), len(seq2)
    n = np.arange(l1 - l2 + 1)[:, None]
    e = val[np.asarray(seq2)[None, :], np.asarray(seq1)[n + np.arange(l2)[None, :]]]
    a = np.cumsum(e, axis=1)
    g = a[:-1] - a[1:]  # [offsets, kappa - 1]
    score = a[1:, -1] + g.max(axis=1)
    best = int(np.argmax(score))  # first max: the smallest offset
    gw = g[best]
    k = 0
    if l2 > 1 and gw[:-1].max() > gw[-1]:
        k = int(np.argmax(gw[:-1])) + 1  # first kappa < len2 of the max
    return int(score[best]), best, k


@settings(max_examples=120, deadline=None, database=None, derandomize=True)
@given(
    alpha=hst.integers(1, 3),
    weights=hst.lists(hst.integers(0, 3), min_size=4, max_size=4),
    l1=hst.integers(2, 40),
    data=hst.data(),
)
def test_shared_diagonal_identity_and_k_recovery_match_prefix_best(alpha, weights, l1, data):
    """Small alphabets and small weights, so that ties between offsets and
    between hyphen positions are the rule: same (score, n, k) as the port's
    ``oracle.prefix_best`` every time."""
    l2 = data.draw(hst.integers(1, l1 - 1))
    codes = hst.integers(1, alpha)
    seq1 = data.draw(hst.lists(codes, min_size=l1, max_size=l1))
    seq2 = data.draw(hst.lists(codes, min_size=l2, max_size=l2))
    want = toracle.prefix_best(np.array(seq1), np.array(seq2), weights)
    assert _shared_diagonal_best(seq1, seq2, weights) == want
    got = _port_plain(np.array(seq1, np.int8), [np.array(seq2, np.int8)], weights)
    assert got == [want]


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


def _packed_seam_cases():
    """(id, seq1, seqs, weights, {row: (field, value)} the oracle's answer
    must show) for the seams of the packed kernel's design (a warp per
    (pair, tile), lanes of 4 consecutive offsets, W pairs a block), at
    interpret-mode sizes: Seq1 of 260, two live 128-offset tiles.  Fields:
    1 = n, 2 = k."""
    rng = np.random.default_rng(31)
    s1 = rng.integers(1, 27, size=260).astype(np.int8)
    cases = []
    for l2s in (8, 16, 32, 64):
        lens = [l2s, l2s // 2 + 1, l2s, 1, l2s - 1, l2s]
        cases.append((f"class {l2s} at its boundary lengths", s1,
                      [rng.integers(1, 27, size=n).astype(np.int8) for n in lens], W, {}))
    lens = [0, 64, 1, 33, 0, 5, 17, 48, 2, 0]
    cases.append(("mixed lengths in one block, len2 = 0 rows", s1,
                  [s1[10 + 7 * i: 10 + 7 * i + n] for i, n in enumerate(lens)], W,
                  {1: (1, 17), 3: (1, 31)}))
    short = s1[:40]
    cases.append(("len2 = len1 and len2 > len1", short,
                  [short.copy(), np.concatenate([short, s1[:5]]), s1[3:30], s1[:39]], W,
                  {2: (1, 3)}))
    # A run of one letter 61 long at offset 71 = 4 * 17 + 3: offsets 71 and
    # 72 (lanes 17 and 18) tie exactly, and at 71 k = 0 ties every k >= 1.
    run = s1.copy()
    run[71:132] = 1
    cases.append(("ties across lanes and between k = 0 and k >= 1", run,
                  [run[71:131], run[72:104]], W, {0: (2, 0), 1: (1, 71)}))
    block = rng.integers(1, 27, size=130).astype(np.int8)  # offsets 40 and 170 tie
    cases.append(("ties across tiles", np.tile(block, 2), [block[40:100], block[40:72]], W,
                  {0: (1, 40), 1: (1, 40)}))
    cases.append(("valid offsets end mid-tile", s1, [s1[223:259], s1[251:259], s1[203:259]],
                  W, {0: (1, 223), 1: (1, 251), 2: (1, 203)}))
    return cases


@pytest.mark.parametrize("case", _packed_seam_cases(), ids=lambda c: c[0])
def test_packed_plain_at_the_kernel_seams(case):
    """The packed plain version (the kernel's formulation over l2s chars)
    against the JAX Pallas kernel (interpret mode), the JAX oracle, the
    masked-argmax ``_plain_rows`` and the fused plain version: raw [B, 4]
    rows exactly equal."""
    _, seq1, seqs, weights, want = case
    l2s = tdispatch.choose_rowpack(128, [s.size for s in seqs])
    assert l2s is not None and l2s >= max(s.size for s in seqs)
    st = _state(seq1, seqs, weights)
    raw = cs.packed_scorer_plain(st, l2s)
    assert raw.dtype == torch.int32
    assert torch.equal(raw, cs._plain_rows(st.seq1ext, st.len1, st.rows, st.lens, st.val, st.l1p))
    assert torch.equal(raw, cs.fused_scorer_plain(st))
    _assert_three_way(seq1, seqs, weights, l2s=l2s)
    got = _port_plain(seq1, seqs, weights, l2s)
    for row, (field, value) in want.items():
        assert got[row][field] == value


@pytest.mark.parametrize("l2s", [8, 16, 32, 64])
def test_rowpack_on_the_card_needs_the_fused_grid_to_fill_it(l2s):
    """The packing rule on the card.  (The name dates from a rule that
    packed only past a fused grid of 2.5 waves.)  The packed kernel beat
    the fused one at every batch size swept, so a 128-wide bucket of >= 2
    rows packs into the smallest class that holds its longest row whatever
    the grid, on the card as off it, as the TPU rule does; one row, or a
    wider bucket, stays on the fused kernel."""
    lens = [l2s, l2s // 2 + 1]
    assert tdispatch.choose_rowpack(128, lens) == l2s
    assert tdispatch.choose_rowpack(128, lens) == jdispatch.choose_rowpack("i8", 128, lens)
    assert tdispatch.choose_rowpack(128, [l2s]) is None
    assert tdispatch.choose_rowpack(256, lens) is None
    wider = tdispatch.choose_rowpack(128, [l2s + 1, 1])
    assert wider == (2 * l2s if l2s < 64 else None)


def test_bucket_launches_cover_every_row_once():
    rng = np.random.default_rng(12)
    seq1 = rng.integers(1, 27, size=300).astype(np.int8)
    lens = [5] * 9 + [30] * 8 + [100] * 8 + [0, 301]
    seqs = [rng.integers(1, 27, size=n).astype(np.int8) for n in lens]
    cpu = torch.device("cpu")
    singles = tdispatch.bucket_launches(seq1, seqs, W, cpu, fuse=False)
    assert [b.l2s for b in singles] == [8, 32, None, None]
    assert [b.keys for b in singles] == [(8,), (32,), (128,), (384,)]
    launches = tdispatch.bucket_launches(seq1, seqs, W, cpu)
    groups = tdispatch.plan_buckets(lens)
    parts = tschedule.plan_fusion_groups(groups, lens, seq1.size)
    assert [b.keys for b in launches] == parts and parts[:2] == [(8,), (32,)]
    assert [b.l2s for b in launches] == [8, 32] + [None] * (len(parts) - 2)
    for ls in (singles, launches):
        assert sorted(np.concatenate([b.idx for b in ls]).tolist()) == list(range(len(seqs)))
        for b in ls:
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
    """At the largest max|v| of the kernels' window the int32 paths still
    equal the int64 oracle; one past it the batch runs the gather
    formulation, still exact; past the admission gate (len2 * max|v| >=
    2^31) the scorer refuses the batch."""
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
        _assert_fused_formulations_agree(seq1, seqs, weights)
    top = tbounds.max_admitted_value(16)
    assert 16 * top <= 2**31 - 1 < 16 * (top + 1)
    for big in (m + 1, top):
        got = tdispatch.AlignmentScorer("cuda", device="cpu").score_codes(
            seq1, seqs, [big, 1, 1, 1]
        )
        assert _rows(got) == _oracle(seq1, seqs, [big, 1, 1, 1])
    with pytest.raises(ValueError, match="2\\^31"):
        tdispatch.AlignmentScorer("cuda", device="cpu").score_codes(
            seq1, seqs, [top + 1, 1, 1, 1]
        )


def _route_spy(monkeypatch):
    """Count the formulations dispatch.run_launch reaches."""
    calls = {"fused": 0, "packed": 0, "gather": 0}
    for name, key in (("fused_scorer", "fused"), ("packed_scorer", "packed"),
                      ("gather_rows", "gather")):
        orig = getattr(tdispatch, name)

        def spy(*a, _orig=orig, _key=key, **k):
            calls[_key] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(tdispatch, name, spy)
    return calls


@pytest.mark.parametrize("lens,packed", [((300, 520, 700), False), ((5, 17, 40, 64), True)],
                         ids=["fused-bucket", "packed-bucket"])
def test_launch_past_the_kernels_window_runs_gather(lens, packed, monkeypatch):
    """A launch with L*M < 2^31 <= 2*L*M runs the int32 gather formulation
    (no kernel), in the kernels' raw layout, and equals the oracle."""
    rng = np.random.default_rng(11)
    seq1 = rng.integers(1, 27, size=800).astype(np.int8)
    seqs = [rng.integers(1, 27, size=n).astype(np.int8) for n in lens]
    big = tbounds.max_exact_value(max(lens)) + 1
    assert max(lens) * big < 2**31 <= 2 * max(lens) * big
    weights = [big, 1, big - 7, 2]
    launches = tdispatch.bucket_launches(seq1, seqs, weights, torch.device("cpu"))
    assert [b.l2s is not None for b in launches] == [packed]
    assert tdispatch.effective_backend("cuda", launches[0].maxv, launches[0].state.rows.shape[1],
                                       launches[0].max_scored) == "gather"
    calls = _route_spy(monkeypatch)
    got = tdispatch.AlignmentScorer("cuda", device="cpu").score_codes(seq1, seqs, weights)
    assert calls == {"fused": 0, "packed": 0, "gather": 1}
    assert _rows(got) == _oracle(seq1, seqs, weights)


def test_launch_inside_the_window_keeps_its_kernel(monkeypatch):
    rng = np.random.default_rng(12)
    seq1 = rng.integers(1, 27, size=300).astype(np.int8)
    seqs = [rng.integers(1, 27, size=n).astype(np.int8) for n in (150, 200)]
    weights = [tbounds.max_exact_value(200), 1, 1, 1]
    calls = _route_spy(monkeypatch)
    got = tdispatch.AlignmentScorer("cuda", device="cpu").score_codes(seq1, seqs, weights)
    assert calls == {"fused": 1, "packed": 0, "gather": 0}
    assert _rows(got) == _oracle(seq1, seqs, weights)


def test_unscored_rows_do_not_count_toward_the_gate():
    """Rows longer than Seq1 or empty get sentinels; only scored rows set
    L (case D of the gate fault: a 64-char row beside a 5-char Seq1)."""
    seq1 = np.array([1, 2, 2, 1, 2], dtype=np.int8)
    seqs = [np.array([1, 2], dtype=np.int8), np.tile([1, 2], 32).astype(np.int8),
            np.zeros(0, dtype=np.int8)]
    for m in (16777216, tbounds.max_admitted_value(2)):
        got = tdispatch.AlignmentScorer("cuda", device="cpu").score_codes(seq1, seqs,
                                                                          [m, 1, 1, 1])
        assert _rows(got) == _oracle(seq1, seqs, [m, 1, 1, 1])
        assert _rows(got)[1:] == [(INT32_MIN, 0, 0)] * 2


@pytest.mark.parametrize("backend", ["cuda", "gather", "mm"])
def test_refusal_once_len2_times_max_value_reaches_2_31(backend):
    seq1 = np.arange(1, 21, dtype=np.int8)
    seqs = [np.arange(1, 9, dtype=np.int8),
            (np.arange(30) % 26 + 1).astype(np.int8)]  # 30 > len1: unscored
    top = tbounds.max_admitted_value(8)
    got = tdispatch.AlignmentScorer(backend, device="cpu").score_codes(seq1, seqs, [top, 1, 1, 1])
    assert _rows(got) == _oracle(seq1, seqs, [top, 1, 1, 1])
    with pytest.raises(ValueError, match="2\\^31"):
        tdispatch.AlignmentScorer(backend, device="cpu").score_codes(
            seq1, seqs, [top + 1, 1, 1, 1])


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
    # Two empty rows of length 0 pad the batch to two chunks of four.
    batch = tdispatch.pad_problem(seq1, seqs + [np.zeros(0, dtype=np.int8)] * 2)
    out = cs.score_chunks_cuda_body(
        torch.from_numpy(batch.seq1ext), batch.len1,
        torch.from_numpy(batch.seq2.reshape(2, 4, batch.l2p)),
        torch.from_numpy(batch.len2.reshape(2, 4)),
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
