"""The port's launch groups (``ops/schedule.py``): grouped launches score
exactly what one launch a bucket scores; the planner keeps packed classes
alone, proposes only contiguous partitions of the sorted keys, picks at
any number of keys what an enumeration of every contiguous partition
picks, and breaks near-ties toward fewer launches;
its launch model follows the fused kernel's own launch shape; and the
production schedule's rows equal the JAX oracle on max-size-like and
input3-class-like batches at reduced depth."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mpi_openmp_cuda_tpu.ops import dispatch as jdispatch
from mpi_openmp_cuda_tpu.ops.oracle import prefix_best
from mpi_openmp_cuda_tpu_torch.io.parse import Problem
from mpi_openmp_cuda_tpu_torch.models.workload import input3_class_problem, synthetic_codes
from mpi_openmp_cuda_tpu_torch.ops import cuda_scorer as cs
from mpi_openmp_cuda_tpu_torch.ops import dispatch as tdispatch
from mpi_openmp_cuda_tpu_torch.ops import schedule

CPU = torch.device("cpu")
W = [10, 2, 3, 4]


def _rows(launches, count):
    return [tuple(int(v) for v in r)
            for r in tdispatch.launch_batch(launches, "cuda", count, CPU).result()]


def _problem(seed, len1, lens, weights=W):
    rng = np.random.default_rng(seed)
    seq1 = rng.integers(1, 27, size=len1).astype(np.int8)
    seqs = [rng.integers(1, 27, size=int(n)).astype(np.int8) for n in lens]
    return Problem(weights=list(weights), seq1="", seq2=[], seq1_codes=seq1, seq2_codes=seqs)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forced_group_equals_singletons_and_oracle(seed):
    """Every fused bucket of a mixed batch in ONE launch at the widest L2P
    (whatever the planner would choose) scores exactly the rows of one
    launch a bucket: the kernel reads each row's own length."""
    rng = np.random.default_rng(seed)
    lens = [int(x) for x in rng.integers(1, 420, size=30)] + [0, 400]
    prob = _problem(seed, 400, lens)
    s1, seqs = prob.seq1_codes, prob.seq2_codes
    singles = tdispatch.bucket_launches(s1, seqs, W, CPU, fuse=False)
    fused = [i for b in singles if b.l2s is None for i in b.idx]
    batch = tdispatch.pad_problem(s1, [seqs[i] for i in sorted(fused)])
    st = cs.state_from_numpy(batch.seq1ext, batch.len1, batch.seq2, batch.len2,
                             tdispatch.value_table(W).reshape(-1), CPU)
    idx = np.asarray(sorted(fused))
    group = tdispatch.BucketLaunch(idx, st, None, dst=torch.from_numpy(idx))
    packed = [b for b in singles if b.l2s is not None]
    want = _rows(singles, len(seqs))
    assert _rows(packed + [group], len(seqs)) == want
    assert _rows(tdispatch.bucket_launches(s1, seqs, W, CPU), len(seqs)) == want
    assert want == [prefix_best(s1, q, W) for q in seqs]


def test_planner_keeps_packed_classes_alone_and_partitions_contiguously():
    sizes = [5] * 9 + [30] * 8 + [100] * 8 + [200] * 8 + [300] * 8 + [500] * 8
    groups = tdispatch.plan_buckets(sizes)
    assert sorted(groups) == [8, 32, 128, 256, 384, 512]
    parts = schedule.plan_fusion_groups(groups, sizes, 600)
    assert parts[:2] == [(8,), (32,)]
    fused = [k for p in parts[2:] for k in p]
    assert fused == [128, 256, 384, 512]  # every key once, in order
    assert all(list(p) == sorted(p) for p in parts)


def test_planner_enumerates_every_contiguous_partition(monkeypatch):
    """With the launch model replaced by a table, the planner returns the
    cheapest contiguous partition, and among near-ties the fewest
    launches; the real table prices the contiguous runs of keys alone."""
    keys = (128, 256, 384, 512)
    groups = {k: [i] for i, k in enumerate(keys)}
    seen = set()

    def table(rule):
        def fake_costs(len1, key_lens, widths, devices=1):
            n = len(key_lens)
            cost = np.full((n + 1, n + 1), np.inf)
            for i in range(n):
                for j in range(i + 1, n + 1):
                    lens = tuple(int(x) for k in key_lens[i:j] for x in k)
                    seen.add((lens, widths[j - 1]))
                    cost[i, j] = rule(lens)
            return cost, np.zeros((n + 1, n + 1), dtype=np.int64)
        return fake_costs

    monkeypatch.setattr(schedule, "part_costs", table(
        lambda lens: 10.0 if len(lens) == 1 else {2: 19.9, 3: 40.0, 4: 60.0}[len(lens)]))
    # A bucket k holds one row of k chars, so a part's lens are its keys.
    parts = schedule.plan_fusion_groups(groups, list(keys), 600)
    # Two pairs (39.8) are cheapest; a pair and two singletons (39.9) and
    # the singletons (40) tie within 2 %, and the fewest launches win.
    assert parts == [(128, 256), (384, 512)]
    # Only contiguous runs are priced: 4 singles, 3 pairs, 2 triples, 1 all.
    assert len(seen) == 10
    monkeypatch.setattr(schedule, "part_costs", table(
        lambda lens: 10.0 if len(lens) == 1 else 10.1 * len(lens)))
    # One launch of all four (40.4) is within 2 % of the singletons (40).
    assert schedule.FUSED_TIE_FRACTION == 0.02
    assert schedule.plan_fusion_groups(groups, list(keys), 600) == [keys]
    monkeypatch.undo()
    cost, split = schedule.part_costs(600, [[k] for k in keys], keys)
    assert np.isfinite(cost).sum() == 10 and (split > 0).sum() == 10
    for i in range(4):
        for j in range(i + 1, 5):
            assert (split[i, j], cost[i, j]) == schedule.choose_split(600, keys[i:j], keys[j - 1])


def _enumerated_plan(groups, sizes, len1):
    """The planner's choice by brute force: every contiguous partition of
    the sorted fused keys priced part by part, each part at its chosen
    split (``schedule.choose_split``), the cheapest within the
    near-tie band with the fewest launches (then the cheapest)."""
    keys = sorted(groups)
    fusable = [k for k in keys if k % schedule.TILE == 0]
    n = len(fusable)
    cost = {}

    def part_us(p):
        if p not in cost:
            cost[p] = schedule.choose_split(len1, [sizes[i] for k in p for i in groups[k]],
                                            p[-1])[1]
        return cost[p]

    cands = []
    for mask in range(1 << (n - 1)):
        cuts = [0] + [j + 1 for j in range(n - 1) if mask & (1 << j)] + [n]
        parts = [tuple(fusable[a:b]) for a, b in zip(cuts, cuts[1:])]
        cands.append((sum(part_us(p) for p in parts), len(parts), parts))
    w_min = min(c[0] for c in cands)
    near = [c for c in cands if c[0] <= w_min * (1.0 + schedule.FUSED_TIE_FRACTION)]
    return min(near, key=lambda c: (c[1], c[0]))


@pytest.mark.parametrize("seed, per_key, parts_want", [(0, 8, 2), (1, 60, 2), (0, 200, 2)])
def test_planner_partitions_past_ten_keys_as_the_enumeration_does(seed, per_key, parts_want):
    """Seq2 lengths over 65..2000 chars: 16 fused keys (more than the JAX
    package's enumeration cap of 10), and the planner's partition is the
    brute-force one, at its cost and launch count.  Each group priced at
    its own split, the short rows of a wide group hold few warps, so at
    every row count one launch of the fused keys is cheapest."""
    rng = np.random.default_rng(seed)
    sizes = [int(x) for x in rng.integers(65, 2001, size=48)] + [5] * 8
    sizes += [128 * k - int(rng.integers(48, 63)) for k in range(1, 17)] * per_key
    groups = tdispatch.plan_buckets(sizes)
    fusable = [k for k in groups if k % schedule.TILE == 0]
    assert len(fusable) == 16 and 8 in groups
    parts = schedule.plan_fusion_groups(groups, sizes, 3000)
    assert parts[0] == (8,) and len(parts) == parts_want
    w, count, want = _enumerated_plan(groups, sizes, 3000)
    assert parts[1:] == want and len(want) == count
    assert [k for p in parts[1:] for k in p] == sorted(fusable)
    # At 11 keys too (one past the cap): the same choice.
    small = {k: v for k, v in groups.items() if k <= 11 * 128}
    assert schedule.plan_fusion_groups(small, sizes, 3000)[1:] == _enumerated_plan(
        small, sizes, 3000)[2]


def test_single_fused_bucket_is_its_own_group():
    groups = {8: [0, 1], 256: [2, 3]}
    assert schedule.plan_fusion_groups(groups, [5, 6, 200, 210], 500) == [(8,), (256,)]


@pytest.mark.parametrize("l2p, shape", [
    (128, (1, 4)), (256, (1, 8)), (288, (2, 5)), (512, (2, 8)), (2048, (2, 8))])
def test_cluster_shape_follows_the_kernel_launch(l2p, shape):
    """fused::launch: a segment a 32 chars, at most 8 a block; past 8
    segments two blocks a cluster."""
    assert schedule.cluster_shape(l2p) == shape


def test_launch_model_counts_live_clusters_and_waves():
    assert schedule.live_tiles(3000, 1999) == 8 and schedule.live_tiles(100, 100) == 1
    assert schedule.live_tiles(100, 150) == 1  # tile 0 carries eq
    # A short row in a wide launch spans more warps but the same chars.
    assert schedule.segment_steps(200, 256) == 32 == schedule.segment_steps(200, 2048)
    assert schedule.segment_steps(1999, 2048) == 128
    clusters, waves, longest = schedule.launch_work(3000, [1999, 1500], 2048)
    assert clusters == 8 + 12
    assert longest == schedule.segment_steps(1999, 2048) + schedule.CLUSTER_STEPS
    # 16 warps a cluster at L2P 2048 (two blocks: each cluster's second
    # block costs PAIR_STEPS), over the card's 132 x 48 warps.
    assert waves == pytest.approx((16 * (
        8 * longest + 12 * (schedule.segment_steps(1500, 2048) + schedule.CLUSTER_STEPS))
        + 20 * schedule.PAIR_STEPS) / (132 * 48))
    assert schedule.launch_us(3000, [1999, 1500], 2048) == pytest.approx(
        schedule.LAUNCH_US + schedule.LAT_US * longest + schedule.SLOT_US * waves)
    # The same short rows hold twice the warps in a launch of width 512
    # (two blocks a cluster) as in their own of width 256 (one block), and
    # pay each cluster's second block; at the same split they cost alike.
    short = [200] * 64
    clusters = schedule.launch_work(3000, short, 256)[0]
    assert schedule.launch_work(3000, short, 512)[1] == pytest.approx(
        2 * schedule.launch_work(3000, short, 256)[1]
        + clusters * schedule.PAIR_STEPS / (132 * 48))
    assert schedule.launch_work(3000, short, 512, 8) == schedule.launch_work(3000, short, 256)


@pytest.mark.parametrize("name", ["max-size", "input3-class"])
def test_production_schedule_rows_equal_the_jax_oracle(name):
    """The production schedule (launch groups) at reduced depth: Seq1 and
    rows cut to keep the plain versions CPU-cheap, bucket mix kept."""
    if name == "max-size":
        s1, seqs = synthetic_codes(700, 24, 280, 699, 7)  # 3 fused buckets
        prob = Problem(W, "", [], s1, seqs)
    else:
        full = input3_class_problem()
        keep = [i for i, c in enumerate(full.seq2_codes) if c.size < 600][:16]
        prob = Problem(full.weights, "", [], full.seq1_codes[:700],
                       [full.seq2_codes[i] for i in keep])
    launches = schedule.production_schedule(prob, "cpu")
    single = tdispatch.bucket_launches(prob.seq1_codes, prob.seq2_codes, prob.weights, CPU,
                                       fuse=False)
    assert len(single) >= 2 and len(launches) <= len(single)
    assert sorted(k for b in launches for k in b.keys) == sorted(
        jdispatch.plan_buckets([c.size for c in prob.seq2_codes], packable=True,
                               classes=jdispatch.pack_classes("i8")))
    got = _rows(launches, len(prob.seq2_codes))
    assert got == [prefix_best(prob.seq1_codes, q, prob.weights) for q in prob.seq2_codes]
    assert got == _rows(single, len(prob.seq2_codes))


def test_production_schedule_describes_each_launch():
    """Each launch carries its kernel (packing class or fused), its rows
    and its group's keys; the fused launches' grids follow the kernel's
    cluster split at their width."""
    prob = _problem(3, 300, [5] * 9 + [30] * 8 + [100] * 8 + [200] * 8)
    launches = schedule.production_schedule(prob, "cpu")
    assert [b.l2s for b in launches[:2]] == [8, 32]
    assert [b.keys for b in launches[:2]] == [(8,), (32,)]
    for b in launches[2:]:
        assert b.l2s is None and b.state.rows.shape[1] == max(b.keys)
        assert schedule.cluster_shape(b.state.rows.shape[1])[1] >= 4
    assert sum(b.idx.size for b in launches) == 33
    assert sorted(i for b in launches for i in b.idx) == list(range(33))


# -- the split a launch runs -----------------------------------------------------


def _scan_chunk(seed: int = 5):
    """One 256-row chunk of a database scan: the scan cell's length law
    (log-normal, median 300, sigma 0.6, 5-2000), against Seq1 2504."""
    from seqbench.scanjobs import quantile_lengths

    law = {"law": "lognormal", "median": 300, "sigma": 0.6}
    lens = np.random.default_rng(seed).permutation(quantile_lengths(4096, law, 5, 2000))
    return lens[:256]


def _batch_long(seed: int = 0):
    return np.random.default_rng(seed).integers(1200, 2000, size=64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_chooser_on_batch_long_shapes(seed):
    """A batch job's 64 rows of 1200-1999 chars against Seq1 3000: one block
    of 8 warps, the launch model's choice since its refit on the card's
    split sweep (there 45.7 us against 46.6 at the default 16); a quarter
    of them (16 rows, every 4th) keeps the default, 16.  The mesh cell's
    card shard is 64 such rows, batch-long's shape, and narrows as it does
    (``test_torch_mesh_groups.py``)."""
    job = _batch_long(seed)
    split, us = schedule.choose_split(3000, job, 2048)
    assert split == 8 and schedule.cluster_shape(2048, split) == (1, 8)
    assert us == schedule.launch_us(3000, job, 2048, 8) < schedule.launch_us(3000, job, 2048)
    assert schedule.choose_split(3000, schedule.shard_lens(job, 4), 2048)[0] == 16


@pytest.mark.parametrize("seed", [3, 5, 8])
def test_the_chooser_narrows_both_groups_of_a_scan_chunk(seed):
    """Both groups a scan chunk made at its widths' default splits (rows of
    at most 256 chars, and the rest) run far fewer segments than their
    defaults, and so does the chunk's one launch group now."""
    chunk = _scan_chunk(seed)
    short, long_ = chunk[chunk <= 256], chunk[chunk > 256]
    wide = -(-int(long_.max()) // 128) * 128
    for lens, l2p in ((short, 256), (long_, wide), (chunk, wide)):
        split, us = schedule.choose_split(2504, lens, l2p)
        assert split <= schedule.segments(l2p) // 2
        assert us < 0.9 * schedule.launch_us(2504, lens, l2p)
    groups = dispatch_groups(chunk)
    assert len(groups) == 1 and groups[0][1] <= 6


def dispatch_groups(lens, len1: int = 2504):
    """``(keys, split)`` of the production plan of rows of ``lens``."""
    sizes = [int(x) for x in lens]
    return schedule.fusion_plan(tdispatch.plan_buckets(sizes), sizes, len1)


@pytest.mark.parametrize("l2p", [128, 256, 384, 1024, 2048, 4096, 12288])
def test_the_chooser_stays_within_the_kernel_and_its_shared_memory(l2p):
    """Never past 16 segments nor the width's default, and never more shared
    memory a block (``fused_scorer_smem``'s formula, ``smem.fused_tile_
    shape``) than the default split's or the 48 KB a launch gets without
    opting in: at L2P 12288 (the ring's windows) one block would stage
    the whole row, so only two-block splits remain."""
    from mpi_openmp_cuda_tpu_torch.analysis.smem import DEFAULT_SMEM, fused_tile_shape

    rng = np.random.default_rng(l2p)
    room = max(fused_tile_shape(l2p).smem, DEFAULT_SMEM)
    for rows in (1, 8, 64, 512):
        for lo in (1, l2p // 2, l2p - 127):
            lens = rng.integers(max(lo, 1), l2p + 1, size=rows)
            split, _ = schedule.choose_split(20000, lens, l2p)
            assert 1 <= split <= min(16, schedule.segments(l2p))
            assert split in schedule.SPLITS
            assert fused_tile_shape(l2p, split).smem <= room
    allowed = [s for s, ok in zip(schedule.SPLITS, schedule._allowed(12288)) if ok]
    if l2p == 12288:
        assert allowed == [10, 12, 14, 16]


def test_plan_fusion_groups_prices_each_group_at_its_chosen_split(monkeypatch):
    """The planner's cost of a candidate group is the launch model at the
    split the group would run, and the plans carry that split."""
    chunk = _scan_chunk(5)
    sizes = [int(x) for x in chunk]
    groups = tdispatch.plan_buckets(sizes)
    fusable = sorted(k for k in groups if k % schedule.TILE == 0)
    key_lens = [[sizes[i] for i in groups[k]] for k in fusable]
    cost, split = schedule.part_costs(2504, key_lens, fusable)
    for i in range(len(fusable)):
        for j in range(i + 1, len(fusable) + 1):
            lens = [x for k in key_lens[i:j] for x in k]
            assert split[i, j] == schedule.choose_split(2504, lens, fusable[j - 1])[0]
            assert cost[i, j] == pytest.approx(
                schedule.launch_us(2504, lens, fusable[j - 1], int(split[i, j])))
    rng = np.random.default_rng(0)
    seq1 = rng.integers(1, 27, 2504).astype(np.int8)
    seqs = [rng.integers(1, 27, n).astype(np.int8) for n in sizes]
    _, plans = tdispatch.launch_plans(seq1, seqs, W)
    assert [(p.keys, p.split) for p in plans] == dispatch_groups(chunk)
    # On a mesh each group's split is chosen at one card's shard.
    _, mesh = tdispatch.launch_plans(seq1, seqs, W, packable=False, devices=4)
    for p in mesh:
        assert p.split == schedule.choose_split(
            2504, schedule.shard_lens(p.len2, 4), p.l2p)[0]


def _hand_warp_chars(len1, lens, l2p, split):
    """The chars a fused launch hands its warps, walked as the kernel walks
    them: each live (pair, tile) cluster's warps, each given ``per``."""
    nblk, nseg = schedule.cluster_shape(l2p, split)
    total = 0
    for len2 in lens:
        len2r = (int(len2) + 3) & ~3
        per = max(-(-(len2r // 4) // (nblk * nseg)) * 4, 32)
        for t in range(-(-len1 // 128)):
            if t > 0 and t * 128 >= len1 - int(len2):
                continue  # the offset-tile skip
            total += nblk * nseg * per
    return total


def test_launched_warp_chars_and_narrowed_launches_count_every_launch():
    """A plan of two launches (a packed class and a fused group) counts,
    as it runs, the chars its kernels hand their warps (a hand count of
    the loop bounds: the packed kernel's one warp a (pair, tile) walks the
    row's chars) and its fused launch once as narrowed."""
    rng = np.random.default_rng(4)
    sizes = [20] * 9 + [int(x) for x in rng.integers(65, 700, size=40)]
    seq1 = rng.integers(1, 27, 900).astype(np.int8)
    seqs = [rng.integers(1, 27, n).astype(np.int8) for n in sizes]
    launches = tdispatch.bucket_launches(seq1, seqs, W, CPU)
    assert [b.l2s for b in launches] == [32, None]
    packed, fused = launches
    split, l2p = fused.state.split, fused.state.rows.shape[1]
    assert packed.state.split is None and split < schedule.segments(l2p)
    want_fused = _hand_warp_chars(900, fused.state.lens.tolist(), l2p, split)
    want_packed = 9 * 20 * -(-(900 - 20) // 128)  # 20 chars, a multiple of 4
    assert (packed.warp_chars, fused.warp_chars) == (want_packed, want_fused)
    before = dict(tdispatch.dispatch_counts)
    _rows([packed, fused], len(seqs))
    rise = {k: tdispatch.dispatch_counts[k] - before[k] for k in before}
    assert rise == {"dispatch_launched_cells": packed.cells + fused.cells,
                    "dispatch_launched_warp_chars": want_packed + want_fused,
                    "dispatch_narrowed_launches": 1}
