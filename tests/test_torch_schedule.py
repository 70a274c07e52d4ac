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
    launches."""
    keys = (128, 256, 384, 512)
    groups = {k: [i] for i, k in enumerate(keys)}
    seen = set()

    def fake_cost(len1, lens, l2p):
        seen.add((tuple(lens), l2p))
        return 10.0 if len(lens) == 1 else {2: 19.9, 3: 40.0, 4: 60.0}[len(lens)]

    monkeypatch.setattr(schedule, "launch_us", fake_cost)
    # A bucket k holds one row of k chars, so a part's lens are its keys.
    parts = schedule.plan_fusion_groups(groups, list(keys), 600)
    # Two pairs (39.8) are cheapest; a pair and two singletons (39.9) and
    # the singletons (40) tie within 2 %, and the fewest launches win.
    assert parts == [(128, 256), (384, 512)]
    # Only contiguous runs were priced: 4 singles, 3 pairs, 2 triples, 1 all.
    assert len(seen) == 10
    monkeypatch.setattr(schedule, "launch_us",
                        lambda len1, lens, l2p: 10.0 if len(lens) == 1 else 10.1 * len(lens))
    # One launch of all four (40.4) is within 2 % of the singletons (40).
    assert schedule.FUSED_TIE_FRACTION == 0.02
    assert schedule.plan_fusion_groups(groups, list(keys), 600) == [keys]


def _enumerated_plan(groups, sizes, len1):
    """The planner's choice by brute force: every contiguous partition of
    the sorted fused keys priced part by part, the cheapest within the
    near-tie band with the fewest launches (then the cheapest)."""
    keys = sorted(groups)
    fusable = [k for k in keys if k % schedule.TILE == 0]
    n = len(fusable)
    cost = {}

    def part_us(p):
        if p not in cost:
            cost[p] = schedule.launch_us(len1, [sizes[i] for k in p for i in groups[k]], p[-1])
        return cost[p]

    cands = []
    for mask in range(1 << (n - 1)):
        cuts = [0] + [j + 1 for j in range(n - 1) if mask & (1 << j)] + [n]
        parts = [tuple(fusable[a:b]) for a, b in zip(cuts, cuts[1:])]
        cands.append((sum(part_us(p) for p in parts), len(parts), parts))
    w_min = min(c[0] for c in cands)
    near = [c for c in cands if c[0] <= w_min * (1.0 + schedule.FUSED_TIE_FRACTION)]
    return min(near, key=lambda c: (c[1], c[0]))


@pytest.mark.parametrize("seed, per_key, parts_want", [(0, 8, 2), (1, 60, 3), (0, 200, 4)])
def test_planner_partitions_past_ten_keys_as_the_enumeration_does(seed, per_key, parts_want):
    """Seq2 lengths over 65..2000 chars: 16 fused keys (more than the JAX
    package's enumeration cap of 10), and the planner's partition is the
    brute-force one, at its cost and launch count; the more rows a key,
    the more launches."""
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
    # 16 warps a cluster at L2P 2048, over the card's 132 x 48 warps.
    assert waves == pytest.approx(16 * (
        8 * longest + 12 * (schedule.segment_steps(1500, 2048) + schedule.CLUSTER_STEPS))
        / (132 * 48))
    assert schedule.launch_us(3000, [1999, 1500], 2048) == pytest.approx(
        schedule.LAUNCH_US + schedule.LAT_US * longest + schedule.SLOT_US * waves)
    # The same short rows hold twice the warps in a launch of width 512
    # (two blocks a cluster) as in their own of width 256 (one block).
    short = [200] * 64
    assert schedule.launch_work(3000, short, 512)[1] == pytest.approx(
        2 * schedule.launch_work(3000, short, 256)[1])


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
