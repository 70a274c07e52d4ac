"""Launch groups: the production schedule as a first-class object (the
port of ``mpi_openmp_cuda_tpu/ops/schedule.py``: ``plan_fusion_groups``,
``production_schedule``, ``kernel_configs`` and ``fused_schedule_config``).

:func:`plan_fusion_groups` partitions the 128-aligned length buckets of
``dispatch.plan_buckets`` into launch groups: contiguous runs of the
sorted bucket keys that share one launch of the fused kernel at the
widest member's L2P.  The kernel needs no change for that: it reads each
row's own length, stops its char loop there and skips the offset tiles
past ``len1 - len2``, so a row padded to a wider group scores exactly as
in its own bucket.  What a wider group changes is the launch shape: the
grid's cluster split (segments a (pair, tile), blocks a cluster) is
sized from the launch's L2P, so a short row in a wide group holds more
warps than in its own launch.  Packed class keys (8/16/32/64) keep their
own launches (the packed kernel), as in the JAX package.

The planner prices a group with the card's own model, not the TPU's
(whose super-block cost and 2 us launch term do not carry over): a fixed
cost per launch plus its work, from the counts of ``ops/costs.py``'s
kind, over the group's live (pair, tile) clusters:

* a cluster of a row of ``len2`` chars in a launch of width ``L`` at a
  split of ``S`` segments runs ``per(len2, S)`` char steps on each of its
  ``S`` warps (the kernel's own segment split, :func:`cluster_shape`),
  plus a fixed ``CLUSTER_STEPS`` (staging, segment combine, reduction),
  and, split over two blocks (``S`` > 8), ``PAIR_STEPS`` warp steps for
  the second block (its own staging of the table, the cluster's
  barriers);
* the clusters share the card's resident warps (:data:`RESIDENT_WARPS`):
  the launch's warp-steps over them are its work in waves of the card,
  priced at ``SLOT_US`` a step;
* the longest cluster is the launch's critical path, priced at
  ``LAT_US`` a step (one warp's latency-bound step);
* ``wall = LAUNCH_US + LAT_US * longest + SLOT_US * waves``.

The five constants were fitted on the card by
``scripts/torch_fusion_sweep.py`` (singleton and fused launches over
group widths and row counts at Seq1 3000 and 1489, each at its width's
default split, and its split sweep: a database scan's chunks, batch jobs
and rows of one width, each at every split).  :func:`choose_split` gives
a launch the split the model prices cheapest, and keeps the width's
default unless another is cheaper by :data:`SPLIT_KEEP_FRACTION`.  Among the
contiguous partitions of the sorted keys, those within
:data:`FUSED_TIE_FRACTION` of the cheapest tie, and the fewest launches
win.  A dynamic program over the contiguous parts finds, for every part
count, the cheapest partition with that many parts (O(k^3) over k keys),
so the choice is the one an enumeration of all 2^(k-1) partitions makes,
at any number of keys.  ``dispatch.bucket_launches`` builds one launch per group, and the
bench and ``chip_smoke.py`` derive their launches from it, so they time
exactly the production schedule.  A batch mesh plans its groups with the
same planner at its device count: every card launches each group at its
shard of the rows, so a group is priced at one card's shard.

:func:`kernel_configs` describes that schedule on the host, one
:class:`LaunchConfig` a launch, planned by ``dispatch.launch_plans`` and
routed as ``dispatch.run_launch`` routes it; :func:`fused_schedule_config`
declares the launches each kernel must see for a problem, the number the
launch audit (``analysis/traceaudit.py``) and ``chip_smoke.py`` hold the
kernels' launch counters to.  The cost sheet (``analysis/costmodel.py``)
prices the same configs.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

# The fused launch model's constants, fitted by scripts/torch_fusion_sweep.py
# on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit.
LAUNCH_US = 7.5874  # fixed cost of one launch (tile and finish kernels)
LAT_US = 0.016165  # one char step of the launch's longest cluster
SLOT_US = 0.168155  # one char step of every resident warp of the card
CLUSTER_STEPS = 10.0  # fixed cost of one warp of a cluster, in char steps
PAIR_STEPS = 150.0  # fixed cost of a cluster's second block, in warp char steps

# Partitions within this share of the cheapest tie; the fewest launches win.
FUSED_TIE_FRACTION = 0.02

# The fused kernel's launch shape (csrc/fused_kernels.cuh: kTile,
# kSegChars, kMaxSeg, kCluster) and its residency on an H100 SXM: the
# tile kernel's 40 registers a thread leave room for 51 warps of an SM's
# 64K registers, 48 in whole blocks of 8 (or 4) warps, on 132 SMs.
TILE = 128
SEG_CHARS, MAX_SEG, CLUSTER = 32, 8, 2
RESIDENT_WARPS = 132 * 48

# The splits (segments a (pair, tile)) the kernel runs: one block of 1..8
# warps, or a cluster of two blocks of 5..8.
SPLITS = (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16)
# A launch keeps its width's default split unless another is modelled
# faster by more than this share.
SPLIT_KEEP_FRACTION = 0.03


def cluster_shape(l2p: int, split: int | None = None) -> tuple[int, int]:
    """(blocks a cluster, warps a block) of a fused launch of width
    ``l2p`` at ``split`` segments (None: the width's default, one a
    ``SEG_CHARS`` chars, at most ``MAX_SEG * CLUSTER``; never past it):
    ``fused::tile_shape``'s segment split."""
    nsegt = min(-(-l2p // SEG_CHARS), MAX_SEG * CLUSTER)
    if split:
        nsegt = min(nsegt, split)
    nblk = CLUSTER if nsegt > MAX_SEG else 1
    return nblk, -(-nsegt // nblk)


def segments(l2p: int, split: int | None = None) -> int:
    """The warps of one (pair, tile) cluster: :func:`cluster_shape`'s
    blocks times warps."""
    nblk, nseg = cluster_shape(l2p, split)
    return nblk * nseg


def _steps(len2, nsegt):
    """The kernel's ``per``: char steps of one segment of rows ``len2`` at
    ``nsegt`` segments (arrays broadcast)."""
    q = ((len2 + 3) & ~3) // 4
    return np.maximum(-(-q // nsegt) * 4, SEG_CHARS)


def _clusters(len1: int, lens, nsegt):
    """``(tiles, per)`` of rows ``lens`` at ``nsegt`` segments (arrays
    broadcast): each row's live (pair, tile) clusters (:func:`live_tiles`)
    and the char steps of one of its segments (the kernel's ``per``), the
    terms :func:`launch_work`, :func:`warp_chars` and :func:`part_costs`
    sum."""
    return np.maximum(1, -(-(int(len1) - lens) // TILE)), _steps(lens, nsegt)


def segment_steps(len2: int, l2p: int, split: int | None = None) -> int:
    """Char steps of one segment of a row of ``len2`` chars in a launch of
    width ``l2p`` at ``split`` (the kernel's ``per``)."""
    return int(_steps(np.int64(len2), segments(l2p, split)))


def live_tiles(len1: int, len2: int) -> int:
    """Offset tiles a pair runs: those with a valid offset, tile 0 always."""
    return max(1, -(-(len1 - len2) // TILE))


def launch_work(len1: int, lens, l2p: int, split: int | None = None
                ) -> tuple[int, float, float]:
    """(live clusters, waves, longest cluster) of one fused launch of width
    ``l2p`` at ``split`` (None: the width's default): waves in char steps
    of every resident warp, the longest cluster in char steps
    (:func:`segment_steps` and :func:`live_tiles` over every row at
    once)."""
    nsegt = segments(l2p, split)
    n = np.asarray(lens, dtype=np.int64).reshape(-1)
    if n.size == 0:
        return 0, 0.0, 0.0
    tiles, per = _clusters(len1, n, nsegt)
    steps = per + CLUSTER_STEPS
    pair = PAIR_STEPS if nsegt > MAX_SEG else 0.0
    warp_steps = float((tiles * steps).sum()) * nsegt + pair * float(tiles.sum())
    return int(tiles.sum()), warp_steps / RESIDENT_WARPS, float(steps.max())


def launch_us(len1: int, lens, l2p: int, split: int | None = None) -> float:
    """Modelled device time of one fused launch, in microseconds."""
    _, waves, longest = launch_work(len1, lens, l2p, split)
    return LAUNCH_US + LAT_US * longest + SLOT_US * waves


def warp_chars(len1: int, lens, l2p: int, split: int | None = None) -> int:
    """The chars one fused launch hands its warps, as the kernel's loop
    bounds set them: over its live (pair, tile) clusters, the cluster's
    warps times the ``per`` of its row (what :func:`launch_work` prices
    before the fixed ``CLUSTER_STEPS``)."""
    nsegt = segments(l2p, split)
    tiles, per = _clusters(len1, np.asarray(lens, dtype=np.int64).reshape(-1), nsegt)
    return int((tiles * per).sum()) * nsegt


@functools.cache
def _allowed(l2p: int) -> np.ndarray:
    """[len(SPLITS)] bool: the splits a launch of width ``l2p`` may run:
    none past its default, and none whose block asks for more shared
    memory than the default's or than a launch gets without opting in
    (``analysis/smem.py``), so no choice opts in where the default did
    not."""
    from ..analysis.smem import DEFAULT_SMEM, fused_tile_shape

    most = segments(l2p)
    room = max(fused_tile_shape(l2p).smem, DEFAULT_SMEM)
    return np.array([s <= most and fused_tile_shape(l2p, s).smem <= room
                     for s in SPLITS])


def part_costs(len1: int, key_lens, widths, devices: int = 1):
    """``(cost, split)``, each ``[n + 1, n + 1]``: ``cost[i, j]`` the
    modelled microseconds of one card's launch of the keys ``i:j``
    (``i < j``; ``inf`` elsewhere) at its chosen split ``split[i, j]``.
    ``key_lens`` holds each key's row lengths, the keys in ascending
    order of length, and ``widths`` each key's L2P; a part launches at its
    widest key's.  Every part and every split is priced in one broadcast:
    the rows sorted once, each split's ``tiles * steps`` summed along them
    with a stride of ``devices`` (a part's shard, :func:`shard_lens`, is
    every ``devices``-th of its sorted rows from its first), so a part's
    work is a difference of two such sums and its longest cluster that of
    its shard's last (longest) row (:func:`launch_work`'s terms).  Of the splits a width allows
    (:func:`_allowed`), a part runs the cheapest, unless the default is
    within :data:`SPLIT_KEEP_FRACTION` of it."""
    n = len(key_lens)
    lens = np.concatenate([np.sort(np.asarray(k, dtype=np.int64)) for k in key_lens])
    bounds = np.cumsum([0] + [len(k) for k in key_lens])
    d = max(1, int(devices))
    segs = np.array(SPLITS, dtype=np.int64)[:, None]
    tiles, per = _clusters(len1, lens[None, :], segs)  # [1, R], [S, R]
    steps = per + CLUSTER_STEPS
    # Each split's warp steps a row, and (last) the row's clusters.
    work = np.vstack([steps * tiles * segs, tiles]).astype(np.float64)
    r = lens.size
    runs = np.pad(work, ((0, 0), (0, -r % d))).reshape(len(work), -1, d)
    csum = np.cumsum(runs, axis=1).reshape(len(work), -1)[:, :r]
    i, j = np.triu_indices(n + 1, 1)
    first = bounds[i]
    last = first + (bounds[j] - 1 - first) // d * d
    before = np.where(first >= d, csum[:, np.maximum(first - d, 0)], 0.0)
    sums = csum[:, last] - before
    pair = np.where(segs > MAX_SEG, PAIR_STEPS, 0.0)
    waves = (sums[:-1] + pair * sums[-1]) / RESIDENT_WARPS
    us = LAUNCH_US + LAT_US * steps[:, last] + SLOT_US * waves  # [S, parts]
    wide = [int(widths[k - 1]) for k in j]
    ok = np.stack([_allowed(w) for w in wide], axis=1)
    dflt = np.array([SPLITS.index(segments(w)) for w in wide])
    cols = np.arange(i.size)
    best = np.where(ok, us, np.inf).argmin(axis=0)
    keep = us[best, cols] >= us[dflt, cols] * (1.0 - SPLIT_KEEP_FRACTION)
    pick = np.where(keep, dflt, best)
    cost = np.full((n + 1, n + 1), np.inf)
    split = np.zeros((n + 1, n + 1), dtype=np.int64)
    cost[i, j] = us[pick, cols]
    split[i, j] = segs[pick, 0]
    return cost, split


def choose_split(len1: int, lens, l2p: int) -> tuple[int, float]:
    """``(split, us)``: the segments a (pair, tile) one fused launch of
    rows ``lens`` (one card's) at width ``l2p`` runs, and its modelled
    microseconds there: :func:`part_costs` of the launch alone."""
    cost, split = part_costs(len1, [lens], [l2p])
    return int(split[0, 1]), float(cost[0, 1])


def shard_lens(lens, devices: int) -> np.ndarray:
    """The lengths one of ``devices`` cards launches of a group of rows
    ``lens``: every ``devices``-th of them in sorted order, ``ceil(B /
    devices)`` rows that span the group as a batch mesh's shard does
    (``parallel/sharding.py::shard_plans``); all of them on one card."""
    lens = np.asarray(lens, dtype=np.int64)
    return lens if devices <= 1 else np.sort(lens)[::devices]


def fusion_plan(groups, sizes, len1: int, devices: int = 1) -> list[tuple[tuple, int | None]]:
    """Partition the keys of ``groups`` (``dispatch.plan_buckets``) into
    launch groups: a list of ``(keys, split)`` sorted by first key, each
    one launch, ``split`` the fused kernel's segments a (pair, tile) for
    it (None for a packed class key, which stays alone).  Every candidate
    group is priced at the split it would run (:func:`part_costs`), so
    groups and splits are chosen together.  On a batch mesh of
    ``devices`` cards each card launches every group once, at its shard
    of the group's rows, so a group is priced, and its split chosen, at
    that shard (:func:`shard_lens`): the partition is the one a single
    card would pick for its share."""
    keys = sorted(groups)
    fusable = [k for k in keys if k % TILE == 0]
    packed = [((k,), None) for k in keys if k % TILE != 0]
    if not fusable:
        return packed
    key_lens = [np.array([int(sizes[x]) for x in groups[k]], dtype=np.int64)
                for k in fusable]
    cost, split = part_costs(int(len1), key_lens, fusable, devices)
    parts = [(tuple(fusable[a:b]), int(split[a, b])) for a, b in _partition(cost)]
    return sorted(packed + parts, key=lambda g: g[0][0])


def plan_fusion_groups(groups, sizes, len1: int, devices: int = 1):
    """The launch groups of :func:`fusion_plan`: a list of key tuples
    sorted by first key.  Packed class keys stay alone; singletons are
    the unfused schedule."""
    return [keys for keys, _ in fusion_plan(groups, sizes, len1, devices)]


def _partition(cost) -> list[tuple[int, int]]:
    """The ``(start, end)`` parts of the cheapest contiguous partition of
    ``n`` keys, ``cost[i][j]`` one part of the keys ``i:j``: among the
    partitions within :data:`FUSED_TIE_FRACTION` of the cheapest, the one
    of fewest parts.  A dynamic program finds, for every part count, the
    cheapest partition with that many parts."""
    n = len(cost) - 1
    cost = [[float(x) for x in row] for row in cost]
    # best[m][j]: (cost, cuts) of the cheapest partition of the keys :j
    # into m parts; parts are summed left to right, as an enumeration would.
    inf = (float("inf"), ())
    best = [[inf] * (n + 1) for _ in range(n + 1)]
    best[0][0] = (0.0, ())
    for m in range(1, n + 1):
        for j in range(m, n + 1):
            best[m][j] = min(
                ((best[m - 1][i][0] + cost[i][j], best[m - 1][i][1] + (i,))
                 for i in range(m - 1, j)),
                key=lambda c: c[0],
            )
    w_min = min(best[m][n][0] for m in range(1, n + 1))
    m = next(m for m in range(1, n + 1)
             if best[m][n][0] <= w_min * (1.0 + FUSED_TIE_FRACTION))
    cuts = (*best[m][n][1], n)
    return list(zip(cuts, cuts[1:]))


def production_schedule(problem, device="cpu"):
    """The launches the production dispatch makes for ``problem`` on
    ``device`` (``dispatch.bucket_launches``): one per launch group."""
    import torch

    from .dispatch import bucket_launches

    return bucket_launches(
        problem.seq1_codes, problem.seq2_codes, problem.weights, torch.device(device)
    )


# The kernel a formulation launches (``cuda_scorer.launch_counts`` names);
# ``mm`` and ``gather`` are plain PyTorch and launch none of them.
KERNEL_OF = {"cuda-fused": "fused_scorer", "cuda-packed": "packed_scorer"}


@dataclass(frozen=True)
class LaunchConfig:
    """The host-side facts of one launch of the production schedule: its
    formulation (``aot/warmset.FORMULATIONS``), padded shapes, Seq1 length,
    padded rows and their lengths, packing class, the fused kernel's
    cluster shape at its split (:func:`cluster_shape`; None off it), the
    bucket keys of its launch group, and the fused kernel's split (None
    off it)."""

    formulation: str
    l1p: int
    l2p: int
    len1: int
    rows: int
    l2s: int | None
    cluster: tuple[int, int] | None
    lens: tuple[int, ...]
    bucket_keys: tuple = ()
    split: int | None = None

    @property
    def kernel(self) -> str | None:
        """The ``cuda_scorer`` kernel the launch runs (None: mm, gather)."""
        return KERNEL_OF.get(self.formulation)

    @property
    def live_pairs(self) -> int:
        return sum(1 for n in self.lens if n > 0)

    def warm_entry(self, source: str = "schedule"):
        """The warm plane's entry of this launch (``aot/warmset.WarmEntry``)."""
        from ..aot.warmset import WarmEntry

        return WarmEntry(self.formulation, self.l2p, self.l2s, self.rows, self.l1p, source)

    @property
    def cache_key(self) -> tuple:
        """The warm manifest's launch-shape key (``WarmEntry.cache_key``)."""
        return self.warm_entry().cache_key

    @property
    def executable_key(self) -> tuple:
        """``WarmEntry.executable_key``: :attr:`cache_key` x padded rows."""
        return self.warm_entry().executable_key


def launch_configs(seq1_codes, seq2_codes, weights, backend: str = "cuda") -> list[LaunchConfig]:
    """One :class:`LaunchConfig` per launch the scorer makes for the batch
    on ``backend`` (``auto`` is ``cuda``; ``oracle`` makes none)."""
    from .dispatch import effective_backend, launch_plans, max_scored
    from .values import max_abs_value

    if backend == "auto":
        backend = "cuda"
    if backend == "oracle":
        return []
    val_flat, plans = launch_plans(seq1_codes, seq2_codes, weights, backend)
    maxv = max_abs_value(val_flat)
    out = []
    for plan in plans:
        route = effective_backend(backend, maxv, plan.l2p, max_scored(plan))
        if route == "cuda":
            form = "cuda-fused" if plan.l2s is None else "cuda-packed"
        else:
            form = route
        out.append(LaunchConfig(
            formulation=form, l1p=plan.l1p, l2p=plan.l2p, len1=plan.len1,
            rows=int(plan.len2.size), l2s=plan.l2s if form == "cuda-packed" else None,
            cluster=cluster_shape(plan.l2p, plan.split) if form == "cuda-fused" else None,
            lens=tuple(int(x) for x in plan.len2), bucket_keys=tuple(plan.keys),
            split=plan.split if form == "cuda-fused" else None,
        ))
    return out


def kernel_configs(problem, backend: str = "cuda") -> list[LaunchConfig]:
    """:func:`launch_configs` of a parsed problem (``io.parse.Problem``)."""
    return launch_configs(problem.seq1_codes, problem.seq2_codes, problem.weights, backend)


@dataclass(frozen=True)
class FusedScheduleConfig:
    """The launch structure the planner declares for a problem: the bucket
    keys of each launch, in launch order, and the launches each kernel
    must see (``declared_launches``, by ``cuda_scorer.launch_counts``
    name; a launch routed to ``mm`` or ``gather`` launches no kernel and
    counts in ``launches`` only)."""

    groups: tuple
    declared_launches: dict
    launches: int


def fused_schedule_config(problem, backend: str = "cuda") -> FusedScheduleConfig:
    """The declared launch structure of ``problem`` on ``backend``."""
    cfgs = kernel_configs(problem, backend)
    declared = dict.fromkeys(KERNEL_OF.values(), 0)
    for cfg in cfgs:
        if cfg.kernel is not None:
            declared[cfg.kernel] += 1
    return FusedScheduleConfig(tuple(c.bucket_keys for c in cfgs), declared, len(cfgs))
