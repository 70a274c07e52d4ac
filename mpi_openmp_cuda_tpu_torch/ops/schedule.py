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

* a cluster of a row of ``len2`` chars in a launch of width ``L`` runs
  ``per(len2, L)`` char steps on each of its ``warps(L)`` warps (the
  kernel's own segment split, :func:`cluster_shape`), plus a fixed
  ``CLUSTER_STEPS`` (staging, segment combine, reduction);
* the clusters share the card's resident warps (:data:`RESIDENT_WARPS`):
  the launch's warp-steps over them are its work in waves of the card,
  priced at ``SLOT_US`` a step;
* the longest cluster is the launch's critical path, priced at
  ``LAT_US`` a step (one warp's latency-bound step);
* ``wall = LAUNCH_US + LAT_US * longest + SLOT_US * waves``.

The four constants were fitted on the card by
``scripts/torch_fusion_sweep.py`` (singleton and fused launches over
group widths and row counts at Seq1 3000 and 1489).  Among the
contiguous partitions of the sorted keys, those within
:data:`FUSED_TIE_FRACTION` of the cheapest tie, and the fewest launches
win.  A dynamic program over the contiguous parts finds, for every part
count, the cheapest partition with that many parts (O(k^3) over k keys),
so the choice is the one an enumeration of all 2^(k-1) partitions makes,
at any number of keys.  ``dispatch.bucket_launches`` builds one launch per group, and the
bench and ``chip_smoke.py`` derive their launches from it, so they time
exactly the production schedule.

:func:`kernel_configs` describes that schedule on the host, one
:class:`LaunchConfig` a launch, planned by ``dispatch.launch_plans`` and
routed as ``dispatch.run_launch`` routes it; :func:`fused_schedule_config`
declares the launches each kernel must see for a problem, the number the
launch audit (``analysis/traceaudit.py``) and ``chip_smoke.py`` hold the
kernels' launch counters to.  The cost sheet (``analysis/costmodel.py``)
prices the same configs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# The fused launch model's constants, fitted by scripts/torch_fusion_sweep.py
# on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit.
LAUNCH_US = 5.6643  # fixed cost of one launch (tile and finish kernels)
LAT_US = 0.043159  # one char step of the launch's longest cluster
SLOT_US = 0.172530  # one char step of every resident warp of the card
CLUSTER_STEPS = 18.0  # fixed cost of one cluster, in char steps

# Partitions within this share of the cheapest tie; the fewest launches win.
FUSED_TIE_FRACTION = 0.02

# The fused kernel's launch shape (csrc/fused_kernels.cuh: kTile,
# kSegChars, kMaxSeg, kCluster) and its residency on an H100 SXM: the
# tile kernel's 40 registers a thread leave room for 51 warps of an SM's
# 64K registers, 48 in whole blocks of 8 (or 4) warps, on 132 SMs.
TILE = 128
SEG_CHARS, MAX_SEG, CLUSTER = 32, 8, 2
RESIDENT_WARPS = 132 * 48


def cluster_shape(l2p: int) -> tuple[int, int]:
    """(blocks a cluster, warps a block) of a fused launch of width
    ``l2p``: ``fused::launch``'s segment split."""
    nsegt = min(-(-l2p // SEG_CHARS), MAX_SEG * CLUSTER)
    nblk = CLUSTER if nsegt > MAX_SEG else 1
    return nblk, -(-nsegt // nblk)


def segment_steps(len2: int, l2p: int) -> int:
    """Char steps of one segment of a row of ``len2`` chars in a launch of
    width ``l2p`` (the kernel's ``per``)."""
    nblk, nseg = cluster_shape(l2p)
    len2r = (len2 + 3) & ~3
    return max(-(-(len2r // 4) // (nseg * nblk)) * 4, SEG_CHARS)


def live_tiles(len1: int, len2: int) -> int:
    """Offset tiles a pair runs: those with a valid offset, tile 0 always."""
    return max(1, -(-(len1 - len2) // TILE))


def launch_work(len1: int, lens, l2p: int) -> tuple[int, float, float]:
    """(live clusters, waves, longest cluster) of one fused launch of width
    ``l2p``: waves in char steps of every resident warp, the longest
    cluster in char steps (:func:`segment_steps` and :func:`live_tiles`
    over every row at once)."""
    nblk, nseg = cluster_shape(l2p)
    n = np.asarray(lens, dtype=np.int64).reshape(-1)
    if n.size == 0:
        return 0, 0.0, 0.0
    len2r = (n + 3) & ~3
    steps = np.maximum(-(-(len2r // 4) // (nseg * nblk)) * 4, SEG_CHARS) + CLUSTER_STEPS
    tiles = np.maximum(1, -(-(int(len1) - n) // TILE))
    warp_steps = float((tiles * steps).sum()) * nblk * nseg
    return int(tiles.sum()), warp_steps / RESIDENT_WARPS, float(steps.max())


def launch_us(len1: int, lens, l2p: int) -> float:
    """Modelled device time of one fused launch, in microseconds."""
    _, waves, longest = launch_work(len1, lens, l2p)
    return LAUNCH_US + LAT_US * longest + SLOT_US * waves


def plan_fusion_groups(groups, sizes, len1: int):
    """Partition the keys of ``groups`` (``dispatch.plan_buckets``) into
    launch groups: a list of key tuples sorted by first key, each one
    launch.  Packed class keys stay alone; singletons are the unfused
    schedule."""
    keys = sorted(groups)
    singletons = [(k,) for k in keys]
    fusable = [k for k in keys if k % TILE == 0]
    packed = [(k,) for k in keys if k % TILE != 0]
    if len(fusable) < 2:
        return singletons
    n = len(fusable)
    key_lens = [np.array([int(sizes[x]) for x in groups[k]], dtype=np.int64)
                for k in fusable]
    # cost[i][j]: one launch of the keys fusable[i:j].
    cost = [[0.0] * (n + 1) for _ in range(n + 1)]
    for i in range(n):
        for j in range(i + 1, n + 1):
            cost[i][j] = launch_us(int(len1), np.concatenate(key_lens[i:j]), fusable[j - 1])
    # best[m][j]: (cost, cuts) of the cheapest partition of fusable[:j]
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
    parts = [tuple(fusable[a:b]) for a, b in zip(cuts, cuts[1:])]
    return sorted(packed + parts, key=lambda g: g[0])


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
    cluster shape (:func:`cluster_shape`; None off it), and the bucket keys
    of its launch group."""

    formulation: str
    l1p: int
    l2p: int
    len1: int
    rows: int
    l2s: int | None
    cluster: tuple[int, int] | None
    lens: tuple[int, ...]
    bucket_keys: tuple = ()

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
        b = plan.batch
        route = effective_backend(backend, maxv, b.l2p, max_scored(b))
        if route == "cuda":
            form = "cuda-fused" if plan.l2s is None else "cuda-packed"
        else:
            form = route
        out.append(LaunchConfig(
            formulation=form, l1p=int(b.l1p), l2p=int(b.l2p), len1=int(b.len1),
            rows=int(b.batch_size), l2s=plan.l2s if form == "cuda-packed" else None,
            cluster=cluster_shape(int(b.l2p)) if form == "cuda-fused" else None,
            lens=tuple(int(x) for x in b.len2), bucket_keys=tuple(plan.keys),
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
