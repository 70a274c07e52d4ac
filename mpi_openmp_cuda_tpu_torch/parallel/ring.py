"""Sequence/context parallelism: ring-sharded Seq1 (the port of
``mpi_openmp_cuda_tpu/parallel/ring.py``).

The reference bounds Seq1 by one device's buffer (myProto.h:3).  The ring
removes that ceiling the way ring attention does for KV blocks:

* Seq1 is split into ``sp`` contiguous blocks of ``Bs`` chars, one per
  device along the ``'seq'`` mesh axis; each device owns the candidate
  offsets that start inside its block.  Each slot receives its block,
  the table its body reads, and its ``batch`` row's rows and lengths as
  one arena (``ops/feed.py``, one copy from a pinned slot of the device's
  ring).
* Scoring offset ``n`` needs the Seq1 window ``[n, n + L2 + 1]``, which
  spills into the next blocks.  Each device assembles its window from
  ``R = ceil((L2P + 1) / Bs)`` ``shift``s of the blocks round the ring,
  never a gather of the whole Seq1: per-device memory is O(Bs + L2P) for
  the window, independent of the global Seq1 length.
* Each device reduces its window to one best candidate a pair: the fused
  kernel (``csrc/fused_scorer.cu``) on ``win[: Bs + L2P + 1]`` with the
  block-local Seq1 length ``len1_eff = len1 - d * Bs`` (above Bs on shard
  0, zero or below on shards past the end of Seq1), whose offset mask
  ``n < len1_eff - len2`` is the global one; or, on the ``gather``
  backend or past the kernels' int32 window, the JAX ring's window body
  (``ops/gather_scorer.py::ring_window_rows``).
* One ``all_gather`` of the ``[bl, 4]`` candidates ``(score, n, k, eq)``
  then picks the global winner: the lowest shard wins ties, which is the
  offset-major first hit globally; ``eq`` comes from shard 0; the
  sentinels come from ``lens``.
* Blocks past the end of Seq1 only feed offsets the masks exclude: the
  valid reads stop at ``len1 - 1 < sp * Bs``.

Composes with data parallelism on a 2-D ``('batch', 'seq')`` mesh: the
batch axis shards the Seq2 rows, the seq axis Seq1.  The result is the
same ``(score, n, k)`` rows, bit for bit, as the single-device paths.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.cuda_scorer import fused_scorer, kernel_table
from ..ops.dispatch import _upload, effective_backend, max_scored, round_up
from ..ops.feed import FeedRing
from ..ops.gather_scorer import ring_window_rows
from ..ops.values import max_abs_value
from ..utils.constants import INT32_MIN
from .comm import Collectives, collectives_for
from .mesh import BATCH_AXIS, SEQ_AXIS, Mesh, make_2d_mesh
from .sharding import ShardedPending, shard_plans

BACKENDS = ("cuda", "gather")


def ring_plan(l1p: int, l2p: int, sp: int, kernel: bool) -> tuple[int, int]:
    """``(Bs, R)``: the offsets a device owns (a multiple of 128 for the
    fused kernel, whose offset tiles are 128 wide; of 8 for the gather
    body) and the ring steps ``R = ceil((L2P + 1) / Bs)`` that build each
    window.  The one source for the ring and its structure tests."""
    bs = round_up(math.ceil(l1p / sp), 128 if kernel else 8)
    return bs, math.ceil((l2p + 1) / bs)


def combine(gathered: torch.Tensor, lens: torch.Tensor, len1: int) -> torch.Tensor:
    """[bl, 3] rows from the ``[sp, bl, 4]`` candidates of a ``seq`` row:
    the first best score over the shards (the lowest shard wins ties),
    ``eq`` from shard 0 when ``len2 == len1``, ``(INT32_MIN, 0, 0)`` when
    ``len2 > len1`` or ``len2 == 0``."""
    gi = torch.argmax(gathered[:, :, 0], dim=0)  # first max: the lowest shard
    best = gathered.gather(0, gi[None, :, None].expand(1, -1, 4))[0]
    searchable = (lens < len1) & (lens > 0)
    score = torch.where(lens == len1, gathered[0, :, 3],
                        torch.where(searchable, best[:, 0], INT32_MIN))
    zero = torch.zeros_like(best[:, 1])
    return torch.stack([score, torch.where(searchable, best[:, 1], zero),
                        torch.where(searchable, best[:, 2], zero)], dim=1)


@dataclass
class RingSharding:
    """Scores a batch with Seq1 ring-sharded over the 'seq' axis."""

    mesh: Mesh  # axes (BATCH_AXIS, SEQ_AXIS)
    comm: Collectives = field(default=None)
    feeds: dict = field(default_factory=dict, repr=False)  # device -> FeedRing

    # Sharded Seq1 has no single-buffer ceiling: AlignmentScorer lifts the
    # reference's BUF_SIZE caps when scoring through this.
    unbounded = True
    # The ring scores the whole batch as one launch: every length bucket
    # merges into the widest.
    min_rows = sys.maxsize

    def __post_init__(self):
        if self.comm is None:
            self.comm = collectives_for(self.mesh)

    @classmethod
    def over_devices(cls, seq: int, batch: int = 1, *, device="cuda",
                     devices=None) -> "RingSharding":
        return cls(mesh=make_2d_mesh(batch, seq, devices=devices, device=device))

    @property
    def sp(self) -> int:
        return self.mesh.shape[SEQ_AXIS]

    @property
    def dp(self) -> int:
        return self.mesh.shape[BATCH_AXIS]

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    def score_async(self, plans, val_flat, backend: str = "cuda") -> ShardedPending:
        """The batch's one plan (``dispatch.launch_plans`` at
        :attr:`min_rows`) scored without the gather: each local slot's
        arena sent, the windows built, every shard's candidates computed
        and combined on its device, a :class:`ShardedPending` returned
        (its gather takes shard 0's rows of each ``seq`` row)."""
        backend = "cuda" if backend == "auto" else backend
        if backend not in BACKENDS:
            raise ValueError(
                f"backend {backend!r} is not available on the sequence-parallel "
                "ring path; drop --backend or use a batch-only mesh"
            )
        (plan,) = plans
        sp, dp, l2p, len1 = self.sp, self.dp, plan.l2p, plan.len1
        kernel = effective_backend(
            backend, max_abs_value(val_flat), l2p, max_scored(plan)) == "cuda"
        bs, r_steps = ring_plan(plan.l1p, l2p, sp, kernel)
        seq1pad = np.zeros(sp * bs, dtype=np.uint8)
        seq1pad[:len1] = plan.seq1
        # The table the body reads: the kernel's, or the gather body's [729].
        table = kernel_table(val_flat) if kernel else np.asarray(val_flat, dtype=np.int32)
        shards = shard_plans(plan, dp)  # one a ``batch`` row
        slots = self.comm.local_slots()
        dev = self.mesh.device

        # -- one arena a slot: its block, the table, its rows and lengths ----
        states = {}
        for s in slots:
            row, d = divmod(s, sp)
            block = dataclasses.replace(shards[row], seq1=seq1pad[d * bs : (d + 1) * bs])
            ring = self.feeds.setdefault(dev(s), FeedRing(dev(s).type == "cuda"))
            (launch,) = _upload(val_flat, [block], dev(s), ring, row0=(0,), table=table)
            states[s] = launch.state

        # -- the windows: R neighbour exchanges round the ring --------------
        blocks = {s: states[s].seq1ext[:bs] for s in slots}
        wins = {s: torch.zeros((r_steps + 1) * bs, dtype=torch.uint8, device=dev(s))
                for s in slots}
        for s in slots:
            wins[s][:bs] = blocks[s]
        for r in range(1, r_steps + 1):
            blocks = self.comm.shift(blocks)
            for s in slots:
                wins[s][r * bs : (r + 1) * bs] = blocks[s]

        # -- each shard's best candidate a pair ------------------------------
        cands = {}
        for s in slots:
            d, st = s % sp, states[s]
            if kernel:
                # A window runs at its width's default split: the plan's
                # was chosen for the whole Seq1, not a window of it.
                raw = fused_scorer(dataclasses.replace(
                    st, seq1ext=wins[s][: bs + l2p + 1], len1=len1 - d * bs, split=None))
                raw[:, 1] += d * bs  # block-local offset -> global
                cands[s] = raw
            else:
                cands[s] = ring_window_rows(wins[s], d, bs, len1, st.rows, st.lens, st.val)

        # -- global combine: one all_gather of the [bl, 4] candidates --------
        gathered = self.comm.all_gather(cands)
        out = {s: combine(gathered[s], states[s].lens, len1) for s in slots}
        return ShardedPending(self.comm, out, [r * sp for r in range(dp)],
                              np.arange(plan.idx.size))
