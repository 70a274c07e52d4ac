"""Bucketed continuous batching: concurrent requests -> shared superblocks
(the port of ``mpi_openmp_cuda_tpu/serve/batcher.py``).

A server that padded each request to its own buckets would pay one mostly
padding dispatch per client.  Here the Seq2 rows of every session popped
in one tick are pooled:

1. group by problem key ``(weights, seq1)``: rows are only co-scorable
   when they share the scorer's other two inputs;
2. inside a group, run the batch path's length-bucket planner
   (:func:`..ops.dispatch.plan_buckets`, ``packable=False`` /
   ``min_rows=1``: no straggler merging, which would change a row's L2P);
3. chop each bucket into :class:`SuperBlock`\\ s of exactly
   ``rows_per_block`` rows, padding the tail block with throwaway rows of
   the same bucket length.

So every block has ``rows_per_block`` rows of one 128-wide L2P bucket,
and the launch shapes stay few.  The scorer then plans each block as it
plans any batch: a block whose real rows fill a packing class (at least
``MIN_BUCKET_ROWS`` rows of at most 64 chars) sends them to the packed
kernel, the rest of the block (pad rows included) to the fused kernel.
Pad rows are scored (wasted lanes, counted by ``fill_ratio``) and dropped
at demux by their ``None`` tag.

Each real row's tag is ``(session, local_index)``: results demux back to
the right client in per-request order however requests interleaved.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ops.dispatch import plan_buckets
from ..utils.constants import BUF_SIZE_SEQ2

#: Rows per dispatched superblock (SEQALIGN_SERVE_BLOCK_ROWS overrides).
DEFAULT_BLOCK_ROWS = 64


@dataclasses.dataclass
class SuperBlock:
    """One fixed-shape dispatch unit: the shared problem key, the padded
    row list, and the demux tags (``None`` marks a pad row)."""

    weights: list[int]
    seq1_codes: np.ndarray
    codes: list[np.ndarray]
    tags: list[tuple | None]
    real_rows: int

    @property
    def fill_ratio(self) -> float:
        return self.real_rows / max(1, len(self.codes))

    def link_ids(self) -> list[str]:
        """Request ids whose rows ride this block, first-row order,
        deduplicated — the many-to-one trace links a shared-superblock
        dispatch span carries (obs/trace.py)."""
        out: list[str] = []
        seen: set[str] = set()
        for tag in self.tags:
            if tag is None:
                continue
            rid = str(tag[0].id)
            if rid not in seen:
                seen.add(rid)
                out.append(rid)
        return out

    def link_traces(self) -> list[str]:
        """The admission-minted trace ids of the same rows, deduplicated
        (empty ids dropped: batch and stream callers mint none); the fleet
        propagates them on its offers to the workers' launch rows."""
        out: list[str] = []
        seen: set[str] = set()
        for tag in self.tags:
            if tag is None:
                continue
            tid = str(getattr(tag[0], "trace_id", "") or "")
            if tid and tid not in seen:
                seen.add(tid)
                out.append(tid)
        return out


def plan_blocks(sessions, rows_per_block: int) -> list[SuperBlock]:
    """Plan the tick's superblocks from every popped session's rows."""
    if rows_per_block < 1:
        raise ValueError(
            f"rows_per_block must be >= 1, got {rows_per_block}"
        )
    groups: dict[tuple, list[tuple]] = {}
    for sess in sessions:
        if getattr(sess, "closed", False) or not sess.seq2_codes:
            # Retired mid-tick (deadline miss, quarantined poison,
            # abandoned client): its rows must not occupy blocks.  A
            # request of no Seq2 has none (the loop sends its done
            # record); the JAX batcher opens an empty group for it and
            # fails on its first row.
            continue
        key = (tuple(int(w) for w in sess.weights), sess.seq1)
        rows = groups.setdefault(key, [])
        for j, codes in enumerate(sess.seq2_codes):
            rows.append((sess, j, codes))
    blocks: list[SuperBlock] = []
    for (weights, _seq1), rows in groups.items():
        seq1_codes = rows[0][0].seq1_codes
        buckets = plan_buckets(
            [c.size for (_, _, c) in rows], packable=False, min_rows=1
        )
        for l2p in sorted(buckets):
            members = [rows[i] for i in sorted(buckets[l2p])]
            # Pad length stays inside the reference buffer cap while
            # keeping the same L2P bucket (round_up(2000,128) == 2048),
            # so the dispatcher sees ONE uniform group per block.
            pad = np.ones(min(int(l2p), BUF_SIZE_SEQ2), dtype=np.int8)
            for off in range(0, len(members), rows_per_block):
                chunk = members[off : off + rows_per_block]
                n_pad = rows_per_block - len(chunk)
                blocks.append(
                    SuperBlock(
                        weights=list(weights),
                        seq1_codes=seq1_codes,
                        codes=[c for (_, _, c) in chunk] + [pad] * n_pad,
                        tags=[(s, j) for (s, j, _) in chunk]
                        + [None] * n_pad,
                        real_rows=len(chunk),
                    )
                )
    return blocks
