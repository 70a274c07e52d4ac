"""Batch dispatch: length buckets, padding, kernel choice, async results.

The port of ``mpi_openmp_cuda_tpu/ops/dispatch.py``'s single-device path.
Rows are grouped by their 128-wide L2P bucket (rows of at most 64 chars by
their packing class 8/16/32/64), each bucket is padded into rectangular
int32 operands and scored by one kernel launch on the scorer's device,
and the results come back to the host once per bucket, in input order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..models.encoding import encode_normalized, pad_to
from ..utils.constants import BUF_SIZE_SEQ1, BUF_SIZE_SEQ2
from .bounds import check_int32_window
from .cuda_scorer import PACK_CLASSES, ScorerState, kernel_table, score_rows
from .oracle import score_batch_oracle
from .values import max_abs_value, value_table

_LANE = 128

# Length buckets smaller than this merge into the next wider bucket:
# below it, a separate launch and copy cost more than padding.
MIN_BUCKET_ROWS = 8


def round_up(x: int, mult: int) -> int:
    return max(mult, mult * math.ceil(x / mult))


@dataclass(frozen=True)
class PaddedBatch:
    """A rectangular, bucket-padded encoding of one scoring problem."""

    seq1ext: np.ndarray  # [L1P + L2P + 1] int32
    len1: int
    seq2: np.ndarray  # [B, L2P] int32
    len2: np.ndarray  # [B] int32
    l1p: int
    l2p: int

    @property
    def batch_size(self) -> int:
        return self.seq2.shape[0]


def pad_problem(seq1_codes: np.ndarray, seq2_codes: list[np.ndarray]) -> PaddedBatch:
    """Encode a ragged problem into bucket-padded rectangular arrays."""
    len1 = int(seq1_codes.size)
    if len1 > BUF_SIZE_SEQ1:
        raise ValueError(f"Seq1 length {len1} exceeds BUF_SIZE_SEQ1={BUF_SIZE_SEQ1}")
    for idx, codes in enumerate(seq2_codes):
        if codes.size > BUF_SIZE_SEQ2:
            raise ValueError(
                f"Seq2[{idx}] length {codes.size} exceeds BUF_SIZE_SEQ2={BUF_SIZE_SEQ2}"
            )
    l1p = round_up(len1, _LANE)
    max_l2 = max((c.size for c in seq2_codes), default=1)
    l2p = round_up(max_l2, _LANE)
    seq1ext = np.zeros(l1p + l2p + 1, dtype=np.int32)
    seq1ext[:len1] = seq1_codes
    rows = (
        np.stack([pad_to(c, l2p).astype(np.int32) for c in seq2_codes])
        if seq2_codes
        else np.zeros((0, l2p), dtype=np.int32)
    )
    lens = np.array([c.size for c in seq2_codes], dtype=np.int32)
    return PaddedBatch(seq1ext, len1, rows, lens, l1p, l2p)


def pack_classes() -> tuple[int, ...]:
    """Row-packing classes the packed kernel admits.  Its scores are plain
    int32 words (no packed score/key word as on the TPU), so the one gate
    of ``ops/bounds.py`` covers it and every class is legal at every
    weight that gate admits."""
    return PACK_CLASSES


def plan_buckets(sizes) -> dict[int, list[int]]:
    """Input indices grouped by L2P shape bucket, rows of at most 64 chars
    by their packing class, with groups of fewer than
    :data:`MIN_BUCKET_ROWS` rows merged into the next wider one."""
    classes = pack_classes()

    def bucket_key(size: int) -> int:
        l2p = round_up(max(size, 1), _LANE)
        if l2p == _LANE and size <= classes[-1]:
            return next(s for s in classes if s >= size)
        return l2p

    groups: dict[int, list[int]] = {}
    for i, size in enumerate(sizes):
        groups.setdefault(bucket_key(int(size)), []).append(i)
    keys = sorted(groups)
    for j, k in enumerate(keys[:-1]):
        if len(groups[k]) < MIN_BUCKET_ROWS:
            groups[keys[j + 1]].extend(groups.pop(k))
    return groups


def choose_rowpack(l2p: int, lens) -> int | None:
    """Packing class for one bucket, or None for the fused kernel: the
    smallest class that holds every live row, when the bucket is one
    128-wide char block with >= 2 rows.  The JAX package's rule, on the
    card as off it: scripts/torch_rowpack_sweep.py measured the packed
    kernel faster than the fused one on an H100 at every batch size it
    swept (8 to 4096 rows, 0.05 to 47 waves of the fused grid), in every
    class, at Seq1 3000 and 1489 (PERF.md)."""
    lens = [int(x) for x in lens]
    live = [x for x in lens if x > 0]
    classes = pack_classes()
    if l2p != _LANE or len(lens) < 2 or not live or max(live) > classes[-1]:
        return None
    return next(s for s in classes if s >= max(live))


def pad_batch_rows(batch: PaddedBatch, bp: int) -> tuple[np.ndarray, np.ndarray]:
    """Zero-pad the batch rows/lengths to ``bp`` rows (zero rows are len-0
    pairs, dropped on output)."""
    rows = np.zeros((bp, batch.l2p), dtype=np.int32)
    rows[: batch.batch_size] = batch.seq2
    lens = np.zeros(bp, dtype=np.int32)
    lens[: batch.batch_size] = batch.len2
    return rows, lens


@dataclass(frozen=True)
class PendingResult:
    """A launched, not yet fetched result: ``raw`` is a [B, 3] int32
    tensor on the scorer's device (or a host array on the oracle path).
    Kernel launches are asynchronous, so host work can overlap them until
    ``result()`` copies the [count, 3] rows to the host."""

    raw: object
    count: int

    def result(self) -> np.ndarray:
        raw = self.raw
        if isinstance(raw, torch.Tensor):
            raw = raw.cpu().numpy()
        return np.asarray(raw).reshape(-1, 3)[: self.count]


@dataclass(frozen=True)
class BucketedPending:
    """Pending results of a length-bucketed dispatch; every bucket is
    launched before any is fetched, and ``result()`` copies each bucket to
    the host once and restores input order."""

    parts: list  # [(row_indices, PendingResult)]
    count: int

    def result(self) -> np.ndarray:
        out = np.zeros((self.count, 3), dtype=np.int32)
        for idx, pend in self.parts:
            out[idx] = pend.result()
        return out


@dataclass(frozen=True)
class BucketLaunch:
    """One kernel launch of a batch: the input rows it scores (ascending),
    its bucket's operands on the device, and its packing class (None: the
    fused kernel)."""

    idx: np.ndarray
    state: ScorerState
    l2s: int | None


def bucket_launches(
    seq1_codes: np.ndarray, seq2_codes: list[np.ndarray], weights, device: torch.device
) -> list[BucketLaunch]:
    """The launches that score one batch on ``device``: caps and the int32
    gate checked on the whole batch (an error names the caller's input
    index before anything is launched), rows grouped by
    :func:`plan_buckets`, each group padded by :func:`pad_problem` and
    moved to the device, its kernel chosen by :func:`choose_rowpack`.
    :class:`AlignmentScorer` launches exactly these."""
    if not seq2_codes:
        return []
    if seq1_codes.size > BUF_SIZE_SEQ1:
        raise ValueError(
            f"Seq1 length {seq1_codes.size} exceeds BUF_SIZE_SEQ1={BUF_SIZE_SEQ1}"
        )
    for i, c in enumerate(seq2_codes):
        if c.size > BUF_SIZE_SEQ2:
            raise ValueError(
                f"Seq2[{i}] length {c.size} exceeds BUF_SIZE_SEQ2={BUF_SIZE_SEQ2}"
            )
    sizes = [int(c.size) for c in seq2_codes]
    val_flat = value_table(weights).astype(np.int32).reshape(-1)
    check_int32_window(max_abs_value(val_flat), max(sizes))
    val = torch.from_numpy(kernel_table(val_flat)).to(device)
    groups = plan_buckets(sizes)
    launches = []
    for key in sorted(groups):
        idx = np.asarray(sorted(groups[key]), dtype=np.int64)
        batch = pad_problem(seq1_codes, [seq2_codes[i] for i in idx])
        state = ScorerState(
            seq1ext=torch.from_numpy(batch.seq1ext).to(device),
            len1=batch.len1,
            rows=torch.from_numpy(batch.seq2).to(device),
            lens=torch.from_numpy(batch.len2).to(device),
            val=val,
            max_len2=int(batch.len2.max()),
        )
        l2s = choose_rowpack(batch.l2p, batch.len2)
        launches.append(BucketLaunch(idx, state, l2s))
    return launches


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device; a CUDA device
    that is not there is an error, never a silent move to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu "
            "on the command line) to score on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class AlignmentScorer:
    """Front door to the scoring paths.

    backend: 'auto' or 'cuda' (the Hopper kernels; on a CPU device their
    plain PyTorch versions), or 'oracle' (host numpy reference).
    device: 'cuda' by default; 'cpu' only when asked for.
    """

    def __init__(self, backend: str = "auto", device=None):
        if backend == "auto":
            backend = "cuda"
        if backend not in ("cuda", "oracle"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        # The oracle scores on the host and touches no device.
        self.device = None if backend == "oracle" else resolve_device(device)

    def score_codes(self, seq1_codes, seq2_codes, weights) -> np.ndarray:
        """[B, 3] int32 array of (score, n, k) rows, input order."""
        return self.score_codes_async(seq1_codes, seq2_codes, weights).result()

    def score_codes_async(
        self, seq1_codes: np.ndarray, seq2_codes: list[np.ndarray], weights
    ) -> PendingResult | BucketedPending:
        """``score_codes`` without waiting for the device->host copy."""
        if self.backend == "oracle":
            out = np.array(
                score_batch_oracle(seq1_codes, seq2_codes, weights), dtype=np.int32
            ).reshape(-1, 3)
            return PendingResult(out, out.shape[0])
        parts = [
            (b.idx, PendingResult(score_rows(b.state, b.l2s), b.idx.size))
            for b in bucket_launches(seq1_codes, seq2_codes, weights, self.device)
        ]
        return BucketedPending(parts, len(seq2_codes))

    def score(self, seq1: str, seq2_list: list[str], weights) -> np.ndarray:
        return self.score_codes(
            encode_normalized(seq1),
            [encode_normalized(s) for s in seq2_list],
            weights,
        )

