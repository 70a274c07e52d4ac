"""The fused kernel at every split (segments a (pair, tile)) it takes from
its caller, on the card: a launch of mixed lengths scores exactly what the
kernel's plain version scores, whatever the split.  The split changes which
warps walk which chars, never a row.

Card only (``gpu``); this file imports no JAX, so it runs on the card's
machine as it stands: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_split_card.py``."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from mpi_openmp_cuda_tpu_torch.ops import cuda_scorer as cs
from mpi_openmp_cuda_tpu_torch.ops import dispatch
from mpi_openmp_cuda_tpu_torch.ops import schedule
from mpi_openmp_cuda_tpu_torch.ops.values import value_table

WEIGHTS = ([100, 2, 3, 4], [10, 2, 3, 4], [2, 2, 1, 10])


def _mixed_state(weights, seed: int):
    """One 2048-wide launch of rows of 5-2000 chars against a Seq1 of
    2100, with an empty row and a homolog (a slice of Seq1)."""
    rng = np.random.default_rng(seed)
    seq1 = rng.integers(1, 27, size=2100).astype(np.int8)
    lens = list(rng.integers(5, 2001, size=40)) + [5, 2000, 300, 33]
    seqs = [rng.integers(1, 27, size=int(n)).astype(np.int8) for n in lens]
    seqs += [seq1[:0], seq1[400:1900].copy()]
    b = dispatch.pad_problem(seq1, seqs)
    assert b.l2p == 2048
    val = value_table(weights).reshape(-1)
    return cs.state_from_numpy(b.seq1ext, b.len1, b.seq2, b.len2, val, "cuda")


_PLAIN: dict = {}


@pytest.mark.gpu
@pytest.mark.parametrize("split", range(1, schedule.MAX_SEG * schedule.CLUSTER + 1))
def test_fused_kernel_is_exact_at_every_split(split):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for seed, weights in enumerate(WEIGHTS):
        st = _mixed_state(weights, seed)
        if seed not in _PLAIN:
            _PLAIN[seed] = cs.fused_scorer_plain(st)
        want = _PLAIN[seed]
        st = dataclasses.replace(st, split=split)
        got = cs.fused_scorer(st)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (split, weights)
        done = torch.full((st.rows.shape[0], 3), -1, dtype=torch.int32, device="cuda")
        cs.fused_scorer(st, done)
        assert torch.equal(done, cs.finish_rows(want, st.lens, st.len1)), (split, weights)


@pytest.mark.gpu
def test_narrow_widths_clamp_the_split_to_their_default():
    """A split past a width's default runs as the default (its warps past
    it would find no chars): same rows, same shared memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(9)
    seq1 = rng.integers(1, 27, size=600).astype(np.int8)
    seqs = [rng.integers(1, 27, size=int(n)).astype(np.int8)
            for n in rng.integers(65, 257, size=24)]
    b = dispatch.pad_problem(seq1, seqs)
    st = cs.state_from_numpy(b.seq1ext, b.len1, b.seq2, b.len2,
                             value_table(WEIGHTS[0]).reshape(-1), "cuda")
    want = cs.fused_scorer_plain(st)
    for split in schedule.SPLITS:
        assert torch.equal(cs.fused_scorer(dataclasses.replace(st, split=split)), want), split
        assert cs._smem_need(256, split) == cs._smem_need(256, min(split, 8))
