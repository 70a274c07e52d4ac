"""The port's ``mm`` and ``gather`` backends against the JAX package's
``score_chunks_mm_body`` / ``score_chunks_body`` and the oracle, exact
int32 equality, at max|v| 127, 128, 3000 and 4095 and past the fp32
window, where the exactness gate routes a bucket to ``gather``.  Both
packages get the same numpy-seeded bytes (the JAX ``pad_problem``)."""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from mpi_openmp_cuda_tpu.ops import dispatch as jdispatch
from mpi_openmp_cuda_tpu.ops.matmul_scorer import score_chunks_mm_body as jax_mm
from mpi_openmp_cuda_tpu.ops.oracle import prefix_best
from mpi_openmp_cuda_tpu.ops.values import value_table
from mpi_openmp_cuda_tpu.ops.xla_scorer import score_chunks_body as jax_gather
from mpi_openmp_cuda_tpu_torch.ops import bounds as tbounds
from mpi_openmp_cuda_tpu_torch.ops import dispatch as tdispatch
from mpi_openmp_cuda_tpu_torch.ops import gather_scorer, matmul_scorer

REPO = Path(__file__).resolve().parent.parent

# max|v| 127, 128, 3000, 4095 (the TPU's three feeds and the JAX mm path's
# static ceiling), 32767 (this port's window at L2P 256, the width of the
# batch below) and one past it.
WEIGHTS = {
    "127": [127, 2, 3, 4],
    "128": [128, 2, 3, 4],
    "3000": [3000, 7, 1, 2],
    "4095": [4093, 4095, 1021, 3001],
    "window-edge": [32767, 3, 2, 1],
    "past-window": [32768, 3, 2, 1],
}


def _problem(seed, len1, lens=(), alphabet=26):
    rng = np.random.default_rng(seed)
    seq1 = rng.integers(1, alphabet + 1, size=len1).astype(np.int8)
    return seq1, [rng.integers(1, alphabet + 1, size=int(n)).astype(np.int8) for n in lens]


def _chunked(seq1, seqs, weights, nc=2):
    """The JAX operands (numpy) and their torch twins, [NC, CB, L2P]."""
    batch = jdispatch.pad_problem(seq1, seqs)
    cb = -(-batch.batch_size // nc)
    rows, lens = jdispatch.pad_batch_rows(batch, nc * cb)
    val = value_table(weights).reshape(-1)
    jargs = (batch.seq1ext, np.int32(batch.len1), rows.reshape(nc, cb, -1),
             lens.reshape(nc, cb), val)
    targs = tuple(torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray) else a
                  for a in jargs)
    return batch, jargs, (targs[0], batch.len1, *targs[2:])


def _rows(x):
    return [tuple(int(v) for v in r) for r in np.asarray(x).reshape(-1, 3)]


@pytest.mark.parametrize("wkey", list(WEIGHTS))
def test_mm_and_gather_match_jax_and_oracle(wkey):
    weights = WEIGHTS[wkey]
    seq1, seqs = _problem(3, 200, [1, 7, 40, 99, 127, 128, 150, 199, 200, 201, 0])
    batch, jargs, targs = _chunked(seq1, seqs, weights)
    want = [prefix_best(seq1, s, weights) for s in seqs]
    got_g = _rows(gather_scorer.score_chunks_body(*targs))
    assert got_g[: len(seqs)] == want
    assert got_g == _rows(jax_gather(*jargs))
    fits = tbounds.fits_exact_window(jargs[4], batch.l2p)
    assert fits == (wkey != "past-window")
    got_m = _rows(matmul_scorer.score_chunks_mm_body(*targs))
    if fits:
        assert got_m[: len(seqs)] == want
        if wkey in ("127", "128", "3000", "4095"):  # inside the JAX mm window too
            assert got_m == _rows(jax_mm(*jargs))
    # The scorer routes by the gate: past the window mm runs gather.
    route = tdispatch.effective_backend("mm", max(abs(w) for w in weights), batch.l2p)
    assert route == ("mm" if fits else "gather")
    for backend in ("mm", "gather"):
        got = tdispatch.AlignmentScorer(backend, device="cpu").score_codes(seq1, seqs, weights)
        assert _rows(got) == want


def test_low_entropy_ties_match_jax():
    """Two letters and equal weights: ties between offsets and between
    hyphen positions; first hit in offset-major, k = 0 first order."""
    seq1, seqs = _problem(9, 260, [1, 2, 30, 64, 100, 130, 255, 259, 260], alphabet=2)
    for weights in ([5, 1, 1, 1], [1, 1, 1, 1], [0, 0, 0, 0]):
        _, jargs, targs = _chunked(seq1, seqs, weights, nc=3)
        want = _rows(jax_gather(*jargs))
        assert _rows(gather_scorer.score_chunks_body(*targs)) == want
        assert _rows(matmul_scorer.score_chunks_mm_body(*targs)) == want
        assert _rows(jax_mm(*jargs)) == want


def test_window_derivation():
    """2 * L2P * M < 2^24: the largest admitted M at each width, exact at
    the edge (above), one past it refused; no operand cap (the JAX
    package's 32767 is an MXU limit)."""
    for l2p in (128, 256, 1408, 2048):
        m = tbounds.mm_max_exact_value(l2p)
        assert 2 * l2p * m < 2**24 <= 2 * l2p * (m + 1)
    assert tbounds.mm_max_exact_value(128) == 65535 > 32767
    assert tbounds.mm_max_exact_value(2048) == 4095
    val = value_table([4095, 1, 1, 1]).reshape(-1)
    assert tbounds.fits_exact_window(val, 2048)
    assert not tbounds.fits_exact_window(value_table([4096, 1, 1, 1]).reshape(-1), 2048)


def test_scorer_routes_wide_buckets_to_gather():
    """At max|v| 6000 a 128 bucket fits the window and a 1664 bucket does
    not: the mm scorer runs each on its own formulation, all exact."""
    seq1, seqs = _problem(4, 1700, [20] * 8 + [1600] * 2)
    weights = [6000, 1, 2, 3]
    launches = tdispatch.bucket_launches(seq1, seqs, weights, torch.device("cpu"),
                                         backend="mm")
    assert [b.maxv for b in launches] == [6000, 6000]
    routes = [tdispatch.effective_backend("mm", b.maxv, b.state.rows.shape[1])
              for b in launches]
    assert [b.state.rows.shape[1] for b in launches] == [128, 1664]
    assert routes == ["mm", "gather"]
    assert all(b.l2s is None for b in launches)  # no packing off the cuda backend
    got = tdispatch.AlignmentScorer("mm", device="cpu").score_codes(seq1, seqs, weights)
    assert _rows(got) == [prefix_best(seq1, s, weights) for s in seqs]


def test_ieee_fp32_is_scoped_and_restored():
    mm = torch.backends.cuda.matmul
    before = mm.fp32_precision
    with matmul_scorer.ieee_fp32():
        assert mm.fp32_precision == "ieee"
    assert mm.fp32_precision == before
    mm.fp32_precision = "tf32"
    try:
        with matmul_scorer.ieee_fp32():
            assert mm.fp32_precision == "ieee"
        assert mm.fp32_precision == "tf32"
    finally:
        mm.fp32_precision = before


def test_bottom_rungs_share_no_code_with_the_kernels():
    """gather and mm back up the kernels in the degrade chain, so neither
    imports the kernels' module (nor each other)."""
    for name in ("gather_scorer", "matmul_scorer"):
        src = (REPO / "mpi_openmp_cuda_tpu_torch" / "ops" / f"{name}.py").read_text()
        mods = {n.module for n in ast.walk(ast.parse(src)) if isinstance(n, ast.ImportFrom)}
        assert not mods & {"cuda_scorer", "gather_scorer", "matmul_scorer", "dispatch"}, mods


def test_empty_and_unsearchable_rows():
    seq1, _ = _problem(1, 50)
    seqs = [seq1.copy(), np.concatenate([seq1, seq1[:3]]), np.zeros(0, np.int8)]
    _, jargs, targs = _chunked(seq1, seqs, [3, 1, 2, 4], nc=1)
    want = _rows(jax_gather(*jargs))
    assert want[1] == want[2] == (-(2**31), 0, 0)
    assert _rows(gather_scorer.score_chunks_body(*targs)) == want
    assert _rows(matmul_scorer.score_chunks_mm_body(*targs)) == want
