"""The ``mm`` backend: the one-hot matmul formulation (the port of
``mpi_openmp_cuda_tpu/ops/matmul_scorer.py``: ``_score_pair_mm`` and
``score_chunks_mm_body``), in IEEE fp32.

* **Value matrix by one-hot matmul.**  ``V[i, j] = val[seq2[i],
  seq1[j]]`` is ``onehot(seq2) @ A`` with ``A = val @ onehot(seq1).T``
  ([27, W], shared by the batch): two ``torch.matmul`` calls, as the JAX
  package computes them with ``lax.dot_general`` outside any Pallas
  kernel.
* **Diagonal shear by pad and reshape.**  Appending one row's worth of
  zeros to ``V``'s flat buffer and viewing it with row stride ``W + 1``
  gives ``D[i, n] = V[i, i + n]``; wrap garbage lands only in cells the
  validity mask kills.
* **Prefix by cumsum.**  With ``d0 = D[:, n]``, ``d1 = D[:, n + 1]`` and
  ``G = cumsum(d0 - d1)`` over the chars, ``score(n, k) = t1(n) +
  G[kappa(k)](n)`` with ``kappa(0) = len2``: a per-offset max over kappa,
  a first-hit argmax over offsets, and ``k = 0`` where ``G[len2]`` ties
  the max.  The JAX block-prefix triangular matmul (``_block_prefix``)
  was an MXU device; a cumsum is exact under the same window and is what
  this port runs.

Exactness: every partial is an integer below ``2 * L2P * max|v|``, exact
in fp32 while that stays below 2^24 (``bounds.fits_exact_window``; the
dispatch routes buckets past it to the gather formulation).  TF32 would
round table values past 11 significant bits, so :func:`ieee_fp32`
switches it off around the matmuls and restores the caller's setting;
nothing is set at import.
"""

from __future__ import annotations

import contextlib

import torch

from ..utils.constants import ALPHABET_SIZE, INT32_MIN

# Max live elements of one [pairs, chars, offsets] slab (64 MiB of fp32).
CHUNK_ELEMS = 16 * 1024 * 1024
_NEG = -(2.0 ** 40)


@contextlib.contextmanager
def ieee_fp32():
    """fp32 matmuls in IEEE precision for the span of one call: the
    ``fp32_precision`` setting where this torch has it, else
    ``allow_tf32``; the previous value is restored."""
    mm = torch.backends.cuda.matmul
    if hasattr(mm, "fp32_precision"):
        prev = mm.fp32_precision
        mm.fp32_precision = "ieee"
        try:
            yield
        finally:
            mm.fp32_precision = prev
    else:
        prev = mm.allow_tf32
        mm.allow_tf32 = False
        try:
            yield
        finally:
            mm.allow_tf32 = prev


def _onehot(codes: torch.Tensor) -> torch.Tensor:
    return (codes.long()[..., None] == torch.arange(ALPHABET_SIZE, device=codes.device)).float()


def _score_pairs(a_right, len1, rows, lens, noff) -> torch.Tensor:
    """[cb, 3] rows of one chunk of pairs against ``a_right`` [27, W]."""
    cb, l2p = rows.shape
    dev = rows.device
    i = torch.arange(l2p, device=dev)
    ln = lens.long()
    live = (i[None] < ln[:, None])[..., None]  # [cb, L2P, 1]
    oh2 = torch.where(live, _onehot(rows), 0.0)  # pad rows contribute 0
    v = torch.matmul(oh2, a_right)  # [cb, L2P, W]
    w = v.shape[2]
    d = torch.cat([v.reshape(cb, -1), v.new_zeros(cb, l2p)], dim=1).reshape(cb, l2p, w + 1)
    d0 = d[:, :, :noff]
    d1 = d[:, :, 1 : noff + 1]
    t1 = d1.sum(dim=1)  # [cb, noff]
    g = torch.cumsum(d0 - d1, dim=1)  # [cb, L2P, noff]; row r = kappa r + 1
    gm = torch.where(live, g, _NEG)
    run_max, run_row = gm.max(dim=1)  # first row of the max
    end_row = torch.clamp(ln - 1, min=0)
    end_g = g.gather(1, end_row[:, None, None].expand(-1, 1, noff))[:, 0]  # G[len2]
    # k = 0 outranks an equal k >= 1 in the reference's candidate order.
    best_k_per_n = torch.where(end_g == run_max, 0, run_row + 1)
    n = torch.arange(noff, device=dev)[None]
    score_per_n = torch.where(
        n < torch.clamp(len1 - ln, min=0)[:, None], t1 + run_max, _NEG)
    best_n = torch.argmax(score_per_n, dim=1)  # first max: the smallest offset
    best = score_per_n.gather(1, best_n[:, None])[:, 0]
    best_k = best_k_per_n.gather(1, best_n[:, None])[:, 0]
    eq = t1[:, 0] + end_g[:, 0]  # the positional score at n = 0
    searchable = (ln < len1) & (ln > 0)
    score = torch.where(ln == len1, eq, best).round().long()
    score = torch.where(searchable | (ln == len1), score, INT32_MIN)
    zero = torch.zeros_like(best_n)
    out_n = torch.where(searchable, best_n, zero)
    out_k = torch.where(searchable, best_k, zero)
    return torch.stack([score, out_n, out_k], dim=1).int()


def mm_rows(seq1ext, len1, rows, lens, val_flat) -> torch.Tensor:
    """[B, 3] int32 (score, n, k) rows of one padded bucket (operands as
    ``gather_scorer.gather_rows``); exact when ``bounds.fits_exact_window``
    holds at this L2P."""
    b, l2p = rows.shape
    noff = seq1ext.shape[0] - l2p - 1  # == L1P
    out = torch.empty((b, 3), dtype=torch.int32, device=rows.device)
    if b == 0:
        return out
    with ieee_fp32():
        val27 = val_flat.reshape(ALPHABET_SIZE, ALPHABET_SIZE).float()
        a_right = torch.matmul(val27, _onehot(seq1ext[:noff]).T)  # [27, W]
        cb = max(1, CHUNK_ELEMS // max(noff * l2p, 1))
        for s in range(0, b, cb):
            out[s : s + cb] = _score_pairs(a_right, int(len1), rows[s : s + cb],
                                           lens[s : s + cb], noff)
    return out


def score_chunks_mm_body(seq1ext, len1, seq2_chunks, len2_chunks, val_flat) -> torch.Tensor:
    """The chunked contract of the JAX ``score_chunks_mm_body``:
    ``[NC, CB, L2P]`` rows and ``[NC, CB]`` lens -> ``[NC, CB, 3]`` int32."""
    nc, cb, l2p = seq2_chunks.shape
    out = mm_rows(
        seq1ext, len1, seq2_chunks.reshape(nc * cb, l2p), len2_chunks.reshape(-1), val_flat
    )
    return out.reshape(nc, cb, 3)
