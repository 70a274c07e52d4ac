"""The ``gather`` backend: the int32 gather formulation (the port of
``mpi_openmp_cuda_tpu/ops/xla_scorer.py``: ``_score_pair`` and
``score_chunks_body``).

For each pair, over the full padded candidate grid of offsets ``n <
L1P`` and mutant positions ``k < L2P``:

* ``v0[n, i] = val[seq2[i], seq1[n + i]]`` (unshifted diagonal) and
  ``v1[n, i] = val[seq2[i], seq1[n + i + 1]]`` (hyphen-shifted), masked to
  zero past len2, gathered from the window table ``vw[c, t] = val[c,
  seq1ext[t]]`` built once per batch;
* ``c0``, ``c1`` their int32 prefix sums over the chars, ``t0``, ``t1``
  the totals; column ``k`` holds ``t0`` for k = 0 and ``c0[k - 1] + t1 -
  c1[k - 1]`` for k >= 1;
* the reference's mask, exactly: ``valid = n < max(len1 - len2, 0) &
  (k == 0 | k < len2)``; the first maximum of the flattened grid
  (offset-major, k ascending with k = 0 first) is the answer;
* ``len2 == len1`` scores positionally (``c0`` at n = 0), ``len2 > len1``
  or ``len2 == 0`` gives ``(INT32_MIN, 0, 0)``.

Every quantity is int32 and exact under the admission gate of
``ops/bounds.py`` (``L * max|v| < 2^31`` over the scored rows), which
is why launches past the kernels' narrower window run here.
Plain PyTorch on the scorer's device, in chunks of pairs to bound
memory.  :func:`ring_window_rows` is the same formulation over one window
of the Seq1 ring (``parallel/ring.py``), the JAX ring's window body.  It is the bottom rung of the degrade chain, so it shares no code
with the kernels' plain versions (``cuda_scorer._kernel_rows``).
"""

from __future__ import annotations

import torch

from ..utils.constants import ALPHABET_SIZE, INT32_MIN

# Max live elements of one [pairs, offsets, chars] slab (64 MiB of int32).
CHUNK_ELEMS = 16 * 1024 * 1024


def _score_pairs(vw, wext, len1, rows, lens) -> torch.Tensor:
    """[cb, 3] rows of one chunk of pairs against the flat window table."""
    cb, l2p = rows.shape
    noff = wext - l2p - 1  # == L1P
    dev = rows.device
    n = torch.arange(noff, device=dev)[:, None]
    i = torch.arange(l2p, device=dev)[None, :]
    idx0 = (n + i)[None]  # [1, noff, L2P]
    base = rows.long()[:, None, :] * wext  # [cb, 1, L2P]
    ln = lens.long()[:, None, None]
    # A row longer than Seq1 is never scored: its chars are masked so its
    # sums stay inside the gate of ops/bounds.py, which counts scored rows.
    charmask = i[None] < torch.where(ln <= len1, ln, 0)
    v0 = torch.where(charmask, vw[base + idx0], 0)
    v1 = torch.where(charmask, vw[base + idx0 + 1], 0)
    c0 = torch.cumsum(v0, dim=2, dtype=torch.int32)
    c1 = torch.cumsum(v1, dim=2, dtype=torch.int32)
    t0 = c0[:, :, -1:]
    t1 = c1[:, :, -1:]
    scores = torch.cat([t0, c0[:, :, :-1] + (t1 - c1[:, :, :-1])], dim=2)
    k = i[None]
    valid = (n[None] < torch.clamp(len1 - ln, min=0)) & ((k == 0) | (k < ln))
    flat = torch.where(valid, scores, INT32_MIN).reshape(cb, -1)
    bi = torch.argmax(flat, dim=1)  # first max: offset-major, k = 0 first
    best = flat.gather(1, bi[:, None])[:, 0]
    l2 = lens.long()
    eq = c0[:, 0, -1]
    searchable = (l2 < len1) & (l2 > 0)
    score = torch.where(
        l2 == len1, eq, torch.where(searchable, best, torch.full_like(best, INT32_MIN))
    )
    zero = torch.zeros_like(bi)
    out_n = torch.where(searchable, bi // l2p, zero)
    out_k = torch.where(searchable, bi % l2p, zero)
    return torch.stack([score.int(), out_n.int(), out_k.int()], dim=1)


def gather_rows(seq1ext, len1, rows, lens, val_flat) -> torch.Tensor:
    """[B, 3] int32 (score, n, k) rows of one padded bucket: ``seq1ext``
    [L1P + L2P + 1], ``rows`` [B, L2P], ``lens`` [B] int32 and the [729]
    value table, all on one device."""
    b, l2p = rows.shape
    wext = seq1ext.shape[0]
    out = torch.empty((b, 3), dtype=torch.int32, device=rows.device)
    if b == 0:
        return out
    vw = val_flat.reshape(ALPHABET_SIZE, ALPHABET_SIZE)[:, seq1ext.long()].reshape(-1)
    cb = max(1, CHUNK_ELEMS // max((wext - l2p - 1) * l2p, 1))
    for s in range(0, b, cb):
        out[s : s + cb] = _score_pairs(vw, wext, int(len1), rows[s : s + cb], lens[s : s + cb])
    return out


def score_chunks_body(seq1ext, len1, seq2_chunks, len2_chunks, val_flat) -> torch.Tensor:
    """The chunked contract of the JAX ``score_chunks_body``: int32
    tensors ``[NC, CB, L2P]`` rows and ``[NC, CB]`` lens -> ``[NC, CB, 3]``
    int32."""
    nc, cb, l2p = seq2_chunks.shape
    out = gather_rows(
        seq1ext, len1, seq2_chunks.reshape(nc * cb, l2p), len2_chunks.reshape(-1), val_flat
    )
    return out.reshape(nc, cb, 3)


def ring_window_rows(win, d: int, bs: int, len1: int, rows, lens, val_flat) -> torch.Tensor:
    """[B, 4] int32 candidates ``(score, n, k, eq)`` of ring shard ``d``
    (the JAX ring's window body, ``mpi_openmp_cuda_tpu/parallel/ring.py``
    ``_ring_fn``): over the ``bs`` offsets the shard owns, global offset
    ``gn = d * bs + n`` valid when ``gn < max(len1 - len2, 0)``, on its
    window ``win`` of Seq1 codes (at least ``bs + L2P + 1`` of them, the
    shard's block first).  ``score`` is ``INT32_MIN`` where no offset of
    the shard is valid, ``n`` is global, and ``eq`` is the k = 0 score at
    the shard's first offset (the positional score on shard 0)."""
    b, l2p = rows.shape
    dev = rows.device
    out = torch.empty((b, 4), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    wlen = win.shape[0]
    vw = val_flat.reshape(ALPHABET_SIZE, ALPHABET_SIZE)[:, win.long()].reshape(-1)
    n = torch.arange(bs, device=dev)[:, None]
    i = torch.arange(l2p, device=dev)[None, :]
    idx0 = (n + i)[None]  # [1, bs, L2P]
    gn = (d * bs + n)[None]
    cb = max(1, CHUNK_ELEMS // max(bs * l2p, 1))
    for s in range(0, b, cb):
        r, ln = rows[s : s + cb].long(), lens[s : s + cb].long()[:, None, None]
        base = r[:, None, :] * wlen
        # Chars of a row longer than Seq1 are masked (never scored), as in
        # gather_rows, so no sum leaves the admission gate's range.
        charmask = i[None] < torch.where(ln <= len1, ln, 0)
        v0 = torch.where(charmask, vw[base + idx0], 0)
        v1 = torch.where(charmask, vw[base + idx0 + 1], 0)
        c0 = torch.cumsum(v0, dim=2, dtype=torch.int32)
        c1 = torch.cumsum(v1, dim=2, dtype=torch.int32)
        t0, t1 = c0[:, :, -1:], c1[:, :, -1:]
        scores = torch.cat([t0, c0[:, :, :-1] + (t1 - c1[:, :, :-1])], dim=2)
        k = i[None]
        valid = (gn < torch.clamp(len1 - ln, min=0)) & ((k == 0) | (k < ln))
        flat = torch.where(valid, scores, INT32_MIN).reshape(r.shape[0], -1)
        bi = torch.argmax(flat, dim=1)  # first max: offset-major, k = 0 first
        out[s : s + cb, 0] = flat.gather(1, bi[:, None])[:, 0]
        out[s : s + cb, 1] = (d * bs + bi // l2p).int()
        out[s : s + cb, 2] = (bi % l2p).int()
        out[s : s + cb, 3] = c0[:, 0, -1]
    return out
