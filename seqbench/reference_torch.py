"""The plain reference in PyTorch: the course spec's scoring (SURVEY.md
Appendix A) in plain ``torch`` operations, written from the spec alone, on
the CPU or on a card.

For each Seq2 the best ``(score, n, k)`` over offsets ``n = 0 .. len1 -
len2 - 1`` and hyphen positions ``k``: the mutant ``MS(k)`` has a hyphen
after its k-th character, chars ``i < k`` meet ``seq1[n + i]`` and chars
``i >= k`` meet ``seq1[n + i + 1]``; the hyphen at the end is reported as
``k = 0``.  Ties go to the first candidate in offset-major order with
``k = 0`` first, then ``k = 1 .. len2 - 1``.  ``len2 == len1`` scores
positionally at ``n = k = 0``; ``len2 > len1`` or ``len2 == 0`` give
``(INT32_MIN, 0, 0)``.

Candidates come from prefix sums along diagonals: with ``P[m, i]`` the sum
of the first ``i + 1`` values of diagonal ``m`` (Seq2 char ``i`` against
Seq1 char ``m + i``) and ``T[m]`` its total, ``score(n, 0) = T[n]`` and
``score(n, k) = P[n, k - 1] + T[n + 1] - P[n + 1, k - 1]``.  Rows are
scored in blocks of similar length, padded with a code whose value is 0
against every char, so a padded char adds nothing to any sum; candidates
past a row's own offsets or chars are masked out before the first-hit
maximum.  Sums are int64; ``acc`` forces a narrower accumulator, which is
how a control computes in a precision below the configuration's.

Nothing here imports the program under test, NumPy's reference or JAX.
"""

from __future__ import annotations

import torch

INT32_MIN = -(2**31)
PAD = 26  # the pad code: value 0 against everything

# Appendix A.1: the 9 conservative and the 11 semi-conservative groups.
CONSERVATIVE = ("NDEQ", "NEQK", "STA", "MILV", "QHRK", "NHQK", "FYW", "HY", "MILF")
SEMI_CONSERVATIVE = ("SAG", "ATV", "CSA", "SGND", "STPA", "STNK", "NEQHRK", "NDEQHK",
                     "SNDEQK", "HFY", "FVLIM")

# Elements of one block's [rows, diagonals, chars] tensors.
BLOCK_ELEMS = 1 << 24


def _same_group(groups) -> torch.Tensor:
    out = torch.zeros((26, 26), dtype=torch.bool)
    for g in groups:
        idx = torch.tensor([ord(c) - 65 for c in g])
        out[idx[:, None], idx[None, :]] = True
    return out


def value_table(weights) -> torch.Tensor:
    """[27, 27] int64 value of a (Seq2 char, Seq1 char) pair, codes 0..25
    for A..Z and :data:`PAD`: ``w1`` if equal, else ``-w2`` in a
    conservative group, else ``-w3`` in a semi-conservative one, else
    ``-w4``; 0 wherever either code is the pad."""
    w1, w2, w3, w4 = (int(w) for w in weights)
    table = torch.full((26, 26), -w4, dtype=torch.int64)
    table[_same_group(SEMI_CONSERVATIVE)] = -w3
    table[_same_group(CONSERVATIVE)] = -w2
    table.fill_diagonal_(w1)
    out = torch.zeros((27, 27), dtype=torch.int64)
    out[:26, :26] = table
    return out


def encode(seq: str) -> torch.Tensor:
    """Letters (either case) -> int64 codes 0..25; anything else is refused."""
    codes = torch.tensor(list(seq.upper().encode("ascii")), dtype=torch.int64) - 65
    if codes.numel() and (int(codes.min()) < 0 or int(codes.max()) > 25):
        raise ValueError(f"not a letter sequence: {seq[:32]!r}")
    return codes


def _block(s1: torch.Tensor, rows: list[torch.Tensor], table: torch.Tensor, acc) -> list:
    """``(score, n, k)`` of rows (host codes) with ``0 < len2 < len1``,
    scored together on the device of ``s1``."""
    dev = s1.device
    len1 = s1.numel()
    lens = torch.tensor([r.numel() for r in rows])
    width = int(lens.max())
    s2 = torch.full((len(rows), width), PAD, dtype=torch.int64)
    for b, r in enumerate(rows):
        s2[b, : r.numel()] = r
    s2, lens = s2.to(dev), lens.to(dev)
    noff = len1 - lens  # each row's offsets
    diags = int(noff.max()) + 1  # diagonals 0 .. max noff
    s1pad = torch.full((diags + width,), PAD, dtype=torch.int64, device=dev)
    s1pad[:len1] = s1
    # diag[b, m, i] = value(s2[b, i], s1[m + i]); a row's own diagonals
    # m <= noff meet Seq1 inside it for every i < len2.
    win = s1pad[torch.arange(diags, device=dev)[:, None] + torch.arange(width, device=dev)]
    diag = table.to(acc).reshape(-1)[s2[:, None, :] * 27 + win[None]]
    prefix = torch.cumsum(diag, dim=2, dtype=acc)
    total = prefix[:, :, -1]
    cand = torch.empty((len(rows), diags - 1, width), dtype=acc, device=dev)
    cand[:, :, 0] = total[:, :-1]
    cand[:, :, 1:] = prefix[:, :-1, :-1] - prefix[:, 1:, :-1] + total[:, 1:, None]
    cand = cand.to(torch.int64)
    n = torch.arange(diags - 1, device=dev)[None, :, None]
    k = torch.arange(width, device=dev)[None, None, :]
    live = (n < noff[:, None, None]) & (k < lens[:, None, None])
    cand = cand.masked_fill(~live, torch.iinfo(torch.int64).min).reshape(len(rows), -1)
    best = cand.max(dim=1).values
    # The first hit: the least flat index (offset-major, k = 0 first) at the max.
    flat = torch.arange(cand.shape[1], device=dev).expand_as(cand)
    first = flat.masked_fill(cand != best[:, None], cand.shape[1]).min(dim=1).values
    out = torch.stack([best, first // width, first % width], dim=1).cpu().tolist()
    return [tuple(int(x) for x in r) for r in out]


def scores(weights, seq1: str, seqs, device="cpu", acc=torch.int64) -> list[tuple[int, int, int]]:
    """``(score, n, k)`` for each Seq2 of one problem, computed on
    ``device`` in blocks of rows of similar length; ``acc`` the
    accumulator type (default: int64, exact)."""
    table = value_table(weights)
    s1 = encode(seq1)
    len1 = s1.numel()
    codes = [encode(s) for s in seqs]
    out: list = [None] * len(codes)
    scored = []
    for j, c in enumerate(codes):
        len2 = c.numel()
        if len2 == 0 or len2 > len1:
            out[j] = (INT32_MIN, 0, 0)
        elif len2 == len1:
            out[j] = (int(table.to(acc)[c, s1].sum(dtype=acc)), 0, 0)
        else:
            scored.append(j)
    scored.sort(key=lambda j: codes[j].numel())
    s1_dev, table_dev = s1.to(device), table.to(device)
    at = 0
    while at < len(scored):
        # Rows from the shortest up while the block's tensors fit: the
        # block's width is its longest row's, its diagonals its shortest's.
        end = at + 1
        while end < len(scored):
            width = codes[scored[end]].numel()
            if (end + 1 - at) * (len1 - codes[scored[at]].numel() + 1) * width > BLOCK_ELEMS:
                break
            end += 1
        block = scored[at:end]
        for j, row in zip(block, _block(s1_dev, [codes[j] for j in block], table_dev, acc)):
            out[j] = row
        at = end
    return out


def line(i: int, row) -> str:
    """One result line of the spec's stdout."""
    return f"#{i}: score: {row[0]}, n: {row[1]}, k: {row[2]}"


def stdout(text: str, device="cpu", acc=torch.int64) -> str:
    """The spec's whole stdout for one stdin text (four weights, Seq1, N,
    then N Seq2s)."""
    tokens = text.split()
    weights = [int(t) for t in tokens[:4]]
    seq1, n = tokens[4], int(tokens[5])
    seqs = tokens[6 : 6 + n]
    if len(seqs) != n:
        raise ValueError(f"declared {n} sequences but found {len(seqs)}")
    rows = scores(weights, seq1, seqs, device, acc)
    return "".join(line(i, r) + "\n" for i, r in enumerate(rows))
