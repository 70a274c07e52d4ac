"""Numeric bounds of the Hopper scorers: the one overflow gate.

Both CUDA kernels (``csrc/fused_scorer.cu``, ``csrc/packed_scorer.cu``)
and their plain PyTorch versions run int32 end to end: no matmul feed,
no float window, no packed (score, key) word.  So the only bound is that
no int32 quantity they form can wrap.  Derivation, with
``M = max |v|`` over the [27, 27] value table and ``L = len2`` of the
longest scored row:

* each pair value ``d0 = val[s2[i], s1[n+i]]`` and ``d1 = val[s2[i],
  s1[n+i+1]]`` has ``|d| <= M``;
* the running sum ``t1 = sum_{i<j} d1`` has ``|t1| <= j*M <= L*M``;
* the running delta prefix ``G = sum_{i<kappa} (d0 - d1)`` has
  ``|G| <= 2*kappa*M <= 2*L*M`` — the largest magnitude formed;
* every candidate ``t1 + G`` is the true score of one (n, k) placement,
  a sum of ``L`` table entries, so ``|t1 + G| <= L*M``.

Hence ``2*L*M <= 2^31 - 1`` keeps every partial sum, every strict ``>``
comparison and every candidate exact in int32.  It also keeps the
``INT32_MIN`` sentinel of masked candidates strictly below every real
score (``-L*M > -2^30 > INT32_MIN``).  At the Seq2 cap (L = 2000) the gate
admits ``M <= 536870``.
"""

from __future__ import annotations

INT32_MAX = 2147483647  # = 2^31 - 1


def max_exact_value(max_len2: int) -> int:
    """Largest |table value| the int32 kernels score exactly when the
    longest row has ``max_len2`` Seq2 characters."""
    return INT32_MAX // (2 * max(int(max_len2), 1))


def check_int32_window(max_abs_value: int, max_len2: int) -> None:
    """Raise ``ValueError`` when ``2 * max_len2 * max_abs_value`` leaves
    int32 (the gate derived in this module's docstring)."""
    limit = max_exact_value(max_len2)
    if max_abs_value > limit:
        raise ValueError(
            f"weights too large for exact int32 scoring: max |value| "
            f"{max_abs_value} exceeds {limit} for Seq2 length {max_len2} "
            "(2 * len2 * max|v| must stay below 2^31)"
        )
