"""Numeric bounds of the Hopper scorers: the int32 admission gate, the
narrower window of the two CUDA kernels, and the fp32 window of the mm
formulation.

Both CUDA kernels (``csrc/fused_scorer.cu``, ``csrc/packed_scorer.cu``)
and their plain PyTorch versions run int32 end to end: no matmul feed,
no float window, no packed (score, key) word.  So the only bound is that
no int32 quantity they form can wrap.  Derivation, with ``M = max |v|``
over the [27, 27] value table and ``L`` the longest *scored* row (``0 <
len2 <= len1``; a row with len2 = 0 or len2 > len1 gets its sentinel
whatever its sums hold, and no scored quantity reads them):

* each pair value ``d0 = val[s2[i], s1[n+i]]`` and ``d1 = val[s2[i],
  s1[n+i+1]]`` has ``|d| <= M``;
* every candidate is the true score of one (n, k) placement, a sum of
  ``len2`` table entries, so ``|score| <= L*M``; so are the gather
  formulation's partial sums (``ops/gather_scorer.py``: the prefixes
  ``c0``, ``c1``, the totals and ``t1 - c1``, a true suffix sum) — every
  quantity it forms is a true partial score;
* the kernels also form the running delta prefix ``G = sum_{i<kappa}
  (d0 - d1)``, with ``|G| <= 2*kappa*M <= 2*L*M`` — the largest magnitude
  any path forms.

Hence two bounds.  **Admission** (:func:`check_int32_window`, on the
whole batch): ``L*M <= 2^31 - 1`` keeps every score and every gather
partial exact, and the ``INT32_MIN`` sentinel of masked candidates
strictly below every real score (``-L*M >= -(2^31 - 1) > INT32_MIN``).
Past it a score itself leaves int32 and the batch is refused.  **The
kernels' window** (:func:`kernel_fits`, per launch): ``2*L*M <= 2^31 -
1`` keeps ``G`` exact too; a launch whose own longest scored row breaks
it runs the gather formulation instead (``dispatch.effective_backend``),
as the JAX package routes such weights to its gather body.  At the Seq2
cap (L = 2000) the kernels take ``M <= 536870`` and the batch is
admitted up to ``M <= 1073741``.

The ``mm`` formulation (``ops/matmul_scorer.py``) runs in IEEE fp32 on
Hopper: TF32 is switched off around its matmuls (TF32 keeps 11
significant bits and would round table values past 2^11).  fp32 has a
24-bit significand, so an integer is exact while its magnitude stays
below ``2^24``, and a sum of exact integers is exact while every partial
does, whatever the order of the additions.  Its operations:

* the one-hot products ``val @ onehot(seq1).T`` and ``onehot(seq2) @ A``
  each sum 27 terms of which at most one is nonzero, a table value times
  1: exact for ``M < 2^24``;
* the prefix ``G = cumsum(d0 - d1)`` over at most ``L2P`` chars and the
  totals ``t1 = sum(d1)``: every partial is bounded by ``2 * L2P * M``;
* the candidates ``t1 + G`` are true scores, ``|.| <= L2P * M``.

So the window is ``2 * L2P * M < 2^24`` (:func:`mm_max_exact_value`,
:func:`fits_exact_window`), a bound at the bucket's own ``L2P``.  The JAX
package also caps ``M`` at 32767 (``OPERAND_CAP``): the MXU's HIGHEST
precision resolves a multiplicand in three bf16 passes, 16 significant
bits in all, and its prefix was a triangular matmul whose multiplicand is
``d0 - d1``.  Neither holds here: an fp32 FMA on the CUDA cores or a
cuBLAS SGEMM multiplies at the full 24 bits, and the prefix is a cumsum
(additions only), so no operand cap carries over.  Buckets past the
window route to the gather formulation (``dispatch.effective_backend``).
"""

from __future__ import annotations

INT32_MAX = 2147483647  # = 2^31 - 1  # cert: int32-max


def max_exact_value(max_len2: int) -> int:
    """Largest |table value| the int32 kernels score exactly when the
    longest scored row has ``max_len2`` Seq2 characters (``2*L*M``)."""
    return INT32_MAX // (2 * max(int(max_len2), 1))


def max_admitted_value(max_len2: int) -> int:
    """Largest |table value| a batch is admitted at when its longest
    scored row has ``max_len2`` characters (``L*M``; the gather
    formulation scores it exactly)."""
    return INT32_MAX // max(int(max_len2), 1)


def kernel_fits(max_abs_value: int, max_len2: int) -> bool:
    """True when the int32 kernels are exact for this max |value| and
    longest scored row."""
    return max_abs_value <= max_exact_value(max_len2)


def check_int32_window(max_abs_value: int, max_len2: int) -> None:
    """Raise ``ValueError`` when ``max_len2 * max_abs_value`` leaves int32
    (the admission gate derived in this module's docstring)."""
    limit = max_admitted_value(max_len2)
    if max_abs_value > limit:
        raise ValueError(
            f"weights too large for exact int32 scoring: max |value| "
            f"{max_abs_value} exceeds {limit} for Seq2 length {max_len2} "
            "(len2 * max|v| must stay below 2^31)"
        )


# Every integer below 2^24 is an exact fp32.
F32_EXACT_WINDOW = 1 << 24  # cert: f32-exact-window


def mm_max_exact_value(l2p: int) -> int:
    """Largest max |table value| the fp32 ``mm`` formulation scores
    exactly in a bucket of width ``l2p`` (``2 * l2p * M < 2^24``)."""
    return (F32_EXACT_WINDOW - 1) // (2 * max(int(l2p), 1))


def fits_exact_window(val_flat, l2p: int) -> bool:
    """True when the ``mm`` formulation is exact for this value table at
    this bucket width."""
    from .values import max_abs_value

    return max_abs_value(val_flat) <= mm_max_exact_value(l2p)
