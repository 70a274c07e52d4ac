"""Signed pair-value table: class matrix x weights (reference C10+C13 scoring).

The reference scores a candidate alignment as ``w1*n$ - w2*n% - w3*n# - w4*n␣``
(spec PDF p.2; cudaFunctions.cu:103,161-163) by counting signs in a histogram.
On TPU, counting then weighting is just a dot product — so we fold the weights
into the class matrix once per run, producing a [27, 27] int32 table ``VAL``
with ``VAL[a, b]`` = the signed score contribution of pairing character ``a``
(from Seq2) with character ``b`` (from Seq1).  Histogram + weighting then
dissolve into a single masked sum over the sequence axis.
"""

from __future__ import annotations

import numpy as np

from ..models.classmat import build_class_matrix
from ..utils.constants import NUM_WEIGHTS


def signed_weights(weights) -> np.ndarray:
    """[4] int32 vector of per-class signed contributions: [+w0, -w1, -w2, -w3]."""
    w = np.asarray(weights, dtype=np.int64).reshape(-1)
    if w.size != NUM_WEIGHTS:
        raise ValueError(f"expected {NUM_WEIGHTS} weights, got {w.size}")
    return np.array([w[0], -w[1], -w[2], -w[3]], dtype=np.int32)


def value_table(weights) -> np.ndarray:
    """[27, 27] int32 table of signed pair values for the given weights."""
    return signed_weights(weights)[build_class_matrix()]


def max_abs_value(val_flat) -> int:
    """Largest |entry| of a value table, for the float exactness gates.
    int64: abs(int32 min) would wrap negative and mis-enable a gate."""
    return int(np.abs(np.asarray(val_flat, dtype=np.int64)).max())
