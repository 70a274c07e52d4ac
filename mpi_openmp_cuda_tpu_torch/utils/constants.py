"""Domain constants (reference parity: C1).

The reference fixes maximum sequence buffer sizes as compile-time constants
(`myProto.h:3-4`): Seq1 buffers are 3000 chars, each Seq2 record is a
fixed-stride 2000-char slot in a flat batch buffer.  The TPU build keeps the
same *capability* caps, but uses them only as upper bounds for shape
bucketing — actual compiled shapes are rounded up per batch, not always
padded to the maximum.
"""

from __future__ import annotations

# Maximum supported sequence lengths (reference: myProto.h:3-4).
BUF_SIZE_SEQ1: int = 3000
BUF_SIZE_SEQ2: int = 2000

# Character-code alphabet: 0 is reserved (pad / hyphen — the reference's
# pair matrices are 27x27 with "do not use index 0", main.c:38); codes
# 1..26 are 'A'..'Z'.
PAD_CODE: int = 0
ALPHABET_SIZE: int = 27

# Sentinel score for undefined problems (len2 > len1).  Matches the
# reference kernel's behaviour of reporting INT_MIN when the offset loop
# is empty (cudaFunctions.cu:113,116; SURVEY B12).
INT32_MIN: int = -(2**31)

# Number of scoring weights (w1..w4 in the spec; indexed 0..3 here).
NUM_WEIGHTS: int = 4

# Pair classification classes, in precedence order ($ > % > # > space),
# per spec PDF p.1-2 and the kernel's if/else chain (cudaFunctions.cu:88-95).
CLASS_DOLLAR: int = 0  # identical characters            -> +w[0]
CLASS_PERCENT: int = 1  # same conservative group          -> -w[1]
CLASS_HASH: int = 2  # same semi-conservative group     -> -w[2]
CLASS_SPACE: int = 3  # otherwise                        -> -w[3]

CLASS_SIGNS: str = "$%# "  # class id -> printable sign
