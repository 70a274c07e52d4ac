"""mpi_openmp_cuda_tpu_torch — the PyTorch + CUDA port of the batch scorer.

The same batch sequence-alignment contract as ``mpi_openmp_cuda_tpu``
(for each Seq2, the best ``(offset n, hyphen position k)`` against Seq1
under the $/%/#/space scoring, printed as ``#i: score: S, n: N, k: K``),
with the two fused scorer kernels written by hand in CUDA C++ for Hopper
(``csrc/``).  Entry points run on ``cuda`` unless the caller asks for the
CPU (``device="cpu"``, ``--device cpu``), where every kernel wrapper runs
its plain PyTorch version instead.
"""

from .models.encoding import encode
from .ops.dispatch import AlignmentScorer
from .ops.oracle import prefix_best
from .ops.values import value_table

__version__ = "0.1.0"

__all__ = ["AlignmentScorer", "encode", "prefix_best", "value_table"]
