"""mpi_openmp_cuda_tpu_torch — the PyTorch + CUDA port of the batch scorer.

The same batch sequence-alignment contract as ``mpi_openmp_cuda_tpu``
(for each Seq2, the best ``(offset n, hyphen position k)`` against Seq1
under the $/%/#/space scoring, printed as ``#i: score: S, n: N, k: K``),
with the two fused scorer kernels written by hand in CUDA C++ for Hopper
(``csrc/``).  Entry points run on ``cuda`` unless the caller asks for the
CPU (``device="cpu"``, ``--device cpu``), where every kernel wrapper runs
its plain PyTorch version instead.

The front door exports the JAX package's fifteen names.  The domain core
(encoding, class matrix, value tables, the numpy oracle) imports no
torch; the scorer and the sharding strategies do, so they load lazily.
"""

from .models.classmat import build_class_matrix, classify_pair
from .models.encoding import decode, encode, encode_normalized, normalize
from .ops.oracle import brute_force_best, prefix_best, score_batch_oracle
from .ops.values import signed_weights, value_table
from .utils import constants

_LAZY = {
    "AlignmentScorer": ("mpi_openmp_cuda_tpu_torch.ops.dispatch", "AlignmentScorer"),
    "BatchSharding": ("mpi_openmp_cuda_tpu_torch.parallel.sharding", "BatchSharding"),
    "RingSharding": ("mpi_openmp_cuda_tpu_torch.parallel.ring", "RingSharding"),
}


def __getattr__(name):
    if name == "__version__":
        from .utils.env import package_version

        return package_version()
    try:
        module, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        ) from None
    import importlib

    return getattr(importlib.import_module(module), attr)


def __dir__():
    return sorted(set(globals()) | set(_LAZY) | {"__version__"})


__all__ = [
    "AlignmentScorer",
    "BatchSharding",
    "RingSharding",
    "build_class_matrix",
    "classify_pair",
    "encode",
    "encode_normalized",
    "normalize",
    "decode",
    "brute_force_best",
    "prefix_best",
    "score_batch_oracle",
    "signed_weights",
    "value_table",
    "constants",
]
