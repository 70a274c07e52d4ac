"""Python side of the port's native driver ``final_torch`` (the port of
``mpi_openmp_cuda_tpu/native_bridge.py``).

The reference's only host-device interface is the 4-function C ABI of
``myProto.h``, kept unchanged in ``native/tpu_proto.h``.  The port's
backend of that ABI, ``native/torch_backend.cpp`` in this package, embeds
CPython and forwards each staged batch, whole, in one call to
:func:`score_strided` below, which decodes the wire format and scores
through the port's :class:`~.ops.dispatch.AlignmentScorer`.  ``make
final_torch`` links it with the unchanged driver ``native/main.cpp``.

Wire format (the JAX bridge's, byte for byte):

* sequences arrive as ASCII bytes, already uppercased by the C++ driver;
* the batch is one ``rows x stride`` byte buffer, each record a
  NUL-terminated C string (the reference's Scatter buffer layout);
* the two 27x27 0/1 membership matrices arrive as 729-byte blobs, as the
  driver built them;
* results return as ``rows x 3`` little-endian int32 ``(score, n, k)``
  triples in one bytes object.
"""

from __future__ import annotations

import numpy as np

from .models.encoding import encode
from .ops.dispatch import AlignmentScorer
from .ops.values import signed_weights, value_table
from .utils.constants import ALPHABET_SIZE


def value_table_from_levels(mat1: np.ndarray, mat2: np.ndarray, weights) -> np.ndarray:
    """[27, 27] signed pair-value table from host-built membership
    matrices, with the kernel's precedence (cudaFunctions.cu:88-95):
    identity beats conservative beats semi-conservative beats mismatch,
    whatever the matrices say of the diagonal."""
    mat1 = np.asarray(mat1).reshape(ALPHABET_SIZE, ALPHABET_SIZE)
    mat2 = np.asarray(mat2).reshape(ALPHABET_SIZE, ALPHABET_SIZE)
    sw = signed_weights(weights)
    val = np.full((ALPHABET_SIZE, ALPHABET_SIZE), sw[3], dtype=np.int32)
    val[mat2 == 1] = sw[2]
    val[mat1 == 1] = sw[1]
    idx = np.arange(1, ALPHABET_SIZE)
    val[idx, idx] = sw[0]
    return val


def _decode_record(record: bytes) -> np.ndarray:
    """One fixed-stride record -> codes; C-string semantics (stop at NUL)."""
    nul = record.find(b"\0")
    if nul >= 0:
        record = record[:nul]
    return encode(record.decode("ascii"))


def score_strided(
    seq1: bytes,
    seq2_all: bytes,
    stride: int,
    rows: int,
    mat1: bytes,
    mat2: bytes,
    weights: tuple,
    backend: str,
    mesh: str | int,
    device: str = "",
) -> bytes:
    """Score a staged fixed-stride batch; returns ``rows * 3`` int32 as
    bytes.

    ``backend`` is the port's (``auto|cuda|mm|gather|oracle``, auto =
    cuda); ``mesh`` the CLI's ``--mesh`` grammar ('N'/'batch:N', 'seq:N',
    'DxS'), parsed by ``parallel/specs.py::build_sharding``, '' or '0'
    one device; ``device`` ``cuda`` ('' means cuda) or ``cpu``.  With no
    card and no ``cpu`` asked for, the scorer raises: there is no quiet
    move to the CPU.  The staged matrices must be the spec's substitution
    groups (``native/main.cpp`` builds exactly those): the port scores the
    table of ``ops/values.py``, and a batch staged with other matrices is
    refused rather than scored under the wrong table."""
    if rows <= 0:
        return b""
    if stride <= 0 or len(seq2_all) < rows * stride:
        raise ValueError(
            f"batch buffer too small: {len(seq2_all)} bytes for "
            f"{rows} rows x {stride} stride"
        )
    seq1_codes = encode(seq1.decode("ascii"))
    seq2_codes = [
        _decode_record(seq2_all[r * stride : (r + 1) * stride]) for r in range(rows)
    ]
    val = value_table_from_levels(
        np.frombuffer(mat1, dtype=np.int8), np.frombuffer(mat2, dtype=np.int8), weights
    )
    if not np.array_equal(val, value_table(weights)):
        raise ValueError(
            "the staged membership matrices are not the spec's substitution "
            "groups; the port scores those groups only (ops/values.py)"
        )
    device = device or "cuda"
    mesh = str(mesh)
    sharding = None
    if mesh not in ("", "0"):
        from .parallel.specs import build_sharding

        sharding = build_sharding(mesh, device=device)
    scorer = AlignmentScorer(backend, device=device, sharding=sharding)
    out = scorer.score_codes(seq1_codes, seq2_codes, list(weights))
    return np.ascontiguousarray(out, dtype="<i4").tobytes()
