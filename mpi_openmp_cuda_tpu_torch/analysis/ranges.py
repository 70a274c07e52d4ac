"""The bounds certifier: every constant of ``ops/bounds.py`` re-derived
from Hopper numerics and diffed against its wired value.

The port of the constant-derivation half of ``mpi_openmp_cuda_tpu/
analysis/ranges.py``.  The JAX certifier also interprets every scoring
jaxpr in an interval domain; the port has no jaxprs (its kernels are CUDA
C++ and its plain versions eager PyTorch), so that half is not ported:
the kernels' value ranges are the derivation in ``ops/bounds.py``'s
docstring, and this module re-derives each constant it wires from three
facts of the H100:

* int32 arithmetic on the CUDA cores wraps at ``2^31``: it has no float
  window at all, so every int32 quantity is exact while its magnitude
  stays at most ``2^31 - 1`` (the kernels, the packed kernel, gather);
* IEEE fp32 has a 24-bit significand (``numpy.finfo(float32).nmant + 1``):
  integers are exact below ``2^24`` (the ``mm`` formulation, TF32 off);
* TF32 keeps 11 significant bits (10 stored mantissa bits), so a TF32
  matmul would round table values past ``2^11``: ``mm`` switches TF32 off
  (``ops/matmul_scorer.py::ieee_fp32``), and int8 MMA into int32 (a
  127 x 128 product per term) is exact for up to 131,071 terms, a path the
  port does not take.

:func:`derive_constants` returns one row a constant, ``{"name",
"derived", "wired", "ok", "source"}``; :func:`certify` wraps
them in a ``RangeCert``-shaped record (``derived_constants``, ``counts``,
``findings``).  A row whose wired value drifted from the derived one is a
finding; ``run_or_raise`` raises :class:`~.RangeCertError` on any.  The
``# cert: <row>`` markers of seqlint SEQ013 name these rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import RangeCertError

#: Significant bits of each Hopper number format the port's formulations
#: could use (stored mantissa + the implicit bit).
FP32_SIGNIFICAND_BITS = int(np.finfo(np.float32).nmant) + 1  # 24
TF32_SIGNIFICAND_BITS = 10 + 1  # TF32: 10 stored mantissa bits
INT32_BITS = int(np.iinfo(np.int32).bits)  # 32, two's complement

#: The widths at which the per-width windows are certified: every
#: 128-wide bucket edge up to the Seq2 cap, and the cap itself.
_WIDTHS = (128, 256, 512, 1024, 2000, 2048)


@dataclasses.dataclass(frozen=True)
class DerivedConstant:
    """One constant: its re-derived value, the value the code wires (they
    must be equal), and where the wired one lives."""

    name: str
    derived: object
    wired: object
    source: str = ""

    @property
    def ok(self) -> bool:
        return self.derived == self.wired

    def as_dict(self) -> dict:
        return {"name": self.name, "derived": self.derived, "wired": self.wired,
                "ok": self.ok, "source": self.source}


def _int32_max() -> int:
    return 2 ** (INT32_BITS - 1) - 1


def _mm_precision() -> str:
    """The fp32 matmul precision the ``mm`` formulation runs under."""
    import torch

    from ..ops.matmul_scorer import ieee_fp32

    mm = torch.backends.cuda.matmul
    with ieee_fp32():
        if hasattr(mm, "fp32_precision"):
            return "ieee" if mm.fp32_precision == "ieee" else "tf32"
        return "tf32" if mm.allow_tf32 else "ieee"


def derive_constants() -> list[DerivedConstant]:
    """Every numeric constant of the port's exactness story, re-derived
    from the format facts above and paired with its wired value."""
    from ..ops import bounds, cuda_scorer, dispatch
    from ..utils import constants

    i32 = _int32_max()
    f32_window = 2**FP32_SIGNIFICAND_BITS
    rows = [
        DerivedConstant("int32-max", i32, bounds.INT32_MAX, source="ops/bounds.py:INT32_MAX"),
        DerivedConstant("int32-sentinel", -i32 - 1, constants.INT32_MIN,
                        source="utils/constants.py:INT32_MIN"),
        DerivedConstant("f32-exact-window", f32_window, bounds.F32_EXACT_WINDOW,
                        source="ops/bounds.py:F32_EXACT_WINDOW"),
        # mm's window above assumes fp32's 24 bits; TF32's 11 would round
        # table values past 2^11, so its matmuls must run in IEEE fp32.
        DerivedConstant("mm-matmul-precision",
                        "ieee" if TF32_SIGNIFICAND_BITS < FP32_SIGNIFICAND_BITS else "tf32",
                        _mm_precision(), source="ops/matmul_scorer.py:ieee_fp32"),
    ]
    for w in _WIDTHS:
        rows.append(DerivedConstant(
            f"kernel-max-exact-value-{w}", i32 // (2 * w), bounds.max_exact_value(w),
            source="ops/bounds.py:max_exact_value"))
        rows.append(DerivedConstant(
            f"admitted-max-value-{w}", i32 // w, bounds.max_admitted_value(w),
            source="ops/bounds.py:max_admitted_value"))
        rows.append(DerivedConstant(
            f"mm-max-exact-value-{w}", (f32_window - 1) // (2 * w),
            bounds.mm_max_exact_value(w), source="ops/bounds.py:mm_max_exact_value"))
    for c in dispatch.pack_classes():
        rows.append(DerivedConstant(
            f"packed-max-exact-value-{c}", i32 // (2 * c), bounds.max_exact_value(c),
            source="analysis/contracts.py:packed_max_exact_value"))
    rows.append(DerivedConstant(
        "pack-classes", [8, 16, 32, 64], list(cuda_scorer.PACK_CLASSES),
        source="ops/cuda_scorer.py:PACK_CLASSES (csrc/packed_scorer.cu instances)"))
    # A launch of len2 <= 2000 (the Seq2 cap) admits the Seq2 cap's window.
    rows.append(DerivedConstant(
        "seq2-cap-kernel-window", i32 // (2 * constants.BUF_SIZE_SEQ2),
        bounds.max_exact_value(constants.BUF_SIZE_SEQ2),
        source="ops/bounds.py (536870 at the Seq2 cap)"))
    return rows


def certify() -> dict:
    """A ``RangeCert``-shaped record of :func:`derive_constants`:
    ``derived_constants`` rows, ``findings`` (one per drifted row) and
    ``counts``."""
    rows = [r.as_dict() for r in derive_constants()]
    findings = [
        {"kind": "constant-drift", "name": r["name"],
         "detail": f"wired {r['wired']!r} != derived {r['derived']!r} ({r['source']})"}
        for r in rows if not r["ok"]
    ]
    return {
        "derived_constants": rows,
        "findings": findings,
        "counts": {"constants": len(rows),
                   "constants_ok": sum(r["ok"] for r in rows),
                   "findings": len(findings)},
    }


def cert_rows() -> set[str]:
    """The row names a ``# cert:`` marker may cite."""
    return {r.name for r in derive_constants()}


def run_or_raise() -> dict:
    """:func:`certify`, raising :class:`RangeCertError` on any drift."""
    cert = certify()
    if cert["findings"]:
        rows = "\n  ".join(f"{f['name']}: {f['detail']}" for f in cert["findings"])
        raise RangeCertError(
            f"{len(cert['findings'])} constant(s) drifted from their Hopper "
            f"derivation:\n  {rows}\nFix the wired value in ops/bounds.py (or the "
            "derivation here, with the numerics that changed)."
        )
    return cert
