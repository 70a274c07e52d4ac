"""Mesh-spec grammar shared by every entry point (a copy of
``mpi_openmp_cuda_tpu/parallel/specs.py``; the CLI's ``--mesh``, library
callers).

One parser so the surfaces cannot drift: 'N' or 'batch:N' shards the Seq2
batch over N devices (data parallel, the MPI_Scatter tier), 'seq:N'
ring-shards Seq1 over N devices (sequence/context parallel), 'DxS'
composes both on a 2-D mesh.  Bad specs raise ValueError (never a silent
fallback to some other parallelism strategy); a missing subsystem module
raises RuntimeError with the offending feature named.  ``device`` is the
kind of device the mesh takes (``'cuda'`` or ``'cpu'``); ``devices``, when
given, is the mesh's explicit device list (the comms audit's ``[cpu] x N``).
"""

from __future__ import annotations


class FeatureUnavailableError(RuntimeError):
    """A lazily-imported subsystem is absent from this build."""


def _feature_import(what: str, importer):
    try:
        return importer()
    except ModuleNotFoundError as e:
        raise FeatureUnavailableError(
            f"{what} is not available in this build ({e.name} missing)"
        ) from e


def build_sharding(mesh_arg: str | None, device="cuda", devices=None):
    """Parse a mesh spec into a sharding strategy (None = single device)."""
    if mesh_arg is None:
        return None

    def _imp_batch():
        from .sharding import BatchSharding

        return BatchSharding

    def _imp_ring():
        from .ring import RingSharding

        return RingSharding

    def _bad(detail: str = "") -> ValueError:
        return ValueError(
            f"bad --mesh spec {mesh_arg!r}: expected 'N', 'batch:N', "
            f"'seq:N', or 'DxS'{detail}"
        )

    def _count(token: str) -> int:
        try:
            value = int(token)
        except ValueError:
            raise _bad() from None
        if value < 1:
            raise _bad(f" (device count must be >= 1, got {value})")
        return value

    spec = mesh_arg.split(":")
    if len(spec) == 2:
        # Explicit axis prefix: anything but 'seq'/'batch' is a spec error,
        # never a silent fallback to some other parallelism strategy.
        if spec[0] == "seq":
            return _feature_import(
                "--mesh sequence sharding", _imp_ring
            ).over_devices(seq=_count(spec[1]), device=device, devices=devices)
        if spec[0] == "batch":
            return _feature_import(
                "--mesh batch sharding", _imp_batch
            ).over_devices(_count(spec[1]), device=device, devices=devices)
        raise _bad(f" (unknown axis {spec[0]!r})")
    if len(spec) != 1:
        raise _bad()
    if "x" in spec[0]:
        tokens = spec[0].split("x")
        if len(tokens) != 2:
            raise _bad()
        dp, sp = (_count(t) for t in tokens)
        return _feature_import("--mesh 2-D sharding", _imp_ring).over_devices(
            seq=sp, batch=dp, device=device, devices=devices
        )
    return _feature_import("--mesh batch sharding", _imp_batch).over_devices(
        _count(spec[0]), device=device, devices=devices
    )
