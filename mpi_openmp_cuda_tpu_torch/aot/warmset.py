"""Warm-set selection: WHICH launch shapes to warm before the first
request, and the fingerprint that scopes their validity (the port of
``mpi_openmp_cuda_tpu/aot/warmset.py``).

A warm entry's identity has two halves:

* the **static half**, :class:`WarmEntry`: one launch shape as the port
  dispatches it.  It keeps what the card's cold costs key on and drops
  the rest.  The formulation names the library (one ``nvcc`` build and
  one load each) and the kernel function (CUDA loads each function's
  module lazily, at its first launch: the fused kernel has one, the
  packed kernel one a packing class ``l2s``); ``l2p`` is the width the
  fused kernel's shared-memory opt-in keys on (past 48 KB) and, with the
  padded ``rows``, sizes the pinned staging copies and the device blocks
  the caching allocators hand out (the pinned one in power-of-two bins).
  ``l1p`` only sizes Seq1 and the ``[B, tiles, 2]`` scratch, small blocks
  any earlier launch leaves in the allocator's pool: it is kept to size
  the warm launch, never to tell two entries apart.  The JAX entry's
  ``feed``, ``mm_hi``, ``cb``, ``n_chunks`` and ``sb`` name static
  arguments of a compiled program; the port compiles nothing per shape,
  so none of them has a counterpart.  :attr:`WarmEntry.executable_key`
  is the dedup key of the warm set.
* the **environment half**, :func:`backend_fingerprint`: torch and its
  CUDA version, the card's name and compute capability (or ``cpu``), the
  nvcc flags and the digest of the kernel sources the build hashes.  A
  manifest entry recorded under another digest is STALE: re-warmed under
  the current one, never replayed.

:func:`select_warmset` merges two of the JAX package's three sources:

1. the problem's launches, as ``dispatch.launch_plans`` makes them
   (launch groups and packed classes) and ``dispatch.run_launch`` routes
   them (``effective_backend``: past the kernels' int32 window a ``cuda``
   launch runs ``gather``);
2. the serve superblock shapes: every block the serve batcher would cut
   from the problem's rows (``serve/batcher.plan_blocks``, the problem as
   one request), planned as the scorer plans any batch, so a block of at
   least ``MIN_BUCKET_ROWS`` short real rows takes its packed form; plus,
   for each L2P bucket, a block of ``rows_per_block`` full-length rows
   (the fused form a block of pad rows and long rows takes).

The third JAX source, the top-K of the cost sheet's hot configs, and
``crosscheck_hot_configs`` wait for the port of ``analysis/costmodel``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np

#: Formulations a warm entry may name: the two Hopper kernels and the
#: two plain-PyTorch device formulations.
FORMULATIONS = ("cuda-fused", "cuda-packed", "mm", "gather")

#: The backend ``dispatch.run_launch`` is called with for each formulation.
BACKEND_OF = {"cuda-fused": "cuda", "cuda-packed": "cuda", "mm": "mm", "gather": "gather"}


@dataclasses.dataclass(frozen=True)
class WarmEntry:
    """One cold launch shape (the static half)."""

    formulation: str  # one of FORMULATIONS
    l2p: int
    l2s: int | None  # packing class (cuda-packed only)
    rows: int  # padded rows of the launch
    l1p: int  # sizes the warm launch; not part of the identity
    source: str = "schedule"  # schedule | serve-block | manifest | stale-rewarm

    @property
    def cache_key(self) -> tuple:
        """The kernel side of the identity: library, kernel function and
        the width the shared-memory opt-in keys on."""
        return (self.formulation, self.l2p, self.l2s)

    @property
    def executable_key(self) -> tuple:
        """The dedup key: :attr:`cache_key` x the padded rows (the
        allocator side)."""
        return self.cache_key + (self.rows,)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["cache_key"] = list(self.cache_key)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "WarmEntry":
        """The entry of a manifest record; ``ValueError`` for a record
        that is not one of the port's (a JAX manifest's ``pallas`` or
        ``xla-*`` entry, a missing field, a packing class on a fused
        launch)."""
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        missing = {"formulation", "l1p", "l2p", "rows"} - set(kw)
        if missing:
            raise ValueError(f"warm entry missing fields {sorted(missing)}: {d!r}")
        kw.setdefault("l2s", None)
        if kw["formulation"] not in FORMULATIONS:
            raise ValueError(
                f"warm entry formulation {kw['formulation']!r} is not one of {FORMULATIONS}"
            )
        if (kw["formulation"] == "cuda-packed") != (kw["l2s"] is not None):
            raise ValueError(f"warm entry: a packing class belongs to cuda-packed only: {d!r}")
        for name in ("l1p", "l2p", "rows"):
            if not isinstance(kw[name], int) or kw[name] < 1:
                raise ValueError(f"warm entry {name} must be a positive int: {d!r}")
        return cls(**kw)


def backend_fingerprint(device=None) -> dict:
    """The environment half of an entry's identity for ``device`` (``cuda``
    when None), with the 16-hex ``digest`` the manifest's staleness check
    compares."""
    import torch

    from ..ops import _build, cuda_scorer
    from ..utils.env import platform_tag

    dev = torch.device("cuda" if device is None else device)
    card, capability = "cpu", None
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        card = torch.cuda.get_device_name(index)
        capability = "sm%d%d" % torch.cuda.get_device_capability(index)
    fp = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": card,
        "capability": capability,
        "platform_tag": platform_tag(dev),
        "nvcc_flags": list(_build.NVCC_FLAGS),
        "sources": {name: _build.source_digest(name)[:16]
                    for name in cuda_scorer.launch_counts},
    }
    fp["digest"] = hashlib.sha256(json.dumps(fp, sort_keys=True).encode()).hexdigest()[:16]
    return fp


def _entries(seq1_codes, seq2_codes, weights, backend, source) -> list[WarmEntry]:
    """One entry per launch the scorer makes for the batch, routed as
    ``dispatch.run_launch`` routes it."""
    from ..ops.dispatch import effective_backend, launch_plans, max_scored
    from ..ops.values import max_abs_value

    val_flat, plans = launch_plans(seq1_codes, seq2_codes, weights, backend)
    maxv = max_abs_value(val_flat)
    out = []
    for plan in plans:
        b = plan.batch
        route = effective_backend(backend, maxv, b.l2p, max_scored(b))
        if route == "cuda":
            form, l2s = ("cuda-fused", None) if plan.l2s is None else ("cuda-packed", plan.l2s)
        else:
            form, l2s = route, None
        out.append(WarmEntry(form, b.l2p, l2s, b.batch_size, b.l1p, source))
    return out


def _serve_block_entries(problem, backend, rows_per_block: int) -> list[WarmEntry]:
    """The launches of every superblock the serve batcher cuts from the
    problem's rows, and of one block of full-length rows a bucket."""
    from ..ops.dispatch import plan_buckets
    from ..serve.batcher import plan_blocks
    from ..utils.constants import BUF_SIZE_SEQ2

    blocks = [(b.seq1_codes, b.codes) for b in plan_blocks([problem], rows_per_block)]
    sizes = [c.size for c in problem.seq2_codes]
    for l2p in sorted(plan_buckets(sizes, packable=False, min_rows=1)):
        pad = np.ones(min(int(l2p), BUF_SIZE_SEQ2), dtype=np.int8)
        blocks.append((problem.seq1_codes, [pad] * rows_per_block))
    out = []
    for seq1_codes, codes in blocks:
        out += _entries(seq1_codes, codes, problem.weights, backend, "serve-block")
    return out


def select_warmset(problem, backend: str, rows_per_block: int | None = None) -> list[WarmEntry]:
    """The deduplicated warm set of one problem on ``backend`` (``auto``
    is ``cuda``): the problem's launches, then, with ``rows_per_block``,
    the serve superblock shapes.  ``oracle`` scores on the host: []."""
    if backend == "auto":
        backend = "cuda"
    if backend == "oracle":
        return []
    merged: dict[tuple, WarmEntry] = {}
    entries = _entries(problem.seq1_codes, problem.seq2_codes, problem.weights, backend,
                       "schedule")
    if rows_per_block:
        entries += _serve_block_entries(problem, backend, int(rows_per_block))
    for entry in entries:
        merged.setdefault(entry.executable_key, entry)
    return list(merged.values())
