"""Warming one entry: the card's cold costs paid at the entry's launch
shape, through the same calls the dispatch makes (the port of
``mpi_openmp_cuda_tpu/aot/compile.py``).

The JAX entry compiles a program and executes it once.  The port
compiles nothing per shape; what a first launch pays on the card is:

* the ``nvcc`` build of the kernel's library, on disk under
  ``build/torch_kernels/`` and keyed by a source hash (``ops/_build.py``),
  and its ``ctypes`` load: ``cuda_scorer.load_kernels``;
* the fused kernel's shared-memory opt-in at a width past 48 KB:
  ``cuda_scorer.check_smem``;
* CUDA's lazy load of each kernel function's module at its first launch,
  the first blocks of the caching allocator and the pinned host blocks
  of the feed's arena (``ops/feed.py``; PyTorch's host allocator keeps
  them for the scorer's slots): one launch at the entry's shape through
  ``dispatch.run_launch``, synchronized.

:func:`compile_entry` makes exactly those calls on a synthetic bucket of
the entry's shape.  On a CPU device the launch runs the plain version and
nothing is built or loaded, so the contract can be tested without a card.
A failure raises: ``prewarm`` counts it and the run goes on, and the
later dispatch launches the kernel or raises, as without a prewarm.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import cuda_scorer, dispatch
from ..ops.feed import FeedRing
from ..ops.values import value_table
from .warmset import BACKEND_OF

#: Weights of the synthetic bucket (inside every formulation's window).
WARM_WEIGHTS = (1, 1, 1, 1)


def _on_card(device: torch.device) -> bool:
    return device.type == "cuda"


def synthetic_plan(entry) -> dispatch.PlannedLaunch:
    """The entry's launch planned on the host: ``rows`` rows of L2P
    ``l2p`` (each ``l2s`` or fewer live chars when packed) against a Seq1
    of ``l1p`` codes, seeded."""
    rng = np.random.default_rng(0)
    len1 = entry.l1p
    len2 = max(1, min(entry.l2s or entry.l2p, len1 - 1))
    seq1 = rng.integers(1, 27, size=len1).astype(np.uint8)
    rows = tuple(rng.integers(1, 27, size=(entry.rows, len2)).astype(np.uint8))
    lens = np.full(entry.rows, len2, dtype=np.int32)
    return dispatch.PlannedLaunch(
        (entry.l2s or entry.l2p,), np.arange(entry.rows), seq1, rows, lens, entry.l2p,
        entry.l2s)


def synthetic_launch(entry, device: torch.device) -> dispatch.BucketLaunch:
    """:func:`synthetic_plan` on ``device``, staged as
    ``dispatch.bucket_launches`` stages a plan (one arena, one copy)."""
    return dispatch._upload(value_table(WARM_WEIGHTS).reshape(-1), [synthetic_plan(entry)],
                            device, FeedRing(device.type == "cuda"))[0]


def validate_entry(entry, device: torch.device) -> None:
    """``--check``: the entry's launch through the launch contracts
    (``analysis/contracts.py``) on its host arrays, before any upload."""
    from ..analysis.contracts import validate_plans

    plan = synthetic_plan(entry)
    validate_plans(value_table(WARM_WEIGHTS).reshape(-1), [plan], BACKEND_OF[entry.formulation],
                   device)


def compile_entry(entry, device=None) -> tuple[float, int]:
    """Warm ONE entry on ``device`` (``cuda`` when None): build and load
    the kernels, opt in the fused kernel's width, make one launch at the
    entry's shape and wait for it.  Returns ``(wall_s, bytes)``: the host
    wall of all of it, and the bytes of the launch's operands and result
    on the device."""
    dev = dispatch.resolve_device(device)
    backend = BACKEND_OF[entry.formulation]
    on_card = _on_card(dev)
    t0 = time.perf_counter()
    if on_card and backend == "cuda":
        cuda_scorer.load_kernels()
    launch = synthetic_launch(entry, dev)
    if on_card and entry.formulation == "cuda-fused":
        cuda_scorer.check_smem(launch.state)
    out = dispatch.run_launch(launch, backend)
    if on_card:
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    st = launch.state
    nbytes = sum(t.numel() * t.element_size()
                 for t in (st.seq1ext, st.rows, st.lens, st.val, out))
    return wall, nbytes
