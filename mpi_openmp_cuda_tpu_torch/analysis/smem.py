"""Shared-memory and register model of the Hopper kernels (the port's
counterpart of ``mpi_openmp_cuda_tpu/analysis/vmem.py``).

A kernel whose block asks for more shared memory than the card allows
fails at launch, on the card only.  This pass makes that a checked
artifact: the shared memory of every configuration the dispatch can
launch is modelled from the launch configuration ``csrc/`` uses, and
:func:`audit_chooser_space` sweeps every plannable width and class
against the card's opt-in limit.  It runs in milliseconds on the CPU.

The model, per kernel (``csrc/fused_kernels.cuh``, ``csrc/packed_scorer.cu``):

* **fused tile kernel** — one (pair, 128-offset tile) on a cluster of
  ``nblk`` blocks of ``nseg`` warps (:func:`fused_tile_shape`, the
  Python twin of ``tile_shape``); dynamic shared memory ``4 * (732 + s2n
  + nblk * nseg * 9 * 32) + 128 + s2n`` bytes with ``s2n`` the block's
  staged chars; no static shared memory.
* **fused finish kernel** — 128 threads, static ``[729]`` table plus its
  reduction words (2,972 bytes), no dynamic.
* **packed tile kernel** — ``W = 4`` warps a block, static table (732
  words), ``W * l2s`` staged codes and a ``128 + l2s`` byte window.
* **packed finish kernel** — 8 warps, static ``[729]`` table.

The budget is the card's dynamic shared memory a block after opting in:
``torch.cuda.get_device_properties(d).shared_memory_per_block_optin`` on
the card, :data:`H100_SMEM_OPTIN` (227 KB) stated for the H100 off it.
At that budget the fused kernel runs L2P up to 84,224 (52,528 bytes at
the ring's L2P 12288, 26,880 at the Seq2 cap).

On the card, :func:`kernel_attributes` reads each kernel's registers and
static shared memory through ``cudaFuncGetAttributes`` (the ``*_attrs``
accessors of the two libraries) and :func:`audit_attributes` holds them
against the model: static shared memory within alignment of it,
registers within the ``__launch_bounds__`` cap and equal to the ptxas
counts recorded in :data:`EXPECTED_REGISTERS`.
"""

from __future__ import annotations

import dataclasses

from . import SmemBudgetError

_TILE = 128
_ALPHA = 27
_TAB_WORDS = 732  # 27 * 27 table words, padded to 16 bytes
_COMB = 9  # 2 * kR + 1 words a thread hands to the combine
# The fused tile constants (FUSED_SEG_CHARS, FUSED_MAX_SEG, FUSED_CLUSTER).
SEG_CHARS = 32
MAX_SEG = 8
CLUSTER = 2
FINISH_THREADS = 128  # kFinish
PACKED_WARPS = 4  # PACKED_WARPS
PACKED_FINISH_PAIRS = 8  # kFinishPairs
PACK_CLASSES = (8, 16, 32, 64)
DEFAULT_SMEM = 48 * 1024  # a launch's dynamic shared memory without opting in

#: The H100's dynamic shared memory a block after opting in (227 KB), the
#: budget of the audit off the card.
H100_SMEM_OPTIN = 232448
#: Registers a thread on the H100 (64K a block's SM).
REGS_PER_SM = 65536

#: The plannable widths: one device's buckets up to the Seq2 cap, and the
#: Seq1 ring's windows, which lift the cap (PERF.md: L2P 12288 on the card).
MAX_L2P_ONE_DEVICE = 2048
MAX_L2P_RING = 12288
SERVE_BLOCK_ROWS = 64

#: ptxas's register counts of the production builds (PERF.md §6: fused
#: tile 56 and finish 40; packed tile 40 in every class, finish 32, and 31
#: in class 64 since the finish kernels store finished rows).
EXPECTED_REGISTERS = {
    "fused_tile": 56,
    "fused_finish": 40,
    **{f"packed_tile_{c}": 40 for c in PACK_CLASSES},
    **{f"packed_finish_{c}": 31 if c == 64 else 32 for c in PACK_CLASSES},
}
#: Static shared memory may exceed the model by alignment padding only.
STATIC_SLACK = 64


@dataclasses.dataclass(frozen=True)
class TileShape:
    """The fused tile kernel's launch shape at one width."""

    nsegt: int  # segments a (pair, tile)
    nblk: int  # blocks of its cluster
    nseg: int  # segments (warps) a block
    s2n: int  # Seq2 chars a block stages
    smem: int  # dynamic shared memory a block, bytes


def _block_chars(l2p: int, nseg: int, nblk: int) -> int:
    return ((l2p // nblk + 3) & ~3) + 4 * nseg + SEG_CHARS


def fused_tile_shape(l2p: int, split: int | None = None) -> TileShape:
    """``csrc/fused_kernels.cuh::tile_shape`` in Python: at the width's
    default split (one segment a ``SEG_CHARS`` chars, at most ``MAX_SEG *
    CLUSTER``), or at ``split`` segments where that is fewer."""
    nsegt = min(-(-l2p // SEG_CHARS), MAX_SEG * CLUSTER)
    if split:
        nsegt = min(nsegt, split)
    nblk = CLUSTER if nsegt > MAX_SEG else 1
    nseg = -(-nsegt // nblk)
    s2n = _block_chars(l2p, nseg, nblk)
    smem = 4 * (_TAB_WORDS + s2n + nblk * nseg * _COMB * 32) + _TILE + s2n
    return TileShape(nsegt, nblk, nseg, s2n, smem)


@dataclasses.dataclass(frozen=True)
class SmemEstimate:
    """Modelled shared memory and threads of one kernel configuration."""

    kernel: str  # fused_tile | fused_finish | packed_tile | packed_finish
    kind: str  # fused | ring | packed | serve
    l2p: int
    l2s: int | None
    threads: int
    dynamic_bytes: int
    static_bytes: int
    budget: int = H100_SMEM_OPTIN

    @property
    def total_bytes(self) -> int:
        return self.dynamic_bytes + self.static_bytes

    @property
    def headroom_bytes(self) -> int:
        return self.budget - self.total_bytes

    @property
    def opt_in(self) -> bool:
        return self.dynamic_bytes > DEFAULT_SMEM

    def describe(self) -> str:
        return (
            f"{self.kernel:<13s} {self.kind:<6s} L2P={self.l2p:>5d} "
            f"l2s={self.l2s or '-':>2} threads={self.threads:>3d} "
            f"dynamic={self.dynamic_bytes:>6d} B static={self.static_bytes:>5d} B "
            f"total={self.total_bytes / 1024:7.2f} KiB of {self.budget / 1024:.0f} KiB"
            f"{' (opt-in)' if self.opt_in else ''}"
        )


def estimate_fused(l2p: int, kind: str = "fused", budget: int = H100_SMEM_OPTIN,
                   split: int | None = None):
    """The fused tile and finish kernels at width ``l2p`` and ``split``
    (None: the width's default)."""
    shape = fused_tile_shape(l2p, split)
    return (
        SmemEstimate("fused_tile", kind, l2p, None, shape.nseg * 32, shape.smem, 0,
                     budget),
        SmemEstimate("fused_finish", kind, l2p, None, FINISH_THREADS, 0,
                     4 * (_ALPHA * _ALPHA + 2 + 3 * (FINISH_THREADS // 32)), budget),
    )


def packed_static_bytes(l2s: int) -> int:
    """The packed tile kernel's static shared memory in class ``l2s``."""
    return 4 * _TAB_WORDS + 4 * PACKED_WARPS * l2s + _TILE + l2s


def estimate_packed(l2s: int, kind: str = "packed", budget: int = H100_SMEM_OPTIN):
    """The packed tile and finish kernels in class ``l2s`` (L2P 128)."""
    return (
        SmemEstimate("packed_tile", kind, _TILE, l2s, PACKED_WARPS * 32, 0,
                     packed_static_bytes(l2s), budget),
        SmemEstimate("packed_finish", kind, _TILE, l2s, PACKED_FINISH_PAIRS * 32, 0,
                     4 * _ALPHA * _ALPHA, budget),
    )


def max_fused_l2p(budget: int = H100_SMEM_OPTIN) -> int:
    """The widest L2P (a multiple of 128) whose fused tile block fits
    ``budget`` (84,224 at the H100's 227 KB)."""
    lo, hi = _TILE, _TILE
    while fused_tile_shape(hi).smem <= budget:
        lo, hi = hi, hi * 2
    while hi - lo > _TILE:
        mid = (lo + hi) // 2 // _TILE * _TILE
        lo, hi = (mid, hi) if fused_tile_shape(mid).smem <= budget else (lo, mid)
    return lo


def iter_chooser_space(budget: int = H100_SMEM_OPTIN, max_ring_l2p: int = MAX_L2P_RING):
    """Yield a :class:`SmemEstimate` for every configuration the dispatch
    can launch: the fused kernels at every L2P of one device (128 to
    2048) and of the ring's windows (up to ``max_ring_l2p``), the packed
    kernels in every class, and the serve plane's blocks (64 rows of one
    bucket: the same kernels at the 128-wide classes and one device's
    widths; shared memory does not depend on the row count)."""
    for l2p in range(_TILE, MAX_L2P_ONE_DEVICE + 1, _TILE):
        yield from estimate_fused(l2p, "fused", budget)
    for l2p in range(MAX_L2P_ONE_DEVICE + _TILE, max_ring_l2p + 1, _TILE):
        yield from estimate_fused(l2p, "ring", budget)
    for l2s in PACK_CLASSES:
        yield from estimate_packed(l2s, "packed", budget)
    for l2p in range(_TILE, MAX_L2P_ONE_DEVICE + 1, _TILE):
        yield from estimate_fused(l2p, "serve", budget)
    for l2s in PACK_CLASSES:
        yield from estimate_packed(l2s, "serve", budget)


def audit_chooser_space(budget: int = H100_SMEM_OPTIN, max_ring_l2p: int = MAX_L2P_RING):
    """Sweep the chooser space against ``budget``: ``(n_configs, worst)``,
    ``worst`` the estimate with the least headroom; raises
    :class:`SmemBudgetError` listing every configuration past it (capped
    at 20 rows)."""
    over: list[SmemEstimate] = []
    worst: SmemEstimate | None = None
    n = 0
    for est in iter_chooser_space(budget, max_ring_l2p):
        n += 1
        if worst is None or est.total_bytes > worst.total_bytes:
            worst = est
        if est.total_bytes > budget:
            over.append(est)
    if worst is None:
        raise SmemBudgetError("chooser sweep yielded no configurations")
    if over:
        over.sort(key=lambda e: -e.total_bytes)
        rows = "\n  ".join(e.describe() for e in over[:20])
        more = f"\n  ... and {len(over) - 20} more" if len(over) > 20 else ""
        raise SmemBudgetError(
            f"{len(over)} of {n} launchable kernel configs exceed the {budget} B "
            f"shared memory a block allows:\n  {rows}{more}\n"
            "Shrink the kernel's staging (csrc/fused_kernels.cuh::tile_shape) "
            "or keep the width off the card (parallel/ring.py::ring_plan, "
            "dispatch.pack_classes) before it reaches hardware."
        )
    return n, worst


def card_budget(device=None) -> int:
    """The shared memory a block may opt in to on ``device``: the card's
    own ``shared_memory_per_block_optin`` on a CUDA device, the H100's
    (:data:`H100_SMEM_OPTIN`) for any other device or none."""
    import torch

    dev = None if device is None else torch.device(device)
    if dev is None or dev.type != "cuda":
        return H100_SMEM_OPTIN
    return _card_budget(dev.index if dev.index is not None else torch.cuda.current_device())


_budgets: dict[int, int] = {}


def _card_budget(index: int) -> int:
    budget = _budgets.get(index)
    if budget is None:
        import torch

        budget = int(torch.cuda.get_device_properties(index).shared_memory_per_block_optin)
        _budgets[index] = budget
    return budget


def check_launch(l2p: int, l2s: int | None, budget: int | None = None,
                 split: int | None = None) -> SmemEstimate:
    """Model ONE concrete launch (the ``--check`` hook; a fused launch at
    ``split``, None for its width's default) and raise
    :class:`SmemBudgetError` when its block needs more shared memory than
    ``budget`` (the H100's when None)."""
    budget = H100_SMEM_OPTIN if budget is None else int(budget)
    tile = (estimate_packed(l2s, budget=budget) if l2s is not None
            else estimate_fused(l2p, budget=budget, split=split))[0]
    if tile.total_bytes > budget:
        raise SmemBudgetError(
            f"dispatch planned a launch past the card's shared memory: "
            f"{tile.describe()}; the fused kernel fits L2P up to "
            f"{max_fused_l2p(budget)} here. Split Seq2 over a ring "
            "(--mesh seq:N) or shorten it"
        )
    return tile


# ---- the card's own attributes ----------------------------------------------


def kernel_attributes() -> dict[str, dict]:
    """``{kernel: {"registers", "static_bytes", "max_threads"}}`` of the
    production builds, read on the card through ``cudaFuncGetAttributes``
    (``fused_scorer_attrs`` and ``packed_scorer_attrs`` in ``csrc/``)."""
    import ctypes

    from ..ops import _build

    def read(fn, *args):
        regs, static, threads = ctypes.c_int(), ctypes.c_longlong(), ctypes.c_int()
        err = fn(*args, ctypes.byref(regs), ctypes.byref(static), ctypes.byref(threads))
        if err:
            raise SmemBudgetError(f"cudaFuncGetAttributes failed: CUDA error {err}")
        return {"registers": regs.value, "static_bytes": static.value,
                "max_threads": threads.value}

    fused = _build.load("fused_scorer").fused_scorer_attrs
    packed = _build.load("packed_scorer").packed_scorer_attrs
    for fn in (fused, packed):
        fn.restype = ctypes.c_int
    out = {"fused_tile": read(fused, 0), "fused_finish": read(fused, 1)}
    for c in PACK_CLASSES:
        out[f"packed_tile_{c}"] = read(packed, c, 0)
        out[f"packed_finish_{c}"] = read(packed, c, 1)
    return out


def _model_of(kernel: str) -> SmemEstimate:
    if kernel.startswith("fused_"):
        tile, finish = estimate_fused(_TILE)
        return tile if kernel == "fused_tile" else finish
    _, part, cls = kernel.split("_")
    tile, finish = estimate_packed(int(cls))
    return tile if part == "tile" else finish


#: Blocks an SM each kernel's ``__launch_bounds__`` asks for.
_MIN_BLOCKS = {"fused_tile": 2, "fused_finish": 1, "packed_tile": 48 // PACKED_WARPS,
               "packed_finish": 1}


def register_cap(kernel: str, threads: int) -> int:
    """Registers a thread the kernel's ``__launch_bounds__`` leave ptxas:
    64K over (max threads x min blocks), at most 255."""
    base = kernel if kernel.startswith("fused_") else "_".join(kernel.split("_")[:2])
    return min(255, REGS_PER_SM // (threads * _MIN_BLOCKS[base]))


def audit_attributes(attrs: dict[str, dict]) -> list[dict]:
    """Hold the card's attributes (:func:`kernel_attributes`) against the
    model: one row a kernel; raises :class:`SmemBudgetError` listing every
    kernel whose static shared memory leaves ``[model, model +
    STATIC_SLACK]``, whose registers pass its launch-bounds cap, or whose
    registers differ from :data:`EXPECTED_REGISTERS`."""
    rows, bad = [], []
    for kernel in sorted(attrs):
        got = attrs[kernel]
        model = _model_of(kernel)
        cap = register_cap(kernel, got["max_threads"])
        row = {
            "kernel": kernel,
            "registers": got["registers"],
            "expected_registers": EXPECTED_REGISTERS[kernel],
            "register_cap": cap,
            "static_bytes": got["static_bytes"],
            "model_static_bytes": model.static_bytes,
            "max_threads": got["max_threads"],
        }
        rows.append(row)
        if not model.static_bytes <= got["static_bytes"] <= model.static_bytes + STATIC_SLACK:
            bad.append(f"{kernel}: static shared memory {got['static_bytes']} B, model "
                       f"{model.static_bytes} B")
        if got["registers"] > cap:
            bad.append(f"{kernel}: {got['registers']} registers past its "
                       f"launch-bounds cap {cap}")
        if got["registers"] != EXPECTED_REGISTERS[kernel]:
            bad.append(f"{kernel}: {got['registers']} registers, ptxas gave "
                       f"{EXPECTED_REGISTERS[kernel]} (PERF.md)")
    if bad:
        raise SmemBudgetError(
            "kernel attributes drifted from the model:\n  " + "\n  ".join(bad)
            + "\nRe-measure (chip_smoke.py phase 18) and update the model or "
            "EXPECTED_REGISTERS with the kernel change that moved them."
        )
    return rows
