"""The issue-rate probe: ``csrc/issue_probe.cu``, its plain PyTorch
version, and the rate function (counterpart of ``bench.py::
vpu_probe_gelems`` in the JAX package).

For each op class the scorer's bound is built from (``fma``: fp32 FFMA;
``arith``: int32 ``y * 3 + 1``; ``lookup``: ``y = tab[y]`` over a
729-entry permutation in shared memory), :func:`issue_probe` runs
``CHAINS`` independent dependent chains per thread for ``iters`` steps
from the start words ``init`` (word ``chain * nthreads + thread``), on the
kernel for CUDA tensors and on :func:`issue_probe_plain` for CPU tensors.
:func:`issue_probe_gelems` measures the card's sustained rate of one op,
in elements per second, from two chain lengths; it runs only on the card.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..utils.timing import time_ms
from . import _build
from .costs import PEAK_PER_S

# Kernel launches per wrapper: incremented only where a kernel is launched.
launch_counts = {"issue_probe": 0}

OPS = ("fma", "arith", "lookup")
THREADS = 128  # per block
CHAINS = 8  # independent chains per thread (kChains in the source)
UNROLL = 16  # steps per chain per loop trip (kUnroll); iters % UNROLL == 0
TABLE = 729  # lookup permutation entries, as the 27 x 27 value table
BANKS = 32
PERM_SEED = 0
# y = fmaf(y, c, d), the float32 values of 1.0000001 and 1e-7: each step
# moves a start value in [1, 2) by 1 to 3 ulps.
FMA_C, FMA_D = float(np.float32(1.0000001)), float(np.float32(1e-7))
ARITH_M, ARITH_A = 3, 1  # y = y * m + a, int32 wrap-around
# The long chain of a rate measurement takes at least this long at the
# op's data-sheet peak; the short one is an eighth of it.
LONG_CHAIN_S = 0.012
RATE_REPS = 3
# A rate above this share of the op's data-sheet peak is a broken probe.
MAX_PEAK_SHARE = 1.05


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def lookup_table() -> np.ndarray:
    """[729] int32 permutation that keeps every entry in its shared-memory
    bank (index mod 32): each residue class is shuffled within itself,
    from ``default_rng(PERM_SEED)``."""
    rng = np.random.default_rng(PERM_SEED)
    perm = np.empty(TABLE, dtype=np.int32)
    for bank in range(BANKS):
        cls = np.arange(bank, TABLE, BANKS)
        perm[cls] = rng.permutation(cls)
    return perm


def probe_init(op: str, nthreads: int) -> np.ndarray:
    """[CHAINS * nthreads] int32 start words (floats as their bits for
    ``fma``).  ``lookup``: lane l of each warp starts in bank l, at an entry
    that differs by warp and chain; ``arith``: the word index; ``fma``:
    values in [1, 2)."""
    j = np.arange(CHAINS * nthreads, dtype=np.int64)
    if op == "lookup":
        chain, gt = j // nthreads, j % nthreads
        rows = TABLE // BANKS  # 22 full bank rows: entries < 704
        return (gt % BANKS + BANKS * ((gt // BANKS + chain) % rows)).astype(np.int32)
    if op == "arith":
        return j.astype(np.int32)
    if op == "fma":
        return (1.0 + (j % 1024) / 1024.0).astype(np.float32).view(np.int32)
    raise ValueError(f"unknown probe op {op!r}; expected one of {OPS}")


# ---- plain version ----------------------------------------------------------


def issue_probe_plain(op: str, init: torch.Tensor, iters: int, perm: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/issue_probe.cu``: the same chains,
    each exact.  ``arith`` runs in int64 masked to 32 bits and ``lookup``
    is a gather.  ``fma`` computes ``y * c + d`` in float64 and rounds it
    once to float32, as ``fmaf`` does: for y in [1, 4) the exact sum has
    bits from 2^1 down to 2^-47 (d's last bit), 49 of float64's 53, so the
    float64 step itself does not round."""
    if op == "fma":
        c, d = (torch.tensor(v, dtype=torch.float64, device=init.device)
                for v in (FMA_C, FMA_D))
        y = init.view(torch.float32).clone()
        for _ in range(iters):
            y = torch.addcmul(d, y.double(), c).float()
        return y.view(torch.int32)
    if op == "arith":
        y = init.long() & 0xFFFFFFFF
        for _ in range(iters):
            y = (y * ARITH_M + ARITH_A) & 0xFFFFFFFF
        return (y - ((y >> 31) << 32)).int()
    if op == "lookup":
        y, p = init.long(), perm.long()
        for _ in range(iters):
            y = p[y]
        return y.int()
    raise ValueError(f"unknown probe op {op!r}; expected one of {OPS}")


# ---- kernel wrapper ---------------------------------------------------------


@functools.cache
def _entry():
    fn = _build.load("issue_probe").issue_probe_launch
    fn.restype = ctypes.c_int
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # op, perm, in, out, blocks, iters, c, d, m, a, stream
    fn.argtypes = [i, p, p, p, i, i, f, f, i, i, p]
    return fn


def _check(op: str, init: torch.Tensor, iters: int, perm: torch.Tensor) -> str:
    if op not in OPS:
        raise ValueError(f"unknown probe op {op!r}; expected one of {OPS}")
    if iters < 0 or iters % UNROLL:
        raise ValueError(f"iters must be a non-negative multiple of {UNROLL}, got {iters}")
    if init.device != perm.device:
        raise ValueError(f"init on {init.device}, perm on {perm.device}")
    for name, t, n in (("init", init, None), ("perm", perm, TABLE)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor")
        if n is not None and t.numel() != n:
            raise ValueError(f"{name} must hold {n} words, got {t.numel()}")
    if init.numel() % (CHAINS * THREADS) or not init.numel():
        raise ValueError(f"init must hold a positive multiple of {CHAINS * THREADS} words")
    kind = init.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"probe operands must be on cpu or cuda, got {kind}")
    return kind


def issue_probe(op: str, init: torch.Tensor, iters: int, perm: torch.Tensor) -> torch.Tensor:
    """The chains' final words from ``csrc/issue_probe.cu`` (CUDA tensors)
    or :func:`issue_probe_plain` (CPU tensors)."""
    if _check(op, init, iters, perm) == "cpu":
        return issue_probe_plain(op, init, iters, perm)
    out = torch.empty_like(init)
    blocks = init.numel() // (CHAINS * THREADS)
    with torch.cuda.device(init.device):
        err = _entry()(
            OPS.index(op), ctypes.c_void_p(perm.data_ptr()),
            ctypes.c_void_p(init.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            blocks, iters, FMA_C, FMA_D, ARITH_M, ARITH_A,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    if err != 0:
        raise RuntimeError(f"issue_probe launch failed: CUDA error {err}")
    launch_counts["issue_probe"] += 1
    return out


# ---- the rate ---------------------------------------------------------------


def resident_blocks(device: torch.device) -> int:
    """:data:`THREADS`-thread blocks the card holds at once by its thread
    limit (SMs x threads an SM / 128: 2112 on an H100), the probe's one
    wave; 0 off the card."""
    if device.type != "cuda":
        return 0
    prop = torch.cuda.get_device_properties(device)
    return prop.multi_processor_count * (prop.max_threads_per_multi_processor // THREADS)


def probe_operands(op: str, device):
    """(init, perm) on ``device`` for one full wave of blocks (the card's
    resident blocks)."""
    dev = torch.device(device)
    init = torch.from_numpy(probe_init(op, resident_blocks(dev) * THREADS)).to(dev)
    return init, torch.from_numpy(lookup_table()).to(dev)


def long_iters(op: str, nthreads: int) -> int:
    """Steps per chain for a launch of at least :data:`LONG_CHAIN_S` at the
    op's data-sheet peak."""
    steps = PEAK_PER_S[op] * LONG_CHAIN_S / (nthreads * CHAINS)
    return UNROLL * math.ceil(steps / UNROLL)


def issue_probe_gelems(op: str, device="cuda") -> float:
    """The card's sustained rate of ``op`` in elements/s: one full wave of
    blocks, a short and a long chain (:func:`long_iters`), each timed over
    :data:`RATE_REPS` back-to-back launches (``utils.timing.time_ms``), the
    element difference over the time difference, so launch and prologue
    cancel.  Raises off the card, and on a rate at or below 0 or above
    :data:`MAX_PEAK_SHARE` of the op's data-sheet peak."""

    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            f"the issue-rate probe measures a CUDA device; got {dev} "
            f"(CUDA available: {torch.cuda.is_available()})"
        )
    init, perm = probe_operands(op, dev)
    nthreads = init.numel() // CHAINS
    hi = long_iters(op, nthreads)
    lo = UNROLL * max(1, hi // (8 * UNROLL))
    ms = {}
    for iters in (lo, hi):
        ms[iters] = time_ms(lambda n=iters: issue_probe(op, init, n, perm), RATE_REPS)
    dt = (ms[hi] - ms[lo]) / 1e3
    rate = nthreads * CHAINS * (hi - lo) / dt if dt > 0 else 0.0
    check_rate(op, rate)
    return rate


def check_rate(op: str, rate: float) -> None:
    """Raise unless 0 < ``rate`` <= :data:`MAX_PEAK_SHARE` x peak."""
    peak = PEAK_PER_S[op]
    if not 0 < rate <= MAX_PEAK_SHARE * peak:
        raise RuntimeError(
            f"issue probe {op}: {rate:.4g} elements/s is outside (0, "
            f"{MAX_PEAK_SHARE:.0%} of the data-sheet peak {peak:.4g}]"
        )
