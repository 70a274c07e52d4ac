"""The two Hopper scorer kernels, their plain PyTorch versions, and the
chunked scoring entry (counterpart of ``mpi_openmp_cuda_tpu/ops/
pallas_scorer.py``).

Both kernels compute, for each padded (Seq1, Seq2) pair, one int32 row
``[score, n, k, eq]``: the best candidate over offsets ``n < len1 - len2``
and hyphen positions ``k`` (k = 0: hyphen after the end) with the
reference's first-hit tie-break (offset-major, k ascending with k = 0
first), and ``eq``, the k = 0 score at n = 0.  Pairs without a valid
offset carry ``(INT32_MIN, 0, 0)``.  The O(B) epilogue
(:func:`finish_rows`) applies the equal-length and unsearchable rules, as
``_pallas_rows`` does.

Each wrapper has two modes.  Raw (``done`` None): the ``[B, 4]`` rows, for
callers whose rows are candidates (the Seq1 ring, the sweep scripts).
Finished (``done`` an int32 ``[count, 3]`` tensor): each pair's answer
row, ``finish_rows`` of its raw row, written at ``done[dst[b]]`` (``dst``
int64 ``[B]``) or, with ``dst`` None, at ``done[row0 + b]``: on the card
by the kernels' finish kernels themselves (``csrc/finish_rows.cuh``), so a
dispatch runs no PyTorch epilogue; in the plain versions by
:func:`finish_rows` and a scatter.  Rows finished by a kernel count in
``epilogue_kernel_rows``, rows finished by :func:`finish_rows` in
``epilogue_torch_rows`` (obs counters).

* :func:`fused_scorer` — ``csrc/fused_scorer.cu`` (kernels in
  ``csrc/fused_kernels.cuh``), for every bucket the packed one does not
  take;
* :func:`packed_scorer` — ``csrc/packed_scorer.cu``, for L2P = 128
  buckets whose every len2 fits a packing class ``l2s``
  (``dispatch.choose_rowpack``).

:func:`window_state` builds the state of one window of the Seq1 ring
(``parallel/ring.py``), whose block-local Seq1 length may lie outside
``[0, L1P]``; the fused kernel takes it as it is.  :func:`check_smem`
refuses a fused launch whose row width needs more shared memory than the
card gives a block.

Each wrapper runs its kernel on CUDA tensors and its plain version
(:func:`fused_scorer_plain`, :func:`packed_scorer_plain`) on CPU tensors
only; on any other device it raises, as it does for codes that are not
uint8 (it never converts them).  ``launch_counts`` counts the kernel
launches, so a run can show which kernels its main path went through;
with the obs plane armed the run report counts them too
(``fused_scorer_launches``, ``packed_scorer_launches``).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..obs.metrics import inc as _obs_inc
from ..resilience.policy import DeviceFaultError, KernelUnavailableError
from ..utils.constants import ALPHABET_SIZE, INT32_MIN
from . import _build

# Kernel launches per wrapper: incremented only where a kernel is launched.
launch_counts = {"fused_scorer": 0, "packed_scorer": 0}
_count_lock = threading.Lock()
# Their counters in the run report, when the obs plane is armed.
_REPORT_COUNTERS = {name: f"{name}_launches" for name in launch_counts}

TILE = 128  # offsets per kernel block (one tile); L1P is a multiple of it
PACK_CLASSES = (8, 16, 32, 64)

# Max live int32 elements of one [pairs, offsets, chars] slab in the plain
# versions (64 MiB); pairs are scored in chunks below it.
PLAIN_CHUNK_ELEMS = 16 * 1024 * 1024


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


@dataclass(frozen=True)
class ScorerState:
    """The operands of one padded bucket, as tensors on one device.

    ``seq1ext`` [L1P + L2P + 1] uint8 Seq1 codes, zero-padded; ``rows``
    [B, L2P] uint8 Seq2 codes, zero-padded; ``lens`` [B] int32; ``val``
    [27, 27] int32 value table with row and column 0 (the pad code)
    zeroed, so padded positions add nothing and no kernel needs a per-char
    mask.  Codes are 0..26, exact in a byte; every sum is int32.
    ``max_len2`` is the longest row, known on the host (the packed
    kernel's class check).  ``split``: the segments a (pair, tile) the
    fused kernel runs for these rows, 1 .. 16
    (``schedule.choose_split``), None for its width's default; the rows
    scored do not depend on it."""

    seq1ext: torch.Tensor
    len1: int
    rows: torch.Tensor
    lens: torch.Tensor
    val: torch.Tensor
    max_len2: int
    split: int | None = None

    @property
    def l1p(self) -> int:
        return self.seq1ext.shape[0] - self.rows.shape[1] - 1


def kernel_table(val_flat) -> np.ndarray:
    """[27, 27] int32 copy of the [729] value table with row and column 0
    (the pad code) zeroed, so padded positions add nothing."""
    val = np.array(val_flat, dtype=np.int32).reshape(ALPHABET_SIZE, ALPHABET_SIZE)
    val[0, :] = 0
    val[:, 0] = 0
    return val


def state_from_numpy(seq1ext, len1, rows, lens, val_flat, device) -> ScorerState:
    """The port's tensors from the JAX package's numpy operands
    (``dispatch.PaddedBatch`` fields plus ``value_table(w).reshape(-1)``),
    so both packages can be fed the same bytes."""
    return _numpy_state(seq1ext, len1, rows, lens, val_flat, device, window=False)


def window_state(win_k, len1_eff, rows, lens, val_flat, device) -> ScorerState:
    """The state of one Seq1 ring window (``parallel/ring.py``) from the
    JAX ring's own numpy operands: ``win_k`` the shard's ``[Bs + L2P + 1]``
    window (so L1P = Bs) and ``len1_eff = len1 - d * Bs`` its block-local
    Seq1 length, which may lie outside ``[0, L1P]``: above it on shard 0
    (every offset of the window valid), zero or below on a shard past the
    end of Seq1 (no offset valid).  The kernel's offset mask ``n < len1_eff
    - len2`` then agrees with the global one."""
    return _numpy_state(win_k, len1_eff, rows, lens, val_flat, device, window=True)


def _numpy_state(seq1ext, len1, rows, lens, val_flat, device, *, window) -> ScorerState:
    seq1ext = np.asarray(seq1ext)
    rows = np.asarray(rows)
    lens = np.asarray(lens, dtype=np.int32)
    val = kernel_table(val_flat)
    b, l2p = rows.shape
    l1p = seq1ext.shape[0] - l2p - 1
    if l1p <= 0 or l1p % TILE or lens.shape != (b,):
        raise ValueError(
            f"bad operand shapes: seq1ext {seq1ext.shape}, rows {rows.shape}, "
            f"lens {lens.shape} (need L1P = len(seq1ext) - L2P - 1 > 0, a "
            f"multiple of {TILE})"
        )
    len1_ok = INT32_MIN < len1 <= 2**31 - 1 if window else 0 <= len1 <= l1p  # cert: int32-max
    if not len1_ok or (b and not (0 <= lens.min() and lens.max() <= l2p)):
        raise ValueError("lengths outside the padded shapes")
    for name, codes in (("seq1ext", seq1ext), ("rows", rows)):
        if codes.size and (codes.min() < 0 or codes.max() >= ALPHABET_SIZE):
            raise ValueError(f"{name} holds codes outside 0..{ALPHABET_SIZE - 1}")
    dev = torch.device(device)
    return ScorerState(
        seq1ext=torch.from_numpy(seq1ext.astype(np.uint8)).to(dev),
        len1=int(len1),
        rows=torch.from_numpy(rows.astype(np.uint8)).to(dev),
        lens=torch.from_numpy(lens).to(dev),
        val=torch.from_numpy(val).to(dev),
        max_len2=int(lens.max()) if b else 0,
    )


# ---- plain versions ---------------------------------------------------------


def _plain_rows(seq1ext, len1, rows, lens, val, noff) -> torch.Tensor:
    """[B, 4] int32 rows over offsets ``n < noff`` and the chars of
    ``rows``: an int32 gather + cumsum + masked first-hit argmax over
    [B, noff, L] slabs (``mpi_openmp_cuda_tpu/ops/xla_scorer.py::
    _score_pair``), in chunks of pairs to bound memory.  No kernel uses
    this formulation; the tests hold both plain versions against it."""
    b, l2 = rows.shape
    dev = rows.device
    n = torch.arange(noff, device=dev)[:, None]
    i = torch.arange(l2, device=dev)[None, :]
    win0 = seq1ext[(n + i).reshape(-1)].reshape(noff, l2).long()
    win1 = seq1ext[(n + i + 1).reshape(-1)].reshape(noff, l2).long()
    k = torch.arange(l2, device=dev)[None, None, :]
    out = torch.empty((b, 4), dtype=torch.int32, device=dev)
    cb = max(1, PLAIN_CHUNK_ELEMS // max(noff * l2, 1))
    for s in range(0, b, cb):
        r = rows[s : s + cb].long()[:, None, :]  # [cb, 1, L]
        ln = lens[s : s + cb][:, None, None]
        d0 = val[r, win0[None]]  # [cb, noff, L]
        d1 = val[r, win1[None]]
        g = torch.cumsum(d0 - d1, dim=2, dtype=torch.int32)  # G[kappa = j + 1]
        t1 = d1.sum(dim=2, keepdim=True, dtype=torch.int32)
        gend = g[:, :, -1:]  # pad chars add 0, so this is G[len2]
        # Column j holds k = j: k = 0 -> t1 + G[len2]; k >= 1 -> t1 + G[k].
        scores = torch.cat([t1 + gend, t1 + g[:, :, :-1]], dim=2)
        valid = (n[None] < len1 - ln) & ((k == 0) | (k < ln))
        flat = torch.where(valid, scores, INT32_MIN).reshape(scores.shape[0], -1)
        best = torch.argmax(flat, dim=1)  # first max: offset-major, k = 0 first
        out[s : s + cb, 0] = flat.gather(1, best[:, None])[:, 0]
        out[s : s + cb, 1] = (best // l2).int()
        out[s : s + cb, 2] = (best % l2).int()
        out[s : s + cb, 3] = (t1 + gend)[:, 0, 0]
    # All-masked pairs: argmax lands on index 0 -> (INT32_MIN, 0, 0).
    return out


def _kernel_rows(seq1ext, len1, rows, lens, val, noff) -> torch.Tensor:
    """[B, 4] int32 rows over offsets ``n < noff`` and the chars of
    ``rows``, in the kernels' own formulation.

    One gather ``e[b, n, i] = val[s2[i], s1[n + i]]`` over the diagonals
    ``n <= noff``, ``A = cumsum(e)`` over the chars, and then
    ``G[kappa](n) = A(n, kappa) - A(n + 1, kappa)``, ``t1(n) = A(n + 1,
    len2)`` and ``eq = A(0, len2)``.  k = 0 (``t1 + G[len2]``) wins every
    tie, so an offset's best score is ``t1 + max_kappa G[kappa]`` with no
    index; the first best offset is found, and k is recovered for it alone.
    Pad chars add 0, so columns past len2 repeat ``G[len2]`` and need no
    mask."""
    b, l2 = rows.shape
    dev = rows.device
    n = torch.arange(noff + 1, device=dev)[:, None]
    i = torch.arange(l2, device=dev)[None, :]
    win = seq1ext[(n + i).reshape(-1)].reshape(noff + 1, l2).long()
    kappa = i + 1  # column j holds G[kappa = j + 1]
    out = torch.empty((b, 4), dtype=torch.int32, device=dev)
    cb = max(1, PLAIN_CHUNK_ELEMS // max((noff + 1) * l2, 1))
    for s in range(0, b, cb):
        ln = lens[s : s + cb]
        e = val[rows[s : s + cb].long()[:, None, :], win[None]]  # [cb, noff + 1, L]
        a = torch.cumsum(e, dim=2, dtype=torch.int32)
        g = a[:, :-1] - a[:, 1:]  # [cb, noff, L]
        valid = n[None, :noff, 0] < (len1 - ln)[:, None]
        score = torch.where(valid, a[:, 1:, -1] + g.max(dim=2).values, INT32_MIN)
        best = torch.argmax(score, dim=1)  # first max: the smallest offset
        top = score.gather(1, best[:, None])[:, 0]
        # k of the winning offset: 0 unless some kappa < len2 beats G[len2].
        gw = g.gather(1, best[:, None, None].expand(-1, 1, l2))[:, 0]  # [cb, L]
        early = torch.where(kappa < ln[:, None], gw, INT32_MIN)
        first = torch.argmax(early, dim=1)  # first max: the smallest kappa
        beats = early.gather(1, first[:, None])[:, 0] > gw[:, -1]
        # All-masked pairs: argmax lands on offset 0 -> (INT32_MIN, 0, 0).
        k = torch.where(beats & (top > INT32_MIN), first + 1, 0)
        out[s : s + cb, 0] = top
        out[s : s + cb, 1] = best.int()
        out[s : s + cb, 2] = k.int()
        out[s : s + cb, 3] = a[:, 0, -1]
    return out


def fused_scorer_plain(state: ScorerState, done=None, dst=None, row0: int = 0) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/fused_scorer.cu``, in the kernel's
    own formulation (:func:`_kernel_rows`) over every char of the padded
    rows and the offsets ``n < L1P``: [B, 4] int32, or with ``done`` the
    finished rows written there (:func:`_store_finished`)."""
    raw = _kernel_rows(
        state.seq1ext, state.len1, state.rows, state.lens, state.val, state.l1p)
    return raw if done is None else _store_finished(raw, state, done, dst, row0)


def packed_scorer_plain(state: ScorerState, l2s: int, done=None, dst=None,
                        row0: int = 0) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/packed_scorer.cu``, in the kernel's
    own formulation (:func:`_kernel_rows`) over the first ``l2s`` chars of
    each row (every len2 <= l2s) and the offsets ``n < L1P``: [B, 4]
    int32, or with ``done`` the finished rows written there."""
    _check_pack(state, l2s)
    raw = _kernel_rows(
        state.seq1ext, state.len1, state.rows[:, :l2s], state.lens, state.val,
        state.l1p,
    )
    return raw if done is None else _store_finished(raw, state, done, dst, row0)


def _store_finished(raw, state: ScorerState, done, dst=None, row0: int = 0) -> torch.Tensor:
    """The finished mode of the plain versions: ``finish_rows`` of the raw
    rows, written into ``done`` at ``dst`` (or from ``row0`` on, in order),
    the finish kernels' contract (``csrc/finish_rows.cuh``).  Returns
    ``done``."""
    put_rows(done, finish_rows(raw, state.lens, state.len1), dst, row0)
    return done


def put_rows(done, rows, dst=None, row0: int = 0) -> None:
    """``[B, 3]`` finished rows into ``done`` at ``dst`` (int64 [B]), or
    at ``row0 ..`` when ``dst`` is None."""
    if dst is None:
        done[row0 : row0 + rows.shape[0]] = rows
    else:
        done.index_copy_(0, dst, rows)


# ---- kernel wrappers --------------------------------------------------------


def _check_pack(state: ScorerState, l2s: int) -> None:
    if l2s not in PACK_CLASSES or state.rows.shape[1] < l2s:
        raise ValueError(f"bad packing class l2s={l2s} for L2P={state.rows.shape[1]}")
    if state.max_len2 > l2s:
        raise ValueError(
            f"packing class l2s={l2s} cannot hold a row of length {state.max_len2}"
        )


def _device_of(state: ScorerState) -> str:
    devs = {t.device for t in (state.seq1ext, state.rows, state.lens, state.val)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devs))}")
    kind = devs.pop().type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"scorer operands must be on cpu or cuda, got {kind}")
    _check_dtypes(state)
    return kind


def _check_dtypes(state: ScorerState) -> None:
    """The kernels' operand types: uint8 codes, int32 lengths and table,
    all contiguous; anything else is refused, never converted."""
    for name in ("seq1ext", "rows", "lens", "val"):
        t = getattr(state, name)
        want = torch.uint8 if name in ("seq1ext", "rows") else torch.int32
        if t.dtype != want or not t.is_contiguous():
            raise ValueError(
                f"scorer operand {name} must be a contiguous {want} tensor, got "
                f"{t.dtype}{'' if t.is_contiguous() else ' (not contiguous)'}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


_POINTER, _INT = ctypes.c_void_p, ctypes.c_int
# int32 words of one (pair, tile) partial of either kernel: [score, n].
_PARTIAL_WORDS = 2
_ARGTYPES = {
    # seq1ext (uint8), len1, rows (uint8), lens, batch, l2p, split, ntiles,
    # val, partial, out, done, dst (int64), row0, stream
    "fused_scorer": (_POINTER, _INT, _POINTER, _POINTER, _INT, _INT, _INT,
                     _INT, _POINTER, _POINTER, _POINTER, _POINTER, _POINTER,
                     _INT, _POINTER),
    # seq1ext (uint8), len1, rows (uint8), lens, batch, l2p, l2s, ntiles,
    # val, partial, out, done, dst (int64), row0, stream
    "packed_scorer": (_POINTER, _INT, _POINTER, _POINTER, _INT, _INT, _INT,
                      _INT, _POINTER, _POINTER, _POINTER, _POINTER, _POINTER,
                      _INT, _POINTER),
}


def typed_entry(lib: ctypes.CDLL, name: str):
    """The C entry ``<name>_launch`` of a loaded build of
    ``csrc/<name>.cu``, typed."""
    fn = getattr(lib, f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = list(_ARGTYPES[name])
    return fn


@functools.cache
def _entry(name: str):
    """The typed C entry of the production build of ``csrc/<name>.cu``."""
    return typed_entry(_build.load(name), name)


# CUDA errors after which the context is unusable (illegal address, launch
# timeout, device-side assert, hardware stack error, illegal instruction,
# misaligned address, invalid address space, invalid PC, launch failure,
# unknown): a launch reporting one raises DeviceFaultError.  Any other
# code (no image for this device, a bad launch configuration) is the
# kernel being unusable here: KernelUnavailableError.
STICKY_CUDA_ERRORS = frozenset({700, 702, 710, 714, 715, 716, 717, 718, 719, 999})


def launch_error(name: str, err: int) -> RuntimeError:
    """The error a failed launch of ``name`` with CUDA error ``err`` raises."""
    cls = DeviceFaultError if err in STICKY_CUDA_ERRORS else KernelUnavailableError
    return cls(f"{name} failed: CUDA error {err}")


def _check_finished(state: ScorerState, done, dst) -> None:
    """The finished mode's buffers: ``done`` a contiguous int32 [count, 3]
    and ``dst`` None or a contiguous int64 [B], on the state's device."""
    dev = state.rows.device
    if (done.dtype != torch.int32 or done.dim() != 2 or done.shape[1] != 3
            or not done.is_contiguous() or done.device != dev):
        raise ValueError(f"done must be a contiguous int32 [count, 3] tensor on {dev}")
    if dst is not None and (dst.dtype != torch.int64 or dst.shape != state.lens.shape
                            or not dst.is_contiguous() or dst.device != dev):
        raise ValueError(f"dst must be a contiguous int64 [B] tensor on {dev}")


def call_entry(fn, state: ScorerState, *extra: int, done=None, dst=None,
               row0: int = 0) -> torch.Tensor:
    """One launch of a typed scorer entry on the state's CUDA device: [B, 4]
    rows, or with ``done`` the finished rows written at ``dst`` (or from
    ``row0`` on) and ``done`` returned.  ``extra`` are the kernel's own int
    arguments after ``l2p`` (the fused kernel's split, 0 for its width's
    default; the packed kernel's class).  It counts nothing: the sweep scripts call
    their own builds through it."""
    _check_dtypes(state)
    if done is not None:
        _check_finished(state, done, dst)
    b, l2p = state.rows.shape
    ntiles = state.l1p // TILE
    dev = state.rows.device
    out = torch.empty((b, 4), dtype=torch.int32, device=dev)
    partial = torch.empty((b, ntiles, _PARTIAL_WORDS), dtype=torch.int32, device=dev)
    null = ctypes.c_void_p(None)
    with torch.cuda.device(dev):
        err = fn(
            _ptr(state.seq1ext), state.len1, _ptr(state.rows), _ptr(state.lens),
            b, l2p, *extra, ntiles, _ptr(state.val), _ptr(partial), _ptr(out),
            null if done is None else _ptr(done), null if dst is None else _ptr(dst),
            row0, _stream(),
        )
    if err != 0:
        raise launch_error(fn.__name__, err)
    return out if done is None else done


def _launch(name: str, state: ScorerState, *extra: int, done=None, dst=None,
            row0: int = 0) -> torch.Tensor:
    """Launch ``csrc/<name>.cu`` on the state's CUDA device and count it."""
    out = call_entry(_entry(name), state, *extra, done=done, dst=dst, row0=row0)
    with _count_lock:  # an in-process fleet launches from several threads
        launch_counts[name] += 1
    _obs_inc(_REPORT_COUNTERS[name])
    if done is not None:
        _obs_inc("epilogue_kernel_rows", state.rows.shape[0])
    return out


@functools.cache
def _smem_entries():
    lib = _build.load("fused_scorer")
    need, limit = lib.fused_scorer_smem, lib.fused_scorer_smem_limit
    need.restype = limit.restype = ctypes.c_longlong
    need.argtypes, limit.argtypes = [_INT, _INT], []
    return need, limit


@functools.cache
def _smem_need(l2p: int, split: int = 0) -> int:
    return int(_smem_entries()[0](l2p, split))


@functools.cache
def _smem_limit(device: torch.device) -> int:
    with torch.cuda.device(device):
        limit = _smem_entries()[1]()
    if limit < 0:
        raise launch_error("fused_scorer_smem_limit", int(-limit))
    return int(limit)


# A launch's dynamic shared memory without opting in (kDefaultSmem in
# csrc/fused_kernels.cuh); the (width, split) launches past it that opted
# in so far.
DEFAULT_SMEM = 48 * 1024
_opted_in: set[tuple[int, int]] = set()


def check_smem(state: ScorerState, split: int = 0) -> int:
    """The tile kernel's dynamic shared memory at the state's L2P and
    ``split`` (0: the width's default), in bytes, or
    ``KernelUnavailableError`` when the state's card cannot give a block
    that much (on the H100, L2P past 84,224 at the default split).  The
    first launch of a shape past :data:`DEFAULT_SMEM` opts the kernel in
    to more, a setup ``_build.build_count`` counts."""
    l2p = state.rows.shape[1]
    need = _smem_need(l2p, split)
    limit = _smem_limit(state.rows.device)
    if need > limit:
        raise KernelUnavailableError(
            f"fused_scorer: a Seq2 bucket of width L2P {l2p} needs {need} bytes of "
            f"shared memory a block, more than the {limit} this card allows"
        )
    if need > DEFAULT_SMEM and (l2p, split) not in _opted_in:
        _opted_in.add((l2p, split))
        _build.note_setup()
    return need


def load_kernels() -> None:
    """Build (if missing) and load both scorer kernels and their shared
    memory queries now, so no later launch pays a build or a load (the
    serve loop calls it before its first tick)."""
    for name in launch_counts:
        _entry(name)
    _smem_entries()


def fused_scorer(state: ScorerState, done=None, dst=None, row0: int = 0) -> torch.Tensor:
    """[B, 4] int32 rows from ``csrc/fused_scorer.cu`` (CUDA tensors) or
    :func:`fused_scorer_plain` (CPU tensors); with ``done``, the finished
    rows written there (the module's note) and ``done`` returned.  The
    kernel runs at the state's split."""
    if _device_of(state) == "cpu":
        return fused_scorer_plain(state, done, dst, row0)
    if state.rows.shape[1] % 4:
        raise ValueError(
            f"fused_scorer needs L2P a multiple of 4, got {state.rows.shape[1]}")
    split = state.split or 0  # 0: the width's default
    check_smem(state, split)
    return _launch("fused_scorer", state, split, done=done, dst=dst, row0=row0)


def packed_scorer(state: ScorerState, l2s: int, done=None, dst=None,
                  row0: int = 0) -> torch.Tensor:
    """[B, 4] int32 rows from ``csrc/packed_scorer.cu`` (CUDA tensors) or
    :func:`packed_scorer_plain` (CPU tensors); every len2 <= ``l2s``; with
    ``done``, the finished rows written there."""
    if _device_of(state) == "cpu":
        return packed_scorer_plain(state, l2s, done, dst, row0)
    _check_pack(state, l2s)
    return _launch("packed_scorer", state, l2s, done=done, dst=dst, row0=row0)


# ---- epilogue and chunked entry ---------------------------------------------


def finish_rows(raw: torch.Tensor, lens: torch.Tensor, len1: int) -> torch.Tensor:
    """O(B) epilogue on [B, 4] kernel rows -> [B, 3] (score, n, k): the
    positional ``eq`` score when len2 == len1, ``(INT32_MIN, 0, 0)`` when
    len2 > len1 or len2 == 0 (``_pallas_rows`` in the JAX package).  The
    referee of the finish kernels' finished mode; counted in
    ``epilogue_torch_rows``."""
    _obs_inc("epilogue_torch_rows", raw.shape[0])
    searchable = (lens < len1) & (lens > 0)
    equal = lens == len1
    score = torch.where(equal, raw[:, 3], raw[:, 0])
    score = torch.where(searchable | equal, score, INT32_MIN)
    zero = torch.zeros_like(raw[:, 1])
    out_n = torch.where(searchable, raw[:, 1], zero)
    out_k = torch.where(searchable, raw[:, 2], zero)
    return torch.stack([score, out_n, out_k], dim=1)


def score_rows(state: ScorerState, l2s: int | None = None) -> torch.Tensor:
    """[B, 3] int32 finished rows of one padded bucket: the packed kernel
    when the dispatch chose a class ``l2s``, else the fused kernel."""
    done = torch.empty((state.rows.shape[0], 3), dtype=torch.int32, device=state.rows.device)
    if l2s is None:
        return fused_scorer(state, done)
    return packed_scorer(state, l2s, done)


def score_chunks_cuda_body(
    seq1ext, len1, seq2_chunks, len2_chunks, val_flat, *, l2s=None, max_len2=None
):
    """Chunked-batch entry, the contract of ``score_chunks_pallas_body``:
    int32 tensors ``[NC, CB, L2P]`` rows and ``[NC, CB]`` lens on one
    device -> ``[NC, CB, 3]`` int32.  The chunks are scored in one launch,
    their codes (0..26) cast to the kernels' uint8 here.  ``val_flat`` is
    the [729] spec value table (pad row/col zeroed here); ``max_len2``
    (host int) defaults to ``L2P``."""
    nc, cb, l2p = seq2_chunks.shape
    val = val_flat.reshape(ALPHABET_SIZE, ALPHABET_SIZE).clone()
    val[0, :] = 0
    val[:, 0] = 0
    state = ScorerState(
        seq1ext=seq1ext.to(torch.uint8).contiguous(),
        len1=int(len1),
        rows=seq2_chunks.reshape(nc * cb, l2p).to(torch.uint8).contiguous(),
        lens=len2_chunks.reshape(nc * cb).contiguous(),
        val=val.contiguous(),
        max_len2=l2p if max_len2 is None else int(max_len2),
    )
    return score_rows(state, l2s).reshape(nc, cb, 3)
