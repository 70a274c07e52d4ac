"""Kernel-build counter: the port's recompile detector (the counterpart of
``mpi_openmp_cuda_tpu/analysis/recompile.py``).

A warm process should make no cold start of a launch shape: the kernels
are built and loaded once, and a width past the default shared memory
opts in once.  A stray one (a kernel source whose digest moved, a library
that is loaded again, a width that opts in on every call) multiplies
latency without failing a correctness test.  This harness turns that
count into a pinned, assertable number.

Signal: ``ops/_build.py::build_count``, which counts every ``nvcc``
build, library load and lazy per-width setup of this process (each also
publishes the ``recompile`` obs event).  It is monotonic, so the harness
reports deltas, as the JAX one does over XLA's compile event.  The serve
loop's ``serve_steady_compiles`` gauge reads the same counter.
"""

from __future__ import annotations

import contextlib

from . import SeqcheckError


def compile_count() -> int:
    """The process's kernel builds, library loads and per-width setups so
    far (monotonic; compare deltas, not absolutes)."""
    from ..ops._build import build_count

    return build_count()


class CompileTally:
    """Result handle for :func:`count_compiles`: ``.count`` is live inside
    the block and frozen after it."""

    def __init__(self, start: int):
        self._start = start
        self._end: int | None = None

    @property
    def count(self) -> int:
        end = self._end if self._end is not None else compile_count()
        return end - self._start

    def _freeze(self) -> None:
        self._end = compile_count()


@contextlib.contextmanager
def count_compiles():
    """``with count_compiles() as tally:`` — ``tally.count`` is the number of
    builds, loads and per-width setups made inside the block."""
    tally = CompileTally(compile_count())
    try:
        yield tally
    finally:
        tally._freeze()


@contextlib.contextmanager
def assert_compiles(expected: int | None = None, *, at_most: int | None = None):
    """Pin the builds of a block: exact (``expected``) or bounded
    (``at_most``).  Raises :class:`SeqcheckError` naming the breach; the
    steady-state form is ``assert_compiles(0)`` around a warm scoring
    call."""
    if (expected is None) == (at_most is None):
        raise ValueError("pass exactly one of expected= / at_most=")
    with count_compiles() as tally:
        yield tally
    n = tally.count
    if expected is not None and n != expected:
        raise SeqcheckError(
            f"recompile detector: block made {n} kernel build(s), load(s) or "
            f"setup(s), pinned expectation is {expected}. A higher count means a "
            "warm path built or loaded a kernel again (a source digest that "
            "moved, a library loaded twice, a width opting in on every call); "
            "lower means the pin is stale: update it WITH the change that "
            "removed the build."
        )
    if at_most is not None and n > at_most:
        raise SeqcheckError(
            f"recompile detector: block made {n} kernel build(s), load(s) or "
            f"setup(s), bound is {at_most}: a warm path built a kernel again."
        )
