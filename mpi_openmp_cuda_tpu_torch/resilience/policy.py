"""The retry/backoff policy (the port of ``mpi_openmp_cuda_tpu/resilience/
policy.py``).

One :class:`RetryPolicy` per run owns three decisions:

* **classification** — :data:`FATAL_ERROR_TYPES` propagate untouched,
  everything else derived from ``Exception`` is transient and retried.
  Fatal: ``ValueError`` and ``TypeError`` (bad input, programming
  errors), :class:`KernelUnavailableError` (a kernel that failed to
  build, load or launch: compiling it again gives the same answer), and a
  fault of the CUDA context — :class:`DeviceFaultError` from the port's
  own launches and ``torch.AcceleratorError`` from torch's (an illegal
  address leaves the context unusable for every later call).  Transient:
  any other ``RuntimeError``, including ``torch.OutOfMemoryError`` (memory
  held by a request that finished frees up), the injected
  ``InjectedFaultError`` and the watchdog's ``DeadlineExpiredError``.
  ``BaseException`` that is not an ``Exception`` (the drain's
  ``DrainInterrupt``, ``KeyboardInterrupt``) is never caught.
* **attempt budget** — ``retries`` extra attempts per budget; a budget
  is a one-element list, so a chunk's dispatch and materialise share one.
* **backoff** — exponential with deterministic jitter seeded by
  ``(seed, describe, attempt)`` only.

A transient failure past the budget raises :class:`RetryExhaustedError`
chaining the last cause: the signal the degrade chain keys on.
"""

from __future__ import annotations

import random
import time

import torch

from ..obs.events import log_line, publish


class KernelUnavailableError(RuntimeError):
    """A kernel cannot run here: nvcc is missing, its build or load
    failed, or its launch was refused (no image for this device, a bad
    launch configuration).  Fatal (never retried); ``--degrade`` steps
    past it to the next backend."""


class DeviceFaultError(RuntimeError):
    """A launch reported a sticky fault of the CUDA context (illegal
    address, illegal instruction, launch failure): every later call on the
    context fails too, so it is fatal and not degradable."""


_ACCELERATOR_ERROR = getattr(torch, "AcceleratorError", None)

FATAL_ERROR_TYPES = (
    ValueError, TypeError, KernelUnavailableError, DeviceFaultError,
) + ((_ACCELERATOR_ERROR,) if _ACCELERATOR_ERROR is not None else ())

_DEFAULT_BACKOFF_BASE = 0.05
_DEFAULT_BACKOFF_FACTOR = 2.0
_DEFAULT_BACKOFF_CAP = 2.0


class RetryExhaustedError(RuntimeError):
    """A transient failure outlived its retry budget; ``__cause__`` is the
    last underlying error."""


class RetryPolicy:
    """Attempt budget + backoff + classification for one run; ``sleep``
    and ``log`` are injectable for tests."""

    def __init__(
        self,
        retries: int = 0,
        *,
        backoff_base: float | None = None,
        backoff_factor: float = _DEFAULT_BACKOFF_FACTOR,
        backoff_cap: float = _DEFAULT_BACKOFF_CAP,
        seed: int = 0,
        sleep=time.sleep,
        log=None,
    ):
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        self.retries = int(retries)
        if backoff_base is None:
            from ..utils.env import env_float

            backoff_base = env_float("SEQALIGN_BACKOFF_BASE", _DEFAULT_BACKOFF_BASE)
        self.backoff_base = float(backoff_base)
        self.backoff_factor = float(backoff_factor)
        self.backoff_cap = float(backoff_cap)
        self.seed = int(seed)
        self._sleep = sleep
        self._log = log or log_line

    @staticmethod
    def is_fatal(exc: BaseException) -> bool:
        return isinstance(exc, FATAL_ERROR_TYPES)

    def new_budget(self) -> list[int]:
        """A fresh shared attempt counter."""
        return [0]

    def backoff_delay(self, attempt: int, describe: str) -> float:
        """Delay before retry ``attempt`` (1-based) at ``describe``:
        exponential, capped, jittered in [0.5x, 1.5x) by a PRNG seeded
        from (seed, describe, attempt) alone."""
        if self.backoff_base <= 0:
            return 0.0
        raw = min(self.backoff_cap, self.backoff_base * self.backoff_factor ** (attempt - 1))
        return raw * (0.5 + random.Random(f"{self.seed}:{describe}:{attempt}").random())

    def run(self, fn, describe: str, budget: list[int] | None = None):
        """``fn()`` absorbing up to ``retries`` transient failures drawn
        from ``budget`` (a fresh one when None)."""
        used = self.new_budget() if budget is None else budget
        while True:
            try:
                return fn()
            except FATAL_ERROR_TYPES:
                raise
            except Exception as e:
                used[0] += 1
                publish("retry.attempt", site=describe, attempt=used[0])
                if used[0] > self.retries:
                    raise RetryExhaustedError(
                        f"{describe}: retry budget exhausted after "
                        f"{used[0]} attempts ({e})"
                    ) from e
                delay = self.backoff_delay(used[0], describe)
                suffix = f" in {delay:.2f}s" if delay > 0 else ""
                self._log(
                    f"mpi_openmp_cuda_tpu_torch: {describe} attempt {used[0]} "
                    f"failed ({e}); retrying{suffix}"
                )
                if delay > 0:
                    publish("retry.backoff", site=describe, delay=delay)
                    self._sleep(delay)
