"""The backend degrade chain (the port of ``mpi_openmp_cuda_tpu/
resilience/degrade.py``).

Under ``--degrade`` a backend that exhausts its retry budget on a chunk,
or whose kernel cannot be built or launched here
(``KernelUnavailableError``), no longer ends the run: ``run_degrading`` falls
down the chain

    cuda -> mm -> gather

rescoring the chunk (and every later one) on the next backend with a
warning on stderr.  ``mm`` is the one-hot fp32 matmul formulation
(``ops/matmul_scorer.py``, which itself routes a bucket to the gather
formulation when the fp32 window does not hold), ``gather`` the int32
gather formulation (``ops/gather_scorer.py``), exact for every weight
the int32 gate admits; neither shares code with the kernels they back
up.  The first degraded result is re-verified against the host oracle
before it is trusted: a mismatch raises
:class:`DegradedBackendMismatchError`, a ``ValueError`` and so fatal.
"""

from __future__ import annotations

from ..obs.events import log_line, publish
from .policy import KernelUnavailableError, RetryExhaustedError, RetryPolicy

DEGRADE_CHAIN = {"cuda": "mm", "mm": "gather"}

# Rows of the first degraded chunk re-verified against the oracle.
VERIFY_CAP = 32


class DegradedBackendMismatchError(ValueError):
    """A degraded backend disagreed with the host oracle (fatal)."""


class MaterialisedRows:
    """A pending-compatible wrapper for rows a degraded backend scored
    synchronously."""

    def __init__(self, rows):
        self._rows = rows

    def prefetch(self) -> None:
        pass

    def result(self):
        return self._rows


class BackendDegrader:
    """Chain state for one run: the live scorer and how far it has
    fallen.  ``make_scorer(backend)`` builds a replacement on the same
    device; ``enabled=False`` makes the object a pass-through."""

    def __init__(self, scorer, make_scorer, *, enabled: bool = False, log=None):
        self.scorer = scorer
        self._make = make_scorer
        self.enabled = enabled
        self.verified = False  # first degraded result oracle-checked yet?
        self._log = log or log_line
        self._built: dict[str, object] = {}

    def step(self, why: str = "exhausted its retry budget") -> str | None:
        """Fall one link down the chain; the new backend's name, or None
        when the chain is exhausted."""
        nxt = DEGRADE_CHAIN.get(self.scorer.backend)
        if nxt is None:
            return None
        publish("degrade.transition", frm=self.scorer.backend, to=nxt)
        self._log(
            f"mpi_openmp_cuda_tpu_torch: warning: backend {self.scorer.backend!r} "
            f"{why}; degrading to {nxt!r} (the first degraded chunk is "
            "re-verified against the host oracle)"
        )
        scorer = self._built.get(nxt)
        if scorer is None:
            scorer = self._built[nxt] = self._make(nxt)
        self.scorer = scorer
        return nxt


def verify_rows_against_oracle(seq1_codes, seq2_codes, weights, rows) -> None:
    """Compare up to :data:`VERIFY_CAP` rows with ``ops/oracle.py``."""
    from ..ops.oracle import score_batch_oracle

    k = min(len(seq2_codes), VERIFY_CAP)
    if k == 0:
        return
    want = score_batch_oracle(seq1_codes, list(seq2_codes)[:k], weights)
    got = [tuple(int(x) for x in row) for row in list(rows)[:k]]
    if got != [tuple(int(x) for x in w) for w in want]:
        raise DegradedBackendMismatchError(
            "degraded backend disagrees with the host oracle on the first "
            f"{k} sequences of the degraded chunk; refusing to continue"
        )


def run_degrading(
    policy: RetryPolicy,
    degrader: BackendDegrader | None,
    attempt,
    rescore,
    describe: str,
    *,
    budget=None,
    verify=None,
    wrap=None,
):
    """``policy.run(attempt)``, falling down the chain when the budget is
    exhausted or the kernel is unavailable.  ``rescore(scorer)`` rescores
    the same work on the degraded scorer under a fresh budget per link;
    ``verify(rows)`` runs once on the first degraded result; ``wrap(rows)``
    adapts it to the caller's return type.  With the degrader disabled or
    None this is exactly ``policy.run``."""
    try:
        return policy.run(attempt, describe, budget=budget)
    except (RetryExhaustedError, KernelUnavailableError) as failed:
        if degrader is None or not degrader.enabled:
            raise
        last = failed
        while True:
            why = ("cannot run its kernel here"
                   if isinstance(last, KernelUnavailableError)
                   else "exhausted its retry budget")
            backend = degrader.step(why)
            if backend is None:
                raise last
            try:
                rows = policy.run(
                    lambda: rescore(degrader.scorer),
                    f"{describe} [degraded:{backend}]",
                    budget=policy.new_budget(),
                )
            except (RetryExhaustedError, KernelUnavailableError) as e:
                last = e
                continue
            if verify is not None and not degrader.verified:
                verify(rows)
                degrader.verified = True
            return wrap(rows) if wrap is not None else rows
