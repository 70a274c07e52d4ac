"""The chunk submit/finish machinery of the ``--stream`` CLI and the serve
loop (the port of ``mpi_openmp_cuda_tpu/io/pipeline.py``):

* :class:`ChunkPipeline` — dispatch and materialise one chunk under a
  retry budget shared by both stages, with the ``--degrade`` chain at
  both and the oracle check of the first degraded result.  All scoring
  goes through ``degrader.scorer`` at call time, so a degradation holds
  for every later chunk.  Under ``--serve --degrade`` a circuit breaker
  (``resilience/breaker.py``) watches the primary attempts and, while it
  is open, dispatch goes straight to the pinned degraded backend.
* :class:`PendingWindow` — the bounded in-flight window: each pushed
  promise's device-to-host copy starts at dispatch (``prefetch``), the
  oldest entry is finished once the window overflows (``push`` says
  whether it did), ``flush()`` drains the rest.  On a mesh the promises
  are ``parallel.sharding.ShardedPending``s, whose ``result`` is the
  gather (in a multi-process job the CLI keeps one chunk in flight: the
  chunk order is the collective schedule).
* :class:`FeedStager` — feed overlap: the next chunk's host-to-device
  copies start on a side CUDA stream (``AlignmentScorer.prestage_codes``)
  while the current chunk computes.  Advisory and single-use: a staged
  handle feeds at most one dispatch, retries stage again from the host.

:data:`stream_counts` counts, in every run, a ``--stream`` run's chunks
dispatched (``stream_chunks``) and the pushes onto its window that first
finished the oldest chunk (``stream_window_full``); with the obs plane
armed the run report counts them too.
"""

from __future__ import annotations

import collections

from ..obs.metrics import inc as _obs_inc
from ..resilience.degrade import MaterialisedRows, run_degrading, verify_rows_against_oracle
from ..resilience.policy import FATAL_ERROR_TYPES

# The stream path's chunks, in every run (as ``ops/cuda_scorer.launch_counts``).
stream_counts = {"stream_chunks": 0, "stream_window_full": 0}


def count_stream(name: str) -> None:
    stream_counts[name] += 1
    _obs_inc(name)


class ChunkPipeline:
    """One run's dispatch/materialise pair over a policy and a degrader,
    and optionally a circuit ``breaker`` fed by every primary attempt."""

    def __init__(self, policy, degrader, breaker=None):
        self.policy = policy
        self.degrader = degrader
        self.breaker = breaker

    def _guard(self, fn):
        """``fn`` reporting to the breaker: a transient failure counts
        toward opening it, a success closes a half-open probe; fatal
        errors (bad input, an oracle mismatch, a kernel that cannot run)
        pass unrecorded."""
        if self.breaker is None:
            return fn

        def guarded():
            try:
                result = fn()
            except FATAL_ERROR_TYPES:
                raise
            except Exception:
                # A BaseException (the drain, an interrupt) passes
                # unrecorded: process lifecycle, not backend health.
                self.breaker.record_failure()
                raise
            self.breaker.record_success()
            return result

        return guarded

    def _verify(self, seq1_codes, codes, weights):
        """The oracle check of the first degraded chunk (None without
        ``--degrade``)."""
        if not self.degrader.enabled:
            return None
        return lambda rows: verify_rows_against_oracle(seq1_codes, codes, weights, rows)

    def dispatch(self, seq1_codes, codes, weights, budget, staged=None, links=(),
                 trace_ctx=None):
        """Dispatch a chunk under the shared budget; past exhaustion with
        ``--degrade``, rescore it synchronously down the chain (wrapped in
        :class:`MaterialisedRows`, which keeps the promise contract).
        ``staged`` feeds only the first attempt on the primary path;
        ``links`` (the serve plane's request ids) go on the chunk's trace
        launch rows, and so does ``trace_ctx``, the fleet stamp a
        ``--fleet-worker`` threads in (the originating trace ids, its
        worker id, the lease epoch; None everywhere else).  While the
        breaker is open the pinned degraded scorer scores the chunk
        synchronously, oracle-checked once a run."""
        deg = self.degrader
        tags = {"links": links, "trace_ctx": trace_ctx}
        if self.breaker is not None and self.breaker.bypass_primary():
            rows = self.policy.run(
                lambda: deg.scorer.score_codes(seq1_codes, codes, weights, **tags),
                "chunk dispatch [breaker-open]", budget=budget,
            )
            if deg.enabled and not deg.verified:
                verify_rows_against_oracle(seq1_codes, codes, weights, rows)
                deg.verified = True
            return MaterialisedRows(rows)
        feed = [staged]

        def attempt():
            return deg.scorer.score_codes_async(
                seq1_codes, codes, weights, staged=feed.pop() if feed else None, **tags)

        return run_degrading(
            self.policy, deg, self._guard(attempt),
            lambda sc: sc.score_codes(seq1_codes, codes, weights, **tags),
            "chunk dispatch", budget=budget,
            verify=self._verify(seq1_codes, codes, weights), wrap=MaterialisedRows,
        )

    def materialise(self, promise, seq1_codes, codes, weights, budget):
        """Force ``promise`` under the chunk's shared budget (retries
        rescore synchronously), degrading past exhaustion like
        :meth:`dispatch`."""
        deg = self.degrader
        first = [promise]

        def attempt():
            if first:
                return first.pop().result()
            return deg.scorer.score_codes(seq1_codes, codes, weights)

        return run_degrading(
            self.policy, deg, self._guard(attempt),
            lambda sc: sc.score_codes(seq1_codes, codes, weights),
            "chunk scoring", budget=budget,
            verify=self._verify(seq1_codes, codes, weights),
        )


class PendingWindow:
    """Bounded in-flight promises; ``finish`` is called with exactly the
    tuple that was pushed, oldest first."""

    def __init__(self, depth: int, finish):
        self.depth = max(1, int(depth))
        self._finish = finish
        self._pending = collections.deque()

    def push(self, promise, *rest) -> bool:
        """Add an entry; True when the window was full and its oldest
        entry was finished first."""
        if promise is not None:
            try:
                promise.prefetch()
            except Exception:
                # advisory: a copy that cannot start here starts again in
                # result(), inside the chunk's retry budget.
                pass
        self._pending.append((promise, *rest))
        if len(self._pending) <= self.depth:
            return False
        self._finish(*self._pending.popleft())
        return True

    def flush(self) -> None:
        while self._pending:
            self._finish(*self._pending.popleft())


def feed_overlap_enabled() -> bool:
    """Feed overlap is on by default; ``TPU_SEQALIGN_FEED_OVERLAP=0``
    turns it off."""
    from ..utils.env import env_flag

    return env_flag("TPU_SEQALIGN_FEED_OVERLAP")


class FeedStager:
    """Starts the next chunk's host-to-device copies while the current
    chunk computes, through ``degrader.scorer.prestage_codes`` resolved
    at call time.  Every failure is advisory (None: the dispatch stages
    from the host as usual)."""

    def __init__(self, degrader, enabled: bool | None = None):
        self.degrader = degrader
        self.enabled = feed_overlap_enabled() if enabled is None else bool(enabled)

    def stage(self, seq1_codes, codes, weights):
        if not self.enabled or not codes:
            return None
        try:
            return self.degrader.scorer.prestage_codes(seq1_codes, codes, weights)
        except Exception:
            # advisory: a real fault resurfaces at dispatch, inside the
            # chunk's retry budget.
            return None
