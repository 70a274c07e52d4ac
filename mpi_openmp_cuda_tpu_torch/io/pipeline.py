"""The chunk submit/finish machinery of the ``--stream`` CLI (the port of
``mpi_openmp_cuda_tpu/io/pipeline.py``; the serve plane will drive the
same classes):

* :class:`ChunkPipeline` — dispatch and materialise one chunk under a
  retry budget shared by both stages, with the ``--degrade`` chain at
  both and the oracle check of the first degraded result.  All scoring
  goes through ``degrader.scorer`` at call time, so a degradation holds
  for every later chunk.
* :class:`PendingWindow` — the bounded in-flight window: each pushed
  promise's device-to-host copy starts at dispatch (``prefetch``), the
  oldest entry is finished once the window overflows, ``flush()`` drains
  the rest.  On a mesh the promises are ``parallel.sharding.
  ShardedPending``s, whose ``result`` is the gather (in a multi-process
  job the CLI keeps one chunk in flight: the chunk order is the
  collective schedule).
* :class:`FeedStager` — feed overlap: the next chunk's host-to-device
  copies start on a side CUDA stream (``AlignmentScorer.prestage_codes``)
  while the current chunk computes.  Advisory and single-use: a staged
  handle feeds at most one dispatch, retries stage again from the host.
"""

from __future__ import annotations

import collections

from ..resilience.degrade import MaterialisedRows, run_degrading, verify_rows_against_oracle


class ChunkPipeline:
    """One run's dispatch/materialise pair over a policy and a degrader."""

    def __init__(self, policy, degrader):
        self.policy = policy
        self.degrader = degrader

    def _verify(self, seq1_codes, codes, weights):
        """The oracle check of the first degraded chunk (None without
        ``--degrade``)."""
        if not self.degrader.enabled:
            return None
        return lambda rows: verify_rows_against_oracle(seq1_codes, codes, weights, rows)

    def dispatch(self, seq1_codes, codes, weights, budget, staged=None):
        """Dispatch a chunk under the shared budget; past exhaustion with
        ``--degrade``, rescore it synchronously down the chain (wrapped in
        :class:`MaterialisedRows`, which keeps the promise contract).
        ``staged`` feeds only the first attempt on the primary path."""
        deg = self.degrader
        feed = [staged]

        def attempt():
            return deg.scorer.score_codes_async(seq1_codes, codes, weights, staged=feed.pop()
                                                if feed else None)

        return run_degrading(
            self.policy, deg, attempt,
            lambda sc: sc.score_codes(seq1_codes, codes, weights),
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
            self.policy, deg, attempt,
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

    def push(self, promise, *rest) -> None:
        if promise is not None:
            try:
                promise.prefetch()
            except Exception:
                # Advisory: a copy that cannot start here starts again in
                # result(), inside the chunk's retry budget.
                pass
        self._pending.append((promise, *rest))
        if len(self._pending) > self.depth:
            self._finish(*self._pending.popleft())

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
            # Advisory: a real fault resurfaces at dispatch, inside the
            # chunk's retry budget.
            return None
