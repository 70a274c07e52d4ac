"""Serve-plane SLO primitives: modelled request cost, token-bucket
admission, and the load-shedding state machine (the port of
``mpi_openmp_cuda_tpu/serve/slo.py``, pricing on the Hopper launch model).

The exhaustive ``(len1 - len2) x len2`` search makes a request's cost vary
wildly with its lengths, so a bare queue-depth cap either starves short
requests behind long ones or admits an hour of work into a one-second
budget.  Admission here is cost-aware: every request is priced in modelled
seconds of superblock wall on the card (:class:`RequestCostModel`, on the
launch model of ``ops/schedule.py`` that also plans the launch groups and
prices the trace's launch rows), and a token bucket bounds the modelled
wall of everything admitted but unfinished.

Pricing is host arithmetic over the request's lengths; the bucket refills
on completions, not at a wall-clock rate, so the same submissions admit
and reject alike on every run.  The only time-derived inputs are values
the serve loop hands in from its clock, the queue waits
(:meth:`AdmissionController.observe_wait`) and the tick time
(:meth:`AdmissionController.update_state`); they feed the shed machine's
wait percentile and the ``retry_after_s`` hint, never a bucket decision.

The launch model is a prior: ``load/refit.py`` refits a multiplier from
measured launch rows, fed back through ``SEQALIGN_SERVE_COST_SCALE``.

Shedding is a three-state machine, escalating one state per serve-loop
tick on the p90 of recent queue waits and stepping down with hysteresis::

    accept ----(p90 >= shed_wait_s)----> shed-new ---(p90 >= 4x)---> drain-only
    accept <---(p90 < shed_wait_s/2)---- shed-new <--(p90 < .../2)--

``shed-new`` and ``drain-only`` both reject new admissions with a typed
``overloaded`` error (``retry_after_s`` = the outstanding modelled wall
over the measured completion rate, when one is measured);
``drain-only`` also tells the loop to stop gathering (window 0) so the
queue drains at full speed.
"""

from __future__ import annotations

import collections
import threading

from ..obs.events import publish
from ..obs.metrics import percentile as _percentile
from ..resilience.faults import scheduled as _fault_scheduled
from ..utils.constants import BUF_SIZE_SEQ1, BUF_SIZE_SEQ2
from ..utils.env import env_float

_BLK = 128

# Shed states, escalation order (the tuple index is the severity).
SHED_ACCEPT = "accept"
SHED_NEW = "shed-new"
SHED_DRAIN = "drain-only"
_SHED_ORDER = (SHED_ACCEPT, SHED_NEW, SHED_DRAIN)

# Queue-wait observations the shed percentile is computed over.
DEFAULT_WAIT_WINDOW = 32

# Per-tick (timestamp, released-total) marks the live bucket-drain
# estimate is computed over: ~DRAIN_WINDOW serve-loop ticks of history.
DRAIN_WINDOW = 16

# The percentile driving shed transitions: one slow straggler must not
# shed, a slow tail must.
_WAIT_PCTL = 0.9


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# The shed machine's p90 and the report histograms' p50/p90/p99 are the
# SAME rank arithmetic: obs.metrics.percentile is the one implementation
# (imported above as _percentile), so a threshold tuned against report
# percentiles transfers to shedding exactly.


def _marginal_pair_us(len1: int, len2: int, rows: int) -> float:
    """Modelled microseconds one pair adds to a launch of ``rows`` such
    pairs: the launch model's wall of that launch, less its fixed launch
    cost, shared by its rows."""
    from ..ops.schedule import LAUNCH_US, launch_us

    l2p = _ceil_div(max(1, len2), _BLK) * _BLK
    return (launch_us(len1, [len2] * rows, l2p) - LAUNCH_US) / rows


def _best_pair_wall_s(nbn: int, nbi: int, rows: int) -> float:
    """The cheaper of a pair's two corners in its block-count cell: Seq1
    at its shortest (``(nbn - 1) * 128 + 1``), Seq2 at its shortest or
    longest, in a full block of ``rows`` such pairs."""
    len1 = (nbn - 1) * _BLK + 1
    return 1e-6 * min(
        _marginal_pair_us(len1, len2, rows)
        for len2 in ((nbi - 1) * _BLK + 1, nbi * _BLK)
    )


class RequestCostModel:
    """Modelled superblock-wall pricing for admission decisions.

    A pair is priced at its marginal share of a full superblock of such
    pairs on the Hopper launch model (``ops/schedule.py``): the block's
    modelled wall less the one fixed launch cost, over its rows.  The
    fixed cost is paid once a block, not once a pair, so charging it per
    pair would overprice a block up to ``rows_per_block`` times.  The
    price is a deliberate lower bound (the cheaper corner of the pair's
    ``(nbn, nbi)`` block-count cell, every row of the block live):
    admission must never reject work the card could make in time, so it
    prices optimistically and lets the deadline checkpoints catch the
    rest.  Prices are memoised per block-count pair (at most 24 x 16),
    so steady-state pricing is a dict lookup.

    ``scale`` is the measured-load refit multiplier
    (``SEQALIGN_SERVE_COST_SCALE``, default 1.0 = trust the model), a run
    constant, so admission stays deterministic within a run.
    """

    def __init__(self, *, scale: float | None = None, rows_per_block: int | None = None):
        from .batcher import DEFAULT_BLOCK_ROWS

        self._pair_wall: dict[tuple[int, int], float] = {}
        if scale is None:
            scale = env_float("SEQALIGN_SERVE_COST_SCALE", 1.0)
        self.scale = max(0.0, float(scale)) or 1.0
        self.rows_per_block = max(1, int(rows_per_block or DEFAULT_BLOCK_ROWS))

    def pair_wall_s(self, len1: int, len2: int) -> float:
        """Unscaled modelled wall of one pair: the prior the refit loop
        measures against."""
        nbn = max(1, _ceil_div(min(int(len1), BUF_SIZE_SEQ1), _BLK))
        nbi = max(1, _ceil_div(min(int(len2), BUF_SIZE_SEQ2), _BLK))
        key = (nbn, nbi)
        wall = self._pair_wall.get(key)
        if wall is None:
            wall = self._pair_wall[key] = _best_pair_wall_s(nbn, nbi, self.rows_per_block)
        return wall

    def request_cost_s(self, raw: dict) -> float:
        """Modelled wall of one raw (still unvalidated) request.
        Defensively prices anything malformed at 0.0 — validation
        rejects it with a typed error on the main thread later; pricing
        runs on reader threads and must never raise."""
        try:
            seq1 = raw.get("seq1")
            seq2 = raw.get("seq2")
            if not isinstance(seq1, str) or not isinstance(seq2, list):
                return 0.0
            total = 0.0
            for s in seq2:
                if isinstance(s, str) and s:
                    total += self.pair_wall_s(len(seq1), len(s))
            return total * self.scale
        except Exception:
            # advisory: admission cost estimate only — 0.0 admits the
            # request and the scorer's own contracts still gate it.
            return 0.0


class AdmissionController:
    """Token-bucket admission + the accept/shed-new/drain-only machine.

    Thread contract: :meth:`admit` runs on reader threads (under the
    queue's condition, which never re-enters here), :meth:`release` on
    whichever thread retires a session, and :meth:`update_state` on the
    serve loop's main thread once per tick; every mutation is guarded by
    the controller's own lock, and the controller never calls back into
    the queue, so the queue -> controller lock order is acyclic.
    """

    def __init__(
        self,
        *,
        budget_s: float,
        shed_wait_s: float,
        cost_model: RequestCostModel | None = None,
        wait_window: int = DEFAULT_WAIT_WINDOW,
    ):
        if budget_s <= 0:
            raise ValueError(f"admission budget_s must be > 0, got {budget_s}")
        if shed_wait_s <= 0:
            raise ValueError(
                f"shed_wait_s threshold must be > 0, got {shed_wait_s}"
            )
        self.budget_s = float(budget_s)
        self.shed_wait_s = float(shed_wait_s)
        self.cost_model = cost_model or RequestCostModel()
        self._lock = threading.Lock()
        self._outstanding_s = 0.0
        self._state = SHED_ACCEPT
        self._waits: collections.deque[float] = collections.deque(
            maxlen=max(1, int(wait_window))
        )
        # Live drain estimate: lifetime released cost + per-tick
        # (loop timestamp, released total) marks.  The timestamps are
        # handed IN by the loop (update_state(now=...)) — never read
        # here — and feed only the retry_after_s hint, not decisions.
        self._released_total_s = 0.0
        self._drain_marks: collections.deque[tuple[float, float]] = (
            collections.deque(maxlen=DRAIN_WINDOW)
        )

    @property
    def state(self) -> str:
        return self._state

    def outstanding_s(self) -> float:
        return self._outstanding_s

    def drain_rate(self) -> float:
        """Measured completion-refill rate: modelled-cost seconds
        released per wall second over the recent tick window (0.0 until
        two ticks with completions between them have been observed)."""
        with self._lock:
            return self._drain_rate_locked()

    def _drain_rate_locked(self) -> float:
        if len(self._drain_marks) < 2:
            return 0.0
        t0, r0 = self._drain_marks[0]
        t1, r1 = self._drain_marks[-1]
        if t1 <= t0 or r1 <= r0:
            return 0.0
        return (r1 - r0) / (t1 - t0)

    def retry_after_s(self) -> float:
        """Client back-off hint: the wall seconds until the outstanding
        work drains at the MEASURED completion-refill rate (the live
        token-bucket drain estimate) — so back-off is proportional to
        actual saturation, not the cost model's optimism.  Before any
        drain has been measured (cold start, first overload tick) it
        falls back to the static prior — the modelled wall of the
        outstanding work itself — and is floored so a zero-cost
        rejection still backs off."""
        with self._lock:
            outstanding = self._outstanding_s
            rate = self._drain_rate_locked()
        hint = outstanding / rate if rate > 0.0 else outstanding
        return round(max(0.05, hint), 3)

    def admit(self, raw: dict) -> tuple[str | None, float]:
        """Price one raw request and charge the bucket.  Returns
        ``(rejection, cost_s)``; rejection is None when admitted (the
        cost is charged and the caller owes exactly one
        :meth:`release`), else the shed reason."""
        cost = self.cost_model.request_cost_s(raw)
        if _fault_scheduled("overload-burst"):
            # Chaos marker: this request arrives as part of a modelled
            # burst that exhausts the bucket on its own.
            cost = cost + self.budget_s + 1.0
        if _fault_scheduled("burst:overload"):
            # Chaos marker: sustained open-loop overload: this request
            # arrives priced at 5x its modelled wall, the saturation
            # regime the load plane drives for real.
            cost = cost * 5.0
        with self._lock:
            if self._state != SHED_ACCEPT:
                return self._state, cost
            if (
                self._outstanding_s > 0.0
                and self._outstanding_s + cost > self.budget_s
            ):
                # An over-budget request against an EMPTY bucket is
                # still admitted: no completion could ever make it fit,
                # so rejecting would reject it forever — the deadline
                # checkpoints are what catch impossible requests.
                return "overloaded", cost
            self._outstanding_s += cost
            return None, cost

    def release(self, cost_s: float) -> None:
        """Return one admitted request's tokens (request done, failed,
        abandoned, or rejected at validation)."""
        with self._lock:
            self._outstanding_s = max(0.0, self._outstanding_s - cost_s)
            self._released_total_s += max(0.0, float(cost_s))

    def observe_wait(self, wait_s: float) -> None:
        """One popped request's queue wait (admission to pop)."""
        with self._lock:
            self._waits.append(float(wait_s))

    def note_idle(self) -> None:
        """Serve-loop signal: the queue is empty this tick, so the next
        arrival would wait ~nothing — feed a zero observation so the
        percentile decays and shed states can step back down."""
        with self._lock:
            self._waits.append(0.0)

    def update_state(self, now: float | None = None) -> str:
        """One tick's shed transition (main loop thread only): move at
        most one state toward where the wait percentile points.

        ``now`` is the loop's ServeClock timestamp for this tick; it
        marks the drain-rate window for :meth:`retry_after_s` and
        touches no transition decision (those stay clock-free)."""
        with self._lock:
            if now is not None:
                self._drain_marks.append(
                    (float(now), self._released_total_s)
                )
            p = _percentile(self._waits, _WAIT_PCTL)
            cur = _SHED_ORDER.index(self._state)
            if p >= 4.0 * self.shed_wait_s:
                target = 2
            elif p >= self.shed_wait_s:
                target = max(cur, 1)
            elif p < 0.5 * self.shed_wait_s:
                target = 0
            else:
                # Hysteresis band: hold the current state.
                target = cur
            if target == cur:
                return self._state
            nxt = cur + (1 if target > cur else -1)
            self._state = _SHED_ORDER[nxt]
            state = self._state
        publish("serve.shed.state", state=state, p90=round(p, 6))
        return state
