"""The port's serve-plane SLO armor against the contract
``tests/test_serve_slo.py`` pins for the JAX package (its tests, on the
port's modules and CLI on ``--device cpu``): deadlines, shedding, the
breaker, quarantine.

* admission is a cost-aware token bucket (modelled superblock-wall
  seconds, completion-refilled, deterministic), with the empty-bucket
  guard that keeps an over-budget request from starving forever; the
  port prices on the Hopper launch model (``ops/schedule.py``), pinned
  here against ``schedule.launch_us``;
* the shed machine escalates accept -> shed-new -> drain-only one state
  per tick on the p90 queue wait, with hysteresis, and decays on idle;
* the circuit breaker opens after ``threshold`` transient failures in a
  tick-counted window, pins the degraded backend, probes half-open after
  the cooldown and closes on a healthy probe; the port's degrader
  (``pin``/``reset``) and ``ChunkPipeline(breaker=...)`` carry it;
* per-request deadlines are enforced at batch planning and at demux;
* a poisoned superblock is bisected until the poison request is isolated
  with a typed error while its co-batched victims still score;
* an overload burst answers every request: a result or a typed
  ``overloaded`` + ``retry_after_s``, pipe and socket alike.
"""

from __future__ import annotations

import json
import signal

import pytest


from mpi_openmp_cuda_tpu_torch.resilience.breaker import (
    STATE_CLOSED,
    STATE_HALF_OPEN,
    STATE_OPEN,
    CircuitBreaker,
)
from mpi_openmp_cuda_tpu_torch.resilience.faults import (
    activate_faults,
    deactivate_faults,
)
from mpi_openmp_cuda_tpu_torch.serve.queue import ADMIT_OK, ADMIT_OVERLOADED
from mpi_openmp_cuda_tpu_torch.serve.session import (
    RequestError,
    Responder,
    build_session,
)
from mpi_openmp_cuda_tpu_torch.serve.slo import (
    SHED_ACCEPT,
    SHED_DRAIN,
    SHED_NEW,
    AdmissionController,
    RequestCostModel,
)

from test_torch_serve import (  # noqa: F401  (shared serve-test helpers)
    _quiet_env,
    run_cli_inproc,
    WEIGHTS,
    FakeClock,
    Sink,
    _lines_by_id,
    _queued,
    _request,
    _serve_records,
)


class FixedCost:
    """Cost-model stand-in pricing every request at raw['cost']."""

    def request_cost_s(self, raw):
        return float(raw.get("cost", 0.5))


def _controller(budget=1.0, shed=4.0, window=8):
    return AdmissionController(
        budget_s=budget,
        shed_wait_s=shed,
        cost_model=FixedCost(),
        wait_window=window,
    )


# -- pricing -----------------------------------------------------------------


class TestRequestCostModel:
    def test_valid_request_prices_positive_and_memoises(self):
        m = RequestCostModel()
        cost = m.request_cost_s(_request("a", "ACGT" * 100, ["ACGT" * 50]))
        assert cost > 0.0
        # Same block-count pair → dict hit, identical price, one entry.
        again = m.request_cost_s(_request("b", "ACGT" * 100, ["ACGT" * 50]))
        assert again == cost
        assert len(m._pair_wall) == 1

    @pytest.mark.parametrize("len1, len2", [(8, 4), (1489, 100), (3000, 64),
                                            (3000, 1999), (300, 2000)])
    def test_pair_price_is_its_marginal_share_of_a_block(self, len1, len2):
        from mpi_openmp_cuda_tpu_torch.ops import schedule

        m = RequestCostModel(scale=1.0, rows_per_block=64)
        nbn, nbi = -(-len1 // 128), -(-len2 // 128)
        lo1 = (nbn - 1) * 128 + 1

        def share(l2):
            l2p = -(-l2 // 128) * 128
            return (schedule.launch_us(lo1, [l2] * 64, l2p) - schedule.LAUNCH_US) / 64

        want = 1e-6 * min(share((nbi - 1) * 128 + 1), share(nbi * 128))
        assert m.pair_wall_s(len1, len2) == pytest.approx(want, rel=1e-12)
        assert 0.0 < m.pair_wall_s(len1, len2) < 1e-6 * schedule.LAUNCH_US

    def test_a_full_block_pays_the_fixed_cost_once_at_most(self):
        from mpi_openmp_cuda_tpu_torch.ops import schedule

        m = RequestCostModel(scale=1.0, rows_per_block=64)
        raw = _request("a", "A" * 3000, ["C" * 1999] * 64)
        block_us = schedule.launch_us(3000, [1999] * 64, 2048)
        assert m.request_cost_s(raw) <= 1e-6 * block_us
        assert m.request_cost_s(raw) >= 1e-6 * (block_us - schedule.LAUNCH_US) * 0.9

    def test_scale_multiplies_the_price(self, monkeypatch):
        raw = _request("a", "ACGT" * 100, ["ACGT" * 50])
        base = RequestCostModel(scale=1.0).request_cost_s(raw)
        monkeypatch.setenv("SEQALIGN_SERVE_COST_SCALE", "2.5")
        assert RequestCostModel().request_cost_s(raw) == pytest.approx(2.5 * base)

    def test_malformed_request_prices_zero_never_raises(self):
        m = RequestCostModel()
        for raw in (
            {},
            {"seq1": 5, "seq2": ["AC"]},
            {"seq1": "AC", "seq2": "not-a-list"},
            {"seq1": "AC", "seq2": [3, None]},
        ):
            assert m.request_cost_s(raw) == 0.0


# -- token bucket ------------------------------------------------------------


class TestAdmissionBucket:
    def test_charge_reject_release_cycle(self):
        c = _controller(budget=1.0)
        rej, cost = c.admit({"cost": 0.6})
        assert rej is None and cost == 0.6
        rej, _ = c.admit({"cost": 0.6})
        assert rej == "overloaded"
        c.release(0.6)
        rej, _ = c.admit({"cost": 0.6})
        assert rej is None

    def test_empty_bucket_admits_over_budget_request(self):
        # No completion could ever make a 5 s request fit a 1 s budget:
        # rejecting would starve it forever, so an empty bucket admits.
        c = _controller(budget=1.0)
        rej, cost = c.admit({"cost": 5.0})
        assert rej is None and cost == 5.0
        # ...but while IT is outstanding, everything else sheds.
        assert c.admit({"cost": 0.01})[0] == "overloaded"

    def test_release_clamps_at_zero(self):
        c = _controller()
        c.release(99.0)
        assert c.outstanding_s() == 0.0

    def test_retry_after_tracks_outstanding_with_floor(self):
        c = _controller(budget=10.0)
        assert c.retry_after_s() == 0.05  # empty bucket still backs off
        c.admit({"cost": 2.5})
        assert c.retry_after_s() == 2.5

    def test_invalid_parameters_rejected(self):
        with pytest.raises(ValueError, match="budget_s"):
            AdmissionController(budget_s=0.0, shed_wait_s=1.0)
        with pytest.raises(ValueError, match="shed_wait_s"):
            AdmissionController(budget_s=1.0, shed_wait_s=-1.0)


# -- shed state machine ------------------------------------------------------


class TestShedMachine:
    def _saturate(self, c, wait):
        for _ in range(8):
            c.observe_wait(wait)

    def test_escalates_one_state_per_tick(self):
        c = _controller(shed=4.0)
        self._saturate(c, 100.0)  # p90 >= 4x threshold → target drain
        assert c.update_state() == SHED_NEW  # but only ONE step per tick
        assert c.update_state() == SHED_DRAIN

    def test_holds_in_hysteresis_band(self):
        c = _controller(shed=4.0)
        self._saturate(c, 5.0)
        assert c.update_state() == SHED_NEW
        self._saturate(c, 3.0)  # between shed/2 and shed: hold
        assert c.update_state() == SHED_NEW

    def test_deescalates_below_half_threshold(self):
        c = _controller(shed=4.0)
        self._saturate(c, 5.0)
        assert c.update_state() == SHED_NEW
        self._saturate(c, 1.0)
        assert c.update_state() == SHED_ACCEPT

    def test_note_idle_decays_the_percentile(self):
        c = _controller(shed=4.0, window=4)
        self._saturate(c, 50.0)
        c.update_state()
        c.update_state()
        assert c.state == SHED_DRAIN
        for _ in range(4):  # idle ticks push zeros through the window
            c.note_idle()
        assert c.update_state() == SHED_NEW
        assert c.update_state() == SHED_ACCEPT

    def test_shed_states_reject_new_admissions(self):
        c = _controller(shed=4.0)
        self._saturate(c, 100.0)
        c.update_state()
        rej, _ = c.admit({"cost": 0.01})
        assert rej == SHED_NEW

    def test_queue_relays_typed_overload_verdict(self):
        from mpi_openmp_cuda_tpu_torch.serve.queue import RequestQueue

        c = _controller(budget=1.0)
        q = RequestQueue(8, FakeClock(), controller=c)
        assert q.submit({"cost": 0.8}, Sink()) == ADMIT_OK
        assert q.submit({"cost": 0.8}, Sink()) == ADMIT_OVERLOADED
        assert q.depth() == 1

    def test_queue_full_backstop_refunds_bucket_charge(self):
        from mpi_openmp_cuda_tpu_torch.serve.queue import ADMIT_FULL, RequestQueue

        c = _controller(budget=10.0)
        q = RequestQueue(1, FakeClock(), controller=c)
        assert q.submit({"cost": 1.0}, Sink()) == ADMIT_OK
        assert q.submit({"cost": 1.0}, Sink()) == ADMIT_FULL
        assert c.outstanding_s() == 1.0  # the rejected charge came back


# -- measured drain-rate back-off hint ---------------------------------------


class TestDrainEstimate:
    """``retry_after_s`` from the MEASURED completion-refill rate:
    ``update_state(now)`` marks the tick window (timestamps handed in,
    never read), ``release`` grows the lifetime refill total, and the
    hint is outstanding work over that measured rate — falling back to
    the modelled outstanding wall until a drain has been observed."""

    def test_hint_is_outstanding_over_measured_rate(self):
        c = _controller(budget=100.0)
        c.admit({"cost": 30.0})
        c.update_state(10.0)  # mark (t=10, released 0)
        c.release(5.0)
        c.release(5.0)
        c.update_state(20.0)  # mark (t=20, released 10) → 1.0 cost-s/s
        assert c.drain_rate() == pytest.approx(1.0)
        # 20 modelled-seconds outstanding at 1.0/s → a 20 s hint.
        assert c.retry_after_s() == pytest.approx(20.0)

    def test_single_mark_falls_back_to_modelled_outstanding(self):
        c = _controller(budget=100.0)
        c.admit({"cost": 7.0})
        c.update_state(1.0)  # one mark is a point, not a rate
        assert c.drain_rate() == 0.0
        assert c.retry_after_s() == pytest.approx(7.0)

    def test_marks_without_completions_keep_the_fallback(self):
        c = _controller(budget=100.0)
        c.admit({"cost": 7.0})
        c.update_state(1.0)
        c.update_state(2.0)  # ticks passed, nothing drained
        assert c.drain_rate() == 0.0
        assert c.retry_after_s() == pytest.approx(7.0)

    def test_rate_spans_first_to_last_mark(self):
        c = _controller(budget=100.0)
        c.update_state(0.0)
        c.release(4.0)
        c.update_state(2.0)
        c.release(4.0)
        c.update_state(4.0)  # (0, 0) .. (4, 8) → 2.0 cost-s/s
        assert c.drain_rate() == pytest.approx(2.0)


# -- hysteresis under bursty open-loop arrivals ------------------------------


class TestBurstyHysteresis:
    """The shed machine under the load plane's *burst* arrival shape
    (``load/arrival.burst_times``) on a fake tick clock: whole groups
    land at once, queue waits spike, the gaps go idle.  The contract
    under that shape: escalation moves ONE state per tick (never
    teleports, however hard the p90 jumps), the hysteresis band holds
    between bursts, and the idle tail decays all the way back."""

    def _simulate(self, offsets, *, shed, window=8):
        """Tick-stepped single-server queue simulation, feeding the
        controller exactly what the serve loop would each tick: one
        ``observe_wait`` per popped request, ``note_idle`` on an empty
        queue, one ``update_state(now)``.  Service is one request per
        tick; waits are arrival-to-pop on the fake clock.  Runs until
        the backlog is drained AND enough idle ticks have flushed the
        wait window for the decay path to finish."""
        c = _controller(shed=shed, window=window)
        pending = sorted(offsets)
        queue: list = []
        states = []
        t = 0.0
        idle = 0
        while t < 500.0:  # safety bound; real runs end far earlier
            while pending and pending[0] <= t:
                queue.append(pending.pop(0))
            if queue:
                c.observe_wait(t - queue.pop(0))
                idle = 0
            else:
                c.note_idle()
                idle += 1
            states.append(c.update_state(t))
            t += 1.0
            if not pending and not queue and idle >= window + 4:
                break
        return states

    def test_burst_waves_escalate_stepwise_and_decay(self):
        from mpi_openmp_cuda_tpu_torch.load.arrival import burst_times

        # Two 20-deep bursts at an average 2 req/s (groups 10 s apart);
        # 1 req/tick service means waits climb past 4x the 4 s
        # threshold, so the machine is driven all the way to drain-only.
        offsets = burst_times(40, 2.0, burst_size=20)
        states = self._simulate(offsets, shed=4.0)
        assert SHED_NEW in states and SHED_DRAIN in states
        order = (SHED_ACCEPT, SHED_NEW, SHED_DRAIN)
        for prev, cur in zip([SHED_ACCEPT] + states, states):
            assert abs(order.index(cur) - order.index(prev)) <= 1, (
                f"teleported {prev} -> {cur} in {states}"
            )
        # The idle tail decayed the machine back to accept.
        assert states[-1] == SHED_ACCEPT

    def test_mild_bursts_stay_in_the_hysteresis_band(self):
        from mpi_openmp_cuda_tpu_torch.load.arrival import burst_times

        # 4-deep bursts every 8 s: each group drains (1 req/tick) well
        # before the next lands, so the worst wait is 3 ticks < the
        # 8 s threshold and the machine never leaves accept.
        offsets = burst_times(16, 0.5, burst_size=4)
        states = self._simulate(offsets, shed=8.0)
        assert set(states) == {SHED_ACCEPT}

    def test_sustained_bursts_hold_shed_between_groups(self):
        from mpi_openmp_cuda_tpu_torch.load.arrival import burst_times

        # 12-deep bursts every 6 s against 1 req/tick service: the
        # queue never clears between groups, waits sit above the 4 s
        # threshold but below 4x it — the machine reaches shed-new and
        # HOLDS there through the gaps (no accept/shed flapping) until
        # the schedule ends and the backlog drains.
        offsets = burst_times(36, 2.0, burst_size=12)
        states = self._simulate(offsets, shed=4.0)
        first_shed = states.index(SHED_NEW)
        last_shed = len(states) - 1 - states[::-1].index(SHED_NEW)
        mid = states[first_shed:last_shed + 1]
        assert SHED_ACCEPT not in mid, (
            f"shed machine flapped back to accept mid-overload: {states}"
        )
        assert states[-1] == SHED_ACCEPT  # but the tail still decays


# -- circuit breaker ---------------------------------------------------------


class FakeDegrader:
    """BackendDegrader stand-in: cuda -> mm, one pin/reset counter."""

    class _Scorer:
        def __init__(self, backend):
            self.backend = backend

    def __init__(self, can=True):
        self.enabled = True
        self._can = can
        self.scorer = self._Scorer("cuda")
        self.pins = 0
        self.resets = 0

    def can_degrade(self):
        return self._can

    def pin(self):
        self.pins += 1
        self.scorer = self._Scorer("mm")
        return "mm"

    def reset(self):
        self.resets += 1
        self.scorer = self._Scorer("cuda")


class TestCircuitBreaker:
    def _breaker(self, deg=None, **kw):
        kw.setdefault("threshold", 3)
        kw.setdefault("window_ticks", 8)
        kw.setdefault("cooldown_ticks", 2)
        return CircuitBreaker(deg or FakeDegrader(), log=lambda s: None, **kw)

    def test_threshold_failures_open_and_pin(self):
        deg = FakeDegrader()
        b = self._breaker(deg)
        for _ in range(2):
            b.record_failure()
        assert b.state == STATE_CLOSED and not b.bypass_primary()
        b.record_failure()
        assert b.state == STATE_OPEN and b.bypass_primary()
        assert deg.pins == 1 and deg.scorer.backend == "mm"

    def test_window_forgets_old_failures(self):
        b = self._breaker(window_ticks=4)
        for _ in range(2):
            b.record_failure()
        for _ in range(6):  # age both failures past the window
            b.tick()
        b.record_failure()
        assert b.state == STATE_CLOSED

    def test_cooldown_probes_half_open_then_closes(self):
        deg = FakeDegrader()
        b = self._breaker(deg, cooldown_ticks=2)
        for _ in range(3):
            b.record_failure()
        b.tick()
        assert b.state == STATE_OPEN  # one tick: still cooling down
        b.tick()
        assert b.state == STATE_HALF_OPEN
        assert deg.resets == 1 and deg.scorer.backend == "cuda"
        b.record_success()
        assert b.state == STATE_CLOSED

    def test_failed_probe_reopens(self):
        b = self._breaker(cooldown_ticks=1)
        for _ in range(3):
            b.record_failure()
        b.tick()
        assert b.state == STATE_HALF_OPEN
        b.record_failure()
        assert b.state == STATE_OPEN and b.opens == 2

    def test_open_breaker_ignores_failures(self):
        b = self._breaker()
        for _ in range(5):
            b.record_failure()
        assert b.opens == 1

    def test_no_degrade_chain_never_opens(self):
        # Without a backend to pin, bypassing onto the same failing
        # backend would help nobody: the breaker stays closed.
        b = self._breaker(FakeDegrader(can=False))
        for _ in range(10):
            b.record_failure()
        assert b.state == STATE_CLOSED

    def test_parameter_validation(self):
        for kw in (
            {"threshold": 0},
            {"window_ticks": 0},
            {"cooldown_ticks": 0},
        ):
            with pytest.raises(ValueError):
                self._breaker(**kw)

    def test_degrader_pin_and_reset_contract(self):
        from mpi_openmp_cuda_tpu_torch.ops.dispatch import AlignmentScorer
        from mpi_openmp_cuda_tpu_torch.resilience.degrade import BackendDegrader

        built = []

        def make(backend):
            built.append(backend)
            return AlignmentScorer(backend=backend, device="cpu")

        primary = AlignmentScorer(backend="cuda", device="cpu")
        deg = BackendDegrader(primary, make, enabled=True, log=lambda s: None)
        assert deg.can_degrade()
        assert deg.pin() == "mm"
        assert deg.scorer.backend == "mm"
        assert deg.pin() == "mm"  # already degraded: pin is idempotent
        deg.verified = True
        deg.reset()
        assert deg.scorer is primary
        assert deg.verified  # sticky: oracle re-verification is once a run
        assert deg.pin() == "mm" and built == ["mm"]  # the mm scorer is reused


# -- the port's degrader and pipeline under the breaker ------------------------


class TestDegraderPinReset:
    def _deg(self, backend="cuda"):
        from mpi_openmp_cuda_tpu_torch.ops.dispatch import AlignmentScorer
        from mpi_openmp_cuda_tpu_torch.resilience.degrade import BackendDegrader

        return BackendDegrader(
            AlignmentScorer(backend=backend, device="cpu"),
            lambda b: AlignmentScorer(backend=b, device="cpu"),
            enabled=True, log=lambda s: None,
        )

    def test_pin_after_a_fall_keeps_the_fallen_backend(self):
        deg = self._deg()
        deg.step()
        deg.step()
        assert deg.pin() == "gather" and deg.scorer.backend == "gather"

    def test_gather_primary_cannot_degrade(self):
        deg = self._deg("gather")
        assert not deg.can_degrade()
        assert deg.pin() is None

    def test_reset_restores_the_primary_after_steps(self):
        deg = self._deg("mm")
        assert deg.can_degrade() and deg.pin() == "gather"
        deg.reset()
        assert deg.scorer.backend == "mm"


class _Flaky:
    """An AlignmentScorer stand-in whose first ``fail`` async dispatches
    raise a transient error."""

    def __init__(self, backend, fail=0):
        from mpi_openmp_cuda_tpu_torch.ops.dispatch import AlignmentScorer

        self.backend = backend
        self.fail = fail
        self.calls = 0
        self._real = AlignmentScorer(backend=backend, device="cpu")

    def score_codes_async(self, *a, **kw):
        self.calls += 1
        if self.calls <= self.fail:
            raise RuntimeError("transient device failure")
        return self._real.score_codes_async(*a, **kw)

    def score_codes(self, *a, **kw):
        self.calls += 1
        return self._real.score_codes(*a, **kw)


class TestChunkPipelineBreaker:
    def _pipe(self, fail):
        from mpi_openmp_cuda_tpu_torch.io.pipeline import ChunkPipeline
        from mpi_openmp_cuda_tpu_torch.resilience.degrade import BackendDegrader
        from mpi_openmp_cuda_tpu_torch.resilience.policy import RetryPolicy

        primary = _Flaky("cuda", fail=fail)
        fallback = {}

        def make(b):
            fallback[b] = _Flaky(b)
            return fallback[b]

        deg = BackendDegrader(primary, make, enabled=True, log=lambda s: None)
        breaker = CircuitBreaker(deg, threshold=2, window_ticks=8, cooldown_ticks=1,
                                 log=lambda s: None)
        policy = RetryPolicy(retries=3, backoff_base=0)
        return ChunkPipeline(policy, deg, breaker=breaker), primary, fallback, breaker

    def _chunk(self):
        from mpi_openmp_cuda_tpu_torch.models.encoding import encode_normalized

        return encode_normalized("ACGTACGTAC"), [encode_normalized(x) for x in ("ACG", "TTAC")]

    def _score(self, pipe):
        seq1, codes = self._chunk()
        budget = pipe.policy.new_budget()
        promise = pipe.dispatch(seq1, codes, WEIGHTS, budget, links=["r1"])
        return pipe.materialise(promise, seq1, codes, WEIGHTS, budget)

    def test_transient_failures_open_the_breaker_and_pin_mm(self):
        from mpi_openmp_cuda_tpu.ops.oracle import score_batch_oracle

        pipe, primary, fallback, breaker = self._pipe(fail=2)
        rows = self._score(pipe)
        seq1, codes = self._chunk()
        assert [tuple(r) for r in rows] == score_batch_oracle(seq1, codes, WEIGHTS)
        assert breaker.state == STATE_OPEN and pipe.degrader.scorer.backend == "mm"
        # Open: the next chunk goes straight to mm, the primary untouched.
        before = primary.calls
        assert [tuple(r) for r in self._score(pipe)] == score_batch_oracle(
            seq1, codes, WEIGHTS)
        assert primary.calls == before and fallback["mm"].calls >= 1

    def test_half_open_probe_success_closes(self):
        pipe, primary, _, breaker = self._pipe(fail=2)
        self._score(pipe)
        breaker.tick()
        assert breaker.state == STATE_HALF_OPEN and pipe.degrader.scorer is primary
        self._score(pipe)
        assert breaker.state == STATE_CLOSED

    def test_fatal_errors_are_not_recorded(self):
        pipe, _, _, breaker = self._pipe(fail=0)
        guarded = pipe._guard(lambda: (_ for _ in ()).throw(ValueError("bad input")))
        with pytest.raises(ValueError):
            guarded()
        assert breaker.state == STATE_CLOSED and not breaker._failures

    def test_no_breaker_is_a_pass_through(self):
        from mpi_openmp_cuda_tpu_torch.io.pipeline import ChunkPipeline

        fn = object()
        assert ChunkPipeline(None, None)._guard(fn) is fn


# -- deadlines ---------------------------------------------------------------


class TestDeadlines:
    def test_bad_deadline_values_rejected(self):
        for bad in (True, "soon", 0, -1.5):
            raw = dict(_request("d"), deadline_s=bad)
            with pytest.raises(RequestError, match="deadline_s"):
                build_session(_queued(raw), FakeClock())

    def test_env_default_applies(self, monkeypatch):
        monkeypatch.setenv("SEQALIGN_SERVE_DEADLINE_S", "7.5")
        sess = build_session(_queued(_request("d")), FakeClock())
        assert sess.deadline_t == 7.5  # admitted_t 0.0 + env default

    def test_explicit_deadline_beats_env(self, monkeypatch):
        monkeypatch.setenv("SEQALIGN_SERVE_DEADLINE_S", "7.5")
        raw = dict(_request("d"), deadline_s=2.0)
        assert build_session(_queued(raw), FakeClock()).deadline_t == 2.0

    def test_fill_past_deadline_fails_typed(self):
        sink = Sink()
        raw = dict(_request("d", "ACGT", ["ACGT"]), deadline_s=0.5)
        sess = build_session(_queued(raw, sink), FakeClock())
        sess.fill(0, (1, 2, 3))  # fake clock now() = 1.0 > 0.5
        assert sink.records == [{"id": "d", "error": "deadline"}]
        assert sess.closed
        sess.fill(0, (1, 2, 3))  # retired: no further records
        assert len(sink.records) == 1

    def _loop(self):
        from mpi_openmp_cuda_tpu_torch.serve.loop import ServeLoop

        class _NoPipeline:
            pass

        return ServeLoop(
            _NoPipeline(), None, clock=FakeClock(), max_depth=4,
            window_s=0.0, rows_per_block=4, max_pop=0,
        )

    def test_planning_checkpoint_rejects_expired_and_unmakeable(self):
        loop = self._loop()
        expired_sink, tight_sink, ok_sink = Sink(), Sink(), Sink()
        expired = build_session(
            _queued(dict(_request("late"), deadline_s=1.0), expired_sink),
            FakeClock(),
        )
        tight = build_session(
            _queued(dict(_request("tight"), deadline_s=5.0), tight_sink),
            FakeClock(),
        )
        tight.cost_s = 10.0  # modelled wall cannot fit the 3 s remaining
        ok = build_session(
            _queued(dict(_request("ok"), deadline_s=60.0), ok_sink),
            FakeClock(),
        )
        live = loop._admit_sessions([expired, tight, ok], now=2.0)
        assert live == [ok]
        assert expired_sink.records[0]["error"] == "deadline"
        assert tight_sink.records[0]["error"] == "deadline"
        assert tight_sink.records[0]["estimated_s"] == 10.0

    def test_abandoned_session_retires_silently_and_refunds(self):
        loop = self._loop()
        sink = Sink()
        sess = build_session(
            _queued(_request("gone"), sink), FakeClock(),
            on_close=loop._release_session,
        )
        sess.cost_s = 2.0
        loop.controller._outstanding_s = 2.0
        sess.responder.dead = True  # the client vanished mid-queue
        assert loop._admit_sessions([sess], now=1.0) == []
        assert sink.records == []  # nobody is listening: no records
        assert loop.controller.outstanding_s() == 0.0  # tokens refunded


# -- responder death / dead-socket absorption --------------------------------


class TestResponderDeath:
    def test_mark_dead_fires_callback_exactly_once(self):
        calls = []

        class _Out:
            def write(self, s):
                raise OSError("gone")

            def flush(self):
                pass

        r = Responder(_Out(), on_dead=lambda: calls.append(1))
        r.send({"a": 1})  # write fails → dead + callback
        assert r.dead and calls == [1]
        r.send({"a": 2})  # dropped silently
        r.mark_dead()  # idempotent
        assert calls == [1]

    def test_dead_socket_chaos_marker_deadens_before_write(self):
        writes = []

        class _Out:
            def write(self, s):
                writes.append(s)

            def flush(self):
                pass

        released = []
        activate_faults("dead-socket-midstream:fail=1")
        try:
            r = Responder(_Out(), on_dead=lambda: released.append(1))
            r.send({"id": "x", "line": "#0: ..."})
        finally:
            deactivate_faults()
        assert r.dead and writes == [] and released == [1]


# -- metrics mapping ---------------------------------------------------------


class TestSloMetrics:
    def test_slo_events_map_to_metrics(self):
        from mpi_openmp_cuda_tpu_torch.obs.metrics import MetricsRegistry

        reg = MetricsRegistry(clock=lambda: 0.0)
        reg.record_event("serve.request.failed", {"error": "deadline"})
        reg.record_event("serve.request.failed", {"error": "poison: ..."})
        reg.record_event("serve.request.shed", {"reason": "overloaded"})
        reg.record_event("serve.shed.state", {"state": "shed-new", "p90": 9.0})
        reg.record_event("serve.queue.wait", {"wait_s": 0.25})
        reg.record_event("serve.queue.wait", {"wait_s": 0.75})
        reg.record_event("serve.request.abandoned", {"id": "x"})
        reg.record_event("serve.request.poisoned", {"id": "p"})
        reg.record_event("serve.block.failed", {"rows": 3, "error": "..."})
        reg.record_event("serve.client.lost", {"how": "slow-client"})
        assert reg.counters == {
            "serve_deadline_rejections": 1,
            "serve_failures": 1,
            "serve_shed": 1,
            "serve_shed_transitions": 1,
            "serve_abandoned": 1,
            "serve_poisoned": 1,
            "serve_block_failures": 1,
            "serve_clients_lost": 1,
        }
        assert reg.gauges["shed_state"] == "shed-new"
        assert reg.histograms["queue_wait_s"] == {
            "count": 2, "sum": 1.0, "min": 0.25, "max": 0.75,
            "buckets": {
                "0.001": 0, "0.005": 0, "0.02": 0, "0.1": 0,
                "0.5": 1, "2": 2, "10": 2, "60": 2, "+Inf": 2,
            },
            "p50": 0.75, "p90": 0.75, "p99": 0.75,
        }

    def test_breaker_events_drive_counters_and_state_gauge(self):
        from mpi_openmp_cuda_tpu_torch.obs.metrics import MetricsRegistry

        reg = MetricsRegistry(clock=lambda: 0.0)
        reg.record_event("breaker.open", {"backend": "xla", "tick": 3})
        assert reg.gauges["breaker_state"] == "open"
        reg.record_event("breaker.half_open", {"backend": "pallas"})
        assert reg.gauges["breaker_state"] == "half_open"
        reg.record_event("breaker.close", {"backend": "pallas"})
        assert reg.gauges["breaker_state"] == "closed"
        assert reg.counters == {
            "breaker_opens": 1,
            "breaker_half_opens": 1,
            "breaker_closes": 1,
        }

    def test_slo_metrics_validate_in_run_report_envelope(self):
        from mpi_openmp_cuda_tpu_torch.obs.metrics import (
            MetricsRegistry,
            run_report,
            validate_report,
        )

        reg = MetricsRegistry(clock=lambda: 0.0)
        for ev, fields in (
            ("serve.request.failed", {"error": "deadline"}),
            ("serve.queue.wait", {"wait_s": 0.1}),
            ("breaker.open", {"backend": "xla"}),
            ("serve.shed.state", {"state": "shed-new"}),
        ):
            reg.record_event(ev, fields)
        rep = run_report(reg, exit_code=0)
        validate_report(rep)  # raises on any schema problem
        assert rep["counters"]["serve_deadline_rejections"] == 1
        assert rep["gauges"]["breaker_state"] == "open"
        assert set(rep["histograms"]["queue_wait_s"]) == {
            "count", "sum", "min", "max", "buckets", "p50", "p90", "p99",
        }


# -- e2e over the deterministic stdin pipe -----------------------------------


class TestSloPipeE2E:
    def test_deadline_miss_and_meet(self, tmp_path, capfd):
        reqfile = tmp_path / "reqs.ndjson"
        reqfile.write_text(
            json.dumps(
                dict(_request("late", "ACGTACGT", ["ACGT"]), deadline_s=1e-9)
            )
            + "\n"
            + json.dumps(
                dict(_request("ok", "ACGTACGT", ["ACGT"]), deadline_s=300.0)
            )
            + "\n"
        )
        report = tmp_path / "report.json"
        out, _ = run_cli_inproc(
            "--serve", "--input", str(reqfile),
            "--metrics-out", str(report), capfd=capfd,
        )
        records = _serve_records(out)
        errors = {r["id"]: r["error"] for r in records if "error" in r}
        assert errors == {"late": "deadline"}
        assert any(r.get("done") and r["id"] == "ok" for r in records)
        rep = json.loads(report.read_text())
        assert rep["counters"]["serve_deadline_rejections"] == 1
        assert rep["histograms"]["queue_wait_s"]["count"] >= 2

    def test_overload_burst_sheds_typed_with_retry_hint(
        self, tmp_path, capfd
    ):
        # overload-burst inflates the first two admissions past the whole
        # bucket: #1 rides the empty-bucket guard in, #2 sheds on its own
        # inflated price, #3 sheds against #1's outstanding charge.
        reqfile = tmp_path / "reqs.ndjson"
        reqfile.write_text(
            "".join(
                json.dumps(_request(rid, "ACGTACGT", ["ACGT"])) + "\n"
                for rid in ("r1", "r2", "r3")
            )
        )
        report = tmp_path / "report.json"
        out, _ = run_cli_inproc(
            "--serve", "--input", str(reqfile),
            "--faults", "overload-burst:fail=2",
            "--metrics-out", str(report), capfd=capfd,
        )
        records = _serve_records(out)
        shed = [r for r in records if r.get("error") == "overloaded"]
        assert {r["id"] for r in shed} == {"r2", "r3"}
        for r in shed:
            assert r["retry_after_s"] >= 0.05
        assert any(r.get("done") and r["id"] == "r1" for r in records)
        rep = json.loads(report.read_text())
        assert rep["counters"]["serve_shed"] == 2

    def test_poison_session_is_quarantined_victims_score(
        self, tmp_path, capfd
    ):
        # Two requests share one superblock; the poison marker lands on
        # the first.  Bisection must isolate it with a typed error while
        # the co-batched victim still gets byte-correct lines ON TIME
        # (its generous deadline is live through the whole quarantine).
        seq2 = ["ACGT", "GATTACA"]
        reqfile = tmp_path / "reqs.ndjson"
        reqfile.write_text(
            json.dumps(_request("poison", "ACGTACGT", seq2)) + "\n"
            + json.dumps(
                dict(_request("victim", "ACGTACGT", seq2), deadline_s=300.0)
            )
            + "\n"
        )
        report = tmp_path / "report.json"
        out, err = run_cli_inproc(
            "--serve", "--input", str(reqfile),
            "--faults", "poison-session:fail=1",
            "--metrics-out", str(report), capfd=capfd,
        )
        records = _serve_records(out)
        errors = {r["id"]: r["error"] for r in records if "error" in r}
        assert set(errors) == {"poison"} and "poison" in errors["poison"]
        assert {"id": "victim", "done": True, "n": 2} in records
        assert "quarantined" in err
        rep = json.loads(report.read_text())
        assert rep["counters"]["serve_poisoned"] == 1
        assert rep["counters"]["serve_block_failures"] >= 1
        assert rep["counters"]["serve_completed"] == 1

        # The victim's quarantine-path lines are the same bytes a clean
        # serve run of the identical problem produces.
        clean_out, _ = run_cli_inproc(
            "--serve", "--input", str(reqfile), capfd=capfd
        )
        clean = _lines_by_id(_serve_records(clean_out))
        assert _lines_by_id(records)["victim"] == clean["victim"]

    def test_victim_sharing_a_second_block_with_the_poison_scores(
        self, tmp_path, capfd
    ):
        # Where the port departs from the JAX package: the poison (p)
        # shares the 128-bucket block with a0 and the 256-bucket block
        # with the victim (v).  Bisection of the first block quarantines
        # p; the second block fails again on p's rows, and with p retired
        # the victim is the one live session left in it.  The JAX loop
        # then blames the victim; the port scores it on a block of its own.
        seq1 = "ACGT" * 100
        reqs = [_request("a0", seq1, ["G" * 10]),
                _request("p", seq1, ["A" * 10, "A" * 200]),
                _request("v", seq1, ["C" * 200, "T" * 150])]
        reqfile = tmp_path / "reqs.ndjson"
        reqfile.write_text("".join(json.dumps(r) + "\n" for r in reqs))
        out, err = run_cli_inproc(
            "--serve", "--input", str(reqfile),
            "--faults", "poison-session:fail=1,after=1", capfd=capfd,
        )
        records = _serve_records(out)
        errors = {r["id"]: r["error"] for r in records if "error" in r}
        assert set(errors) == {"p"} and "poison" in errors["p"]
        clean = _lines_by_id(_serve_records(
            run_cli_inproc("--serve", "--input", str(reqfile), capfd=capfd)[0]))
        got = _lines_by_id(records)
        assert got["v"] == clean["v"] and got["a0"] == clean["a0"]
        from test_torch_serve import _jax_run

        jout, _ = _jax_run("--serve", "--input", str(reqfile),
                           "--faults", "poison-session:fail=1,after=1", capfd=capfd)
        jerrors = {r["id"] for r in _serve_records(jout) if "error" in r}
        assert jerrors == {"p", "v"}

    def test_slow_client_marker_is_absorbed(self, tmp_path, capfd):
        reqfile = tmp_path / "reqs.ndjson"
        reqfile.write_text(
            json.dumps(_request("stall", "ACGTACGT", ["ACGT"])) + "\n"
            + json.dumps(_request("fine", "ACGTACGT", ["TTTT"])) + "\n"
        )
        report = tmp_path / "report.json"
        out, _ = run_cli_inproc(
            "--serve", "--input", str(reqfile),
            "--faults", "slow-client:fail=1",
            "--metrics-out", str(report), capfd=capfd,
        )
        # The pipe responder is shared, so the chaos marker deadens it on
        # the FIRST record: the loop must survive with zero output — the
        # stalled client forfeits its results, the server lives on.
        assert _serve_records(out) == []
        rep = json.loads(report.read_text())
        assert rep["counters"]["serve_clients_lost"] == 1
        # Both sessions still retire cleanly (their records are dropped,
        # not wedged behind a stalled write).
        assert rep["counters"]["serve_completed"] == 2


# -- concurrent burst over the loopback socket -------------------------------


@pytest.mark.no_chaos  # exact admission accounting on a live socket
def test_socket_burst_every_client_gets_result_or_typed_rejection(
    tmp_path, monkeypatch, capfd
):
    """Satellite gate: a concurrent queue-full burst never hangs or
    drops a client — each one reads back either its done record or a
    typed rejection (``overloaded`` / queue full), then SIGTERM drains
    the server to 75 as usual."""
    import os
    import socket
    import threading

    monkeypatch.setenv("SEQALIGN_SERVE_MAX_QUEUE", "2")
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]

    results: dict[str, dict] = {}
    failures: list[BaseException] = []

    def client(rid):
        try:
            deadline = 60.0
            while True:
                try:
                    conn = socket.create_connection(
                        ("127.0.0.1", port), timeout=5
                    )
                    break
                except OSError:
                    deadline -= 0.05
                    if deadline <= 0:
                        raise
                    threading.Event().wait(0.05)
            with conn:
                conn.sendall(
                    (json.dumps(_request(rid, "ACGTACGT", ["ACGT"])) + "\n")
                    .encode()
                )
                buf = b""
                while b'"done"' not in buf and b'"error"' not in buf:
                    chunk = conn.recv(65536)
                    if not chunk:
                        break
                    buf += chunk
            for line in buf.decode().splitlines():
                rec = json.loads(line)
                if rec.get("done") or "error" in rec:
                    results[rid] = rec
                    return
        except BaseException as e:  # surfaced in the main thread
            failures.append(e)

    rids = [f"c{i}" for i in range(6)]
    threads = [
        threading.Thread(target=client, args=(rid,), daemon=True)
        for rid in rids
    ]

    def fire_when_served():
        for t in threads:
            t.join(120)
        os.kill(os.getpid(), signal.SIGTERM)

    for t in threads:
        t.start()
    stopper = threading.Thread(target=fire_when_served, daemon=True)
    stopper.start()

    _, _ = run_cli_inproc(
        "--serve", "--port", str(port), "--input", "/dev/null",
        capfd=capfd, rc_want=75,
    )
    stopper.join(120)
    assert not failures, failures
    assert set(results) == set(rids)  # every client answered: no hangs
    for rid, rec in results.items():
        assert rec.get("done") or "error" in rec, (rid, rec)
    # At least one client actually scored through the burst.
    assert any(rec.get("done") for rec in results.values())
