"""Load plane: deterministic open-loop traffic against the serve plane (the
port of ``mpi_openmp_cuda_tpu/load``, pure library and stdlib).

The serve plane's overload defences (cost-aware admission, shed
hysteresis, deadlines, the breaker) need traffic that does not wait:
an arrival schedule fixed before the run and replayed against the wire
however the server responds.  This package generates that open-loop
regime and closes the measure-model-refit loop on admission:

* :mod:`.arrival` — seeded arrival-time schedules (constant / poisson /
  burst / ramp); arithmetic over a seed, no clock;
* :mod:`.workload` — seeded request synthesis: Seq2 length mix,
  problem-key diversity (distinct weights + Seq1), deadline mix;
* :mod:`.replay` — request-trace record/replay at k x speed;
* :mod:`.driver` — the only wall-clock module: concurrent ndjson socket
  clients paced to the schedule, every request classified into a typed
  outcome;
* :mod:`.gates` — the overload-survival gates: every request answered or
  rejected with a type (no silent drops, no resets), goodput retention
  past saturation, legal shed and breaker transition sequences;
* :mod:`.report` — the ``formulation="serve-load"`` bench record in the
  obs run-report envelope;
* :mod:`.refit` — refit the cost model's scale and the admission budget
  from measured launch rows and queue waits, fed back through the env
  registry (``SEQALIGN_SERVE_COST_SCALE``,
  ``SEQALIGN_SERVE_COST_BUDGET_S``).

Nothing here imports torch, so a load generator can schedule and price
without touching the card.
"""
