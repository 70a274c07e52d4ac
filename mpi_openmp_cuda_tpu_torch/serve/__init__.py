"""The serve plane (the port of ``mpi_openmp_cuda_tpu/serve``, single
process): a persistent alignment server with bucketed continuous batching
over the same ``AlignmentScorer``, and so the same Hopper kernels, as the
batch CLI.

* :mod:`.clock` — the injectable serve clock, the one home of blocking
  waits here;
* :mod:`.queue` — deterministic admission control over raw request dicts;
* :mod:`.session` — per-request lifecycle: typed validation, ordered
  result emission, done/error records, the serve journal;
* :mod:`.batcher` — Seq2 rows of concurrent requests coalesced into
  shared fixed-shape superblocks, tagged for demux;
* :mod:`.slo` — request pricing on the Hopper launch model, the token
  bucket and the load-shedding machine;
* :mod:`.loop` — the serve loop: dispatch through the shared
  ``io/pipeline.py``, the circuit breaker, poison quarantine, the live
  journal, drain -> journal -> exit 75, the fleet coordinator's and the
  standby's branches;
* :mod:`.fleet` — the elastic serve fleet: superblocks offered on a
  ``FileBoard`` under epoch-fenced leases to ``--fleet-worker`` processes
  (each scoring on its own card's kernels), leader leases and the
  ``--fleet-standby`` takeover.

The CLI imports it only under ``--serve``, ``--fleet-worker`` and
``--fleet-standby``.
"""

from .fleet import (
    FleetCoordinator,
    FleetWorker,
    LeadershipLostError,
    lease_ticks_for,
    run_fleet_worker,
    standby_wait,
)

__all__ = [
    "FleetCoordinator",
    "FleetWorker",
    "LeadershipLostError",
    "lease_ticks_for",
    "run_fleet_worker",
    "standby_wait",
]
