"""The closing loop: refit the admission plane from measured load (the
port of ``mpi_openmp_cuda_tpu/load/refit.py``).

The serve plane prices admission in modelled superblock-wall seconds (the
Hopper launch model of ``ops/schedule.py``, a lower bound by design) — a
prior that can be far off the wall a deployment achieves (host overhead,
another card, a CPU run).  A mispriced bucket admits much more real work
than its budget and the queue, not admission, absorbs the overload.  This
module refits that prior from measurement:

* **scale** — the per-launch gap rows the trace recorder keeps
  (``gap_attribution.launches``: measured vs modelled wall per launch)
  give the calibration directly: ``scale = total_measured /
  total_modelled``.  The model itself is never edited: the multiplier
  goes back through the env registry (``SEQALIGN_SERVE_COST_SCALE``) and
  drift beyond tolerance is reported as a finding;
* **budget** — measured queue-wait percentiles tune
  ``SEQALIGN_SERVE_COST_BUDGET_S`` toward a target wait: if admitted
  work queued ``p90_wait`` seconds against a ``target_wait_s`` SLO,
  the budget shrinks proportionally (clamped, prior-anchored), so the
  bucket, not the queue, becomes the backpressure surface.

Pure arithmetic over collected reports.
"""

from __future__ import annotations

import dataclasses

from ..obs.metrics import percentile

#: Refit multiplier clamp: beyond this the measurement itself is
#: suspect (a 10^7x drift is a broken trace, not a slow host).
SCALE_CLAMP = (1e-3, 1e7)

#: Budget refit clamp, as a fraction of the prior budget: the refit
#: may tighten hard but never to zero (that would reject everything)
#: nor loosen past 4x (that would un-ask the SLO question).
BUDGET_CLAMP = (0.05, 4.0)

#: Measured/prior drift beyond this factor (either direction) is a
#: finding: the audited prior no longer describes this deployment.
DRIFT_TOLERANCE = 2.0

#: Gap rows below this count refuse to refit (hold the prior): one
#: launch's wall is noise, not a calibration.
MIN_LAUNCHES = 3


@dataclasses.dataclass(frozen=True)
class RefitResult:
    """One refit's knobs, evidence, and findings."""

    prior_scale: float
    scale: float
    prior_budget_s: float
    budget_s: float
    launches: int
    measured_total_s: float
    modelled_total_s: float
    ratio_p50: float  # per-launch measured/modelled spread
    ratio_p90: float
    measured_p90_wait_s: float
    target_wait_s: float
    findings: tuple

    @property
    def drift(self) -> float:
        """Measured-over-prior calibration factor (1.0 = the prior was
        right)."""
        return self.scale / self.prior_scale if self.prior_scale else 0.0

    def env(self) -> dict:
        """The tuned knobs, as env-registry assignments for the next
        run (the feedback half of the loop)."""
        return {
            "SEQALIGN_SERVE_COST_SCALE": f"{self.scale:.6g}",
            "SEQALIGN_SERVE_COST_BUDGET_S": f"{self.budget_s:.6g}",
        }

    def delta_rows(self) -> list:
        """The measured-vs-prior delta report, one row per knob."""
        return [
            {
                "knob": "SEQALIGN_SERVE_COST_SCALE",
                "prior": self.prior_scale,
                "refit": round(self.scale, 6),
                "evidence": (
                    f"{self.launches} launch gap rows: measured "
                    f"{self.measured_total_s:.4f}s vs modelled "
                    f"{self.modelled_total_s:.6f}s (per-launch ratio "
                    f"p50 {self.ratio_p50:.1f}, p90 {self.ratio_p90:.1f})"
                ),
                "drift": round(self.drift, 6),
            },
            {
                "knob": "SEQALIGN_SERVE_COST_BUDGET_S",
                "prior": self.prior_budget_s,
                "refit": round(self.budget_s, 6),
                "evidence": (
                    f"measured p90 queue wait "
                    f"{self.measured_p90_wait_s:.4f}s vs target "
                    f"{self.target_wait_s:.4f}s"
                ),
                "drift": round(
                    self.budget_s / self.prior_budget_s, 6
                ) if self.prior_budget_s else 0.0,
            },
        ]


def _clamp(x: float, lo: float, hi: float) -> float:
    return min(hi, max(lo, x))


def refit(
    gap_attribution: dict | None,
    server_report: dict | None,
    *,
    prior_scale: float = 1.0,
    prior_budget_s: float,
    target_wait_s: float,
    tolerance: float = DRIFT_TOLERANCE,
    min_launches: int = MIN_LAUNCHES,
) -> RefitResult:
    """One measure-vs-prior pass; never raises on thin evidence — it
    holds the prior and says so in ``findings`` instead."""
    findings = []
    gap = gap_attribution or {}
    rows = [
        r for r in (gap.get("launches") or [])
        if isinstance(r, dict)
        and isinstance(r.get("measured_s"), (int, float))
        and isinstance(r.get("modelled_s"), (int, float))
        and r["modelled_s"] > 0.0
    ]
    measured = sum(r["measured_s"] for r in rows)
    modelled = sum(r["modelled_s"] for r in rows)
    ratios = [r["measured_s"] / r["modelled_s"] for r in rows]

    scale = float(prior_scale)
    if len(rows) < max(1, int(min_launches)) or modelled <= 0.0:
        findings.append(
            f"insufficient gap evidence ({len(rows)} priced launches, "
            f"want >= {min_launches}): holding the prior cost scale "
            f"{prior_scale:g}"
        )
    else:
        scale = _clamp(measured / modelled, *SCALE_CLAMP)
        drift = scale / float(prior_scale)
        if drift > tolerance or drift < 1.0 / tolerance:
            findings.append(
                f"cost-model drift: measured launch walls are "
                f"{drift:.1f}x the audited prior (tolerance "
                f"{tolerance:g}x) — the static model stays the prior; "
                f"refit scale {scale:.6g} feeds back via "
                f"SEQALIGN_SERVE_COST_SCALE"
            )

    hist = ((server_report or {}).get("histograms") or {}).get(
        "queue_wait_s"
    ) or {}
    p90_wait = float(hist.get("p90", 0.0))
    budget = float(prior_budget_s)
    if p90_wait > target_wait_s > 0.0:
        lo, hi = BUDGET_CLAMP
        budget = _clamp(
            prior_budget_s * target_wait_s / p90_wait,
            lo * prior_budget_s,
            hi * prior_budget_s,
        )
        ratio = budget / float(prior_budget_s)
        if ratio > tolerance or ratio < 1.0 / tolerance:
            findings.append(
                f"admission-budget drift: measured p90 queue wait "
                f"{p90_wait:.3f}s vs {target_wait_s:.3f}s target refits "
                f"the budget {ratio:.2f}x the prior "
                f"{prior_budget_s:g}s (tolerance {tolerance:g}x)"
            )

    return RefitResult(
        prior_scale=float(prior_scale),
        scale=scale,
        prior_budget_s=float(prior_budget_s),
        budget_s=budget,
        launches=len(rows),
        measured_total_s=round(measured, 9),
        modelled_total_s=round(modelled, 9),
        ratio_p50=round(percentile(ratios, 0.50), 6),
        ratio_p90=round(percentile(ratios, 0.90), 6),
        measured_p90_wait_s=p90_wait,
        target_wait_s=float(target_wait_s),
        findings=tuple(findings),
    )
