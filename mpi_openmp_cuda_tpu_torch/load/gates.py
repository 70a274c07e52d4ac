"""Machine-checked overload-survival gates (the port of
``mpi_openmp_cuda_tpu/load/gates.py``).

Each gate returns a list of problem strings (empty = pass) so callers
aggregate everything wrong at once.  Pure functions over collected
data: the driver and the run report measure, these judge.

The three promises:

1. **Answered-or-typed** (:func:`survival_problems`): at any offered
   rate, every request ends in a result or a *typed* rejection — a
   ``missing`` (silent drop) or ``reset`` (connection death) outcome is
   an overload-survival failure, full stop.
2. **Goodput holds** (:func:`survival_problems` with ``plateau_rps``):
   past saturation the server keeps completing at ≥
   ``min_goodput_frac`` of its pre-saturation plateau — overload may
   shed the excess, it may not collapse the core.
3. **Hysteresis contract** (:func:`transition_problems`): the shed
   machine steps through ``accept → shed-new → drain-only`` one state
   per transition, never teleports; breaker transitions follow
   ``closed → open → half-open → {closed | open}``.  Checked against
   the bus instants in the trace export (``kind="trace"``
   ``traceEvents``), i.e. against what the server actually published.
"""

from __future__ import annotations

from ..serve.slo import _SHED_ORDER


def survival_problems(
    result,
    *,
    phase: str,
    plateau_rps: float | None = None,
    min_goodput_frac: float = 0.8,
    require_typed_shed: bool = False,
) -> list:
    """Gates 1 + 2 over one :class:`~..load.driver.LoadResult`."""
    problems = []
    counts = result.counts()
    for kind, label in (
        ("missing", "silently dropped (no reply before grace deadline)"),
        ("reset", "lost to connection resets/errors"),
    ):
        bad = [o.id for o in result.outcomes if o.kind == kind]
        if bad:
            problems.append(
                f"{phase}: {counts[kind]} request(s) {label}: "
                f"{bad[:8]}{'...' if len(bad) > 8 else ''}"
            )
    for o in result.outcomes:
        if o.kind == "rejected" and o.retry_after_s is None:
            problems.append(
                f"{phase}: overloaded rejection for {o.id} lacks the "
                f"retry_after_s back-off hint"
            )
    if require_typed_shed and counts["rejected"] + counts["failed"] == 0:
        problems.append(
            f"{phase}: expected typed sheds at this offered rate, saw "
            f"none (did the overload phase actually overload?)"
        )
    if plateau_rps is not None and plateau_rps > 0:
        floor = min_goodput_frac * plateau_rps
        if result.goodput_rps < floor:
            problems.append(
                f"{phase}: goodput collapsed past saturation: "
                f"{result.goodput_rps:.2f} req/s < {min_goodput_frac:.0%} "
                f"of the {plateau_rps:.2f} req/s pre-saturation plateau"
            )
    return problems


def _bus_instants(trace_events, name: str) -> list:
    return [
        ev.get("args", {})
        for ev in trace_events
        if isinstance(ev, dict)
        and ev.get("ph") == "i"
        and ev.get("name") == name
    ]


def shed_sequence(trace_events) -> list:
    """The published shed-state sequence, in bus order."""
    return [
        str(args.get("state"))
        for args in _bus_instants(trace_events, "serve.shed.state")
    ]


def breaker_sequence(trace_events) -> list:
    """Published breaker transitions (``open``/``half_open``/``close``)."""
    out = []
    for ev in trace_events:
        if not isinstance(ev, dict) or ev.get("ph") != "i":
            continue
        name = str(ev.get("name", ""))
        if name.startswith("breaker."):
            out.append(name.split(".", 1)[1])
    return out


def transition_problems(trace_events) -> list:
    """Gate 3: every published shed transition moves exactly one step;
    every breaker transition is legal from its predecessor."""
    problems = []
    prev = _SHED_ORDER[0]  # the machine starts at accept
    for state in shed_sequence(trace_events):
        if state not in _SHED_ORDER:
            problems.append(f"shed sequence: unknown state {state!r}")
            continue
        step = abs(_SHED_ORDER.index(state) - _SHED_ORDER.index(prev))
        if step != 1:
            problems.append(
                f"shed sequence: illegal transition {prev!r} -> {state!r} "
                f"({step} steps; the hysteresis contract is one per tick)"
            )
        prev = state
    bstate = "closed"
    legal = {
        "closed": {"open"},
        "open": {"half_open"},
        "half_open": {"close", "open"},
    }
    for what in breaker_sequence(trace_events):
        if what not in legal.get(bstate, set()):
            problems.append(
                f"breaker sequence: illegal transition {bstate!r} -> "
                f"{what!r}"
            )
            break
        bstate = "closed" if what == "close" else what
    return problems
