"""Deterministic fault injection (the port of ``mpi_openmp_cuda_tpu/
resilience/faults.py``, with the sites of the batch path, the serve
plane and the fleet).

An instrumented code path calls :func:`fire` with a stable site name; an
armed registry decides from a counted schedule whether that invocation
raises.  Same spec + same input => the same faults at the same points.

Spec grammar (``--faults`` or the ``SEQALIGN_FAULTS`` env var)::

    spec    ::= entry (';' entry)*
    entry   ::= site ':' kv (',' kv)*
    kv      ::= 'fail=' N        # inject N consecutive faults
              | 'after=' M      # ... starting at invocation M (default 0)
              | 'kind=' transient|fatal

``kind=transient`` (default) raises :class:`InjectedFaultError`, a
``RuntimeError`` the retry policy absorbs; ``kind=fatal`` raises
:class:`InjectedFatalFaultError`, a ``ValueError``, never retried.

Sites:

========================  ====================================================
``chunk_dispatch``        ``AlignmentScorer.score_codes_async`` entry
``chunk_scoring``         result materialisation (``PendingResult.result`` /
                          ``BucketedPending.result``)
``device_transfer``       the prefetched device->host copy (``prefetch``)
``journal_append``        every journal record write (``utils/journal.py``)
``broadcast_problem``     each coordinator broadcast
``broadcast_chunk``       (``parallel/distributed.py``)
``broadcast_index_set``
``broadcast_stream_meta``
``hang:dispatch``         ``chunk_dispatch`` never returns: blocks until the
                          armed watchdog deadline, then raises the transient
                          ``DeadlineExpiredError``
``hang:gather``           the same at ``chunk_scoring``
``hang:broadcast``        the same at every ``broadcast_*`` site, counted
                          over all four
``kill:journal-append``   SIGKILL this process at the scheduled
                          ``journal_append``
``kill:serve-tick``       SIGKILL at the scheduled serve-loop tick boundary
                          (the ``serve_tick`` fire point): the live serve
                          journal must make ``--resume`` lose and double
                          nothing
``kill:fleet-worker``     SIGKILL a fleet scoring worker at its scheduled
                          ``fleet_score`` fire point: after the lease claim,
                          before any result lands
``kill:fleet-coordinator``  SIGKILL the fleet coordinator at its scheduled
                          ``fleet_pump`` fire point (the pump-tick boundary,
                          after the previous tick's board checkpoint): a
                          ``--fleet-standby`` must take over and answer
                          every unanswered request exactly once
========================  ====================================================

A hang site needs an armed watchdog (``--deadline``); without one it is
the fatal ``HangWithoutDeadlineError``.  ``kind=`` is rejected for hang
and kill sites.

The serve plane's sites are markers: they are consulted with the
non-raising :func:`scheduled` probe and the serve plane shapes the
failure itself, so ``kind=`` is rejected for them too:

==========================  ==================================================
``slow-client``             this ``Responder.send`` behaves like a client
                            whose socket buffer never drains: the record is
                            dropped and the responder marked dead
``dead-socket-midstream``   the client vanished between records
``poison-session``          the session built from this request is poisoned:
                            every superblock holding it fails fatally until
                            the quarantine bisection isolates it
``overload-burst``          this request arrives in a modelled burst that
                            exhausts the admission bucket on its own
``burst:overload``          this request is priced at 5x its modelled wall
                            (sustained open-loop overload)
==========================  ==================================================

The fleet's marker sites (``serve/fleet.py``) shape worker- and
leader-side failures the same way:

==========================  ==================================================
``zombie:fleet-worker``     after scoring, this worker freezes its heartbeat
                            until it is declared dead and its lease epoch
                            fenced, then posts the stale result, which must
                            be counted as fenced, never demuxed
``board:torn-post``         this result post lands half-written; readers
                            treat it as missing, the lease expires and the
                            superblock is re-dispatched
``lease:stall``             this worker claims the offer and never scores it
                            (the pure lease-expiry path)
``zombie:fleet-leader``     the coordinator freezes its leader beat at this
                            pump tick while it goes on serving: a standby
                            deposes it and its late posts are fenced by
                            generation
``board:enospc``            this board post's staging write fails mid-write
                            (disk full): the key reads as missing and no
                            ``.tmp.`` file is left behind
==========================  ==================================================
"""

from __future__ import annotations

from dataclasses import dataclass

from ..obs.events import publish

# Serve-plane marker sites: consulted with scheduled(), never fire().
SERVE_SITES = frozenset({
    "slow-client",
    "dead-socket-midstream",
    "poison-session",
    "overload-burst",
    "burst:overload",
})

# Fleet marker sites (serve/fleet.py, resilience/rescue.py): the same
# scheduled() contract.
FLEET_SITES = frozenset({
    "zombie:fleet-worker",
    "zombie:fleet-leader",
    "board:torn-post",
    "board:enospc",
    "lease:stall",
})

KNOWN_SITES = SERVE_SITES | FLEET_SITES | frozenset({
    "chunk_dispatch",
    "chunk_scoring",
    "device_transfer",
    "journal_append",
    "broadcast_problem",
    "broadcast_chunk",
    "broadcast_index_set",
    "broadcast_stream_meta",
    "hang:dispatch",
    "hang:gather",
    "hang:broadcast",
    "kill:journal-append",
    "kill:serve-tick",
    "kill:fleet-worker",
    "kill:fleet-coordinator",
})

# Which fire point each hang/kill site rides; the alias keeps its own
# invocation counter, so "hang:broadcast:fail=1,after=2" hangs the third
# broadcast of any kind.
_HANG_SITES = {
    "chunk_dispatch": "hang:dispatch",
    "chunk_scoring": "hang:gather",
    "broadcast_problem": "hang:broadcast",
    "broadcast_chunk": "hang:broadcast",
    "broadcast_index_set": "hang:broadcast",
    "broadcast_stream_meta": "hang:broadcast",
}
_KILL_SITES = {
    "journal_append": "kill:journal-append",
    "serve_tick": "kill:serve-tick",
    "fleet_score": "kill:fleet-worker",
    "fleet_pump": "kill:fleet-coordinator",
}


class InjectedFaultError(RuntimeError):
    """An injected transient fault (retried by the policy)."""


class InjectedFatalFaultError(ValueError):
    """An injected fatal fault (never retried)."""


@dataclass(frozen=True)
class SiteFaults:
    """One site's schedule: invocations [after, after + fail) fault."""

    fail: int
    after: int = 0
    kind: str = "transient"


def parse_spec(spec: str) -> dict[str, SiteFaults]:
    """Parse the ``site:fail=N[,after=M][,kind=K]`` grammar; unknown sites
    and keys fail fast, so a typo cannot silently test nothing."""
    sites: dict[str, SiteFaults] = {}
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        site, sep, body = entry.partition(":")
        site = site.strip()
        if site in ("hang", "kill", "zombie", "board", "lease", "burst"):
            # These site names carry a colon: the first body segment joins.
            sub, sep2, rest = body.partition(":")
            site, sep, body = f"{site}:{sub.strip()}", sep2, rest
        if not sep or not body.strip():
            raise ValueError(
                f"bad --faults entry {entry!r}: want site:fail=N[,after=M]"
                "[,kind=transient|fatal]"
            )
        if site not in KNOWN_SITES:
            raise ValueError(
                f"bad --faults site {site!r}: known sites are "
                f"{', '.join(sorted(KNOWN_SITES))}"
            )
        kv = {}
        for part in body.split(","):
            key, sep, val = part.partition("=")
            key, val = key.strip(), val.strip()
            if not sep or key not in ("fail", "after", "kind"):
                raise ValueError(
                    f"bad --faults key {part.strip()!r} for site {site!r}: "
                    "want fail=N, after=M, or kind=transient|fatal"
                )
            if key == "kind":
                if val not in ("transient", "fatal"):
                    raise ValueError(f"bad --faults kind {val!r}: want transient or fatal")
                kv[key] = val
                continue
            try:
                n = int(val)
            except ValueError:
                raise ValueError(f"bad --faults value {val!r} for {site}:{key}") from None
            if n < 0:
                raise ValueError(f"--faults {site}:{key} must be >= 0")
            kv[key] = n
        if "fail" not in kv:
            raise ValueError(f"--faults entry for {site!r} needs fail=N")
        if "kind" in kv and (site.partition(":")[0] in ("hang", "kill")
                             or site in SERVE_SITES or site in FLEET_SITES):
            raise ValueError(
                f"--faults site {site!r} does not take kind= (the failure "
                "shape is the site's own, not a raised error class)"
            )
        if site in sites:
            raise ValueError(f"duplicate --faults site {site!r}")
        sites[site] = SiteFaults(**kv)
    return sites


class FaultRegistry:
    """Per-run fault state: invocation counters + the parsed schedule."""

    def __init__(self, spec: str):
        self.sites = parse_spec(spec)
        self.counts: dict[str, int] = {}
        self.injected = 0

    def _scheduled(self, site: str) -> bool:
        """Bump ``site``'s counter; True inside its [after, after + fail)."""
        n = self.counts.get(site, 0)
        self.counts[site] = n + 1
        sf = self.sites.get(site)
        return sf is not None and sf.after <= n < sf.after + sf.fail

    def scheduled(self, site: str) -> bool:
        """Marker-site probe: bump the counter and report (never raise)
        whether this invocation is scheduled."""
        if self._scheduled(site):
            self.injected += 1
            publish("fault.injected", site=site, kind="marker")
            return True
        return False

    def fire(self, site: str) -> None:
        n = self.counts.get(site, 0)
        sf = self.sites.get(site)
        if self._scheduled(site):
            self.injected += 1
            publish("fault.injected", site=site, kind=sf.kind)
            cls = InjectedFatalFaultError if sf.kind == "fatal" else InjectedFaultError
            raise cls(f"injected {sf.kind} fault at site {site!r} (invocation {n})")
        hang = _HANG_SITES.get(site)
        if hang is not None and hang in self.sites and self._scheduled(hang):
            self.injected += 1
            publish("fault.injected", site=hang, kind="hang")
            from . import watchdog

            watchdog.hang_until_deadline(hang)
        kill = _KILL_SITES.get(site)
        if kill is not None and kill in self.sites and self._scheduled(kill):
            self.injected += 1
            publish("fault.injected", site=kill, kind="kill")
            import os
            import signal

            # A deterministic preemption: SIGKILL cannot be caught; the
            # journal's flushed chunks are already fsync'd.
            os.kill(os.getpid(), signal.SIGKILL)


_active: FaultRegistry | None = None


def activate_faults(spec) -> FaultRegistry | None:
    """Arm a fresh registry for one run (None/empty spec: nothing armed)."""
    global _active
    _active = FaultRegistry(spec) if spec else None
    return _active


def deactivate_faults() -> None:
    global _active
    _active = None


def fire(site: str) -> None:
    """Raise per the armed schedule, else no-op."""
    if _active is not None:
        _active.fire(site)


def scheduled(site: str) -> bool:
    """Non-raising marker probe (the serve sites): True when the armed
    schedule marks this invocation."""
    return _active is not None and _active.scheduled(site)
