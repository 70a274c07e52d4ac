"""Static analysis and machine-checked contracts of the port (``seqcheck``).

The port of ``mpi_openmp_cuda_tpu/analysis/``, for the Hopper kernels and
the port's own modules.  Every pass runs on the CPU with no card (the
shared-memory audit against a stated H100 budget there, against the
card's own attributes on it):

* :mod:`.contracts` — the concrete gates of ``--check`` /
  ``SEQALIGN_CHECK`` (the formulation a launch runs, the int32 and fp32
  windows, the packed class, the launch group's widths and the fused
  kernel's tile split, the operands' codes and lengths), checked on the
  host arrays of every planned launch before it is enqueued, and the
  entry points' output contracts, checked on their plain versions at a
  tiny CPU size;
* :mod:`.smem` — the dynamic shared memory of each kernel per width and
  class, modelled from the launch configuration of ``csrc/``, swept over
  every plannable width, packed class and serve block against the card's
  opt-in limit, and (on the card) held against the registers and static
  shared memory ``cudaFuncGetAttributes`` reports;
* :mod:`.ranges` — the constants of ``ops/bounds.py`` re-derived from
  Hopper numerics and diffed against their wired values (a
  ``RangeCert``-shaped record);
* :mod:`.seqlint` — the repo-specific AST lint with the port's scopes;
* :mod:`.lockgraph` — the whole-program lock-graph audit;
* :mod:`.exitflow` — the failure-path certifier;
* :mod:`.interleave` — the small-scope model checker over the fleet
  protocol's real state machines.

Every failure raises a :class:`SeqcheckError` subclass whose message
names the violated bound and the fix.  ``SeqcheckError`` is a
``RuntimeError``, as in the JAX package, so the retry policy classifies a
violation the same way in both packages (transient: ``--retries N``
retries it, and the budget then ends the run with exit 65).
"""

from __future__ import annotations


class SeqcheckError(RuntimeError):
    """Base of every analysis-pass failure.  Always carries an actionable
    message: the violated bound, the observed value, and where the legal
    policy lives."""


class ContractViolation(SeqcheckError):
    """A launch was (or would be) made outside its declared shape, value
    range or formulation contract."""


class ExactnessViolation(ContractViolation):
    """A launch's weights and longest scored row leave the window its
    formulation is exact in: the int32 window of the kernels and of
    ``gather`` (``ops/bounds.py``), or the fp32 window of ``mm``."""


class FeedViolation(ContractViolation):
    """A launch would run a formulation its weights do not afford
    (``dispatch.effective_backend``): the kernels past their int32
    window, ``mm`` past its fp32 window, or an unknown formulation."""


class RowpackViolation(ContractViolation):
    """A packed launch breaches the packed kernel's preconditions: L2P
    128, a class of ``dispatch.pack_classes``, every live row within the
    class, at least 2 rows, and its int32 bound ``2 * l2s * max|v|``."""


class SuperblockViolation(ContractViolation):
    """A launch group the fused kernel cannot run as launched: a member
    bucket wider than the group's L2P, a tile split that does not cover
    L1P or L2P, a serve superblock past its row count, or a ring window
    whose Seq1 length leaves int32."""


class OperandViolation(ContractViolation):
    """A launch's padded host operands break the kernels' input contract:
    codes outside ``0..26``, a length outside ``0..L2P``, or an extended
    Seq1 of the wrong length."""


class SmemBudgetError(SeqcheckError):
    """A kernel configuration's dynamic shared memory exceeds what the
    card allows a block (its opt-in limit), or a kernel's registers or
    static shared memory drifted from the model."""


class LintError(SeqcheckError):
    """The repo-specific AST lint found violations (driver-level error;
    individual findings are :class:`.seqlint.LintFinding` rows)."""


class LockGraphError(SeqcheckError):
    """The whole-program lock-graph audit (analysis/lockgraph.py) found
    a lock-order cycle, a blocking operation reachable while a
    serve-plane/obs lock is held, or a lock acquired and released by
    different classes."""


class InterleaveViolation(SeqcheckError):
    """The interleaving explorer (analysis/interleave.py) found a
    schedule that violates a fleet-protocol invariant (double demux,
    fenced-epoch post admitted, dead-worker resurrection, dropped
    reply).  The message carries the exact event schedule so the
    counterexample replays deterministically."""


class RangeCertError(SeqcheckError):
    """The bounds certifier (analysis/ranges.py) could not certify a
    constant: a wired value in ``ops/bounds.py`` drifted from the value
    re-derived from Hopper numerics.  The message names the constant row,
    both values and the derivation."""


class ExitFlowError(SeqcheckError):
    """The failure-path certifier (analysis/exitflow.py) found an
    exception-flow hazard: a raise site whose exception can escape the
    production call graph without reaching a classifier, a broad
    swallow without a reasoned ``# advisory:`` marker, a shadowed
    (double-classified) handler arm, an exit path that bypasses the
    finally-first flush, an exit-75 mapping not rooted in a
    deadline/drain cause, or a fault-registry site with no reachable
    fire point.  The message names the site and the escape path."""


__all__ = [
    "SeqcheckError",
    "ContractViolation",
    "ExactnessViolation",
    "FeedViolation",
    "RowpackViolation",
    "SuperblockViolation",
    "OperandViolation",
    "SmemBudgetError",
    "LintError",
    "LockGraphError",
    "InterleaveViolation",
    "RangeCertError",
    "ExitFlowError",
]
