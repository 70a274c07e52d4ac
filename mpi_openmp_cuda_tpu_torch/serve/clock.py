"""The injectable serve-plane clock, the one home of blocking waits.

Everything under ``serve/`` that needs "now" or "wait until" goes through
a :class:`ServeClock` handed in at construction:

* tests inject a fake clock whose ``block_until`` returns at once, so
  admission and coalescing run without real sleeps;
* every wait is bounded and condition-based, so a SIGTERM reaches the
  drain's exit 75 within one tick.
"""

from __future__ import annotations

import time


class ServeClock:
    """Monotonic now + bounded condition wait, both injectable.

    ``block_until`` must be called with ``cond``'s lock held (the
    ``threading.Condition.wait_for`` contract); it returns the predicate's
    final value, so a caller tells "woke because true" from a timeout.
    """

    def __init__(self, now=time.monotonic):
        self._now = now

    def now(self) -> float:
        return self._now()

    def block_until(self, cond, predicate, timeout_s: float) -> bool:
        """Wait on ``cond`` until ``predicate()`` or ``timeout_s``."""
        return cond.wait_for(predicate, timeout=timeout_s)
