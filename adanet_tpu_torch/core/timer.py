"""Countdown timer for cooperative worker waits.

Analogue of reference `_CountDownTimer`
(reference: adanet/core/timer.py:25-45).
"""

from __future__ import annotations

import time


class CountDownTimer:
    """Counts down from a duration in seconds."""

    def __init__(self, duration_secs: float):
        self._start = time.monotonic()
        self._duration_secs = float(duration_secs)

    def secs_remaining(self) -> float:
        return max(0.0, self._duration_secs - (time.monotonic() - self._start))
