"""Yield-point seams for deterministic schedule exploration.

`tools/schedcheck` drives the *real* coordination protocols (work-queue
claims, store leases/GC, fleet flips, set-once refs) through
exhaustively enumerated thread interleavings. It needs to pause a
protocol actor exactly at the races' critical windows — between winning
a claim token and writing the lease, between GC's mark and its sweep —
which requires a seam in the protocol code itself, in the same
injection style as the mocked clocks: a label-carrying no-op that a
test harness can hook.

Production cost is one global read per point (`_HOOK is None`); no
import of schedcheck, no threading machinery. The labels form a public
contract: `tools/schedcheck/models.py` registers which labels each
protocol model exercises, and `tests/test_schedcheck.py` cross-checks
every registered label against the live sources (the JL015 discipline,
applied to schedules).
"""

from __future__ import annotations

from typing import Callable, Optional

_HOOK: Optional[Callable[[str], None]] = None


def sched_point(label: str) -> None:
    """Announces a critical window to an installed scheduler hook.

    A no-op unless a harness installed a hook; the hook typically blocks
    the calling thread until the explorer grants it the next step (or
    raises to simulate a crash at exactly this point).
    """
    hook = _HOOK
    if hook is not None:
        hook(label)


def install_hook(hook: Callable[[str], None]) -> Optional[Callable[[str], None]]:
    """Installs `hook`; returns the previous hook for restoration."""
    global _HOOK
    previous = _HOOK
    _HOOK = hook
    return previous


def uninstall_hook(previous: Optional[Callable[[str], None]] = None) -> None:
    """Restores `previous` (default: clears the hook)."""
    global _HOOK
    _HOOK = previous
