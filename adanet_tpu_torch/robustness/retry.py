"""Bounded, deterministic retry-with-backoff for transient host errors.

A long search crosses many filesystem and data-source operations; a
single EIO from a flaky network mount must degrade to a short stall,
not kill a multi-hour run. `with_retries` wraps such an operation with a
DETERMINISTIC exponential backoff (no jitter — reproducibility beats
thundering-herd concerns for a handful of processes) and a hard attempt
bound, so a persistent failure still surfaces quickly and with the
original exception.

Only *transient* errors are retried: `is_transient` recognizes the
classic retriable errno family plus the injected-transient marker from
`robustness.faults`. A `FileNotFoundError` or a corruption error is
never retried — retrying cannot fix those, and absorbing them would turn
a real bug into a slow mystery.
"""

from __future__ import annotations

import errno
import logging
import time
from typing import Callable, Optional, TypeVar

_LOG = logging.getLogger("adanet_tpu_torch")

T = TypeVar("T")

#: Errnos that plausibly heal on retry (I/O hiccup, contention, stale
#: NFS handle). ENOENT/EACCES and friends are deliberately absent.
TRANSIENT_ERRNOS = frozenset(
    {
        errno.EIO,
        errno.EAGAIN,
        errno.EBUSY,
        errno.EINTR,
        errno.ETIMEDOUT,
        getattr(errno, "ESTALE", errno.EIO),
    }
)


def is_transient(exc: BaseException) -> bool:
    """True when retrying `exc` can plausibly succeed."""
    if isinstance(exc, (TimeoutError, InterruptedError, BlockingIOError)):
        return True
    if isinstance(exc, ConnectionError):
        return True
    if isinstance(exc, OSError):
        return exc.errno in TRANSIENT_ERRNOS
    return False


def with_retries(
    fn: Callable[[], T],
    attempts: int = 4,
    base_delay: float = 0.05,
    multiplier: float = 2.0,
    max_delay: float = 2.0,
    retry_on: Callable[[BaseException], bool] = is_transient,
    sleep: Callable[[float], None] = time.sleep,
    label: str = "",
) -> T:
    """Calls `fn` up to `attempts` times, backing off between failures.

    Delays are the deterministic sequence `base_delay * multiplier**k`
    capped at `max_delay`. Non-transient errors (per `retry_on`) and the
    final attempt's error propagate unchanged.
    """
    if attempts < 1:
        raise ValueError("attempts must be >= 1.")
    delay = base_delay
    for attempt in range(attempts):
        try:
            return fn()
        except BaseException as exc:
            if attempt == attempts - 1 or not retry_on(exc):
                raise
            _LOG.warning(
                "Transient failure%s (attempt %d/%d, retrying in %.2fs): %s",
                " in %s" % label if label else "",
                attempt + 1,
                attempts,
                delay,
                exc,
            )
            sleep(delay)
            delay = min(delay * multiplier, max_delay)
    raise AssertionError("unreachable")  # pragma: no cover


def retrying_open_read(
    path: str,
    attempts: int = 4,
    sleep: Optional[Callable[[float], None]] = None,
    label: str = "",
) -> bytes:
    """Reads a file's bytes with transient-error retries."""

    def read() -> bytes:
        with open(path, "rb") as f:
            return f.read()

    kwargs = {"attempts": attempts, "label": label or path}
    if sleep is not None:
        kwargs["sleep"] = sleep
    return with_retries(read, **kwargs)
