"""Collective deadlines and the chief heartbeat: hangs become errors.

Copy of adanet_tpu/robustness/watchdog.py (no framework in it). A dead
peer does not error: it hangs every later rendezvous (a store wait, a
gloo or NCCL collective). `call_with_deadline` runs such a call on a
daemon worker thread and bounds the join, so that a hang becomes a
`PeerLostError` within seconds. The chief keeps a heartbeat file in the
model dir (`HeartbeatWriter`); a worker waiting on the manifest
(`distributed.coordination.wait_for_iteration`) raises `PeerLostError`
as soon as that heartbeat goes stale, instead of waiting out
`worker_wait_timeout_secs`.

Tuning knobs (environment):
- `ADANET_COLLECTIVE_TIMEOUT_SECS`: deadline for every host-level
  agreement (default 600; `0` disables).
- `ADANET_HEARTBEAT_INTERVAL_SECS`: chief heartbeat period (default 5).
- `ADANET_HEARTBEAT_TIMEOUT_SECS`: staleness after which workers declare
  the chief lost (default 60).
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
from typing import Any, Callable, Optional, TypeVar

_LOG = logging.getLogger("adanet_tpu_torch")

T = TypeVar("T")


class PeerLostError(RuntimeError):
    """A distributed peer stopped participating (hang or dead link).

    Carries enough context to diagnose WHICH rendezvous died: the label
    of the collective (or wait), the deadline that expired, and the
    process suspected dead (the broadcast source / the chief).
    """

    def __init__(
        self,
        label: str,
        timeout_secs: Optional[float] = None,
        source_process: Optional[int] = None,
        detail: str = "",
    ):
        self.label = label
        self.timeout_secs = timeout_secs
        self.source_process = source_process
        parts = ["peer lost at %r" % label]
        if timeout_secs is not None:
            parts.append("deadline %.1fs expired" % timeout_secs)
        if source_process is not None:
            parts.append("suspect process %d" % source_process)
        if detail:
            parts.append(detail)
        super().__init__("; ".join(parts))


def collective_timeout_secs(default: float = 600.0) -> Optional[float]:
    """The host-collective deadline; None when disabled (env set to 0)."""
    raw = os.environ.get("ADANET_COLLECTIVE_TIMEOUT_SECS", "")
    if not raw:
        return default
    value = float(raw)
    return value if value > 0 else None


#: Substrings that identify a transport-death exception raised from
#: inside a collective (gloo surfaces peer death as a RuntimeError).
_TRANSPORT_DEATH_MARKERS = (
    "connection",
    "closed",
    "reset",
    "gloo",
    "socket",
    "broken pipe",
    "transport",
)


def call_with_deadline(
    fn: Callable[[], T],
    timeout_secs: Optional[float],
    label: str,
    source_process: Optional[int] = None,
) -> T:
    """Runs `fn` bounded by `timeout_secs`; hangs become PeerLostError.

    `fn` executes on a daemon worker thread. Three outcomes:
    - it returns in time: the value is returned;
    - it raises a transport-death error (connection reset by a dead
      peer): wrapped into `PeerLostError` with the original chained;
    - the deadline expires: `PeerLostError` is raised and the worker
      thread is abandoned (parked on the dead transport; the caller must
      not issue further collectives — see multihost degraded mode).

    `timeout_secs=None` disables the deadline (direct call).
    """
    if timeout_secs is None:
        return fn()
    result: list = []
    error: list = []

    def run():
        try:
            result.append(fn())
        except BaseException as exc:  # surfaced on the caller thread
            error.append(exc)

    thread = threading.Thread(
        target=run, name="watchdog-%s" % label, daemon=True
    )
    start = time.monotonic()
    thread.start()
    thread.join(timeout_secs)
    if thread.is_alive():
        raise PeerLostError(
            label,
            timeout_secs=timeout_secs,
            source_process=source_process,
            detail="collective did not complete (hung transport)",
        )
    if error:
        exc = error[0]
        if isinstance(exc, PeerLostError):
            raise exc
        text = ("%s: %s" % (type(exc).__name__, exc)).lower()
        if isinstance(exc, RuntimeError) and any(
            marker in text for marker in _TRANSPORT_DEATH_MARKERS
        ):
            raise PeerLostError(
                label,
                timeout_secs=timeout_secs,
                source_process=source_process,
                detail="transport died after %.1fs: %s"
                % (time.monotonic() - start, exc),
            ) from exc
        raise exc
    return result[0]


# ----------------------------------------------------------------- heartbeat


def heartbeat_path(directory: str, role: str = "chief") -> str:
    return os.path.join(directory, "heartbeat-%s.json" % role)


def heartbeat_age(directory: str, role: str = "chief") -> Optional[float]:
    """Seconds since the last beat; None when no heartbeat file exists."""
    try:
        return max(0.0, time.time() - os.path.getmtime(heartbeat_path(directory, role)))
    except OSError:
        return None


def _atomic_write_json(path: str, obj: Any) -> None:
    # Local (not checkpoint.py's) to keep this module import-light and
    # cycle-free; heartbeat files are advisory, so no directory fsync.
    directory = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=directory)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class HeartbeatWriter:
    """Periodically touches `heartbeat-<role>.json` in `directory`.

    Run by the chief during training so workers can distinguish "the
    chief is slow" from "the chief is gone" (`wait_for_iteration`'s
    staleness check). Usable as a context manager.
    """

    def __init__(
        self,
        directory: str,
        role: str = "chief",
        interval_secs: Optional[float] = None,
        process_index: int = 0,
    ):
        if interval_secs is None:
            interval_secs = float(
                os.environ.get("ADANET_HEARTBEAT_INTERVAL_SECS", "5")
            )
        self._directory = directory
        self._role = role
        self._interval = float(interval_secs)
        self._process_index = int(process_index)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _beat(self) -> None:
        try:
            _atomic_write_json(
                heartbeat_path(self._directory, self._role),
                {
                    "time": time.time(),
                    "pid": os.getpid(),
                    "process_index": self._process_index,
                },
            )
        except OSError as exc:  # advisory: never kill training over it
            _LOG.warning("Heartbeat write failed: %s", exc)

    def start(self) -> "HeartbeatWriter":
        if self._thread is not None:
            return self
        self._beat()

        def run():
            while not self._stop.wait(self._interval):
                self._beat()

        self._thread = threading.Thread(
            target=run, name="heartbeat-%s" % self._role, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(self._interval + 1.0)
            self._thread = None

    def __enter__(self) -> "HeartbeatWriter":
        return self.start()

    def __exit__(self, *exc_info) -> None:
        self.stop()


def heartbeat_timeout_secs(default: float = 60.0) -> float:
    raw = os.environ.get("ADANET_HEARTBEAT_TIMEOUT_SECS", "")
    return float(raw) if raw else default
