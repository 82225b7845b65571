"""Crash flight recorder: dump the telemetry ring on the way down.

A `FlightRecorder` binds a directory to the process tracer + metrics
registry. `dump(reason)` writes ONE JSON document — the last-N span
events, a full metrics snapshot, the armed fault specs, and the dump
reason — via the staged+fsync+rename protocol (`core/checkpoint.py`'s
writer discipline), so a reader can never observe a partial dump: a
SIGKILL mid-write abandons the staging file and leaves the PRIOR dump
intact at the final path.

Dump triggers (docs/observability.md has the lifecycle):

- **fault-site trips**: `robustness/faults.py` calls `on_fault_trip`
  before firing, so even a `torn`/`kill` trip that SIGKILLs the process
  leaves a readable trace of everything up to the injected failure —
  chaos forensics become trace reading instead of log archaeology.
- **SIGTERM drain**: the Estimator's checkpoint-and-stop path and the
  serving front-end's signal-initiated drain call
  `dump_installed("sigterm_drain")` from their (non-signal-handler)
  drain machinery; a programmatic front-end `drain()` writes no dump.
- **peer loss**: the Estimator dumps when a `PeerLostError` degrades
  the search.

One recorder is INSTALLED process-wide: `install_default` keeps the
incumbent when the directory matches (the Estimator and a serving pool
sharing one model dir share one recorder) and REBINDS when it differs
(the newest search/pool owns the dumps). The dump path is stable per
process (`flight-<pid>.json`, replaced atomically), so concurrent
searcher/server processes sharing a model dir never clobber each other
and "the prior dump survives a mid-write SIGKILL" is a single-file
invariant.

Host-only module: stdlib I/O between device steps, nothing else.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

from adanet_tpu_torch.observability import metrics as metrics_lib
from adanet_tpu_torch.observability import spans as spans_lib

_LOG = logging.getLogger("adanet_tpu_torch")

__all__ = [
    "FlightRecorder",
    "dump_installed",
    "install",
    "install_default",
    "installed",
    "on_fault_trip",
    "uninstall",
]

#: Subdirectory of a model dir where the default recorder lives.
DEFAULT_SUBDIR = "flightrec"

#: Staging prefix inside the flight dir: an abandoned stage file (a
#: SIGKILL between stage and rename) is identifiable and reclaimed by
#: a later dump; it is never a readable dump. The writer's pid is
#: embedded (`.stage-<pid>-...`) so the sweep can distinguish a DEAD
#: writer's stray (reclaim) from a LIVE concurrent dumper's in-flight
#: stage in a shared flight dir (leave alone — unlinking it would turn
#: that process's os.replace into a lost dump).
_STAGE_PREFIX = ".stage-"


def _stage_pid(name: str) -> Optional[int]:
    """The writer pid embedded in a stage filename, or None."""
    rest = name[len(_STAGE_PREFIX):]
    pid_part = rest.split("-", 1)[0]
    return int(pid_part) if pid_part.isdigit() else None


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True  # e.g. EPERM: exists, owned by someone else
    return True


class FlightRecorder:
    """Dumps the telemetry ring + metrics snapshot to one directory."""

    def __init__(
        self,
        directory: str,
        tracer: Optional[spans_lib.Tracer] = None,
        registry: Optional[metrics_lib.MetricsRegistry] = None,
        clock=time.time,
    ):
        self.directory = os.path.abspath(directory)
        self.tracer = tracer or spans_lib.tracer()
        self.registry = registry or metrics_lib.registry()
        self._clock = clock
        self._lock = threading.Lock()
        self._dump_seq = 0
        self._reasons: List[str] = []
        os.makedirs(self.directory, exist_ok=True)

    @property
    def dump_path(self) -> str:
        return os.path.join(self.directory, "flight-%d.json" % os.getpid())

    def _sweep_stale_stages(self) -> None:
        """Reclaims staging strays whose writer is gone.

        Own-pid strays are safe to reclaim too: `_dump` holds `_lock`
        for the whole stage->rename window, so a same-pid stray can
        only be a previous incarnation's leftover (pid reuse). A stray
        from a LIVE other pid is a concurrent dumper mid-write — never
        touched.
        """
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        for name in names:
            if not name.startswith(_STAGE_PREFIX):
                continue
            pid = _stage_pid(name)
            if pid is not None and pid != os.getpid() and _pid_alive(pid):
                continue
            try:
                os.unlink(os.path.join(self.directory, name))
            except OSError:
                pass

    def dump(self, reason: str, extra: Optional[dict] = None) -> Optional[str]:
        """Writes the flight dump; returns its path (None on failure).

        Never raises: the recorder rides failure paths (fault trips,
        drains) where a telemetry error must not mask or amplify the
        original problem.
        """
        try:
            return self._dump(reason, extra)
        except Exception as exc:  # telemetry must not kill the patient
            _LOG.error(
                "Flight-recorder dump failed (%s: %s); continuing.",
                type(exc).__name__,
                exc,
            )
            return None

    def _dump(self, reason: str, extra: Optional[dict]) -> str:
        # One lock over the whole stage->rename window: concurrent
        # dumpers in this process (a fault trip on a worker thread vs a
        # drain on the executor thread) serialize instead of racing the
        # sweep against each other's in-flight stage files.
        with self._lock:
            return self._dump_locked(reason, extra)

    def _dump_locked(self, reason: str, extra: Optional[dict]) -> str:
        from adanet_tpu_torch.robustness import faults

        self._dump_seq += 1
        self._reasons.append(str(reason))
        seq = self._dump_seq
        reasons = list(self._reasons)
        doc: Dict[str, Any] = {
            "version": 1,
            "reason": str(reason),
            "reasons": reasons,
            "dump_seq": seq,
            "pid": os.getpid(),
            "wall_time": float(self._clock()),
            "events": [e.to_json() for e in self.tracer.events()],
            "metrics": self.registry.snapshot(),
            "armed_faults": {
                site: {
                    "mode": spec.mode,
                    "after": spec.after,
                    "count": spec.count,
                    "hits": spec.hits,
                    "trips": spec.trips,
                }
                for site, spec in faults.armed().items()
            },
        }
        if extra:
            doc["extra"] = dict(extra)
        payload = json.dumps(doc, sort_keys=True).encode()
        self._sweep_stale_stages()
        final = self.dump_path
        fd, tmp = tempfile.mkstemp(
            dir=self.directory,
            prefix="%s%d-" % (_STAGE_PREFIX, os.getpid()),
        )
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            # The chaos seam sits between stage and rename: a `kill`
            # armed here SIGKILLs mid-write — the stage file is
            # abandoned and the PRIOR dump at the final path stays
            # intact (the invariant tests/flightrec_chaos_runner.py
            # proves).
            faults.trip("flightrec.dump", path=final, data=payload)
            os.replace(tmp, final)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        directory_fd = None
        try:
            directory_fd = os.open(self.directory, os.O_RDONLY)
            os.fsync(directory_fd)
        except OSError:  # pragma: no cover - exotic filesystems
            pass
        finally:
            if directory_fd is not None:
                os.close(directory_fd)
        _LOG.info("Flight dump #%d (%s) -> %s", seq, reason, final)
        return final


def load_dump(path: str) -> dict:
    """Parses one flight dump (the trace_view CLI's reader)."""
    with open(path, "rb") as f:
        doc = json.loads(f.read().decode())
    if not isinstance(doc, dict) or "events" not in doc:
        raise ValueError("%s is not a flight dump" % path)
    return doc


# ----------------------------------------------------- process default

_installed_lock = threading.Lock()
_installed: Optional[FlightRecorder] = None
_in_fault_dump = threading.local()


def install(recorder: FlightRecorder) -> FlightRecorder:
    """Installs `recorder` as the process default (replaces any)."""
    global _installed
    with _installed_lock:
        _installed = recorder
    return recorder


def install_default(directory: str) -> Optional[FlightRecorder]:
    """Installs (or rebinds) the default recorder rooted at `directory`.

    Same directory as the incumbent -> the incumbent is kept (the
    Estimator and a serving pool sharing one model dir share one
    recorder, reason history intact). A DIFFERENT directory rebinds to
    the newest caller: the active search/pool owns the dumps — a stale
    first-wins latch would misroute (or, after the old tmpdir is
    deleted, silently lose) every later consumer's crash forensics.
    Never raises: an unwritable directory logs and leaves the incumbent
    (possibly None) installed.
    """
    global _installed
    with _installed_lock:
        requested = os.path.abspath(directory)
        if _installed is None or _installed.directory != requested:
            if _installed is not None:
                _LOG.info(
                    "Flight recorder rebinding %s -> %s.",
                    _installed.directory,
                    requested,
                )
            try:
                _installed = FlightRecorder(directory)
            except OSError as exc:
                # Telemetry must not kill the patient: a read-only
                # model dir (serving-only replica on a snapshot mount)
                # must not crash Estimator/ModelPool construction —
                # they ran fine without a recorder before this plane
                # existed. The incumbent (or None) stays installed.
                _LOG.error(
                    "Flight recorder unavailable at %s (%s: %s); "
                    "running without crash dumps there.",
                    requested,
                    type(exc).__name__,
                    exc,
                )
        return _installed


def installed() -> Optional[FlightRecorder]:
    with _installed_lock:
        return _installed


def uninstall() -> None:
    global _installed
    with _installed_lock:
        _installed = None


def dump_installed(reason: str, extra: Optional[dict] = None) -> Optional[str]:
    """Dumps via the installed recorder; no-op when none is installed."""
    recorder = installed()
    if recorder is None:
        return None
    return recorder.dump(reason, extra)


def on_fault_trip(site: str, mode: str, trip: int) -> None:
    """The `faults._fire` hook: narrate the trip, then dump.

    Runs BEFORE the fault's action, so `kill`/`torn` trips (SIGKILL)
    still leave a dump. Reentrancy-guarded: the dump's own
    `flightrec.dump` seam must not recurse into another dump.
    """
    if getattr(_in_fault_dump, "active", False):
        return
    recorder = installed()
    tracer = recorder.tracer if recorder is not None else spans_lib.tracer()
    tracer.instant("fault.trip", site=site, mode=mode, trip=trip)
    metrics_lib.registry().counter("faults.trips").inc()
    if recorder is None:
        return
    if site == "flightrec.dump":
        # The in-flight dump IS the dump for this trip; recursing would
        # stack dumps behind the very seam being chaos-tested.
        return
    _in_fault_dump.active = True
    try:
        recorder.dump("fault:%s:%s" % (site, mode))
    finally:
        _in_fault_dump.active = False
