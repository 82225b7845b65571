"""Deterministic fault injection: named sites, armed by hit count.

Chaos engineering for the search loop. Production code is instrumented
with named *fault sites* — host-side seams where real failures happen
(a torn checkpoint write, a flaky compile-cache read, a peer that stops
answering collectives). A site is a no-op until armed; tests and chaos
runs arm it by hit count so failures are exactly reproducible:

    from adanet_tpu_torch.robustness import faults
    faults.arm("compile_cache.read", "transient", after=3, count=2)

or, for subprocess chaos runs, via the environment:

    ADANET_FAULTS="checkpoint.write:torn:after=2;collective.entry:hang"

Modes:
- `error`: raise `InjectedFault` (non-transient; bounded retries must NOT
  absorb it).
- `transient`: raise `InjectedTransientError` (an `OSError` with EIO,
  matching `retry.is_transient` — the bounded-retry helpers recover).
- `hang`: sleep `delay` seconds (default 3600) — a dead peer / stuck
  mount, for exercising watchdog deadlines.
- `kill`: SIGKILL the current process — an unclean preemption.
- `torn`: write-site only — write a truncated prefix (`frac` of the
  payload) DIRECTLY at the final path, bypassing the atomic
  write-then-rename protocol, then SIGKILL: the on-disk result of a
  crash on a filesystem without atomic rename semantics.
- `rot`: file-site only — silently flip bits of the file at `path`
  (deterministic positions) and return WITHOUT raising: storage bit
  rot. The process keeps running on corrupted bytes; the verify-on-read
  digest machinery must catch it downstream.

Determinism contract: a spec trips on its `after+1`-th hit and the
`count-1` hits after that, counted per site within the process. No
randomness, no wall clock.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal
import threading
import time
from typing import Dict, Optional

_LOG = logging.getLogger("adanet_tpu_torch")

#: The instrumented sites. `arm` validates against this set so a typo in
#: a chaos config fails loudly instead of silently never firing.
FAULT_SITES = frozenset(
    {
        "checkpoint.write",  # core/checkpoint.py payload writes
        "manifest.read",  # core/checkpoint.py manifest reads
        "collective.entry",  # distributed/multihost.py host collectives
        "compile_cache.read",  # core/compile_cache.py executable lookup
        "data.pull",  # core/estimator.py training-batch pulls
        "lease.renew",  # distributed/scheduler.py work-unit lease renewal
        "workunit.execute",  # distributed/scheduler.py unit execution entry
        "serving.flip",  # serving/model_pool.py generation flip entry
        "serving.model_load",  # serving/model_pool.py program deserialize
        "serving.batch_execute",  # serving/batcher.py padded-batch dispatch
        "serving.replica_heartbeat",  # serving/fleet/replica.py watermark publish
        "serving.fleet_flip",  # serving/fleet/flip_coordinator.py flip participation
        "store.put",  # store/blobstore.py blob publication (post-write)
        "store.get",  # store/blobstore.py blob read entry
        "store.gc",  # store/gc.py collection entry
        "flightrec.dump",  # observability/flightrec.py stage->rename seam
        "fleet.promote",  # fleet/controller.py rung promotion entry
        "fleet.graft",  # fleet/transfer.py cross-search graft planning
    }
)

_MODES = frozenset({"error", "transient", "hang", "kill", "torn", "rot"})

#: Sites whose trip fires before the payload is written; `rot` there
#: would corrupt bytes the site immediately overwrites (see `arm`).
_WRITE_SITES = frozenset({"checkpoint.write"})

ENV_VAR = "ADANET_FAULTS"


class InjectedFault(RuntimeError):
    """A non-transient injected failure (must not be retried away)."""


class InjectedTransientError(OSError):
    """A transient injected failure (satisfies `retry.is_transient`)."""

    def __init__(self, message: str):
        import errno

        super().__init__(errno.EIO, message)


@dataclasses.dataclass
class FaultSpec:
    """One armed fault: trips on hits in [after, after + count)."""

    site: str
    mode: str
    after: int = 0
    count: int = 1
    delay: float = 3600.0
    frac: float = 0.5
    hits: int = 0
    trips: int = 0


_lock = threading.Lock()
_armed: Dict[str, FaultSpec] = {}


def arm(
    site: str,
    mode: str,
    after: int = 0,
    count: int = 1,
    delay: float = 3600.0,
    frac: float = 0.5,
) -> FaultSpec:
    """Arms `site` to trip with `mode` after `after` clean hits."""
    if site not in FAULT_SITES:
        raise ValueError(
            "Unknown fault site %r; known sites: %s"
            % (site, sorted(FAULT_SITES))
        )
    if mode not in _MODES:
        raise ValueError(
            "Unknown fault mode %r; known modes: %s" % (mode, sorted(_MODES))
        )
    if mode == "rot" and site in _WRITE_SITES:
        # At a write site the trip fires BEFORE the payload lands, so
        # the rotted bytes would be immediately overwritten by the
        # clean write — a silently vacuous chaos run. Use `torn` there.
        raise ValueError(
            "rot mode is read/file-site only; %r writes its payload "
            "after the trip (arm torn instead)" % site
        )
    spec = FaultSpec(
        site=site,
        mode=mode,
        after=int(after),
        count=int(count),
        delay=float(delay),
        frac=float(frac),
    )
    with _lock:
        _armed[site] = spec
    _LOG.warning(
        "FAULT ARMED site=%s mode=%s after=%d count=%d",
        site,
        mode,
        spec.after,
        spec.count,
    )
    return spec


def disarm(site: Optional[str] = None) -> None:
    """Disarms one site, or every site when `site` is None."""
    with _lock:
        if site is None:
            _armed.clear()
        else:
            _armed.pop(site, None)


def armed() -> Dict[str, FaultSpec]:
    """Snapshot of the currently armed specs (by site)."""
    with _lock:
        return dict(_armed)


def load_env(value: Optional[str] = None) -> int:
    """Parses `ADANET_FAULTS` (or `value`) and arms the specs within.

    Format: semicolon-separated `site:mode[:key=value]*` entries, e.g.
    `checkpoint.write:torn:after=2;collective.entry:hang:delay=600`.
    Returns the number of specs armed.
    """
    raw = os.environ.get(ENV_VAR, "") if value is None else value
    n = 0
    for entry in raw.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) < 2:
            raise ValueError(
                "Bad %s entry %r (want site:mode[:key=value]*)"
                % (ENV_VAR, entry)
            )
        site, mode = parts[0], parts[1]
        kwargs = {}
        for item in parts[2:]:
            key, _, val = item.partition("=")
            if key not in ("after", "count", "delay", "frac"):
                raise ValueError(
                    "Bad %s option %r in %r" % (ENV_VAR, item, entry)
                )
            kwargs[key] = float(val) if key in ("delay", "frac") else int(val)
        arm(site, mode, **kwargs)
        n += 1
    return n


def _fire(spec: FaultSpec, path: Optional[str], data: Optional[bytes]):
    message = "injected fault at site %s (trip %d)" % (
        spec.site,
        spec.trips,
    )
    _LOG.error("FAULT TRIPPED site=%s mode=%s: %s", spec.site, spec.mode, message)
    # Flight-record the trip BEFORE the failure action, so `kill`/`torn`
    # (SIGKILL) still leave a readable trace of everything up to the
    # injected failure. Lazy import: observability is optional here and
    # the hook must never turn a deterministic chaos run into an import
    # error.
    try:
        from adanet_tpu_torch.observability import flightrec

        flightrec.on_fault_trip(spec.site, spec.mode, spec.trips)
    except Exception:  # telemetry must not alter fault semantics
        _LOG.exception("Flight-recorder fault hook failed; continuing.")
    if spec.mode == "error":
        raise InjectedFault(message)
    if spec.mode == "transient":
        raise InjectedTransientError(message)
    if spec.mode == "hang":
        time.sleep(spec.delay)
        raise InjectedFault(message + " (hang elapsed)")
    if spec.mode == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
        raise InjectedFault(message + " (SIGKILL did not take effect)")
    if spec.mode == "rot":
        if path is None:
            raise InjectedFault(
                message + " (rot mode armed at a site without a path)"
            )
        if data is None:
            with open(path, "rb") as f:
                data = f.read()
        # Bit rot: flip the top bit of 8 deterministically-spaced bytes
        # IN PLACE at the final path, then carry on as if nothing
        # happened — silent corruption is the whole point of the mode.
        rotted = bytearray(data)
        stride = max(1, len(rotted) // 8)
        for i in range(0, len(rotted), stride):
            rotted[i] ^= 0x80
        with open(path, "wb") as f:
            f.write(bytes(rotted))
            f.flush()
            os.fsync(f.fileno())
        return
    if spec.mode == "torn":
        if path is None or data is None:
            raise InjectedFault(
                message + " (torn mode armed at a non-write site)"
            )
        # A crash mid-direct-write: a truncated payload at the FINAL
        # path (no atomic rename protected this file), then lights out.
        torn = data[: max(1, int(len(data) * spec.frac))]
        with open(path, "wb") as f:
            f.write(torn)
            f.flush()
            os.fsync(f.fileno())
        os.kill(os.getpid(), signal.SIGKILL)
        # Only reachable when os.kill is stubbed (tests observing the
        # torn bytes): the write must still not complete.
        raise InjectedFault(message + " (SIGKILL did not take effect)")


def trip(
    site: str,
    path: Optional[str] = None,
    data: Optional[bytes] = None,
) -> None:
    """The instrumented seam: a no-op unless `site` is armed and due.

    Write sites pass `path`/`data` so `torn` mode can leave a truncated
    payload at the final path before killing the process.
    """
    with _lock:
        spec = _armed.get(site)
        if spec is None:
            return
        hit = spec.hits
        spec.hits += 1
        due = hit >= spec.after and (spec.trips < spec.count)
        if due:
            spec.trips += 1
    if due:
        _fire(spec, path, data)


# Subprocess chaos runs arm faults purely through the environment: the
# registry loads ADANET_FAULTS once at import (the instrumented modules
# import this one, so arming precedes any site's first hit).
load_env()
