"""The lease-based work queue and the callable drain behind ModelFlow.

Port of the jax-free part of adanet_tpu/distributed/scheduler.py that
`experimental.ParallelScheduler` needs: `LeaseLostError`, `InMemoryKV`,
`WorkUnit`, `plan_windows`, `WorkQueueConfig`, `WorkQueue`,
`LeaseRenewer` and `drain_callables`, the same code. Units are claimed
under TTL leases in published order, renewed by a heartbeat thread, and
settled by a set-once `done/` marker, so a duplicate execution resolves
to one authoritative result (the JAX module's docstring and
docs/scheduler.md describe the lease state machine).

`drain_callables` runs zero-arg callables on a thread pool, each worker
pinned to one device of the pool: a CUDA device is made the thread's
current device (`torch.cuda.device`), as the JAX version pins
`jax.default_device`; a CPU device needs no pinning. The pool defaults
to every visible card, and raises without CUDA unless the caller names
CPU devices. The coordination-service KV store (`CoordinationKV`), the
file KV store (`FileKV`) and the elastic executor come with the port's
distributed placement (ROADMAP item 8), which extends this module.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from adanet_tpu_torch._device import resolve_device
from adanet_tpu_torch.observability import metrics as metrics_lib
from adanet_tpu_torch.observability import spans as spans_lib
from adanet_tpu_torch.robustness import faults
from adanet_tpu_torch.robustness.sched import sched_point

_LOG = logging.getLogger("adanet_tpu_torch")

#: gRPC caps messages at 4 MiB; state payloads are chunked below it
#: (same bound as multihost._KV_CHUNK_BYTES).
_KV_CHUNK_BYTES = 2 << 20

ENSEMBLE = "__ensemble__"

#: Lease TTL for same-process drains (`drain_callables`), where worker
#: "death" is impossible and lease expiry would only add failure modes.
_IN_PROCESS_LEASE_TTL = 24 * 3600.0


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        _LOG.warning("Ignoring non-numeric %s=%r.", name, raw)
        return default


class LeaseLostError(RuntimeError):
    """This worker's lease was re-issued to another worker."""


# --------------------------------------------------------------- KV stores


class InMemoryKV:
    """Thread-safe in-process KV store with the coordination surface.

    Serves single-process elastic runs and the `ParallelScheduler` shim
    (`experimental/phases.py`), and doubles as the deterministic test
    double for the coordination-service client. Values are arbitrary
    Python objects (no serialization round-trip in-process).
    """

    def __init__(self):
        self._store: Dict[str, Any] = {}
        self._cond = threading.Condition()

    def set(self, key: str, value, overwrite: bool = True) -> bool:
        """Stores `value`; returns False when `key` exists and
        `overwrite` is False (the set-once claim primitive)."""
        with self._cond:
            if not overwrite and key in self._store:
                return False
            self._store[key] = value
            self._cond.notify_all()
            return True

    def get(self, key: str, timeout_secs: float):
        """Blocking get bounded by `timeout_secs` (raises TimeoutError)."""
        deadline = time.monotonic() + timeout_secs
        with self._cond:
            while key not in self._store:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(remaining):
                    if key in self._store:
                        break
                    raise TimeoutError(
                        "key %r not set within %.1fs" % (key, timeout_secs)
                    )
            return self._store[key]

    def try_get(self, key: str):
        with self._cond:
            return self._store.get(key)

    def scan(self, prefix: str) -> Dict[str, Any]:
        with self._cond:
            return {
                k: v for k, v in self._store.items() if k.startswith(prefix)
            }

    def delete(self, key: str) -> None:
        with self._cond:
            self._store.pop(key, None)


# ---------------------------------------------------------------- work units


@dataclasses.dataclass(frozen=True)
class WorkUnit:
    """One schedulable unit: `num_steps` training steps of one candidate
    (or of the ensemble group) starting at iteration-local `start_step`."""

    kind: str  # "subnetwork" | "ensemble"
    name: str  # candidate name, or ENSEMBLE
    start_step: int
    num_steps: int

    @property
    def uid(self) -> str:
        return "%s/s%d+%d" % (self.name, self.start_step, self.num_steps)

    @property
    def end_step(self) -> int:
        return self.start_step + self.num_steps

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(obj: dict) -> "WorkUnit":
        return WorkUnit(**obj)


def plan_windows(
    start: int, stop: int, window_steps: int
) -> List[Tuple[int, int]]:
    """K-grid-aligned (start, num_steps) windows covering [start, stop).

    Windows break at multiples of `window_steps` regardless of `start`,
    so a run resumed from any checkpointed step re-joins the same global
    window grid (unit ids — and therefore re-issue bookkeeping and
    speculative warm-starts — stay stable across restarts).
    """
    if window_steps < 1:
        raise ValueError("window_steps must be >= 1.")
    windows = []
    s = start
    while s < stop:
        e = min(stop, (s // window_steps + 1) * window_steps)
        windows.append((s, e - s))
        s = e
    return windows


@dataclasses.dataclass
class WorkQueueConfig:
    """Queue tuning knobs (env-overridable where operators need them)."""

    window_steps: int = 4
    lease_ttl_secs: float = dataclasses.field(
        default_factory=lambda: _env_float("ADANET_LEASE_TTL_SECS", 15.0)
    )
    max_attempts: int = 3
    poll_interval_secs: float = 0.05
    #: No claimable unit AND no completion for this long => the queue is
    #: wedged (e.g. the chief holding the ensemble tail died): raise
    #: PeerLostError instead of polling forever.
    drain_timeout_secs: float = dataclasses.field(
        default_factory=lambda: _env_float(
            "ADANET_DRAIN_TIMEOUT_SECS", 600.0
        )
    )

    @property
    def renew_interval_secs(self) -> float:
        return max(0.05, self.lease_ttl_secs / 3.0)


class WorkQueue:
    """Lease-based work queue over a KV store.

    Key layout under `namespace`:
      units                 JSON list of every unit (published once)
      claim/<uid>/<n>       set-once claim token for attempt n
      lease/<uid>           {owner, attempt, deadline} (renewed)
      done/<uid>            {owner, attempt} (set-once, terminal)
      state/...             completion payloads (written before done/)
      poison/<name>         candidate quarantined (attempts exhausted)
      final/<name>          last completed end_step of a poisoned candidate

    Lifecycle of a unit: pending -> claimed(n) -> done, or
    claimed(n) -> lease expired -> claimed(n+1) -> ... -> poison after
    `max_attempts`. `done/` is set-once so duplicate executions (an
    expired-but-alive worker racing the re-issue) resolve to exactly one
    authoritative result.
    """

    def __init__(
        self,
        kv,
        namespace: str,
        config: WorkQueueConfig,
        worker: str,
        clock: Callable[[], float] = time.time,
    ):
        self._kv = kv
        self._ns = namespace.rstrip("/")
        self.config = config
        self.worker = worker
        self._clock = clock
        self._units: List[WorkUnit] = []
        self._done_cache: Dict[str, dict] = {}
        self._poison_cache: Dict[str, str] = {}
        # Lease-churn accounting on the process registry: the scheduler's
        # recovery behavior used to be visible only in logs; these
        # counters make "how many units re-issued after worker deaths"
        # a snapshot read (flight dumps embed it).
        reg = metrics_lib.registry()
        self._m_claims = reg.counter("scheduler.lease.claims")
        self._m_expiries = reg.counter("scheduler.lease.expiries")
        # claim() observes the same expired lease on every poll until
        # someone wins the re-issue; count each (unit, lease-attempt)
        # expiry once or the counter inflates with poll frequency.
        self._expiries_seen: set = set()
        self._m_reissues = reg.counter("scheduler.lease.reissues")
        self._m_renewals = reg.counter("scheduler.lease.renewals")
        self._m_lost = reg.counter("scheduler.lease.lost")
        self._m_completions = reg.counter("scheduler.units.completions")
        self._m_poisoned = reg.counter("scheduler.units.poisoned")

    # ------------------------------------------------------------- keys

    def _key(self, *parts) -> str:
        return "/".join([self._ns] + [str(p) for p in parts])

    @property
    def namespace(self) -> str:
        return self._ns

    # ------------------------------------------------------ publish/load

    def publish(self, units: List[WorkUnit]) -> None:
        """Publishes the full unit list (chief-only, once per drain)."""
        payload = json.dumps([u.to_json() for u in units])
        self._kv.set(self._key("units"), payload, overwrite=False)
        self._units = list(units)

    def load(self, timeout_secs: float) -> List[WorkUnit]:
        """Blocks until the chief publishes, then caches the unit list."""
        raw = self._kv.get(self._key("units"), timeout_secs)
        if isinstance(raw, bytes):
            raw = raw.decode()
        self._units = [WorkUnit.from_json(o) for o in json.loads(raw)]
        return list(self._units)

    def attach(self, units: List[WorkUnit]) -> None:
        """Adopts an already-loaded unit list (same namespace)."""
        self._units = list(units)

    @property
    def units(self) -> List[WorkUnit]:
        return list(self._units)

    # ------------------------------------------------------------ status

    @staticmethod
    def _json_value(value):
        if value is None:
            return None
        if isinstance(value, bytes):
            value = value.decode()
        if isinstance(value, str):
            return json.loads(value)
        return value

    def refresh(self) -> None:
        """One scan per status prefix instead of a bounded-blocking get
        per key: done/poison markers are monotone, so the caches only
        ever grow and staleness is benign (a unit looks pending a beat
        longer, never done when it is not)."""
        done_prefix = self._key("done")
        for key, value in self._kv.scan(done_prefix).items():
            uid = key[len(done_prefix) + 1 :]
            if uid and uid not in self._done_cache:
                self._done_cache[uid] = self._json_value(value)
        poison_prefix = self._key("poison")
        for key, value in self._kv.scan(poison_prefix).items():
            name = key[len(poison_prefix) + 1 :]
            if isinstance(value, bytes):
                value = value.decode()
            if name:
                self._poison_cache[name] = value

    def is_done(self, unit: WorkUnit) -> bool:
        return unit.uid in self._done_cache

    def poisoned(self, name: str) -> Optional[str]:
        return self._poison_cache.get(name)

    def poison(self, name: str, reason: str, final_step: int) -> None:
        """Quarantines a candidate: its remaining units stop re-issuing
        and readers fall back to its last completed state."""
        self._poison_cache[name] = reason
        if self._kv.set(self._key("poison", name), reason, overwrite=False):
            self._kv.set(self._key("final", name), str(int(final_step)))
            self._m_poisoned.inc()
            spans_lib.tracer().instant(
                "scheduler.poison",
                correlation={"candidate": name},
                reason=str(reason),
            )
            _LOG.error(
                "Work-queue candidate %r poisoned after %d attempts: %s",
                name,
                self.config.max_attempts,
                reason,
            )

    def final_step(self, name: str, fallback: int) -> int:
        value = self._kv.try_get(self._key("final", name))
        if value is None:
            return fallback
        if isinstance(value, bytes):
            value = value.decode()
        return int(value)

    def last_completed_step(self, name: str, entry_step: int) -> int:
        """Largest end_step among this candidate's done units."""
        best = entry_step
        for unit in self._units:
            if unit.name == name and self.is_done(unit):
                best = max(best, unit.end_step)
        return best

    def settled(self, unit: WorkUnit) -> bool:
        """Done, or never coming (its candidate is poisoned)."""
        return self.is_done(unit) or (
            unit.kind == "subnetwork" and self.poisoned(unit.name) is not None
        )

    def drained(self) -> bool:
        self.refresh()
        return all(self.settled(u) for u in self._units)

    # ------------------------------------------------------------- claims

    def _lease(self, unit: WorkUnit) -> Optional[dict]:
        return self._json_value(self._kv.try_get(self._key("lease", unit.uid)))

    def claim(
        self, ready: Callable[[WorkUnit], bool], can_run: Callable[[WorkUnit], bool]
    ) -> Optional[Tuple[WorkUnit, int]]:
        """Claims the first pending-or-expired ready unit, in published
        order (deterministic). Returns (unit, attempt) or None."""
        self.refresh()
        now = self._clock()
        for unit in self._units:
            if self.settled(unit) or not can_run(unit):
                continue
            if not ready(unit):
                continue
            lease = self._lease(unit)
            if lease is None:
                attempt = 0
            elif float(lease["deadline"]) > now:
                continue  # live lease: someone is (believed) working on it
            else:
                expired = (unit.uid, int(lease["attempt"]))
                if expired not in self._expiries_seen:
                    self._expiries_seen.add(expired)
                    self._m_expiries.inc()
                attempt = int(lease["attempt"]) + 1
            won = self._claim_attempt(unit, attempt)
            if won is not None:
                self._m_claims.inc()
                if won > 0:
                    # Attempt > 0 means a prior holder's lease expired
                    # (or died mid-claim) and this unit re-issued.
                    self._m_reissues.inc()
                    spans_lib.tracer().instant(
                        "scheduler.reissue",
                        correlation={
                            "candidate": unit.name,
                            "work_unit": unit.uid,
                        },
                        attempt=won,
                    )
                return unit, won
        return None

    def _claim_token(self) -> str:
        return json.dumps(
            {
                "owner": self.worker,
                "deadline": self._clock() + self.config.lease_ttl_secs,
            }
        )

    def _claim_token_value(self, key: str) -> Optional[dict]:
        try:
            value = self._json_value(self._kv.try_get(key))
        except ValueError:
            return None
        return value if isinstance(value, dict) else None

    def _claim_attempt(self, unit: WorkUnit, attempt: int) -> Optional[int]:
        """Wins the set-once claim token for `attempt` — or a successor.

        The token carries its own deadline so the claim->lease window is
        crash-recoverable: a worker SIGKILLed after winning the token
        but before writing its lease would otherwise park the unit
        forever (every later claimant recomputes the same attempt from
        the absent lease and loses the same set-once race). Losing the
        race against a live token (or a lease at this attempt) means the
        unit is being worked on; losing against an EXPIRED token with no
        matching lease means the winner died mid-claim and the next
        attempt is free to take.
        """
        while True:
            if attempt >= self.config.max_attempts:
                if unit.kind != "ensemble":
                    self.poison(
                        unit.name,
                        "unit %s exhausted %d lease attempts (workers "
                        "died or hung mid-unit)" % (unit.uid, attempt),
                        final_step=self.last_completed_step(
                            unit.name, unit.start_step
                        ),
                    )
                    return None
                # The ensemble cannot be quarantined away (it IS the
                # selection state), and only the chief may run it: keep
                # re-claiming without bound. A stalled-but-alive chief
                # recovers, duplicate executions are arbitrated by the
                # set-once done/ marker, and a DEAD chief is the
                # workers' drain-timeout PeerLostError — not a poison.
            token_key = self._key("claim", unit.uid, attempt)
            if self._kv.set(token_key, self._claim_token(), overwrite=False):
                # Crash window: token won, lease not yet on record — the
                # token's own deadline is what makes a death here
                # recoverable (schedcheck crashes an actor exactly at
                # this point to prove it).
                sched_point("wq.claim_token_won")
                self._write_lease(unit, attempt)
                return attempt
            lease = self._lease(unit)
            if lease is not None and int(lease["attempt"]) >= attempt:
                return None  # the token winner wrote its lease: live
            token = self._claim_token_value(token_key)
            if token is None or float(token.get("deadline", 0.0)) > self._clock():
                return None  # winner presumed alive (mid claim->lease)
            attempt += 1

    def _write_lease(self, unit: WorkUnit, attempt: int, expired=False):
        deadline = 0.0 if expired else self._clock() + self.config.lease_ttl_secs
        self._kv.set(
            self._key("lease", unit.uid),
            json.dumps(
                {
                    "owner": self.worker,
                    "attempt": attempt,
                    "deadline": deadline,
                }
            ),
        )

    def renew(self, unit: WorkUnit, attempt: int) -> None:
        """Heartbeat: extends this worker's lease on `unit`.

        Raises `LeaseLostError` when the lease was re-issued to another
        worker (this worker was declared dead — its eventual result is
        discarded by the set-once `done/` marker anyway).
        """
        faults.trip("lease.renew")
        lease = self._lease(unit)
        if (
            lease is None
            or int(lease["attempt"]) != attempt
            or lease["owner"] != self.worker
        ):
            self._m_lost.inc()
            raise LeaseLostError(
                "lease on %s (attempt %d) re-issued to %s"
                % (unit.uid, attempt, lease and lease.get("owner"))
            )
        # Race window: the ownership check above against the write
        # below — a re-issue landing in between is legal (the set-once
        # done/ marker arbitrates) and schedcheck explores it.
        sched_point("wq.renew_checked")
        self._write_lease(unit, attempt)
        self._m_renewals.inc()

    def release(self, unit: WorkUnit, attempt: int) -> None:
        """Expires this worker's own lease so the unit re-issues
        immediately (used after a unit-scoped fault)."""
        lease = self._lease(unit)
        if lease and int(lease["attempt"]) == attempt:
            self._write_lease(unit, attempt, expired=True)

    # ------------------------------------------------------- completions

    def complete(self, unit: WorkUnit, attempt: int, blob: Optional[bytes]) -> bool:
        """Publishes a unit result; returns False when another execution
        already won (duplicate results are bit-identical by the
        determinism contract, so losing is harmless)."""
        if blob is not None:
            prefix = self._key("state", unit.uid, attempt)
            nchunks = max(1, -(-len(blob) // _KV_CHUNK_BYTES))
            for i in range(nchunks):
                self._kv.set(
                    "%s/%d" % (prefix, i),
                    blob[i * _KV_CHUNK_BYTES : (i + 1) * _KV_CHUNK_BYTES],
                )
            self._kv.set("%s/n" % prefix, str(nchunks))
        # Crash window: payload chunks on record, done/ marker not yet —
        # readers must never observe this as complete.
        sched_point("wq.complete_before_done")
        won = self._kv.set(
            self._key("done", unit.uid),
            json.dumps({"owner": self.worker, "attempt": attempt}),
            overwrite=False,
        )
        if won:
            self._m_completions.inc()
        return won

    def read_blob(self, unit: WorkUnit, timeout_secs: float) -> bytes:
        """The authoritative completion payload of a done unit."""
        record = self._json_value(
            self._kv.get(self._key("done", unit.uid), timeout_secs)
        )
        prefix = self._key("state", unit.uid, record["attempt"])
        raw_n = self._kv.get("%s/n" % prefix, timeout_secs)
        if isinstance(raw_n, bytes):
            raw_n = raw_n.decode()
        chunks = [
            self._kv.get("%s/%d" % (prefix, i), timeout_secs)
            for i in range(int(raw_n))
        ]
        return b"".join(chunks)


class LeaseRenewer:
    """Background heartbeat renewing one unit's lease during execution.

    The work-unit analogue of `watchdog.HeartbeatWriter`: training a
    window blocks the worker thread in device dispatch, so renewal runs
    on a daemon thread. A lost lease is recorded, not raised — the unit
    finishes and the set-once completion marker arbitrates.
    """

    def __init__(self, queue: WorkQueue, unit: WorkUnit, attempt: int):
        self._queue = queue
        self._unit = unit
        self._attempt = attempt
        self._stop = threading.Event()
        self.lost: Optional[LeaseLostError] = None
        self._thread: Optional[threading.Thread] = None

    def __enter__(self) -> "LeaseRenewer":
        def run():
            interval = self._queue.config.renew_interval_secs
            while not self._stop.wait(interval):
                try:
                    self._queue.renew(self._unit, self._attempt)
                except LeaseLostError as exc:
                    self.lost = exc
                    return
                except Exception as exc:  # renewal is best-effort
                    _LOG.warning(
                        "Lease renewal for %s failed: %s",
                        self._unit.uid,
                        exc,
                    )

        self._thread = threading.Thread(
            target=run, name="lease-%s" % self._unit.uid, daemon=True
        )
        self._thread.start()
        return self

    def __exit__(self, *exc_info) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(self._queue.config.renew_interval_secs + 1.0)


# ------------------------------------------------ generic callable drain


def default_devices() -> List[torch.device]:
    """Every visible card; raises without CUDA (`resolve_device`)."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _pinned(device):
    """The thread's current device for a unit: `torch.cuda.device(device)`
    for a card, nothing for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def drain_callables(
    make_units,
    num_workers: int,
    devices=None,
    config: Optional[WorkQueueConfig] = None,
    kv=None,
    labels: Optional[List[str]] = None,
    on_error: str = "raise",
) -> Dict[str, BaseException]:
    """Runs an iterator of zero-arg callables (with barrier sentinels)
    through the lease-based queue on a thread pool.

    The engine behind `experimental.ParallelScheduler` (a thin shim):
    units are claimed under leases in published order, each executing
    on a worker pinned to one device of the pool (`devices`, torch
    devices; by default every visible card, `_pinned`), and a `None`
    sentinel in the
    stream is a BARRIER — all in-flight units drain before later units
    publish (the phase-chaining contract).

    `labels` (aligned with the non-sentinel callables) name the units in
    spans and in the returned error map; unlabeled units are named by
    position. Labels should be unique — the error map is keyed by
    label, so duplicate labels collapse to the LAST failure recorded
    under that name. Failure policy is `on_error`:

    - `"raise"` (the default, the historic contract): the first
      exception aborts the remaining units of the phase and re-raises
      after the drain.
    - `"isolate"`: a failing unit is recorded and the OTHER units keep
      running — its freed worker slot immediately claims the next unit
      (the fleet needs this: one dead trial must not abort a rung).
      The collected `{label: exception}` map is returned.

    In-process threads cannot die independently of the process — every
    callable either completes or raises, and both paths publish the
    set-once done/ marker — so the lease TTL is pinned effectively
    eternal: expiry here could only ever DOUBLE-execute a non-idempotent
    callable (a GIL-starved renewal heartbeat) or silently poison-drop
    it after `max_attempts`, failure modes the cross-process queue needs
    and a same-process pool does not.
    """
    if on_error not in ("raise", "isolate"):
        raise ValueError(
            "on_error must be 'raise' or 'isolate', got %r" % (on_error,)
        )
    config = config or WorkQueueConfig()
    config = dataclasses.replace(
        config,
        lease_ttl_secs=max(config.lease_ttl_secs, _IN_PROCESS_LEASE_TTL),
    )
    kv = kv or InMemoryKV()
    devices = list(devices) if devices is not None else default_devices()
    labels = list(labels) if labels is not None else None
    errors: List[BaseException] = []
    failures: Dict[str, BaseException] = {}
    error_lock = threading.Lock()

    phase = [0]

    def run_phase(
        callables: List[Callable[[], None]], names: List[str]
    ) -> None:
        if not callables:
            return
        phase[0] += 1
        wq = WorkQueue(
            kv,
            "adanet/callables/%d" % phase[0],
            config,
            worker="pool",
        )
        wq.publish(
            [
                WorkUnit("subnetwork", "unit%d" % i, 0, 1)
                for i in range(len(callables))
            ]
        )

        def worker(worker_index: int) -> None:
            wq_local = WorkQueue(
                kv,
                wq.namespace,
                config,
                worker="w%d" % worker_index,
            )
            wq_local.attach(wq.units)
            device = devices[worker_index % len(devices)]
            while True:
                if on_error == "raise":
                    with error_lock:
                        if errors:
                            return
                claim = wq_local.claim(lambda u: True, lambda u: True)
                if claim is None:
                    if wq_local.drained():
                        return
                    time.sleep(config.poll_interval_secs)
                    continue
                unit, attempt = claim
                index = int(unit.name[len("unit"):])
                try:
                    with LeaseRenewer(wq_local, unit, attempt):
                        with _pinned(device):
                            with spans_lib.tracer().span(
                                "callable_unit", unit=names[index]
                            ):
                                callables[index]()
                except BaseException as exc:  # surfaced after the drain
                    with error_lock:
                        errors.append(exc)
                        failures[names[index]] = exc
                    wq_local.complete(unit, attempt, None)
                    if on_error == "raise":
                        return
                    continue
                wq_local.complete(unit, attempt, None)

        threads = [
            threading.Thread(target=worker, args=(i,), daemon=True)
            for i in range(min(num_workers, len(callables)))
        ]
        for thread in threads:
            thread.start()
        for thread in threads:
            # Bounded join (JL009) in a liveness loop: slow callables
            # hold their (eternal) lease, so the wait simply re-arms
            # until the worker thread exits — it cannot exit without
            # first publishing its unit's done/ marker.
            while thread.is_alive():
                thread.join(timeout=60.0)
        if errors and on_error == "raise":
            raise errors[0]

    def unit_name(index: int) -> str:
        if labels is not None and index < len(labels):
            return str(labels[index])
        return "unit%d" % index

    batch: List[Callable[[], None]] = []
    names: List[str] = []
    cursor = 0
    for item in make_units:
        if item is None:  # barrier
            run_phase(batch, names)
            batch, names = [], []
            continue
        batch.append(item)
        names.append(unit_name(cursor))
        cursor += 1
    run_phase(batch, names)
    return dict(failures)
