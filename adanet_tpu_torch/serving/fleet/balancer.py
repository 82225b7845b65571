"""Watermark-balanced front tier: route on backpressure, not on hope.

The balancer is the fleet's single client-facing entry. It holds no
model state — it reads every replica's heartbeat (the typed
`ServingFrontend.stats()` snapshot) off the coordination KV and turns
the watermarks into routing decisions:

- **power-of-two-choices** — each request samples two admitted
  replicas and routes to the lower load score
  `queue_depth + latency_weight * (wait_ewma + exec_ewma)`; classic
  p2c keeps the maximum queue exponentially tighter than random
  routing while reading only two heartbeats per request.
- **hysteretic exclusion** — a replica that goes stale (no fresh
  heartbeat), shedding, or draining is excluded IMMEDIATELY;
  re-admission requires `readmit_beats` consecutive fresh, healthy
  beats — the same one-sided hysteresis as the frontend's own shed
  watermarks, so a replica flapping at the boundary cannot oscillate
  into the routing set once per beat.
- **deadline-aware retry** — a shed, draining, unavailable, or
  connection-failed attempt is retried on a DIFFERENT replica while
  the request's remaining deadline budget still covers one more
  execution (the replica's own exec EWMA is the estimate); a request
  that dies with its budget is answered `shed`/`deadline_exceeded`,
  never silently dropped. `error` is reserved for replica-side 5xx —
  the balancer forwards it, the chaos gate asserts it stays zero.

Thread contract: `submit` is safe from many client threads (routing
state under one lock, transports per-thread).

Host-only module.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set

from adanet_tpu_torch.observability import metrics as metrics_lib
from adanet_tpu_torch.observability import spans as spans_lib
from adanet_tpu_torch.serving import frontend as frontend_lib
from adanet_tpu_torch.serving.fleet import replica as replica_lib
from adanet_tpu_torch.serving.fleet import transport as transport_lib

_LOG = logging.getLogger("adanet_tpu_torch")

ServeResult = frontend_lib.ServeResult


@dataclasses.dataclass
class BalancerConfig:
    #: A replica with no NEW heartbeat (seq advance) for this long on
    #: the balancer's clock is stale.
    stale_after_secs: float = 1.0
    #: Consecutive fresh healthy beats required to re-admit an
    #: excluded replica (the hysteresis boundary).
    readmit_beats: int = 3
    #: Load score weight of the latency watermarks vs queue depth.
    latency_weight: float = 100.0
    #: Retry budget per request across replicas.
    max_attempts: int = 4
    #: Floor on the remaining deadline below which retrying is futile
    #: even when a replica reports a zero exec EWMA (cold start).
    min_retry_budget_secs: float = 0.005
    default_deadline_secs: float = 2.0
    #: Socket-timeout grace past the request's remaining deadline: the
    #: replica answers `deadline_exceeded` ITSELF within the deadline,
    #: so this only covers its answer's tail (and first-shape compile
    #: stalls). A hung-but-connected replica costs at most
    #: remaining + this before TransportError excludes it.
    transport_grace_secs: float = 5.0
    #: Heartbeat-fold rate limit: a `refresh()` younger than this is a
    #: no-op, so a thousand closed-loop clients share one KV scan per
    #: interval instead of issuing one each per request. 0 disables
    #: the throttle (mocked-clock tests drive refresh explicitly).
    refresh_interval_secs: float = 0.05
    #: Forget a tracked replica whose heartbeat key has been GONE this
    #: many seconds (a drained replica deletes its key): bounds
    #: `_tracked` and keeps dead entries out of the brownout fallback.
    forget_after_secs: float = 30.0


class _Tracked:
    __slots__ = (
        "replica_id",
        "payload",
        "last_seq",
        "last_change",
        "excluded",
        "healthy_streak",
    )

    def __init__(self, replica_id: str, now: float):
        self.replica_id = replica_id
        self.payload: Dict[str, Any] = {}
        self.last_seq = -1
        self.last_change = now
        self.excluded = True  # unknown until the first healthy beat
        self.healthy_streak = 0

    @property
    def address(self) -> Optional[str]:
        return self.payload.get("address")

    def score(self, latency_weight: float) -> float:
        depth = float(self.payload.get("queue_depth", 0) or 0)
        wait = float(self.payload.get("wait_ewma_secs", 0.0) or 0.0)
        execs = float(self.payload.get("exec_ewma_secs", 0.0) or 0.0)
        return depth + latency_weight * (wait + execs)


class FleetBalancer:
    """Routes requests across replicas on their heartbeat watermarks."""

    def __init__(
        self,
        kv,
        namespace: str = replica_lib.NAMESPACE,
        config: Optional[BalancerConfig] = None,
        transport_factory: Optional[Callable[[str], Any]] = None,
        clock: Callable[[], float] = time.monotonic,
        rng: Optional[random.Random] = None,
    ):
        self._kv = kv
        self._ns = namespace
        self.config = config or BalancerConfig()
        self._transport_factory = (
            transport_factory or transport_lib.SocketClient
        )
        self._clock = clock
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        self._tracked: Dict[str, _Tracked] = {}
        self._last_refresh: Optional[float] = None
        self._local = threading.local()
        #: Every transport ever built, across ALL client threads —
        #: `close()` must reach further than the caller's own
        #: thread-local cache.
        self._all_clients: List[Any] = []
        reg = metrics_lib.registry()
        self._m_requests = reg.counter("serving.balancer.requests")
        self._m_retries = reg.counter("serving.balancer.retries")
        self._m_transport_errors = reg.counter(
            "serving.balancer.transport_errors"
        )
        self._m_exhausted = reg.counter("serving.balancer.exhausted")
        self._m_exclusions = reg.counter("serving.balancer.exclusions")
        self._m_readmissions = reg.counter(
            "serving.balancer.readmissions"
        )
        self._g_admitted = reg.gauge("serving.balancer.admitted")

    # ------------------------------------------------------------- tracking

    def refresh(self, force: bool = False) -> None:
        """Folds the latest heartbeats into the exclusion state machine."""
        interval = self.config.refresh_interval_secs
        if (
            not force
            and interval > 0
            and self._last_refresh is not None
            and self._clock() - self._last_refresh < interval
        ):
            return
        beats = replica_lib.read_heartbeats(self._kv, self._ns)
        now = self._clock()
        self._last_refresh = now
        with self._lock:
            for replica_id, payload in beats.items():
                tracked = self._tracked.get(replica_id)
                if tracked is None:
                    tracked = _Tracked(replica_id, now)
                    self._tracked[replica_id] = tracked
                seq = int(payload.get("seq", 0))
                # ANY seq change is a new beat: a respawned replica
                # restarts its counter at 1, and keying freshness on
                # "strictly greater" would read the new incarnation as
                # stale until it out-counted its previous uptime.
                new_beat = seq != tracked.last_seq
                if new_beat:
                    tracked.last_seq = seq
                    tracked.last_change = now
                    tracked.payload = payload
                self._fold_health(tracked, payload, now, new_beat)
            # Replicas whose heartbeat KEY is gone (a drained replica
            # deletes it) get the same staleness verdict — iterating
            # only present keys would leave them admitted forever —
            # and are forgotten entirely once long gone.
            for replica_id in list(self._tracked):
                if replica_id in beats:
                    continue
                tracked = self._tracked[replica_id]
                if (
                    now - tracked.last_change
                    > self.config.forget_after_secs
                ):
                    del self._tracked[replica_id]
                    continue
                self._fold_health(
                    tracked, tracked.payload, now, new_beat=False
                )
            self._g_admitted.set(
                sum(
                    1
                    for t in self._tracked.values()
                    if not t.excluded
                )
            )

    def _fold_health(
        self,
        tracked: _Tracked,
        payload: Dict[str, Any],
        now: float,
        new_beat: bool,
    ) -> None:
        """One replica's exclusion-state transition (lock held)."""
        fresh = (
            now - tracked.last_change <= self.config.stale_after_secs
        )
        healthy = (
            fresh
            and not payload.get("shedding")
            and not payload.get("draining")
        )
        if not healthy:
            if not tracked.excluded:
                self._m_exclusions.inc()
            tracked.excluded = True
            tracked.healthy_streak = 0
        elif tracked.excluded and new_beat:
            tracked.healthy_streak += 1
            if tracked.healthy_streak >= self.config.readmit_beats:
                tracked.excluded = False
                self._m_readmissions.inc()
        # An admitted replica stays admitted on a healthy beat.

    def admitted(self) -> List[_Tracked]:
        with self._lock:
            return [
                t for t in self._tracked.values() if not t.excluded
            ]

    def exclude_now(self, replica_id: str) -> None:
        """Connection-level evidence beats heartbeat optimism."""
        with self._lock:
            tracked = self._tracked.get(replica_id)
            if tracked is not None:
                if not tracked.excluded:
                    self._m_exclusions.inc()
                tracked.excluded = True
                tracked.healthy_streak = 0

    # -------------------------------------------------------------- routing

    def choose(self, exclude: Set[str] = frozenset()) -> Optional[_Tracked]:
        """Power-of-two-choices over the admitted set.

        Falls back to any FRESH tracked replica not in `exclude` when
        the admitted set is empty — during a fleet-wide brownout a
        shedding-but-alive replica (which answers an orderly `shed`)
        beats a guaranteed client-side failure. Stale replicas stay
        out of the fallback too: a dead socket costs a connection
        failure per attempt and would burn the bounded retry budget
        while an alive replica waits.
        """
        now = self._clock()
        with self._lock:
            pool = [
                t
                for t in self._tracked.values()
                if not t.excluded
                and t.replica_id not in exclude
                and t.address
            ]
            if not pool:
                pool = [
                    t
                    for t in self._tracked.values()
                    if t.replica_id not in exclude
                    and t.address
                    and now - t.last_change
                    <= self.config.stale_after_secs
                ]
            if not pool:
                return None
            if len(pool) == 1:
                return pool[0]
            a, b = self._rng.sample(pool, 2)
            weight = self.config.latency_weight
            return a if a.score(weight) <= b.score(weight) else b

    def _transport(self, address: str):
        cache = getattr(self._local, "clients", None)
        if cache is None:
            cache = self._local.clients = {}
        client = cache.get(address)
        if client is None:
            client = cache[address] = self._transport_factory(address)
            with self._lock:
                self._all_clients.append(client)
        return client

    # --------------------------------------------------------------- submit

    def submit(
        self,
        features: Any,
        deadline_secs: Optional[float] = None,
    ) -> ServeResult:
        """Routes one request; retries orderly rejections elsewhere."""
        self._m_requests.inc()
        budget = (
            deadline_secs
            if deadline_secs is not None
            else self.config.default_deadline_secs
        )
        deadline = self._clock() + budget
        tried: Set[str] = set()
        attempts = 0
        last: Optional[ServeResult] = None
        span = spans_lib.tracer().span("serving.fleet.request")
        with span:
            while attempts < self.config.max_attempts:
                self.refresh()
                choice = self.choose(exclude=tried)
                if choice is None:
                    break  # nothing routable (or every replica tried)
                attempts += 1
                remaining = deadline - self._clock()
                if remaining <= 0:
                    last = ServeResult(
                        status=frontend_lib.STATUS_DEADLINE,
                        error="deadline exhausted before dispatch",
                    )
                    break
                try:
                    reply = self._transport(choice.address).send(
                        {
                            "op": "serve",
                            "features": features,
                            "deadline_secs": remaining,
                        },
                        timeout_secs=remaining
                        + self.config.transport_grace_secs,
                    )
                except transport_lib.TransportError as exc:
                    self._m_transport_errors.inc()
                    self.exclude_now(choice.replica_id)
                    tried.add(choice.replica_id)
                    last = ServeResult(
                        status=frontend_lib.STATUS_UNAVAILABLE,
                        error=str(exc),
                    )
                    if self._retryable(choice, deadline):
                        self._m_retries.inc()
                        continue
                    break
                result = ServeResult(
                    status=reply.get("status", frontend_lib.STATUS_ERROR),
                    outputs=reply.get("outputs"),
                    generation=reply.get("generation"),
                    retry_after=reply.get("retry_after"),
                    error=reply.get("error"),
                    cascade_level=reply.get("cascade_level"),
                )
                if result.status in (
                    frontend_lib.STATUS_SHED,
                    frontend_lib.STATUS_DRAINING,
                    frontend_lib.STATUS_UNAVAILABLE,
                ):
                    tried.add(choice.replica_id)
                    last = result
                    if self._retryable(choice, deadline):
                        self._m_retries.inc()
                        continue
                    break
                span.set(
                    replica=choice.replica_id,
                    attempts=attempts,
                    status=result.status,
                )
                return result
            self._m_exhausted.inc()
            if last is None:
                last = ServeResult(
                    status=frontend_lib.STATUS_UNAVAILABLE,
                    error="no replicas known to the balancer",
                )
            span.set(attempts=attempts, status=last.status)
            return last

    def _retryable(self, choice: _Tracked, deadline: float) -> bool:
        remaining = deadline - self._clock()
        estimate = max(
            float(choice.payload.get("exec_ewma_secs", 0.0) or 0.0),
            self.config.min_retry_budget_secs,
        )
        return remaining > estimate

    def close(self) -> None:
        with self._lock:
            clients, self._all_clients = self._all_clients, []
        for client in clients:
            try:
                client.close()
            except Exception:
                pass
