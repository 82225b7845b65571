"""Coordinated fleet-wide generation flips: all replicas flip, or none.

Port of adanet_tpu/serving/fleet/flip_coordinator.py. The protocol is
the JAX package's, key for key; the port stages a generation through its
own gate on the pool's device (`gate_generation(path, pool.device)`),
and its default canary replays live request batches the way the batcher
runs them, zero-padded to a bucket (the exported programs are called at
bucket sizes).

A lone `ModelPool` flips itself after its local canary. A FLEET must
not: replicas flipping independently would serve two generations side
by side for a canary window per replica, and a replica that rejects
what the others accepted would diverge forever. This module runs one
flip decision for the whole fleet over the coordination KV's set-once
claims (the scheduler's primitive, `distributed/scheduler.py`):

1. **lead claim** — the replica that wins the set-once
   `flip/<target>/lead-0` token becomes the canary. The token carries
   its own deadline (the scheduler's claim idiom): a leader SIGKILLed
   mid-canary costs one TTL, then a survivor claims `lead-1` and takes
   over — the flip never wedges on a dead canary.
2. **canary** — the leader stages the generation through the full
   verify/load/smoke gate (`model_pool.gate_generation`) and replays
   recent live traffic on it. Failure publishes an `abort` outcome.
3. **prepare** — every replica stages the generation and writes its
   set-once `ready/<replica>` mark; a gate failure writes
   `stage_failed/<replica>` instead.
4. **decide** — the leader waits for `ready` from every replica with a
   FRESH heartbeat. A replica that dies mid-prepare goes heartbeat-
   stale and drops out of the required set; a stage failure or the
   ready deadline aborts. The decision lands as the set-once
   `outcome` key — the all-or-none point: exactly one of
   `{commit, abort}` can ever exist for a target.
5. **apply** — replicas observing `outcome=commit` atomically adopt
   the staged record (`ModelPool.adopt`); on `abort` they discard it
   and keep the incumbent. A replica SIGKILLed between commit and its
   own adopt completes the flip at respawn: `bootstrap_generation`
   resolves the newest committed target, so the fleet converges to one
   generation regardless of where the crash landed.

Flip targets are keyed by `(iteration, directory inode)`, so a
quarantined-and-republished generation is a fresh flip, never a retry
of the aborted one.

Host-only module; every KV access is non-blocking or bounded, and the
whole machine advances via `step()` — no internal threads, no sleeps —
so the state machine is mocked-clock testable end to end.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from adanet_tpu_torch.robustness import faults
from adanet_tpu_torch.robustness.sched import sched_point
from adanet_tpu_torch.serving import publisher
from adanet_tpu_torch.serving.batcher import bucket_for, pad_batch, request_rows
from adanet_tpu_torch.serving.model_pool import GateError, gate_generation

_LOG = logging.getLogger("adanet_tpu_torch")

DECISION_COMMIT = "commit"
DECISION_ABORT = "abort"


@dataclasses.dataclass
class FlipConfig:
    #: Leader claim-token TTL: a dead canary costs this long before a
    #: survivor takes over.
    lead_ttl_secs: float = 30.0
    #: Live sample batches the leader replays on the staged candidate.
    canary_batches: int = 4
    #: How long the leader waits for every fresh replica's ready mark
    #: before aborting the flip fleet-wide.
    ready_timeout_secs: float = 120.0
    #: Optional bound on |candidate - incumbent| over the canary
    #: samples (replicas serve the SAME chain, so divergence is real
    #: signal here, unlike consecutive AdaNet generations).
    max_divergence: Optional[float] = None


def flip_prefix(namespace: str) -> str:
    return "%s/flip/" % namespace


def target_id(t: int, path: str) -> Optional[str]:
    try:
        st = os.stat(path)
    except OSError:
        return None
    return "gen-%d-%x" % (int(t), st.st_ino)


def parse_target_iteration(target: str) -> int:
    return int(target.split("-")[1])


class _FlipKeys:
    def __init__(self, namespace: str, target: str):
        base = flip_prefix(namespace) + target
        self.lead = lambda attempt: "%s/lead-%d" % (base, attempt)
        self.ready = lambda replica: "%s/ready/%s" % (base, replica)
        self.stage_failed = lambda replica: "%s/stage_failed/%s" % (
            base,
            replica,
        )
        self.outcome = "%s/outcome" % base
        self.flipped = lambda replica: "%s/flipped/%s" % (base, replica)
        self.base = base


def _json(value: Optional[bytes]) -> Optional[dict]:
    if value is None:
        return None
    try:
        return json.loads(
            value.decode() if isinstance(value, bytes) else value
        )
    except (ValueError, AttributeError):
        return None


class FlipParticipant:
    """One replica's role in the coordinated flip protocol.

    Drive with `step()` from the replica's control loop. Collaborators
    are injected for testability: `stage_fn(path) -> record` (default:
    the real verify/load/smoke gate), `canary_fn(record) -> (ok,
    reason)` (default: replay `sample_fn()` batches and check
    finiteness/divergence), `fresh_replicas() -> set` (heartbeat
    census incl. self), and a shared-epoch `clock` (wall clock in
    production — lead deadlines are read by OTHER processes).
    `bucket_sizes` are the batch sizes the default canary pads a
    sample to (the replica's batcher buckets).
    """

    def __init__(
        self,
        kv,
        namespace: str,
        replica_id: str,
        pool,
        model_dir: str,
        fresh_replicas: Callable[[], Set[str]],
        stage_fn: Optional[Callable[[str], Any]] = None,
        canary_fn: Optional[Callable[[Any], Tuple[bool, str]]] = None,
        sample_fn: Optional[Callable[[], List[Any]]] = None,
        config: Optional[FlipConfig] = None,
        clock: Callable[[], float] = time.time,
        bucket_sizes: Tuple[int, ...] = (1, 2, 4, 8, 16, 32),
    ):
        self._kv = kv
        self._ns = namespace
        self.replica_id = replica_id
        self._pool = pool
        self._model_dir = model_dir
        self._fresh = fresh_replicas
        self._stage = stage_fn or (
            lambda path: gate_generation(path, pool.device)
        )
        self._canary = canary_fn or self._default_canary
        self._samples = sample_fn or (lambda: [])
        self.config = config or FlipConfig()
        self._clock = clock
        self._buckets = tuple(bucket_sizes)
        # In-flight target state.
        self._target: Optional[str] = None
        self._path: Optional[str] = None
        self._record = None
        self._lead_attempt: Optional[int] = None
        self._ready_written = False
        self._canary_passed = False
        self._wait_started: Optional[float] = None
        self._tripped = False
        #: Targets resolved locally (committed, aborted, or stale).
        self._finished: Set[str] = set()

    # ------------------------------------------------------------ discovery

    def _active_iteration(self) -> int:
        active = self._pool.active
        return active.iteration_number if active is not None else -1

    def _newest_candidate(self) -> Optional[Tuple[int, str, str]]:
        """Newest unfinished flip candidate above the incumbent."""
        active_t = self._active_iteration()
        candidates = []
        for t, path in publisher.list_generations(self._model_dir):
            if t <= active_t:
                continue
            target = target_id(t, path)
            if target is None or target in self._finished:
                continue
            candidates.append((t, path, target))
        return candidates[-1] if candidates else None

    def _unlatch(self) -> None:
        self._target = None
        self._path = None
        self._record = None
        self._lead_attempt = None
        self._ready_written = False
        self._canary_passed = False
        self._wait_started = None

    def _maybe_supersede(self) -> None:
        """Abandons an in-flight target once a NEWER candidate appears.

        Without this, a generation published while a flip is in flight
        splits the fleet: late-ticking replicas latch the newer target,
        early ones the older, and neither flip can ever gather every
        fresh replica's ready mark — both starve to the ready timeout.
        Publishing a set-once `superseded` abort for the old target
        (lost races against a concurrent commit are fine — the next
        discovery of the target applies whatever outcome won) and
        re-latching keeps every participant converging on the newest
        publication, the fleet edition of the pool's skip-to-newest
        rule.
        """
        if self._target is None:
            return
        newest = self._newest_candidate()
        if newest is None or newest[2] == self._target:
            return
        keys = _FlipKeys(self._ns, self._target)
        if _json(self._kv.try_get(keys.outcome)) is None:
            self._kv.set(
                keys.outcome,
                json.dumps(
                    {
                        "decision": DECISION_ABORT,
                        "reason": "superseded by %s" % newest[2],
                        "replica": self.replica_id,
                        "participants": [],
                    }
                ),
                overwrite=False,
            )
        # NOT locally finished: if a concurrent COMMIT won the outcome
        # race, a later discovery of this target must still apply it.
        self._unlatch()

    def _discover(self) -> None:
        if self._target is not None:
            return
        newest = self._newest_candidate()
        if newest is None:
            return
        t, path, target = newest
        outcome = _json(
            self._kv.try_get(_FlipKeys(self._ns, target).outcome)
        )
        if outcome is not None and outcome.get("decision") == DECISION_ABORT:
            self._finished.add(target)
            return
        self._unlatch()
        self._target, self._path = target, path
        self._tripped = False

    # ------------------------------------------------------------- protocol

    def step(self) -> Optional[str]:
        """Advances one tick; returns an event label when state moved."""
        self._maybe_supersede()
        self._discover()
        if self._target is None:
            return None
        keys = _FlipKeys(self._ns, self._target)
        outcome = _json(self._kv.try_get(keys.outcome))
        if outcome is not None:
            return self._apply(keys, outcome)
        if not self._tripped:
            # The chaos seam: a replica dies HERE — mid-flip, after the
            # target is visible fleet-wide, before its ready/outcome
            # contribution — and the fleet must still converge.
            self._tripped = True
            faults.trip("serving.fleet_flip")
        if self._is_leader(keys):
            return self._lead(keys)
        return self._follow(keys)

    # The leader role is sticky per attempt: whoever won lead-<k> keeps
    # it until the outcome lands or its token expires and a successor
    # claims lead-<k+1>.
    def _is_leader(self, keys: _FlipKeys) -> bool:
        now = self._clock()
        attempt = 0
        while True:
            token = _json(self._kv.try_get(keys.lead(attempt)))
            if token is None:
                # Race window: the absent-token read above vs the
                # set-once claim below — two replicas both reach here
                # and the claim must elect exactly one.
                sched_point("flip.lead_claim")
                won = self._kv.set(
                    keys.lead(attempt),
                    json.dumps(
                        {
                            "replica": self.replica_id,
                            "deadline": now + self.config.lead_ttl_secs,
                        }
                    ),
                    overwrite=False,
                )
                if won:
                    self._lead_attempt = attempt
                    return True
                continue  # lost the race: re-read this attempt
            if token.get("replica") == self.replica_id and (
                self._lead_attempt == attempt
            ):
                # RENEW a live leadership whose token is past half its
                # TTL: a slow prepare phase (followers still staging)
                # must not make an alive-and-waiting canary look dead
                # and spawn a redundant successor leader. Overwrite is
                # safe — only the holder renews its own attempt.
                remaining = float(token.get("deadline", 0.0)) - now
                if remaining < self.config.lead_ttl_secs / 2.0:
                    self._kv.set(
                        keys.lead(attempt),
                        json.dumps(
                            {
                                "replica": self.replica_id,
                                "deadline": now
                                + self.config.lead_ttl_secs,
                            }
                        ),
                        overwrite=True,
                    )
                return True
            if float(token.get("deadline", 0.0)) > now:
                return False  # live foreign leader
            attempt += 1  # expired: the canary died; try to succeed it

    def _ensure_staged(self, keys: _FlipKeys) -> bool:
        if self._record is not None:
            return True
        try:
            started = time.perf_counter()
            self._record = self._stage(self._path)
            _LOG.info(
                "FLEET FLIP %s: staged on %s in %.3f s.",
                self._target,
                self.replica_id,
                time.perf_counter() - started,
            )
            return True
        except GateError as exc:
            self._kv.set(
                keys.stage_failed(self.replica_id),
                json.dumps({"reason": str(exc)}),
                overwrite=False,
            )
            _LOG.error(
                "FLEET FLIP %s: stage failed on %s: %s",
                self._target,
                self.replica_id,
                exc,
            )
            return False

    def _lead(self, keys: _FlipKeys) -> Optional[str]:
        if not self._ensure_staged(keys):
            return self._decide(keys, DECISION_ABORT, "leader stage failed")
        if not self._canary_passed:
            ok, reason = self._canary(self._record)
            if not ok:
                return self._decide(
                    keys, DECISION_ABORT, "canary failed: %s" % reason
                )
            self._canary_passed = True
            self._kv.set(
                keys.ready(self.replica_id), b"1", overwrite=False
            )
            self._ready_written = True
            self._wait_started = self._clock()
        failed = self._kv.scan(keys.base + "/stage_failed/")
        if failed:
            who = sorted(
                key.rsplit("/", 1)[1] for key in failed
            )
            return self._decide(
                keys, DECISION_ABORT, "stage failed on %s" % who
            )
        required = set(self._fresh()) | {self.replica_id}
        ready = {
            key.rsplit("/", 1)[1]
            for key in self._kv.scan(keys.base + "/ready/")
        }
        if required <= ready:
            return self._decide(
                keys, DECISION_COMMIT, "all ready", sorted(required)
            )
        if (
            self._wait_started is not None
            and self._clock() - self._wait_started
            > self.config.ready_timeout_secs
        ):
            return self._decide(
                keys,
                DECISION_ABORT,
                "ready timeout; missing %s" % sorted(required - ready),
            )
        return None

    def _follow(self, keys: _FlipKeys) -> Optional[str]:
        if not self._ensure_staged(keys):
            return "stage_failed"
        if not self._ready_written:
            self._kv.set(
                keys.ready(self.replica_id), b"1", overwrite=False
            )
            self._ready_written = True
            return "ready"
        return None

    def _decide(
        self,
        keys: _FlipKeys,
        decision: str,
        reason: str,
        participants: Optional[List[str]] = None,
    ) -> Optional[str]:
        # Race window: concurrent leaders (successor after an expired
        # token) may both reach the outcome write; the set-once claim
        # must yield exactly one fleet-wide decision.
        sched_point("flip.decide_write")
        won = self._kv.set(
            keys.outcome,
            json.dumps(
                {
                    "decision": decision,
                    "reason": reason,
                    "replica": self.replica_id,
                    "participants": participants or [],
                }
            ),
            overwrite=False,
        )
        outcome = _json(self._kv.try_get(keys.outcome))
        if outcome is None:
            return None  # decided but unreadable; next step retries
        if won:
            _LOG.warning(
                "FLEET FLIP %s: %s decided %s (%s).",
                self._target,
                self.replica_id,
                decision,
                reason,
            )
        return self._apply(keys, outcome)

    def _apply(self, keys: _FlipKeys, outcome: dict) -> str:
        decision = outcome.get("decision")
        target = self._target
        if decision == DECISION_COMMIT:
            if not self._ensure_staged(keys):
                # A commit is irrevocable; a replica that cannot stage
                # the committed generation keeps serving the incumbent
                # and retries from a clean slate next tick (the dir may
                # have rotted locally — heal via store, republish, or
                # operator action; it must NOT mask the fleet decision).
                self._unlatch()
                return "commit_stage_failed"
            from adanet_tpu_torch.observability import spans as spans_lib

            self._pool.adopt(self._record, how="fleet")
            self._kv.set(
                keys.flipped(self.replica_id), b"1", overwrite=False
            )
            spans_lib.tracer().instant(
                "serving.fleet_flip",
                target=target,
                decision=decision,
                replica=self.replica_id,
            )
            self._gc_older_flips(parse_target_iteration(target))
            event = "committed"
        else:
            event = "aborted"
        self._finished.add(target)
        self._unlatch()
        return event

    def _gc_older_flips(self, committed_iteration: int) -> None:
        """Deletes flip records of targets BELOW the new commit.

        Every `FileKV.scan` lists the whole directory, so the hot
        heartbeat path would degrade linearly with flip history if
        finished-flip keys accumulated forever. Anything below the
        newest commit is garbage by construction — `bootstrap` and
        joiners only ever need the newest committed outcome — and
        deletes are idempotent, so replicas racing the same GC are
        harmless.
        """
        prefix = flip_prefix(self._ns)
        for key in self._kv.scan(prefix):
            target = key[len(prefix) :].split("/", 1)[0]
            try:
                if parse_target_iteration(target) < committed_iteration:
                    self._kv.delete(key)
            except (ValueError, IndexError):
                continue

    # ------------------------------------------------------- default canary

    def _default_canary(self, record) -> Tuple[bool, str]:
        """Replays recent live batches on the staged candidate."""
        from adanet_tpu_torch.serving.model_pool import outputs_finite, to_host

        samples = self._samples()[-self.config.canary_batches :]
        incumbent = self._pool.active
        for sample in samples:
            try:
                rows = request_rows(sample)
                features, _ = pad_batch([sample], bucket_for(rows, self._buckets))
                outputs = to_host(record.program(features))
            except Exception as exc:
                return False, "%s: %s" % (type(exc).__name__, exc)
            if not outputs_finite(outputs):
                return False, "non-finite canary outputs"
            if (
                self.config.max_divergence is not None
                and incumbent is not None
            ):
                from adanet_tpu_torch.serving.batcher import max_divergence

                delta = max_divergence(
                    to_host(incumbent.program(features)), outputs
                )
                if delta is not None and delta > self.config.max_divergence:
                    return False, "divergence %.3g" % delta
        return True, "ok"


# ------------------------------------------------------------- bootstrap


def bootstrap_generation(
    kv, namespace: str, model_dir: str
) -> Optional[Tuple[int, str]]:
    """(iteration, path) a (re)spawning replica should serve.

    The highest fleet-COMMITTED generation wins — a replica SIGKILLed
    between the commit outcome and its local adopt completes the flip
    here, at respawn. With no committed flip on record, the newest
    generation NOT under a pending flip is the incumbent everyone else
    is serving (adopting a pending target early would front-run the
    all-or-none decision). A fresh fleet with no flip records at all
    bootstraps from the newest publication.
    """
    generations = publisher.list_generations(model_dir)
    if not generations:
        return None
    by_target = {
        target_id(t, path): (t, path) for t, path in generations
    }
    committed: List[Tuple[int, str]] = []
    pending_iters: List[int] = []
    aborted_targets: Set[str] = set()
    prefix = flip_prefix(namespace)
    targets = {
        key[len(prefix) :].split("/", 1)[0] for key in kv.scan(prefix)
    }
    for target in targets:
        outcome = _json(
            kv.try_get(_FlipKeys(namespace, target).outcome)
        )
        if outcome is None:
            pending_iters.append(parse_target_iteration(target))
        elif outcome.get("decision") == DECISION_COMMIT:
            entry = by_target.get(target)
            if entry is not None:
                committed.append(entry)
        else:
            # Aborted BY IDENTITY: a quarantined-and-republished dir
            # for the same iteration is a fresh target and stays
            # eligible below.
            aborted_targets.add(target)
    if committed:
        return max(committed)
    # The fleet REJECTED aborted targets — a respawning replica
    # adopting one would diverge from the incumbent-serving fleet.
    eligible = [
        (t, path)
        for t, path in generations
        if target_id(t, path) not in aborted_targets
    ]
    if pending_iters:
        floor = min(pending_iters)
        below = [(t, p) for t, p in eligible if t < floor]
        return max(below) if below else None
    return max(eligible) if eligible else None
