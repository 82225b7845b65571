"""The port's work queue (`distributed/scheduler.py`: the part of the JAX
scheduler that ModelFlow's `ParallelScheduler` needs) against the JAX
package's tests.

- Copies of the jax-free work-queue tests of tests/test_scheduler.py
  (plan_windows through test_drain_callables_isolates_failures_by_label),
  lease-expiry boundaries on an injected clock and the in-memory KV, no
  sleeps; `drain_callables` is given a CPU pool. Not copied:
  test_batch_log_replay_survives_second_transient, which tests the
  Estimator's `_BatchLog` (the elastic drain's input log, ROADMAP item
  8).
- `drain_callables`' barriers: every unit before a barrier finishes
  before any after it starts, with several workers.
- The same unit list, claims and completions in both packages' queues.
"""

import threading
import time

import pytest
import torch

from adanet_tpu_torch.distributed.scheduler import (
    InMemoryKV,
    LeaseLostError,
    WorkQueue,
    WorkQueueConfig,
    WorkUnit,
    plan_windows,
)

CPU = [torch.device("cpu")]


class FakeClock:
    def __init__(self, start: float = 1000.0):
        self.now = start

    def __call__(self) -> float:
        return self.now

    def advance(self, secs: float) -> None:
        self.now += secs


def _queue(clock, worker="p0", **config_kwargs):
    kv = InMemoryKV()
    config = WorkQueueConfig(
        lease_ttl_secs=10.0, poll_interval_secs=0.0, **config_kwargs
    )
    return (
        kv,
        WorkQueue(kv, "ns", config, worker=worker, clock=clock),
    )


def _peer(kv, queue, worker, clock):
    other = WorkQueue(kv, "ns", queue.config, worker=worker, clock=clock)
    other.attach(queue.units)
    return other


ALWAYS = (lambda u: True, lambda u: True)


# ----------------------------------------------------------- queue mechanics


def test_plan_windows_grid_alignment():
    assert plan_windows(0, 8, 4) == [(0, 4), (4, 4)]
    # Resume from an off-grid step re-joins the global K-grid.
    assert plan_windows(6, 20, 4) == [(6, 2), (8, 4), (12, 4), (16, 4)]
    # Budget stops are exact, not rounded.
    assert plan_windows(0, 10, 4) == [(0, 4), (4, 4), (8, 2)]
    assert plan_windows(5, 5, 4) == []
    with pytest.raises(ValueError):
        plan_windows(0, 4, 0)


def test_claim_order_and_live_lease_blocks():
    clock = FakeClock()
    kv, q = _queue(clock)
    units = [
        WorkUnit("subnetwork", "a", 0, 4),
        WorkUnit("subnetwork", "b", 0, 4),
    ]
    q.publish(units)
    unit, attempt = q.claim(*ALWAYS)
    assert (unit.name, attempt) == ("a", 0)  # published order
    peer = _peer(kv, q, "p1", clock)
    unit2, attempt2 = peer.claim(*ALWAYS)
    assert (unit2.name, attempt2) == ("b", 0)  # a's lease is live
    assert peer.claim(*ALWAYS) is None  # everything leased


def test_lease_expiry_boundary_and_reissue():
    clock = FakeClock()
    kv, q = _queue(clock)
    q.publish([WorkUnit("subnetwork", "a", 0, 4)])
    unit, attempt = q.claim(*ALWAYS)
    peer = _peer(kv, q, "p1", clock)

    # One tick BEFORE the deadline the lease is still the owner's;
    # exactly AT the deadline it expires (validity is `now < deadline`)
    # and the next claimant re-issues at attempt 1.
    clock.advance(q.config.lease_ttl_secs - 0.001)
    assert peer.claim(*ALWAYS) is None
    clock.advance(0.001)
    unit2, attempt2 = peer.claim(*ALWAYS)
    assert (unit2.uid, attempt2) == (unit.uid, 1)

    # The original owner's renewal now fails: its lease was re-issued.
    with pytest.raises(LeaseLostError):
        q.renew(unit, attempt)
    # ...and the set-once done marker arbitrates the race: the original
    # owner finishing late is harmless (results are deterministic).
    assert peer.complete(unit2, attempt2, b"result") is True
    assert q.complete(unit, attempt, b"result") is False
    assert q.read_blob(unit2, timeout_secs=1.0) == b"result"


def test_renew_extends_lease():
    clock = FakeClock()
    kv, q = _queue(clock)
    q.publish([WorkUnit("subnetwork", "a", 0, 4)])
    unit, attempt = q.claim(*ALWAYS)
    peer = _peer(kv, q, "p1", clock)
    for _ in range(5):  # heartbeat outlives many TTL windows
        clock.advance(q.config.lease_ttl_secs * 0.8)
        q.renew(unit, attempt)
    assert peer.claim(*ALWAYS) is None


def test_lease_renew_fault_site_error_and_transient():
    """Chaos coverage for the `lease.renew` fault site (jaxlint JL015).

    The renewal heartbeat is best-effort: an injected failure must
    surface to the renewer (which logs and retries next interval) while
    the PRIOR lease stays intact — a flaky KV write costs one missed
    heartbeat, never a lost unit.
    """
    from adanet_tpu_torch.robustness import faults
    from adanet_tpu_torch.robustness.faults import (
        InjectedFault,
        InjectedTransientError,
    )

    clock = FakeClock()
    kv, q = _queue(clock)
    q.publish([WorkUnit("subnetwork", "a", 0, 4)])
    unit, attempt = q.claim(*ALWAYS)

    faults.arm("lease.renew", "error", after=0, count=1)
    try:
        with pytest.raises(InjectedFault):
            q.renew(unit, attempt)
    finally:
        faults.disarm()
    # The fault fired BEFORE the lease write: the claim-time lease is
    # untouched, so the unit is still owned and a clean renewal extends.
    clock.advance(q.config.lease_ttl_secs * 0.5)
    q.renew(unit, attempt)
    peer = _peer(kv, q, "p1", clock)
    assert peer.claim(*ALWAYS) is None  # still leased by p0

    # Transient mode satisfies retry.is_transient (an OSError), the
    # contract the bounded-retry helpers key on.
    faults.arm("lease.renew", "transient", after=0, count=1)
    try:
        with pytest.raises(InjectedTransientError):
            q.renew(unit, attempt)
    finally:
        faults.disarm()
    q.renew(unit, attempt)  # clean again


def test_lease_renewer_absorbs_renewal_fault():
    """`LeaseRenewer` (the production heartbeat thread) treats an
    injected renewal failure as best-effort — `lost` stays None and the
    worker's unit completes normally."""
    from adanet_tpu_torch.distributed.scheduler import LeaseRenewer
    from adanet_tpu_torch.robustness import faults

    clock = FakeClock()
    kv = InMemoryKV()
    config = WorkQueueConfig(lease_ttl_secs=0.2, poll_interval_secs=0.0)
    q = WorkQueue(kv, "ns", config, worker="p0", clock=clock)
    q.publish([WorkUnit("subnetwork", "a", 0, 4)])
    unit, attempt = q.claim(*ALWAYS)
    faults.arm("lease.renew", "error", after=0, count=1)
    try:
        with LeaseRenewer(q, unit, attempt) as renewer:
            deadline = time.time() + 5.0
            spec = faults.armed().get("lease.renew")
            while spec.trips < 1 and time.time() < deadline:
                time.sleep(0.01)
        assert spec.trips == 1  # the heartbeat really hit the seam
        assert renewer.lost is None  # best-effort: not a lost lease
    finally:
        faults.disarm()
    assert q.complete(unit, attempt, b"result") is True


def test_attempts_exhausted_poisons_candidate():
    clock = FakeClock()
    kv, q = _queue(clock, max_attempts=2)
    q.publish(
        [
            WorkUnit("subnetwork", "a", 0, 4),
            WorkUnit("subnetwork", "a", 4, 4),
        ]
    )
    for expected_attempt in range(2):
        unit, attempt = q.claim(*ALWAYS)
        assert attempt == expected_attempt
        clock.advance(q.config.lease_ttl_secs + 1.0)
    # Third claim: attempts exhausted -> candidate poisoned, both its
    # units settle (never block the drain), final step recorded.
    assert q.claim(*ALWAYS) is None
    assert q.poisoned("a") is not None
    assert q.drained()
    assert q.final_step("a", fallback=0) == 0


def test_claim_crash_window_recovery():
    """A worker SIGKILLed between winning the set-once claim token and
    writing its lease must not park the unit forever: once the orphaned
    token's own deadline passes, the next claimant advances to the next
    attempt instead of losing the same race eternally."""
    import json

    clock = FakeClock()
    kv, q = _queue(clock)
    q.publish([WorkUnit("subnetwork", "a", 0, 4)])
    # The KV state a mid-claim SIGKILL leaves behind: a claim token for
    # attempt 0, and no lease.
    kv.set(
        "ns/claim/%s/0" % q.units[0].uid,
        json.dumps(
            {"owner": "dead", "deadline": clock() + q.config.lease_ttl_secs}
        ),
        overwrite=False,
    )
    peer = _peer(kv, q, "p1", clock)
    # Token still fresh: the winner may be about to write its lease.
    assert peer.claim(*ALWAYS) is None
    clock.advance(q.config.lease_ttl_secs + 0.001)
    unit, attempt = peer.claim(*ALWAYS)
    assert (unit.name, attempt) == ("a", 1)  # the dead claim consumed 0
    peer.complete(unit, attempt, None)
    assert peer.drained()


def test_ensemble_units_never_poison():
    """The ensemble unit IS the selection state: exhausting lease
    attempts keeps re-claiming (a stalled-but-alive chief recovers)
    instead of poisoning, and the unit never falsely settles."""
    from adanet_tpu_torch.distributed.scheduler import ENSEMBLE

    clock = FakeClock()
    kv, q = _queue(clock, max_attempts=2)
    q.publish([WorkUnit("ensemble", ENSEMBLE, 0, 4)])
    for expected_attempt in range(4):  # well past max_attempts
        unit, attempt = q.claim(*ALWAYS)
        assert attempt == expected_attempt
        assert not q.drained()
        clock.advance(q.config.lease_ttl_secs + 1.0)
    assert q.poisoned(ENSEMBLE) is None
    unit, attempt = q.claim(*ALWAYS)
    q.complete(unit, attempt, None)
    assert q.drained()


def test_release_reissues_immediately():
    clock = FakeClock()
    kv, q = _queue(clock)
    q.publish([WorkUnit("subnetwork", "a", 0, 4)])
    unit, attempt = q.claim(*ALWAYS)
    q.release(unit, attempt)
    unit2, attempt2 = q.claim(*ALWAYS)  # no TTL wait after a clean fault
    assert (unit2.uid, attempt2) == (unit.uid, 1)


def test_drain_callables_isolates_failures_by_label():
    """`on_error="isolate"`: a failing unit is recorded under its label
    and the OTHER units still run (the fleet's one-dead-trial-must-not-
    abort-the-rung contract); `"raise"` keeps the historic first-error
    behavior."""
    from adanet_tpu_torch.distributed.scheduler import drain_callables

    ran = []

    def ok(name):
        return lambda: ran.append(name)

    def boom():
        raise RuntimeError("unit death")

    failures = drain_callables(
        [ok("a"), boom, ok("c")],
        num_workers=1,
        devices=CPU,
        labels=["trial_a", "trial_b", "trial_c"],
        on_error="isolate",
    )
    assert ran == ["a", "c"]
    assert set(failures) == {"trial_b"}
    assert isinstance(failures["trial_b"], RuntimeError)

    with pytest.raises(RuntimeError, match="unit death"):
        drain_callables([boom, ok("late")], num_workers=1, devices=CPU)
    with pytest.raises(ValueError):
        drain_callables([], num_workers=1, devices=CPU, on_error="bogus")


def test_drain_callables_barriers_order_phases():
    """A `None` in the stream is a barrier: with three workers, every
    unit published before it completes before any unit after it starts."""
    from adanet_tpu_torch.distributed.scheduler import drain_callables

    log, lock = [], threading.Lock()

    def unit(phase, i):
        def run():
            with lock:
                log.append(("start", phase, i))
            time.sleep(0.01 * (3 - i))
            with lock:
                log.append(("end", phase, i))

        return run

    stream = [unit(0, i) for i in range(3)] + [None] + [unit(1, i) for i in range(3)]
    assert drain_callables(iter(stream), num_workers=3, devices=CPU) == {}
    last_end_0 = max(k for k, e in enumerate(log) if e[:2] == ("end", 0))
    first_start_1 = min(k for k, e in enumerate(log) if e[:2] == ("start", 1))
    assert last_end_0 < first_start_1 and len(log) == 12


def test_queue_matches_the_jax_packages():
    """The same published units, claim order, lease re-issue and done
    markers in both packages' queues under the same clock."""
    from adanet_tpu.distributed import scheduler as jax_scheduler

    units = [("subnetwork", "a", 0, 4), ("subnetwork", "a", 4, 4), ("ensemble", "__ensemble__", 0, 4)]
    trace = {}
    for name, module in (("port", None), ("jax", jax_scheduler)):
        clock = FakeClock()
        if module is None:
            kv, q = _queue(clock, max_attempts=2)
            unit_cls = WorkUnit
        else:
            kv = module.InMemoryKV()
            q = module.WorkQueue(kv, "ns", module.WorkQueueConfig(lease_ttl_secs=10.0, poll_interval_secs=0.0,
                                                                  max_attempts=2), worker="p0", clock=clock)
            unit_cls = module.WorkUnit
        q.publish([unit_cls(*u) for u in units])
        events = []
        for _ in range(5):
            claim = q.claim(*ALWAYS)
            events.append(None if claim is None else (claim[0].uid, claim[1]))
            clock.advance(q.config.lease_ttl_secs + 1.0)
        unit, attempt = q.claim(*ALWAYS)
        events.append(q.complete(unit, attempt, b"x"))
        events.append((q.drained(), q.poisoned("a") is not None, sorted(kv.scan("ns/done"))))
        trace[name] = events
    assert trace["port"] == trace["jax"]
