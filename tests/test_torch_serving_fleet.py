"""The port's serving fleet on the CPU.

Copies of tests/test_serving_fleet.py's FileKV, transport codec,
balancer, retry, flip-coordinator, bootstrap, heartbeat, servectl and
chaos-gate tests, run on the port with `device="cpu"`. Where the JAX
tests publish `jnp.tanh(x @ w)`, these publish the torch function
`torch.tanh(x @ w)` of the same numpy weights. The balancer and the
flip coordinator run against a mocked clock (no sleeps, no programs);
the servectl tests and the chaos gate spawn the port's replica module
(`python -m adanet_tpu_torch.serving.fleet.replica --device cpu`).
"""

import collections
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from adanet_tpu_torch.distributed.scheduler import FileKV, InMemoryKV
from adanet_tpu_torch.robustness import faults
from adanet_tpu_torch.serving import publisher
from adanet_tpu_torch.serving.fleet import (
    BalancerConfig,
    CascadeSpec,
    FleetBalancer,
    FlipConfig,
    FlipParticipant,
    NAMESPACE,
    bootstrap_generation,
    publish_heartbeat,
    read_heartbeats,
    transport,
)
from adanet_tpu_torch.serving.fleet import flip_coordinator as flip_lib
from adanet_tpu_torch.serving.model_pool import GateError, GenerationRecord

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(TESTS_DIR)


@pytest.fixture(autouse=True)
def _disarm_faults():
    faults.disarm()
    yield
    faults.disarm()


class FakeClock:
    def __init__(self, start: float = 1000.0):
        self.now = start

    def __call__(self) -> float:
        return self.now

    def advance(self, secs: float) -> None:
        self.now += secs


def _tanh_program(w):
    """`{"predictions": tanh(x @ w)}`, the JAX tests' program in torch."""
    weight = torch.as_tensor(w)
    return lambda f: {"predictions": torch.tanh(f["x"] @ weight)}


def _replica_env(extra=None):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([REPO_DIR, env.get("PYTHONPATH", "")])
    env.pop("ADANET_FAULTS", None)
    env.update(extra or {})
    return env


# ----------------------------------------------------------------- FileKV


def test_filekv_set_once_and_scan(tmp_path):
    kv = FileKV(str(tmp_path / "kv"))
    assert kv.set("fleet/hb/r0", b"a", overwrite=False)
    assert not kv.set("fleet/hb/r0", b"b", overwrite=False)
    assert kv.try_get("fleet/hb/r0") == b"a"
    # Overwrite mode is last-writer-wins (heartbeats).
    assert kv.set("fleet/hb/r0", b"c")
    assert kv.try_get("fleet/hb/r0") == b"c"
    kv.set("fleet/flip/gen-1/outcome", b"{}", overwrite=False)
    assert set(kv.scan("fleet/hb/")) == {"fleet/hb/r0"}
    assert set(kv.scan("fleet/")) == {"fleet/hb/r0", "fleet/flip/gen-1/outcome"}
    kv.delete("fleet/hb/r0")
    assert kv.try_get("fleet/hb/r0") is None


def test_filekv_set_once_across_processes(tmp_path):
    """The claim primitive holds across processes: of N concurrent
    writers exactly one wins."""
    root = str(tmp_path / "kv")
    FileKV(root)
    script = (
        "import sys\n"
        "from adanet_tpu_torch.distributed.scheduler import FileKV\n"
        "kv = FileKV(sys.argv[1])\n"
        "print(int(kv.set('claim', sys.argv[2].encode(), overwrite=False)))\n"
    )
    procs = [
        subprocess.Popen([sys.executable, "-c", script, root, "w%d" % i], stdout=subprocess.PIPE, text=True,
                         cwd=REPO_DIR, env=_replica_env())
        for i in range(3)
    ]
    wins = [int(p.communicate(timeout=120)[0].strip()) for p in procs]
    assert sum(wins) == 1, wins
    assert FileKV(root).try_get("claim") is not None


# -------------------------------------------------------------- transport


def test_transport_codec_round_trip_bit_exact():
    tree = {
        "features": {"x": np.arange(12, dtype=np.float32).reshape(3, 4), "mask": np.array([True, False, True])},
        "nested": [1, "two", None, {"deep": np.float64(2.5)}],
        "pair": (np.int32(7), 8),
    }
    out = transport.decode_message(transport.encode_message(tree))
    np.testing.assert_array_equal(out["features"]["x"], tree["features"]["x"])
    assert out["features"]["x"].dtype == np.float32
    np.testing.assert_array_equal(out["features"]["mask"], tree["features"]["mask"])
    assert out["nested"][:3] == [1, "two", None]
    assert out["nested"][3]["deep"] == 2.5
    assert isinstance(out["pair"], tuple) and out["pair"][1] == 8
    # Scalar leaves keep their 0-d shape.
    scalar = transport.decode_message(transport.encode_message({"scale": np.float32(0.5)}))["scale"]
    assert scalar.shape == () and scalar == np.float32(0.5)
    assert np.asarray(out["nested"][3]["deep"]).shape == ()


def test_transport_rejects_bad_messages_in_taxonomy():
    """Unencodable input fails the sender with TypeError (a torch tensor
    too: replica answers must be host numpy); a torn frame decodes to
    TransportError."""
    with pytest.raises(TypeError, match="dtype"):
        transport.encode_message({"bad": np.array([object()], dtype=object)})
    with pytest.raises(TypeError, match="non-string"):
        transport.encode_message({0: np.zeros(2)})
    with pytest.raises(TypeError):
        transport.encode_message({"t": torch.zeros(2)})
    with pytest.raises(transport.TransportError, match="truncated"):
        transport.decode_message(b"\x00")


def test_replica_answers_are_host_numpy(tmp_path):
    """What a replica hands the codec: the frontend's outputs, which the
    batcher copied to host numpy (`to_host`), never a torch tensor."""
    from adanet_tpu_torch.serving.fleet import ReplicaConfig, ServingReplica

    model_dir = str(tmp_path / "model")
    rng = np.random.RandomState(0)
    publisher.publish_generation(model_dir, 0, _tanh_program(rng.randn(16, 4).astype(np.float32)),
                                 {"x": np.zeros((2, 16), np.float32)}, device="cpu")
    replica = ServingReplica(ReplicaConfig("r0", str(tmp_path / "fleet"), model_dir), device="cpu")
    replica.tick()
    replica.frontend.start()
    try:
        answer = replica._handle({"op": "serve", "features": {"x": rng.randn(3, 16).astype(np.float32)}})
    finally:
        replica.frontend.drain(timeout=30.0)
    assert answer["status"] == "ok" and answer["generation"] == 0
    assert isinstance(answer["outputs"]["predictions"], np.ndarray)
    decoded = transport.decode_message(transport.encode_message(answer))
    np.testing.assert_array_equal(decoded["outputs"]["predictions"], answer["outputs"]["predictions"])


# --------------------------------------------------- balancer (mocked clock)


def _beat(kv, replica_id, seq, ts, **overrides):
    payload = {
        "replica_id": replica_id,
        "seq": seq,
        "ts": ts,
        "address": "/tmp/%s.sock" % replica_id,
        "generation": 0,
        "queue_depth": 0,
        "wait_ewma_secs": 0.0,
        "exec_ewma_secs": 0.01,
        "shedding": False,
        "draining": False,
    }
    payload.update(overrides)
    publish_heartbeat(kv, NAMESPACE, replica_id, payload)


def _admitted_ids(balancer):
    return {t.replica_id for t in balancer.admitted()}


def _balancer(kv, clock, **config):
    config.setdefault("refresh_interval_secs", 0)
    return FleetBalancer(kv, config=BalancerConfig(**config), clock=clock)


def test_balancer_stale_exclusion_and_readmission_boundaries():
    """Exclusion is immediate at staleness; re-admission needs exactly
    readmit_beats consecutive fresh healthy beats."""
    kv, clock = InMemoryKV(), FakeClock()
    balancer = _balancer(kv, clock, stale_after_secs=1.0, readmit_beats=2)
    for seq in (1, 2):
        _beat(kv, "r0", seq, clock.now)
        balancer.refresh()
    assert _admitted_ids(balancer) == {"r0"}
    clock.advance(0.99)
    balancer.refresh()
    assert _admitted_ids(balancer) == {"r0"}
    clock.advance(0.02)
    balancer.refresh()
    assert _admitted_ids(balancer) == set()
    _beat(kv, "r0", 3, clock.now)
    balancer.refresh()
    assert _admitted_ids(balancer) == set()
    balancer.refresh()
    assert _admitted_ids(balancer) == set()
    _beat(kv, "r0", 4, clock.now)
    balancer.refresh()
    assert _admitted_ids(balancer) == {"r0"}


def test_balancer_shedding_exclusion_resets_streak():
    kv, clock = InMemoryKV(), FakeClock()
    balancer = _balancer(kv, clock, stale_after_secs=10.0, readmit_beats=2)
    for seq in (1, 2):
        _beat(kv, "r0", seq, clock.now)
        balancer.refresh()
    assert _admitted_ids(balancer) == {"r0"}
    _beat(kv, "r0", 3, clock.now, shedding=True)
    balancer.refresh()
    assert _admitted_ids(balancer) == set()
    _beat(kv, "r0", 4, clock.now)
    balancer.refresh()
    _beat(kv, "r0", 5, clock.now, shedding=True)
    balancer.refresh()
    _beat(kv, "r0", 6, clock.now)
    balancer.refresh()
    assert _admitted_ids(balancer) == set()
    _beat(kv, "r0", 7, clock.now)
    balancer.refresh()
    assert _admitted_ids(balancer) == {"r0"}


def test_balancer_respawned_replica_readmits_despite_seq_reset():
    kv, clock = InMemoryKV(), FakeClock()
    balancer = _balancer(kv, clock, stale_after_secs=1.0, readmit_beats=2)
    for seq in (100000, 100001):
        _beat(kv, "r0", seq, clock.now)
        balancer.refresh()
    assert _admitted_ids(balancer) == {"r0"}
    clock.advance(2.0)
    balancer.refresh()
    assert _admitted_ids(balancer) == set()
    _beat(kv, "r0", 1, clock.now, pid=999)
    balancer.refresh()
    _beat(kv, "r0", 2, clock.now, pid=999)
    balancer.refresh()
    assert _admitted_ids(balancer) == {"r0"}


def test_balancer_forgets_replicas_whose_heartbeat_key_vanished():
    kv, clock = InMemoryKV(), FakeClock()
    balancer = _balancer(kv, clock, stale_after_secs=1.0, readmit_beats=1, forget_after_secs=5.0)
    _beat(kv, "r0", 1, clock.now)
    balancer.refresh()
    assert _admitted_ids(balancer) == {"r0"}
    kv.delete("%s/hb/r0" % NAMESPACE)
    clock.advance(1.5)
    balancer.refresh()
    assert _admitted_ids(balancer) == set()
    clock.advance(5.0)
    balancer.refresh()
    assert "r0" not in balancer._tracked
    assert balancer.choose() is None


def test_balancer_power_of_two_prefers_lower_score():
    kv, clock = InMemoryKV(), FakeClock()
    balancer = _balancer(kv, clock, readmit_beats=1, latency_weight=100.0)
    _beat(kv, "deep", 1, clock.now, queue_depth=50)
    _beat(kv, "slow", 1, clock.now, wait_ewma_secs=1.0)
    _beat(kv, "good", 1, clock.now)
    balancer.refresh()
    assert _admitted_ids(balancer) == {"deep", "slow", "good"}
    wins = collections.Counter(balancer.choose().replica_id for _ in range(40))
    assert wins["slow"] == 0
    assert wins["good"] > 0


class _ScriptedTransport:
    """address -> list of scripted replies or exceptions."""

    def __init__(self, scripts, log):
        self._scripts = scripts
        self._log = log

    def __call__(self, address):
        outer = self

        class _Client:
            def send(self, message, timeout_secs=None):
                outer._log.append(address)
                action = outer._scripts[address].pop(0)
                if isinstance(action, Exception):
                    raise action
                return action

            def close(self):
                pass

        return _Client()


def test_balancer_deadline_aware_retry_on_shed():
    kv, clock, log = InMemoryKV(), FakeClock(), []
    scripts = {
        "/tmp/r0.sock": [{"status": "shed", "retry_after": 0.05}],
        "/tmp/r1.sock": [{"status": "ok", "generation": 0, "outputs": 1}],
    }
    balancer = FleetBalancer(kv, config=BalancerConfig(readmit_beats=1, refresh_interval_secs=0),
                             transport_factory=_ScriptedTransport(scripts, log), clock=clock)
    _beat(kv, "r0", 1, clock.now, queue_depth=0)
    _beat(kv, "r1", 1, clock.now, queue_depth=10)
    result = balancer.submit({"x": 1}, deadline_secs=5.0)
    assert result.ok and result.outputs == 1
    assert log == ["/tmp/r0.sock", "/tmp/r1.sock"]
    assert balancer._m_retries.value == 1


def test_balancer_exhausted_budget_returns_shed_without_retry():
    kv, clock, log = InMemoryKV(), FakeClock(), []

    class _Factory:
        def __call__(self, address):
            class _Client:
                def send(self, message, timeout_secs=None):
                    log.append(address)
                    clock.advance(10.0)  # the attempt consumed the whole budget
                    return {"status": "shed", "retry_after": 0.05}

                def close(self):
                    pass

            return _Client()

    balancer = FleetBalancer(kv, config=BalancerConfig(readmit_beats=1, refresh_interval_secs=0),
                             transport_factory=_Factory(), clock=clock)
    _beat(kv, "r0", 1, clock.now)
    _beat(kv, "r1", 1, clock.now)
    result = balancer.submit({"x": 1}, deadline_secs=5.0)
    assert result.status == "shed"
    assert len(log) == 1


def test_balancer_transport_error_excludes_and_retries():
    kv, clock, log = InMemoryKV(), FakeClock(), []
    scripts = {
        "/tmp/r0.sock": [transport.TransportError("connection refused")],
        "/tmp/r1.sock": [{"status": "ok", "generation": 1, "outputs": 2}],
    }
    balancer = FleetBalancer(kv, config=BalancerConfig(readmit_beats=1, refresh_interval_secs=0),
                             transport_factory=_ScriptedTransport(scripts, log), clock=clock)
    _beat(kv, "r0", 1, clock.now, queue_depth=0)
    _beat(kv, "r1", 1, clock.now, queue_depth=10)
    result = balancer.submit({"x": 1}, deadline_secs=5.0)
    assert result.ok and result.generation == 1
    assert log == ["/tmp/r0.sock", "/tmp/r1.sock"]
    assert _admitted_ids(balancer) == {"r1"}
    assert balancer._m_transport_errors.value == 1


# ---------------------------------------- flip coordinator (mocked clock)


class FakePool:
    def __init__(self, active=None):
        self._active = active
        self.adopted = []
        self.device = torch.device("cpu")

    @property
    def active(self):
        return self._active

    def adopt(self, record, how="fleet"):
        self._active = record
        self.adopted.append((record.iteration_number, how))


def _gen_dir(tmp_path, t):
    path = publisher.generation_dir(str(tmp_path), t)
    os.makedirs(path, exist_ok=True)
    return path


def _record(t, path):
    return GenerationRecord(t, path, lambda features: {"y": np.ones(2)}, {})


def flip_target_iter(path):
    return int(os.path.basename(path).split("-")[1])


def _participant(kv, replica_id, pool, model_dir, fresh, clock, stage_fn=None, canary_fn=None, config=None):
    return FlipParticipant(
        kv,
        NAMESPACE,
        replica_id,
        pool,
        model_dir,
        fresh_replicas=lambda: set(fresh),
        stage_fn=stage_fn or (lambda path: _record(flip_target_iter(path), path)),
        canary_fn=canary_fn,
        config=config or FlipConfig(lead_ttl_secs=5.0),
        clock=clock,
    )


def _target(tmp_path, t):
    return flip_lib.target_id(t, publisher.generation_dir(str(tmp_path), t))


def _two(tmp_path, kv, clock, names=("r0", "r1"), **kwargs):
    gen0 = _gen_dir(tmp_path, 0)
    pools = {r: FakePool(_record(0, gen0)) for r in names}
    fresh = set(names)
    parts = {r: _participant(kv, r, pools[r], str(tmp_path), fresh, clock, **kwargs) for r in names}
    return pools, fresh, parts


def test_flip_commit_happy_path(tmp_path):
    kv, clock = InMemoryKV(), FakeClock()
    pools, _, parts = _two(tmp_path, kv, clock)
    _gen_dir(tmp_path, 1)
    assert parts["r0"].step() is None
    assert parts["r1"].step() == "ready"
    assert parts["r0"].step() == "committed"
    assert parts["r1"].step() == "committed"
    assert pools["r0"].adopted == [(1, "fleet")]
    assert pools["r1"].adopted == [(1, "fleet")]
    outcome = json.loads(kv.try_get("%s/flip/%s/outcome" % (NAMESPACE, _target(tmp_path, 1))))
    assert outcome["decision"] == "commit"
    assert sorted(outcome["participants"]) == ["r0", "r1"]


def test_flip_canary_failure_aborts_fleet_wide(tmp_path):
    kv, clock = InMemoryKV(), FakeClock()
    pools, _, parts = _two(tmp_path, kv, clock, canary_fn=lambda record: (False, "diverged"))
    _gen_dir(tmp_path, 1)
    assert parts["r0"].step() == "aborted"
    assert parts["r1"].step() is None
    assert pools["r0"].adopted == [] and pools["r1"].adopted == []
    assert parts["r0"].step() is None and parts["r1"].step() is None


def test_flip_follower_stage_failure_aborts(tmp_path):
    kv, clock = InMemoryKV(), FakeClock()
    gen0 = _gen_dir(tmp_path, 0)
    pools = {r: FakePool(_record(0, gen0)) for r in ("r0", "r1")}
    fresh = {"r0", "r1"}

    def bad_stage(path):
        raise GateError("verification failed: rot")

    leader = _participant(kv, "r0", pools["r0"], str(tmp_path), fresh, clock)
    follower = _participant(kv, "r1", pools["r1"], str(tmp_path), fresh, clock, stage_fn=bad_stage)
    _gen_dir(tmp_path, 1)
    assert leader.step() is None
    assert follower.step() == "stage_failed"
    assert leader.step() == "aborted"
    assert follower.step() == "aborted"
    assert pools["r0"].adopted == [] and pools["r1"].adopted == []


def test_flip_leader_death_successor_takes_over(tmp_path):
    kv, clock = InMemoryKV(), FakeClock()
    gen0 = _gen_dir(tmp_path, 0)
    pools = {r: FakePool(_record(0, gen0)) for r in ("r0", "r1")}
    config = FlipConfig(lead_ttl_secs=5.0)
    dead_leader = _participant(kv, "r0", pools["r0"], str(tmp_path), {"r0", "r1"}, clock, config=config)
    survivor = _participant(kv, "r1", pools["r1"], str(tmp_path), {"r1"}, clock, config=config)
    _gen_dir(tmp_path, 1)
    assert dead_leader.step() is None
    assert survivor.step() == "ready"
    assert survivor.step() is None
    assert pools["r1"].adopted == []
    clock.advance(6.0)
    assert survivor.step() == "committed"
    assert pools["r1"].adopted == [(1, "fleet")]
    assert dead_leader.step() == "committed"
    assert pools["r0"].adopted == [(1, "fleet")]


def test_flip_live_leader_renews_token_past_half_ttl(tmp_path):
    kv, clock = InMemoryKV(), FakeClock()
    gen0 = _gen_dir(tmp_path, 0)
    leader = _participant(kv, "r0", FakePool(_record(0, gen0)), str(tmp_path), {"r0", "r1"}, clock,
                          config=FlipConfig(lead_ttl_secs=10.0, ready_timeout_secs=500.0))
    _gen_dir(tmp_path, 1)
    assert leader.step() is None
    token_key = "%s/flip/%s/lead-0" % (NAMESPACE, _target(tmp_path, 1))
    first_deadline = json.loads(kv.try_get(token_key))["deadline"]
    clock.advance(6.0)
    assert leader.step() is None
    renewed = json.loads(kv.try_get(token_key))
    assert renewed["replica"] == "r0"
    assert renewed["deadline"] > first_deadline
    follower = _participant(kv, "r1", FakePool(_record(0, gen0)), str(tmp_path), {"r0", "r1"}, clock,
                            config=FlipConfig(lead_ttl_secs=10.0))
    assert follower.step() == "ready"
    assert leader.step() == "committed"


def test_flip_dead_follower_drops_from_required_set(tmp_path):
    kv, clock = InMemoryKV(), FakeClock()
    pools, fresh, parts = _two(tmp_path, kv, clock, names=("r0", "r1", "r2"))
    _gen_dir(tmp_path, 1)
    assert parts["r0"].step() is None
    assert parts["r1"].step() == "ready"
    fresh.discard("r2")
    assert parts["r0"].step() == "committed"
    assert parts["r1"].step() == "committed"
    assert pools["r2"].adopted == []
    entry = bootstrap_generation(kv, NAMESPACE, str(tmp_path))
    assert entry is not None and entry[0] == 1


def test_flip_ready_timeout_aborts(tmp_path):
    kv, clock = InMemoryKV(), FakeClock()
    gen0 = _gen_dir(tmp_path, 0)
    pool = FakePool(_record(0, gen0))
    leader = _participant(kv, "r0", pool, str(tmp_path), {"r0", "r1"}, clock,
                          config=FlipConfig(lead_ttl_secs=500.0, ready_timeout_secs=60.0))
    _gen_dir(tmp_path, 1)
    assert leader.step() is None
    clock.advance(61.0)
    assert leader.step() == "aborted"
    assert pool.adopted == []


def test_flip_mid_flight_publication_supersedes_and_converges(tmp_path):
    kv, clock = InMemoryKV(), FakeClock()
    pools, _, parts = _two(tmp_path, kv, clock)
    _gen_dir(tmp_path, 1)
    assert parts["r0"].step() is None
    _gen_dir(tmp_path, 2)
    assert parts["r1"].step() is None
    assert parts["r0"].step() == "ready"
    gen1_outcome = json.loads(kv.try_get("%s/flip/%s/outcome" % (NAMESPACE, _target(tmp_path, 1))))
    assert gen1_outcome["decision"] == "abort"
    assert "superseded" in gen1_outcome["reason"]
    assert parts["r1"].step() == "committed"
    assert parts["r0"].step() == "committed"
    assert pools["r0"].adopted == [(2, "fleet")]
    assert pools["r1"].adopted == [(2, "fleet")]
    gen1_keys = [key for key in kv.scan("%s/flip/" % NAMESPACE) if "/%s/" % _target(tmp_path, 1) in key]
    assert gen1_keys == []


def test_flip_default_stage_and_canary_run_the_ports_programs(tmp_path):
    """Without injected collaborators the participant stages through the
    port's gate on the pool's device, and its canary replays live samples
    padded to a bucket on the staged program: a non-finite candidate
    aborts the flip fleet-wide."""
    from adanet_tpu_torch.serving import ModelPool, PoolConfig
    from adanet_tpu_torch.serving.model_pool import gate_generation

    model_dir = str(tmp_path)
    w = np.random.RandomState(0).randn(16, 4).astype(np.float32)
    sample = {"x": np.zeros((2, 16), np.float32)}
    gen0 = publisher.publish_generation(model_dir, 0, _tanh_program(w), sample, device="cpu")
    pool = ModelPool(model_dir, PoolConfig(follow=False), device="cpu")
    pool.adopt(gate_generation(gen0, pool.device), how="bootstrap")
    kv, clock = InMemoryKV(), FakeClock()
    samples = [{"x": np.ones((3, 16), np.float32)}]
    part = FlipParticipant(kv, NAMESPACE, "r0", pool, model_dir, fresh_replicas=lambda: {"r0"},
                           sample_fn=lambda: samples, clock=clock, bucket_sizes=(1, 4))
    publisher.publish_generation(model_dir, 1, _tanh_program(w * 2), sample, device="cpu")
    assert part.step() == "committed"
    assert pool.stats()["active_generation"] == 1 and pool.events[-1]["how"] == "fleet"
    # A program that is finite on the gate's zeros sample and not on the
    # live sample: the canary catches it.
    publisher.publish_generation(model_dir, 2, lambda f: {"predictions": torch.log(-f["x"])}, sample, device="cpu")
    assert part.step() == "aborted"
    assert pool.stats()["active_generation"] == 1


def test_bootstrap_generation_resolution(tmp_path):
    kv = InMemoryKV()
    _gen_dir(tmp_path, 0)
    _gen_dir(tmp_path, 1)
    assert bootstrap_generation(kv, NAMESPACE, str(tmp_path))[0] == 1
    target = _target(tmp_path, 1)
    kv.set("%s/flip/%s/lead-0" % (NAMESPACE, target), json.dumps({"replica": "r9", "deadline": 1e18}),
           overwrite=False)
    assert bootstrap_generation(kv, NAMESPACE, str(tmp_path))[0] == 0
    kv.set("%s/flip/%s/outcome" % (NAMESPACE, target), json.dumps({"decision": "commit"}), overwrite=False)
    assert bootstrap_generation(kv, NAMESPACE, str(tmp_path))[0] == 1


def test_bootstrap_skips_aborted_generation(tmp_path):
    kv = InMemoryKV()
    _gen_dir(tmp_path, 0)
    gen1 = _gen_dir(tmp_path, 1)
    target = _target(tmp_path, 1)
    kv.set("%s/flip/%s/outcome" % (NAMESPACE, target), json.dumps({"decision": "abort", "reason": "canary failed"}),
           overwrite=False)
    assert bootstrap_generation(kv, NAMESPACE, str(tmp_path))[0] == 0
    os.replace(gen1, gen1 + ".corrupt")
    _gen_dir(tmp_path, 1)
    assert bootstrap_generation(kv, NAMESPACE, str(tmp_path))[0] == 1


def test_replica_heartbeat_fault_site_armed():
    kv = InMemoryKV()
    faults.arm("serving.replica_heartbeat", "error")
    with pytest.raises(faults.InjectedFault):
        publish_heartbeat(kv, NAMESPACE, "r0", {"seq": 1, "ts": 0.0})
    faults.disarm()
    publish_heartbeat(kv, NAMESPACE, "r0", {"seq": 2, "ts": 0.0})
    assert read_heartbeats(kv, NAMESPACE)["r0"]["seq"] == 2


# ----------------------------------------------------------- servectl CLI


def test_servectl_launch_status_drain_exit_contract(tmp_path, capsys, monkeypatch):
    """The operator loop end to end with the 0/1/2/64 contract, the
    `cascade` subcommand over a live cascade-published fleet of the
    port's replicas on the CPU."""
    from adanet_tpu_torch.tools import servectl

    for key, value in _replica_env().items():
        monkeypatch.setenv(key, value)
    fleet_dir = str(tmp_path / "fleet")
    model_dir = str(tmp_path / "model")
    os.makedirs(model_dir)
    rng = np.random.RandomState(0)
    w = rng.randn(16, 4).astype(np.float32)
    w_cheap = w + 0.01 * rng.randn(16, 4).astype(np.float32)
    publisher.publish_generation(
        model_dir, 0, _tanh_program(w), {"x": np.zeros((2, 16), np.float32)},
        cascade=CascadeSpec(_tanh_program(w_cheap), {"x": rng.randn(256, 16).astype(np.float32)},
                            target_agreement=0.6),
        device="cpu",
    )
    with pytest.raises(SystemExit) as excinfo:
        servectl.main(["launch", fleet_dir])
    assert excinfo.value.code == 64
    assert servectl.main(["status", fleet_dir, "--json"]) == 2
    assert servectl.main(["cascade", fleet_dir, "--json"]) == 2
    capsys.readouterr()
    try:
        assert servectl.main(["launch", fleet_dir, "--model-dir", model_dir, "--replicas", "2", "--json",
                              "--device", "cpu", "--timeout", "120"]) == 0
        launch_report = json.loads(capsys.readouterr().out)
        assert launch_report["missing_heartbeats"] == []
        assert servectl.main(["status", fleet_dir, "--json"]) == 0
        status = json.loads(capsys.readouterr().out)
        assert status["consistent_generation"] is True
        assert all(entry["state"] == "serving" for entry in status["replicas"].values())
        assert servectl.main(["cascade", fleet_dir, "--json"]) == 0
        census = json.loads(capsys.readouterr().out)
        assert sorted(census["replicas"]) == ["r0", "r1"]
        for entry in census["replicas"].values():
            assert entry["state"] == "cascade"
            assert entry["mode"] == "row"
            assert entry["generation"] == 0
            assert entry["source"] == "member"
            assert 0.0 < entry["threshold"] <= 1.0
            assert entry["program_digest"]
            assert entry["rollback"] is None
    finally:
        rc = servectl.main(["drain", fleet_dir, "--json"])
    assert rc == 0
    drained = json.loads(capsys.readouterr().out)
    assert sorted(drained["drained"]) == ["r0", "r1"]
    assert servectl.main(["status", fleet_dir, "--json"]) == 2
    capsys.readouterr()
    assert servectl.main(["cascade", fleet_dir, "--json"]) == 2
    # Each replica's drained line carries its counts: K1 none on the CPU,
    # and program calls by program file.
    for rid in ("r0", "r1"):
        with open(os.path.join(fleet_dir, "logs", rid + ".log")) as f:
            lines = [line for line in f if line.startswith("REPLICA DRAINED %s " % rid)]
        counts = json.loads(lines[-1].split(" ", 3)[3])
        assert counts["launches"] == {"copy": 0, "combine": 0, "sepconv": 0, "cell": 0}
        assert sorted(os.path.basename(p) for p in counts["calls"]) == ["cascade.pt2", "serving.pt2"]


def test_servectl_cascade_degraded_states(tmp_path, capsys):
    from adanet_tpu_torch.serving import fleet as fleet_lib
    from adanet_tpu_torch.tools import servectl

    fleet_dir = str(tmp_path / "fleet")
    os.makedirs(fleet_dir)
    with open(os.path.join(fleet_dir, servectl.FLEET_STATE), "w") as f:
        json.dump({"model_dir": str(tmp_path / "model"), "replicas": [{"id": r} for r in ("r0", "r1", "r2")]}, f)
    kv = FileKV(os.path.join(fleet_dir, fleet_lib.replica.KV_SUBDIR))
    base = {
        "enabled": True,
        "published": True,
        "mode": "row",
        "generation": 3,
        "source": "distilled",
        "threshold": 0.9,
        "row_fallthrough_rate": 0.2,
        "fallthrough_rate": 0.6,
        "shadow_divergence": 0.01,
        "shadow_divergence_bound": 0.05,
        "rollback": None,
    }
    publish_heartbeat(kv, NAMESPACE, "r0", {"ts": time.time(), "cascade": base})
    publish_heartbeat(kv, NAMESPACE, "r1", {"ts": time.time(), "cascade": dict(
        base, rollback={"generation": 3, "reason": "shadow divergence 0.2 past bound 0.05"})})
    assert servectl.main(["cascade", fleet_dir, "--json"]) == 1
    census = json.loads(capsys.readouterr().out)
    assert census["replicas"]["r0"]["state"] == "cascade"
    assert census["replicas"]["r1"]["state"] == "ensemble-only"
    assert "shadow divergence" in census["replicas"]["r1"]["rollback"]["reason"]
    assert census["replicas"]["r2"]["state"] == "missing"
    assert servectl.main(["cascade", fleet_dir]) == 1
    out = capsys.readouterr().out
    assert "ROLLBACK" in out and "ensemble-only" in out


def test_servectl_cascade_ignores_a_superseded_rollback(tmp_path, capsys):
    """A replica that flipped to generation 4 still carries generation 3's
    rollback record until its first level-0 dispatch of 4; the census
    reads it as serving the cascade, while a rollback of 4 degrades it."""
    from adanet_tpu_torch.serving import fleet as fleet_lib
    from adanet_tpu_torch.tools import servectl

    fleet_dir = str(tmp_path / "fleet")
    os.makedirs(fleet_dir)
    with open(os.path.join(fleet_dir, servectl.FLEET_STATE), "w") as f:
        json.dump({"model_dir": str(tmp_path / "model"), "replicas": [{"id": r} for r in ("r0", "r1")]}, f)
    kv = FileKV(os.path.join(fleet_dir, fleet_lib.replica.KV_SUBDIR))
    base = {"enabled": True, "published": True, "mode": "row", "generation": 4, "source": "distilled",
            "rollback": None}
    stale = {"generation": 3, "reason": "shadow divergence 0.0139 past published bound 0.0100"}
    publish_heartbeat(kv, NAMESPACE, "r0", {"ts": time.time(), "cascade": base})
    publish_heartbeat(kv, NAMESPACE, "r1", {"ts": time.time(), "cascade": dict(base, rollback=stale)})
    assert servectl.main(["cascade", fleet_dir, "--json"]) == 0
    census = json.loads(capsys.readouterr().out)
    assert {r: e["state"] for r, e in census["replicas"].items()} == {"r0": "cascade", "r1": "cascade"}
    assert census["replicas"]["r1"]["rollback"] is None
    publish_heartbeat(kv, NAMESPACE, "r1", {"ts": time.time(), "cascade": dict(
        base, rollback=dict(stale, generation=4))})
    assert servectl.main(["cascade", fleet_dir, "--json"]) == 1
    census = json.loads(capsys.readouterr().out)
    assert census["replicas"]["r1"]["state"] == "ensemble-only"


# ------------------------------------------------------------ the chaos gate


def _spawn_replica(fleet_dir, model_dir, replica_id, env_extra=None):
    from adanet_tpu_torch.tools import servectl

    return servectl.spawn_replica(fleet_dir, model_dir, replica_id, env=_replica_env(env_extra),
                                  heartbeat_interval=0.1, heartbeat_stale=1.0, device="cpu")


def _read_log(fleet_dir, replica_id):
    try:
        with open(os.path.join(fleet_dir, "logs", replica_id + ".log")) as f:
            return f.read()[-4000:]
    except OSError:
        return "<no log>"


def test_fleet_flip_sigkill_chaos_gate(tmp_path):
    """A 3-replica fleet of the port's replica processes under closed-loop
    traffic survives SIGKILL of one replica mid-fleet-flip with zero
    `error` results, converges on generation 1 (the respawned victim
    completes the flip at bootstrap) with the per-row cascade published
    and not rolled back, one `commit` outcome, and a clean fsck of the
    shared artifact store through the library and through
    `adanet_tpu_torch.tools.ckpt_fsck`."""
    from adanet_tpu_torch.store import ArtifactStore, fsck_store
    from adanet_tpu_torch.tools import ckpt_fsck

    fleet_dir = str(tmp_path / "fleet")
    model_dir = os.path.join(fleet_dir, "model")
    store_root = os.path.join(fleet_dir, "store")
    os.makedirs(model_dir)
    store = ArtifactStore(store_root)
    rng = np.random.RandomState(0)
    w0 = rng.randn(16, 4).astype(np.float32)
    sample = {"x": np.zeros((2, 16), np.float32)}
    holdout = {"x": rng.randn(256, 16).astype(np.float32)}

    def _cascade_for(w):
        w_cheap = w + 0.01 * rng.randn(16, 4).astype(np.float32)
        return CascadeSpec(_tanh_program(w_cheap), holdout, target_agreement=0.6)

    publisher.publish_generation(model_dir, 0, _tanh_program(w0), sample, store=store, cascade=_cascade_for(w0),
                                 device="cpu")
    procs = {}
    victim = "r2"
    for rid in ("r0", "r1"):
        procs[rid] = _spawn_replica(fleet_dir, model_dir, rid)
    procs[victim] = _spawn_replica(fleet_dir, model_dir, victim, env_extra={"ADANET_FAULTS": "serving.fleet_flip:kill"})
    kv = FileKV(os.path.join(fleet_dir, "kv"))
    balancer = FleetBalancer(kv, config=BalancerConfig(stale_after_secs=1.0))
    results = []
    results_lock = threading.Lock()
    stop = threading.Event()

    def client(seed):
        client_rng = np.random.RandomState(seed)
        while not stop.is_set():
            x = {"x": client_rng.randn(client_rng.randint(1, 3), 16).astype(np.float32)}
            result = balancer.submit(x, deadline_secs=15.0)
            with results_lock:
                results.append(result)

    threads = [threading.Thread(target=client, args=(seed,), daemon=True) for seed in range(3)]
    try:
        deadline = time.time() + 180
        while time.time() < deadline:
            beats = read_heartbeats(kv, NAMESPACE)
            if len(beats) == 3 and all(p.get("generation") == 0 for p in beats.values()):
                break
            dead = [r for r, p in procs.items() if p.poll() is not None]
            assert not dead, "\n".join(_read_log(fleet_dir, r) for r in dead)
            time.sleep(0.1)
        else:
            pytest.fail("fleet never bootstrapped:\n%s" % "\n".join(_read_log(fleet_dir, r) for r in procs))
        for thread in threads:
            thread.start()
        time.sleep(1.0)
        publisher.publish_generation(model_dir, 1, _tanh_program(w0 * 1.5), sample, store=store,
                                     cascade=_cascade_for(w0 * 1.5), device="cpu")
        deadline = time.time() + 120
        while time.time() < deadline and procs[victim].poll() is None:
            time.sleep(0.05)
        assert procs[victim].poll() == -signal.SIGKILL, _read_log(fleet_dir, victim)
        while time.time() < deadline:
            beats = read_heartbeats(kv, NAMESPACE)
            if all(beats.get(r, {}).get("generation") == 1 for r in ("r0", "r1")):
                break
            time.sleep(0.1)
        else:
            pytest.fail("survivors never flipped:\n%s\n%s" % (_read_log(fleet_dir, "r0"), _read_log(fleet_dir, "r1")))
        procs[victim] = _spawn_replica(fleet_dir, model_dir, victim)
        while time.time() < deadline:
            beats = read_heartbeats(kv, NAMESPACE)
            if beats.get(victim, {}).get("generation") == 1:
                break
            assert procs[victim].poll() is None, _read_log(fleet_dir, victim)
            time.sleep(0.1)
        else:
            pytest.fail("respawned victim never converged: %s" % _read_log(fleet_dir, victim))
        for _ in range(5):
            result = balancer.submit({"x": rng.randn(2, 16).astype(np.float32)}, deadline_secs=15.0)
            with results_lock:
                results.append(result)
        beats = read_heartbeats(kv, NAMESPACE)
        for rid in ("r0", "r1", victim):
            cascade = beats[rid].get("cascade")
            assert cascade, "replica %s lost cascade stats" % rid
            assert cascade["published"] is True
            assert cascade["mode"] == "row"
            assert cascade["rollback"] is None
    finally:
        stop.set()
        for thread in threads:
            thread.join(timeout=30.0)
        for proc in procs.values():
            if proc.poll() is None:
                proc.terminate()
        for proc in procs.values():
            try:
                proc.wait(timeout=30.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30.0)

    assert results
    statuses = collections.Counter(r.status for r in results)
    assert statuses.get("error", 0) == 0, statuses
    assert statuses["ok"] > 0
    oks = [r for r in results if r.ok]
    assert {r.generation for r in oks} <= {0, 1}
    assert [r.generation for r in oks][-1] == 1
    outcomes = [json.loads(v) for k, v in kv.scan("%s/flip/" % NAMESPACE).items() if k.endswith("/outcome")]
    assert len(outcomes) == 1 and outcomes[0]["decision"] == "commit"
    audit = fsck_store(ArtifactStore(store_root))
    assert audit["clean"], audit
    assert ckpt_fsck.main([model_dir, "--json", "--store", store_root]) == 0
