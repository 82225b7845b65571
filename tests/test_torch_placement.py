"""The port's placement (`distributed/`) against the JAX package's.

- Copies of tests/test_distributed.py's in-process RoundRobin tests,
  tests/test_robustness.py's quarantine and watchdog tests and
  tests/test_summary.py's summary hook under RoundRobin, with the JAX
  tests' own numbers: the placement's groups (over eight labelled
  devices), training, windows, stale syncs, teachers, and the
  fused-divergence bound (EMA gap < 0.10 x |EMA| + 0.005 after 30
  epochs; subnetwork losses rtol 1e-3).
- One RoundRobin step and one window of 4, the port against the JAX
  package's `RoundRobinExecutor` (its 8 virtual CPU devices) from the
  same `initial_variables`: subnetwork losses and parameters within atol
  1e-5 x max(1, |value|) (f32 forwards and SGD on both sides; the JAX
  side shards each group's batch over its devices, which reorders a
  sum); ensemble losses and mixture weights within atol 1e-5 x max(1,
  |value|) too, since both ensemble groups read the same post-update
  member copies in eval mode.
- The split `Iteration` (`subnetwork_update`, `ensemble_update`) bitwise
  equal to the parent tree's fused step, kept below as
  `_fused_step_before_split`, over two iterations with dropout, a bagged
  subnetwork, teachers and example weights.
- RoundRobin subnetwork training equal to the fused path's (bagging
  within rtol 2e-4, atol 1e-5, the JAX test's), the ImageNet trainer's
  `--placement=round_robin` wiring, and its convergence gate (slow).
"""

import json
import os
import time
import types

import numpy as np
import pytest
import torch
from torch import nn

from adanet_tpu_torch.core import iteration as iteration_lib
from adanet_tpu_torch.core.estimator import Estimator
from adanet_tpu_torch.core.heads import MultiClassHead, RegressionHead
from adanet_tpu_torch.core.iteration import IterationBuilder
from adanet_tpu_torch.distributed import (
    RoundRobinExecutor,
    RoundRobinStrategy,
    coordination,
    partition_devices,
)
from adanet_tpu_torch.ensemble import ComplexityRegularizedEnsembler, GrowStrategy
from adanet_tpu_torch.robustness import faults, watchdog
from adanet_tpu_torch.subnetwork.generator import SimpleGenerator

from torch_port_common import dnn_builder, linear_dataset, one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)

CPU = torch.device("cpu")
CANDIDATE = "t0_a_grow_complexity_regularized"


def _sgd(lr):
    return lambda params: torch.optim.SGD(params, lr=lr)


def _factory(**kwargs):
    return IterationBuilder(
        head=RegressionHead(),
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=_sgd(0.05))],
        ensemble_strategies=[GrowStrategy()],
        device="cpu",
        **kwargs,
    )


def _sample():
    return next(linear_dataset()())


def _build(builders, t=0, previous=None, **kwargs):
    return _factory(**kwargs).build_iteration(t, builders, previous, input_shape=(2,))


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _executor(it, **kwargs):
    return RoundRobinExecutor(it, RoundRobinStrategy([CPU]), **kwargs)


def _params(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


# ----------------------------------------------------------------- groups


def test_partition_devices():
    devices = [torch.device("cuda", i) for i in range(8)]
    groups = partition_devices(devices, 3)
    assert len(groups) == 3
    assert [len(g) for g in groups] == [3, 3, 2]
    assert {d.index for g in groups for d in g} == set(range(8))
    # More groups than devices wraps around.
    groups = partition_devices(devices[:2], 5)
    assert len(groups) == 5
    assert all(len(g) == 1 for g in groups)
    assert [g[0].index for g in groups] == [0, 1, 0, 1, 0]


def test_round_robin_meshes_are_disjoint():
    strategy = RoundRobinStrategy([torch.device("cuda", i) for i in range(8)])
    n = 3
    meshes = [strategy.ensemble_mesh(n)] + [strategy.subnetwork_mesh(n, i) for i in range(n)]
    seen = set()
    for mesh in meshes:
        ids = {d.index for d in mesh.devices}
        assert not (seen & ids)
        seen |= ids
    assert len(seen) == 8


def test_device_group_helpers():
    """The mesh helpers in one process: groups over the given devices,
    batches and state placed on a group's device, the batch signature
    (the JAX function's parts) and a plain stream through
    `lockstep_batches` (no agreement in one process)."""
    from adanet_tpu_torch.distributed import (
        batch_signature,
        candidate_submeshes,
        data_parallel_mesh,
        global_batch,
        lockstep_batches,
        replicate_state,
        shard_batch,
    )

    groups = candidate_submeshes(3, [CPU] * 4)
    assert [len(g.devices) for g in groups] == [2, 1, 1]
    group = data_parallel_mesh([CPU])
    assert group.device == CPU and group.process_group is None
    batch = ({"x": np.ones((4, 2), np.float32)}, np.zeros((4, 1), np.int64))
    for placed in (shard_batch(batch, group), global_batch(batch, group)):
        assert torch.is_tensor(placed[0]["x"]) and placed[0]["x"].device == CPU
        assert placed[1].dtype == torch.int64
    state = replicate_state({"w": torch.ones(3)}, group)
    assert torch.equal(state["w"], torch.ones(3))
    assert batch_signature(batch) == "({'x':*},*)|float32:(4, 2)|int64:(4, 1)"
    assert batch_signature(shard_batch(batch, group)) == batch_signature(batch)
    stream = lambda: iter([batch] * 3)  # noqa: E731
    assert len(list(lockstep_batches(stream, collective=True))) == 3
    assert len(list(lockstep_batches(stream, steps=2))) == 2


def test_groups_must_be_on_the_iterations_device():
    it = _build([dnn_builder("a", 1)])
    with pytest.raises(ValueError, match="iteration's device"):
        RoundRobinExecutor(it, RoundRobinStrategy([torch.device("cuda", 0)]))


# ------------------------------------------------------------ the executor


def test_round_robin_executor_trains():
    it = _build([dnn_builder("a", 1), dnn_builder("b", 2)])
    executor = _executor(it)
    state = executor.init_state(_gen(), _sample())
    first = None
    for _ in range(10):
        for batch in linear_dataset()():
            state, metrics = executor.train_step(state, batch)
            if first is None:
                first = float(metrics["adanet_loss/%s" % CANDIDATE])
    last = float(metrics["adanet_loss/%s" % CANDIDATE])
    assert last < first
    emas = executor.ema_losses(state)
    assert all(np.isfinite(v) for v in emas.values())
    best = it.best_candidate_index(state)
    frozen = it.freeze_candidate(executor.gather(state), it.candidate_names()[best], _sample())
    assert len(frozen.weighted_subnetworks) == 1


def test_round_robin_multi_step_window():
    """train_steps runs K steps a group; subnetwork training equals K
    single dispatches (sync_every=K aligns the member syncs)."""
    batches = list(linear_dataset()())[:4]

    def build(sync_every):
        it = _build([dnn_builder("a", 1), dnn_builder("b", 2)])
        return it, _executor(it, sync_every=sync_every)

    it_multi, ex_multi = build(1)
    st = ex_multi.init_state(_gen(), batches[0])
    st, metrics = ex_multi.train_steps(st, batches)
    assert st.iteration_step == 4
    assert np.isfinite(float(metrics["adanet_loss/%s" % CANDIDATE]))
    it_single, ex_single = build(4)
    st1 = ex_single.init_state(_gen(), batches[0])
    for batch in batches:
        st1, m1 = ex_single.train_step(st1, batch)
    assert st1.iteration_step == 4
    for spec in it_single.subnetwork_specs:
        for key, value in _params(st.subnetworks[spec.name].module).items():
            torch.testing.assert_close(value, st1.subnetworks[spec.name].module.state_dict()[key], rtol=2e-5, atol=0)
    frozen = it_multi.freeze_candidate(
        ex_multi.gather(st), it_multi.candidate_names()[it_multi.best_candidate_index(st)], batches[0]
    )
    assert frozen.weighted_subnetworks


class _DropoutModule(nn.Module):
    def __init__(self, dim, logits_dimension):
        super().__init__()
        self.dense = nn.Linear(dim, 8)
        self.logits = nn.Linear(8, logits_dimension)

    def forward(self, features, training=False, generator=None):
        from adanet_tpu_torch.subnetwork.generator import Subnetwork

        x = torch.relu(self.dense(features["x"].float()))
        if training:
            keep = torch.rand(x.shape, generator=generator) < 0.5
            x = torch.where(keep, x / 0.5, torch.zeros_like(x))
        return Subnetwork(last_layer=x, logits=self.logits(x), complexity=1.0)


def _dropout_builder(name):
    base = dnn_builder(name, 1)

    class _Builder(type(base)):
        def build_subnetwork(self, logits_dimension, previous_ensemble=None, *, input_shape):
            torch.manual_seed(sum(map(ord, name)))
            return _DropoutModule(int(np.prod(input_shape)), logits_dimension)

    return _Builder()


def test_round_robin_multi_step_rng_matches_single_step():
    """A window replays the draws of K single steps, so dropout builders
    train the same trajectory whatever iterations_per_loop says."""
    batches = list(linear_dataset()())[:4]

    def build():
        it = _build([_dropout_builder("d"), _dropout_builder("e")])
        return _executor(it)

    ex_multi = build()
    st_m = ex_multi.init_state(_gen(3), batches[0])
    st_m, _ = ex_multi.train_steps(st_m, batches)
    ex_single = build()
    st_s = ex_single.init_state(_gen(3), batches[0])
    for batch in batches:
        st_s, _ = ex_single.train_step(st_s, batch)
    for name in ("d", "e"):
        for key, value in _params(st_m.subnetworks[name].module).items():
            torch.testing.assert_close(value, st_s.subnetworks[name].module.state_dict()[key], rtol=1e-5, atol=0)
    # The generator after the window matches too (resume equivalence).
    assert torch.equal(st_m.generator.get_state(), st_s.generator.get_state())


def test_round_robin_subnetworks_train_as_the_fused_step():
    """Dropout draws included: the groups draw in the fused step's order
    and the ensemble group draws nothing, so the subnetworks' parameters
    are the fused path's, bitwise, on the CPU."""
    batches = list(linear_dataset()())
    fused = _build([_dropout_builder("d"), _dropout_builder("e")])
    st_f = fused.init_state(_gen(5), batches[0])
    rr = _build([_dropout_builder("d"), _dropout_builder("e")])
    executor = _executor(rr)
    st_r = executor.init_state(_gen(5), batches[0])
    for batch in batches * 2:
        st_f, m_f = fused.train_step(st_f, batch)
        st_r, m_r = executor.train_step(st_r, batch)
        for name in ("d", "e"):
            assert torch.equal(m_f["subnetwork_loss/%s" % name], m_r["subnetwork_loss/%s" % name])
    for name in ("d", "e"):
        for key, value in _params(st_f.subnetworks[name].module).items():
            assert torch.equal(value, st_r.subnetworks[name].module.state_dict()[key]), (name, key)
    assert torch.equal(st_f.generator.get_state(), st_r.generator.get_state())


def test_round_robin_fused_divergence_bounded():
    """From identical init on identical batches, the candidates' EMAs
    (the selection signal) stay within 10% relative plus half the noise
    floor (0.005) after 30 epochs and the selection agrees; subnetwork
    losses agree at every step (rtol 1e-3). The tests/test_distributed.py
    numbers."""
    builders = [dnn_builder("a", 1), dnn_builder("b", 2)]
    sample = _sample()
    it_fused = _build(builders)
    st_fused = it_fused.init_state(_gen(), sample)
    it_rr = _build([dnn_builder("a", 1), dnn_builder("b", 2)])
    executor = _executor(it_rr)
    st_rr = executor.init_state(_gen(), sample)
    for _ in range(30):
        for batch in linear_dataset()():
            st_fused, m_fused = it_fused.train_step(st_fused, batch)
            st_rr, m_rr = executor.train_step(st_rr, batch)
            for spec in it_fused.subnetwork_specs:
                key = "subnetwork_loss/%s" % spec.name
                np.testing.assert_allclose(float(m_fused[key]), float(m_rr[key]), rtol=1e-3)
    ema_fused = it_fused.ema_losses(st_fused)
    ema_rr = it_rr.ema_losses(st_rr)
    assert set(ema_fused) == set(ema_rr)
    for name, value in ema_fused.items():
        gap = abs(value - ema_rr[name])
        assert gap < 0.10 * abs(value) + 0.005, (name, value, ema_rr[name])
    assert it_fused.best_candidate_index(st_fused) == it_rr.best_candidate_index(st_rr)


def test_round_robin_executor_stale_sync():
    """sync_every > 1 (the async parameter-server analogue) still trains;
    the copies are clones, so a stale step reads the last sync's values."""
    it = _build([dnn_builder("a", 1)])
    executor = RoundRobinExecutor(it, sync_every=4)
    state = executor.init_state(_gen(), _sample())
    synced = None
    for step, batch in enumerate(linear_dataset()()):
        state, metrics = executor.train_step(state, batch)
        copies = executor._member_copies["a"].state_dict()
        if step == 0:
            synced = {k: v.clone() for k, v in copies.items()}
        else:
            # Steps 1-3 read the copies of step 0's sync, not the live
            # module (which moved).
            for key, value in copies.items():
                assert torch.equal(value, synced[key])
            assert not torch.equal(copies["logits.weight"], state.subnetworks["a"].module.logits.weight)
    assert np.isfinite(float(metrics["adanet_loss/%s" % CANDIDATE]))


def test_round_robin_custom_loss_gets_teacher_context():
    seen = {"context": None}

    def kd(name):
        class _KD(type(dnn_builder(name, 1))):
            def build_subnetwork_loss(self, subnetwork, labels, head, context):
                seen["context"] = context
                loss = head.loss(subnetwork.logits, labels)
                if context is not None and context.previous_ensemble_logits is not None:
                    loss = loss + 0.1 * torch.mean((subnetwork.logits - context.previous_ensemble_logits) ** 2)
                return loss

        return _KD()

    sample = _sample()
    it0 = _build([kd("a")])
    ex0 = _executor(it0)
    st0 = ex0.init_state(_gen(0), sample)
    st0, _ = ex0.train_step(st0, sample)
    assert seen["context"] is None  # no previous ensemble at t=0
    frozen = it0.freeze_candidate(ex0.gather(st0), it0.candidate_names()[0], sample)
    it1 = _build([kd("b")], t=1, previous=frozen)
    ex1 = _executor(it1)
    st1 = ex1.init_state(_gen(1), sample)
    st1, metrics = ex1.train_step(st1, sample)
    assert seen["context"] is not None
    assert seen["context"].previous_ensemble_logits is not None
    assert np.isfinite(float(metrics["subnetwork_loss/b"]))


def test_round_robin_executor_quarantines_faulted_candidate():
    """A candidate whose dispatch faults is marked dead and the iteration
    finishes with the survivors (tests/test_robustness.py's copy)."""
    it = _build([dnn_builder("a", 1), dnn_builder("b", 2)])
    executor = _executor(it)
    batches = list(linear_dataset()())
    state = executor.init_state(_gen(), batches[0])
    orig = executor._sub_steps["a"]
    calls = [0]

    def flaky(*args):
        calls[0] += 1
        if calls[0] >= 3:
            raise faults.InjectedFault("group fault at call 3")
        return orig(*args)

    executor._sub_steps["a"] = flaky
    for batch in batches:
        state, _ = executor.train_step(state, batch)
    assert "a" in executor.dead_subnetworks()
    dead = executor.dead_candidate_names()
    assert any("a" in name for name in dead)
    assert all("b" not in name.split("_")[1] for name in dead)
    assert int(state.subnetworks["a"].step) == 2
    gathered = executor.gather(state)
    for name in dead:
        gathered.candidates[name].dead = torch.ones_like(gathered.candidates[name].dead)
    best = it.best_candidate_index(gathered)
    assert "b" in it.candidate_names()[best]
    assert it.freeze_candidate(gathered, it.candidate_names()[best], batches[0]).weighted_subnetworks


def test_builder_summary_hook_under_round_robin():
    """The hook fires under RoundRobin placement too, as on the fused
    path, and not when summaries are off (tests/test_summary.py)."""

    def summary_builder(name):
        class _Summary(type(dnn_builder(name, 1))):
            def build_subnetwork_summaries(self, subnetwork, features, labels):
                return {"activations": subnetwork.last_layer}

        return _Summary()

    sample = _sample()
    for collect, expected in ((True, True), (False, False)):
        it = _build([summary_builder("a")], collect_summaries=collect)
        executor = _executor(it)
        state = executor.init_state(_gen(), sample)
        state, metrics = executor.train_step(state, sample)
        assert ("summary/a/activations" in metrics) == expected
        it2 = _build([summary_builder("a")], collect_summaries=collect)
        st2 = it2.init_state(_gen(), sample)
        st2, m2 = it2.train_step(st2, sample)
        assert ("summary/a/activations" in m2) == expected
        if expected:
            assert torch.equal(metrics["summary/a/activations"], m2["summary/a/activations"])


# ------------------------------------------------------------ the Estimator


def _rr_estimator(tmp_path, **kwargs):
    return Estimator(
        head=RegressionHead(),
        subnetwork_generator=SimpleGenerator([dnn_builder("a", 1), dnn_builder("b", 2)]),
        max_iteration_steps=6,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=_sgd(0.05))],
        max_iterations=2,
        model_dir=str(tmp_path / "model"),
        log_every_steps=0,
        device="cpu",
        placement_strategy=RoundRobinStrategy([CPU]),
        **kwargs,
    )


def test_estimator_with_round_robin_placement(tmp_path):
    est = _rr_estimator(tmp_path)
    est.train(linear_dataset(), max_steps=100)
    assert est.latest_iteration_number() == 2
    metrics = est.evaluate(linear_dataset())
    assert np.isfinite(metrics["average_loss"])


def test_estimator_round_robin_iterations_per_loop(tmp_path):
    """2 iterations x 6 steps in windows of 4, then 2 (clipped)."""
    est = _rr_estimator(tmp_path, iterations_per_loop=4)
    est.train(linear_dataset(), max_steps=100)
    assert est.latest_iteration_number() == 2
    assert est.latest_global_step() == 12
    assert np.isfinite(est.evaluate(linear_dataset())["average_loss"])


def test_estimator_round_robin_stops_and_resumes(tmp_path):
    """A RoundRobin search stopped inside an iteration resumes from its
    checkpoint to the same step count as one run straight through."""
    est = _rr_estimator(tmp_path)
    est.train(linear_dataset(), max_steps=9)
    assert est.latest_global_step() == 9 and est.latest_iteration_number() == 1
    est.train(linear_dataset(), max_steps=100)
    assert est.latest_global_step() == 12 and est.latest_iteration_number() == 2


def test_estimator_rejects_other_placements(tmp_path):
    with pytest.raises(ValueError, match="Unsupported placement"):
        Estimator(RegressionHead(), SimpleGenerator([dnn_builder("a", 1)]), 6, device="cpu",
                  model_dir=str(tmp_path / "x"), placement_strategy=object())


def test_weights_under_round_robin(tmp_path):
    """tests/test_weights.py's copy: the poison test passes under
    RoundRobin placement (weighted subnetwork and ensemble updates)."""
    from test_torch_weights import _make_estimator, _poisoned_dataset

    train_fn, clean_eval_fn = _poisoned_dataset()
    est = _make_estimator(
        tmp_path, "rr", weight_key="w", placement_strategy=RoundRobinStrategy([CPU]),
        subnetwork_generator=SimpleGenerator(
            [dnn_builder("dnn", 1, learning_rate=0.2), dnn_builder("deep", 2, learning_rate=0.2)]
        ),
    )
    est.train(train_fn, max_steps=60)
    assert est.evaluate(clean_eval_fn)["accuracy"] >= 0.9


def test_bagging_under_round_robin(tmp_path):
    """tests/test_autoensemble.py's copy: each group trains on its own
    stream, and the subnetworks end where the fused path's do (rtol 2e-4,
    atol 1e-5)."""
    from test_torch_autoensemble import _MLP, _Linear, _probe_subnetwork_params

    from adanet_tpu_torch.autoensemble import AutoEnsembleEstimator, AutoEnsembleSubestimator

    def make(model_dir, placement):
        return AutoEnsembleEstimator(
            head=RegressionHead(),
            candidate_pool={
                "bagged": AutoEnsembleSubestimator(_MLP(), optimizer=_sgd(0.05),
                                                   train_input_fn=lambda: linear_dataset(seed=7)()),
                "plain": AutoEnsembleSubestimator(_Linear(), optimizer=_sgd(0.05)),
            },
            max_iteration_steps=8,
            max_iterations=1,
            model_dir=str(tmp_path / model_dir),
            log_every_steps=0,
            device="cpu",
            placement_strategy=placement,
        )

    fused, _ = _probe_subnetwork_params(make("fused", None), linear_dataset(), 8)
    rr, _ = _probe_subnetwork_params(make("rr", RoundRobinStrategy([CPU])), linear_dataset(), 8)
    assert sorted(fused) == sorted(rr) and fused
    assert any(k.startswith("bagged") for k in fused)
    for key in fused:
        np.testing.assert_allclose(fused[key].numpy(), rr[key].numpy(), rtol=2e-4, atol=1e-5)


# -------------------------------------------------------- watchdog copies


def test_heartbeat_staleness_threshold_boundary(tmp_path, monkeypatch):
    """A heartbeat exactly at the threshold is live (strict `>`); one tick
    past it declares the chief lost (tests/test_robustness.py:156)."""
    d = str(tmp_path)
    path = watchdog.heartbeat_path(d)
    with open(path, "w") as f:
        f.write("{}")
    now = [1_000_000.0]
    monkeypatch.setattr(watchdog, "time", types.SimpleNamespace(time=lambda: now[0], monotonic=time.monotonic))
    beat = now[0] - 30.0
    os.utime(path, (beat, beat))
    assert watchdog.heartbeat_age(d) == pytest.approx(30.0)
    with pytest.raises(coordination.WorkerWaitTimeout):
        coordination.wait_for_iteration(d, 1, timeout_secs=0.15, poll_interval_secs=0.05,
                                        heartbeat_timeout_secs=30.0)
    now[0] += 0.5
    with pytest.raises(watchdog.PeerLostError) as err:
        coordination.wait_for_iteration(d, 1, timeout_secs=60.0, poll_interval_secs=0.05,
                                        heartbeat_timeout_secs=30.0)
    assert err.value.source_process == 0


def test_watchdog_deadline_and_transport_death():
    t0 = time.monotonic()
    with pytest.raises(watchdog.PeerLostError) as err:
        watchdog.call_with_deadline(lambda: time.sleep(30), 0.4, "member sync a", source_process=3)
    assert time.monotonic() - t0 < 5.0
    assert err.value.source_process == 3
    assert "member sync a" in str(err.value)

    def reset():
        raise RuntimeError("Connection reset by peer")

    with pytest.raises(watchdog.PeerLostError):
        watchdog.call_with_deadline(reset, 5.0, "gather b")

    def boom():
        raise ValueError("genuine bug")

    with pytest.raises(ValueError):
        watchdog.call_with_deadline(boom, 5.0, "gather c")
    assert watchdog.call_with_deadline(lambda: 41 + 1, 5.0, "quick") == 42


def test_heartbeat_writer_and_stale_chief_detection(tmp_path):
    d = str(tmp_path)
    with watchdog.HeartbeatWriter(d, interval_secs=0.1):
        time.sleep(0.05)
        age = watchdog.heartbeat_age(d)
        assert age is not None and age < 5.0
    old = time.time() - 120
    os.utime(watchdog.heartbeat_path(d), (old, old))
    t0 = time.monotonic()
    with pytest.raises(watchdog.PeerLostError):
        coordination.wait_for_iteration(d, 1, timeout_secs=60.0, poll_interval_secs=0.05, heartbeat_timeout_secs=1.0)
    assert time.monotonic() - t0 < 5.0
    with pytest.raises(coordination.WorkerWaitTimeout):
        coordination.wait_for_iteration(str(tmp_path / "empty"), 1, timeout_secs=0.2, poll_interval_secs=0.05,
                                        heartbeat_timeout_secs=1.0)


# ---------------------------------------------------- parity with the JAX


FEATURES, CLASSES = 256, 10


def _digit_batches(n, seed=7, batch_size=32):
    from adanet_tpu_torch.examples.synthetic_digits import input_fn, make_dataset

    x, y = make_dataset(n * batch_size, seed=seed)
    return list(input_fn(x, y, batch_size)())


def _jax_round_robin(batches, window):
    import jax
    import optax

    from adanet_tpu.core.heads import MultiClassHead as JaxHead
    from adanet_tpu.core.iteration import IterationBuilder as JaxIterationBuilder
    from adanet_tpu.distributed import RoundRobinExecutor as JaxExecutor
    from adanet_tpu.distributed import RoundRobinStrategy as JaxStrategy
    from adanet_tpu.ensemble import ComplexityRegularizedEnsembler as JaxEnsembler
    from adanet_tpu.ensemble import GrowStrategy as JaxGrow
    from adanet_tpu.examples import simple_dnn as jax_simple_dnn

    from adanet_tpu_torch.utils.convert import WithInitialVariables, convert_simple_dnn

    generator = WithInitialVariables(
        jax_simple_dnn.Generator(optimizer_fn=lambda: optax.sgd(0.05), layer_size=16, initial_num_layers=1, seed=0),
        FEATURES, CLASSES, convert=lambda v: v,
    )
    builder = JaxIterationBuilder(JaxHead(CLASSES), [JaxEnsembler(optimizer=optax.sgd(0.05))], [JaxGrow()])
    it = builder.build_iteration(0, generator.generate_candidates(None, 0, [], []), None)
    executor = JaxExecutor(it, JaxStrategy())
    state = executor.init_state(jax.random.PRNGKey(0), batches[0])
    if window:
        stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *batches)
        state, metrics = executor.train_steps(state, stacked)
    else:
        state, metrics = executor.train_step(state, batches[0])
    state = executor.gather(state)
    params = {
        name: {k: v.numpy() for k, v in convert_simple_dnn(jax.device_get(st.variables["params"])).items()}
        for name, st in state.subnetworks.items()
    }
    weights = {name: [float(np.asarray(w)) for w in est.params["weights"]] for name, est in state.ensembles.items()}
    return {k: float(v) for k, v in metrics.items()}, params, weights


def _torch_round_robin(batches, window):
    from adanet_tpu_torch.examples import simple_dnn
    from adanet_tpu_torch.utils.convert import WithInitialVariables

    generator = WithInitialVariables(
        simple_dnn.Generator(optimizer_fn=_sgd(0.05), layer_size=16, initial_num_layers=1, seed=0),
        FEATURES, CLASSES,
    )
    builder = IterationBuilder(MultiClassHead(CLASSES), [ComplexityRegularizedEnsembler(optimizer=_sgd(0.05))],
                               [GrowStrategy()], device="cpu")
    it = builder.build_iteration(0, generator.generate_candidates(None, 0, [], []), None, input_shape=(FEATURES,))
    executor = _executor(it)
    state = executor.init_state(_gen(0), batches[0])
    if window:
        state, metrics = executor.train_steps(state, batches)
    else:
        state, metrics = executor.train_step(state, batches[0])
    params = {name: {k: v.detach().numpy() for k, v in st.module.state_dict().items()}
              for name, st in state.subnetworks.items()}
    weights = {name: [float(w.detach()) for w in est.params["weights"]] for name, est in state.ensembles.items()}
    return {k: float(v) for k, v in metrics.items()}, params, weights


def _close(got, want, what):
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (what, got, want)


@pytest.mark.parametrize("window", [False, True])
def test_round_robin_matches_jax(window):
    batches = _digit_batches(4)
    want_metrics, want_params, want_weights = _jax_round_robin(batches, window)
    got_metrics, got_params, got_weights = _torch_round_robin(batches, window)
    assert sorted(got_metrics) == sorted(want_metrics)
    for key, value in want_metrics.items():
        _close(got_metrics[key], value, key)
    assert sorted(got_params) == sorted(want_params)
    for name, params in want_params.items():
        for key, value in params.items():
            np.testing.assert_allclose(got_params[name][key], value, atol=1e-5, rtol=1e-5, err_msg=key)
    for name, weights in want_weights.items():
        for got, want in zip(got_weights[name], weights):
            _close(got, want, "weight %s" % name)


# ---------------------------------------- the split Iteration, bitwise


def _fused_step_before_split(it, state, batch, extra_batches):
    """The parent tree's `Iteration._train_step`, before it was split
    into `subnetwork_update` and `ensemble_update`, line for line."""
    _Guard, _grads, _step, _detached = (iteration_lib._Guard, iteration_lib._grads, iteration_lib._step,
                                        iteration_lib._detached)
    from adanet_tpu_torch.core import candidate as candidate_lib
    from adanet_tpu_torch.utils.trees import tree_finite

    features, weights, labels = it._step_inputs(batch)
    metrics = {}
    frozen_outs = it.frozen_outputs(state.frozen, features)
    context = it.build_loss_context(state.ensembles[it.ensemble_specs[0].name].params, frozen_outs)
    sub_outs = {}
    sub_updates = {}
    for spec in it.subnetwork_specs:
        st = state.subnetworks[spec.name]
        kwargs = {"generator": state.generator} if spec.takes_generator else {}
        guard = _Guard(st.module, st.optimizer)
        if spec.name in extra_batches:
            own_features, own_weights, own_labels = it._step_inputs(extra_batches[spec.name])
            own_context = it.build_loss_context(
                state.ensembles[it.ensemble_specs[0].name].params, it.frozen_outputs(state.frozen, own_features))
        else:
            own_features, own_weights, own_labels, own_context = features, weights, labels, context
        out = st.module(own_features, training=True, **kwargs)
        loss = spec.builder.build_subnetwork_loss(out, own_labels, it.head, own_context)
        if loss is None:
            loss = it.head.loss(out.logits, own_labels, own_weights)
        params = list(st.module.parameters())
        grads = _grads(loss, params)
        finite = torch.isfinite(loss)
        sub_updates[spec.name] = (st, params, grads, guard, finite & tree_finite(grads) & ~st.dead, finite)
        metrics.update(it.builder_summary_metrics(spec, out, own_features, own_labels))
        sub_outs[spec.name] = _detached(out)
        metrics["subnetwork_loss/%s" % spec.name] = loss.detach()
    for spec in it.subnetwork_specs:
        if spec.name not in extra_batches:
            continue
        st, params, grads, guard, ok, _ = sub_updates[spec.name]
        _step(st.optimizer, params, grads)
        guard.keep(ok)
        kwargs = {"generator": state.generator} if spec.takes_generator else {}
        buffers = list(st.module.buffers())
        kept = [b.clone() for b in buffers]
        with torch.no_grad():
            sub_outs[spec.name] = _detached(st.module(features, training=True, **kwargs))
            for buffer, value in zip(buffers, kept):
                buffer.copy_(value)
    ens_updates = []
    for espec in it.ensemble_specs:
        est = state.ensembles[espec.name]
        member_outs = it.member_outputs(espec, sub_outs, frozen_outs)
        with torch.set_grad_enabled(est.optimizer is not None):
            ens = espec.ensembler.build_ensemble(est.params, member_outs)
            loss = it.head.loss(ens.logits, labels, weights)
            adanet_loss = loss + iteration_lib._complexity_regularization(ens)
        if est.optimizer is not None:
            params = iteration_lib._params_list(est.params)
            grads = _grads(adanet_loss, params)
            ens_updates.append((est, params, grads, torch.isfinite(adanet_loss) & tree_finite(grads)))
        if espec.track_ema:
            state.candidates[espec.name] = candidate_lib.update_candidate_state(
                state.candidates[espec.name], adanet_loss, it.adanet_loss_decay)
        metrics["adanet_loss/%s" % espec.name] = adanet_loss.detach()
        metrics["ensemble_loss/%s" % espec.name] = loss.detach()
    for name, (st, params, grads, guard, ok, finite) in sub_updates.items():
        if name not in extra_batches:
            _step(st.optimizer, params, grads)
            guard.keep(ok)
        st.step = st.step + ok.to(torch.int32)
        st.dead = st.dead | ~finite
    for est, params, grads, ok in ens_updates:
        guard = _Guard(None, est.optimizer)
        _step(est.optimizer, params, grads)
        guard.keep(ok)
    state.iteration_step += 1
    return state, metrics


def _snapshot(state):
    out = {"generator": state.generator.get_state(), "step": state.iteration_step}
    for name, st in state.subnetworks.items():
        out.update({"%s/%s" % (name, k): v.clone() for k, v in st.module.state_dict().items()})
        for i, slots in enumerate(st.optimizer.state.values()):
            out.update({"%s/slot%d/%s" % (name, i, k): v.clone() for k, v in slots.items() if torch.is_tensor(v)})
        out["%s/counters" % name] = torch.stack([st.step.float(), st.dead.float()])
    for name, est in state.ensembles.items():
        out.update({"%s/w%d" % (name, i): p.detach().clone()
                    for i, p in enumerate(iteration_lib._params_list(est.params))})
    for name, cs in state.candidates.items():
        out.update({"%s/%s" % (name, k): v.clone() for k, v in vars(cs).items()})
    return out


def test_split_iteration_is_bitwise_the_fused_step():
    """Two iterations of simple_dnn (dropout 0.2, adam) with a weighted
    MultiClassHead, a bagged subnetwork at t = 0 and teachers at t = 1:
    the split step and the parent's fused step leave every parameter,
    optimizer slot, counter, mixture weight, EMA and the generator
    bitwise equal, and return equal metrics."""
    from adanet_tpu_torch.examples import simple_dnn

    x = np.random.RandomState(0).randn(6 * 16, 8).astype(np.float32)
    y = np.random.RandomState(1).randint(0, 3, size=6 * 16)
    w = np.random.RandomState(2).uniform(0.5, 1.5, size=(6 * 16, 1)).astype(np.float32)
    batches = [({"x": x[i:i + 16], "w": w[i:i + 16]}, y[i:i + 16]) for i in range(0, len(x), 16)]
    adam = lambda params: torch.optim.Adam(params, lr=1e-2)  # noqa: E731
    previous = [None, None]
    for t in range(2):
        runs = []
        for side in range(2):
            generator = simple_dnn.Generator(optimizer_fn=adam, layer_size=8, initial_num_layers=1, dropout=0.2,
                                             seed=0)
            it = IterationBuilder(MultiClassHead(3), [ComplexityRegularizedEnsembler(optimizer=adam)],
                                  [GrowStrategy()], device="cpu", weight_key="w").build_iteration(
                t, generator.generate_candidates(previous[side], t, [], []), previous[side], input_shape=(8,))
            state = it.init_state(_gen(t), batches[0])
            names = [spec.name for spec in it.subnetwork_specs]
            trace = []
            for step, batch in enumerate(batches):
                extra = {names[0]: batches[-1 - step]} if t == 0 else {}
                if side == 0:
                    state, metrics = _fused_step_before_split(it, state, batch, extra)
                else:
                    state, metrics = it.train_step(state, batch, extra)
                trace.append({k: v.clone() for k, v in metrics.items()})
            runs.append((it, state, trace))
            previous[side] = it.freeze_candidate(state, it.candidate_names()[-1], batches[0])
        (_, want, want_trace), (_, got, got_trace) = runs
        for a, b in zip(want_trace, got_trace):
            assert list(a) == list(b)
            for key in a:
                assert torch.equal(a[key], b[key]), (t, key)
        want_snap, got_snap = _snapshot(want), _snapshot(got)
        assert sorted(want_snap) == sorted(got_snap)
        for key, value in want_snap.items():
            if torch.is_tensor(value):
                assert torch.equal(value, got_snap[key]), (t, key)
            else:
                assert value == got_snap[key], (t, key)


# -------------------------------------------------------- ImageNet trainer


def test_build_estimator_wires_round_robin(tmp_path):
    from adanet_tpu_torch.research.imagenet_autoensemble import trainer

    flags = trainer.parse_args(["--placement=round_robin", "--device=cpu", "--image_size=32"])
    provider = types.SimpleNamespace(num_classes=8)
    est = trainer.build_estimator(flags, provider, str(tmp_path))
    assert isinstance(est._placement_strategy, RoundRobinStrategy)
    assert est._placement_strategy.devices == [CPU]
    est = trainer.build_estimator(trainer.parse_args(["--device=cpu", "--image_size=32"]), provider, str(tmp_path))
    assert est._placement_strategy is None
    with pytest.raises(ValueError, match="Unknown placement"):
        trainer.build_estimator(trainer.parse_args(["--placement=elastic", "--device=cpu"]), provider, str(tmp_path))


@pytest.mark.slow
def test_imagenet_autoensemble_convergence_gate(tmp_path):
    """tests/test_imagenet_pipeline.py's gate, under RoundRobin as there:
    image 32, ResNet-18 width 8 + EfficientNet-B0, 60 steps, batch 32,
    resnet_lr 0.05, on 256 synthetic images (seed 11): accuracy >= 0.5
    (chance 0.125)."""
    from adanet_tpu_torch.research.imagenet_autoensemble import trainer
    from adanet_tpu_torch.research.imagenet_autoensemble.imagenet_data import SyntheticProvider

    flags = trainer.parse_args([
        "--dataset=fake", "--image_size=32", "--placement=round_robin", "--resnet_depth=18", "--resnet_width=8",
        "--efficientnet_variant=b0", "--candidates=resnet50,efficientnet_b0", "--boosting_iterations=1",
        "--train_steps=60", "--batch_size=32", "--resnet_lr=0.05", "--device=cpu",
    ])
    provider = SyntheticProvider(num_classes=8, num_examples=256, batch_size=32, image_size=32, seed=11)
    est = trainer.build_estimator(flags, provider, str(tmp_path / "model"))
    est.train(provider.get_input_fn("train"), max_steps=60)
    metrics = est.evaluate(provider.get_input_fn("test"))
    assert np.isfinite(metrics["average_loss"])
    assert metrics["accuracy"] >= 0.5, metrics
