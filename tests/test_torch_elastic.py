"""The port's elastic work queue in one process, against the JAX package.

- Copies of tests/test_scheduler.py's batch-log, codec, elastic-executor,
  quarantine and speculation tests, with the JAX tests' numbers. The
  elastic drain against lockstep RoundRobin (`sync_every` = the window,
  builders that draw nothing): the same winner and the subnetworks'
  parameters within rtol 2e-5 (the JAX test's); on the CPU both drives
  run the same operations in the same order, so the port is also held
  bitwise there.
- The heterogeneous-budget test is asserted on dispatched steps and on
  the order in which candidates finish, not on wall-clock time (the JAX
  test races the clock).
- The budget-stop and resume half of the JAX package's full-search test
  (stopped at step 6, off the window grid; resumed to 16, two
  iterations). Its elastic-against-RoundRobin selection at t = 1 is not
  copied: the two drives read members at different staleness, and the
  JAX package itself parts there.
- `FileKV`, `InMemoryKV` and `CoordinationKV` (over a one-process gloo
  group) through one contract: the insert-if-absent race, the bounded
  `get`, `scan` and `delete`; a drain over the process group's store
  bitwise equal to one over the in-memory store.
- The multi-host executor in one process (the JAX degenerate test).
- One elastic iteration of simple_dnn against the JAX package's elastic
  executor from the same `initial_variables`: the same winner, the
  subnetworks' parameters within atol 1e-5 and rtol 1e-5 (f32 forwards
  and SGD on both sides; JAX's XLA reorders sums), the mixture weights
  within 1e-5 x max(1, |w|).
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from adanet_tpu_torch.core import checkpoint as ckpt_lib
from adanet_tpu_torch.core.estimator import Estimator, _BatchLog
from adanet_tpu_torch.core.heads import MultiClassHead, RegressionHead
from adanet_tpu_torch.core.iteration import IterationBuilder
from adanet_tpu_torch.distributed import (
    CoordinationKV,
    ElasticWorkQueueExecutor,
    ElasticWorkQueueStrategy,
    FileKV,
    InMemoryKV,
    MultiHostRoundRobinExecutor,
    RoundRobinExecutor,
    RoundRobinStrategy,
    decode_tree,
    encode_tree,
    multihost_candidate_groups,
)
from adanet_tpu_torch.ensemble import ComplexityRegularizedEnsembler, GrowStrategy
from adanet_tpu_torch.replay import Config as ReplayConfig
from adanet_tpu_torch.robustness import faults
from adanet_tpu_torch.subnetwork.generator import SimpleGenerator

from torch_port_common import dnn_builder, linear_dataset, one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)

CPU = torch.device("cpu")


def _sgd(lr):
    return lambda params: torch.optim.SGD(params, lr=lr)


def _factory():
    return IterationBuilder(
        head=RegressionHead(),
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=_sgd(0.05))],
        ensemble_strategies=[GrowStrategy()],
        device="cpu",
    )


def _build(builders):
    return _factory().build_iteration(0, builders, None, input_shape=(2,))


def _strategy(**kwargs):
    return ElasticWorkQueueStrategy(devices=[CPU], **kwargs)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _budgeted(name, num_layers, budget=None, **kwargs):
    builder = dnn_builder(name, num_layers, **kwargs)
    builder.train_steps_budget = budget
    return builder


# --------------------------------------------------------------- batch log


def test_batch_log_replay_survives_second_transient():
    """A transient failure DURING the deterministic replay consumes the
    next bounded retry attempt instead of escaping the loop (and the
    replayed stream stays position-exact)."""
    pulls = {"n": 0}
    fail_at = {5, 7}  # pull #5: the live stream; pull #7: mid-replay

    def make_iter():
        def gen():
            i = 0
            while True:
                pulls["n"] += 1
                if pulls["n"] in fail_at:
                    raise ConnectionResetError("flaky data source")
                yield i
                i += 1

        return gen()

    log = _BatchLog(make_iter)
    assert [log.batch_at(i) for i in range(4)] == [0, 1, 2, 3]
    # Attempt 1 fails live (#5); attempt 2 re-opens and fails mid-replay
    # (#7); attempt 3 re-opens, replays the 4-batch prefix, and pulls
    # the real batch — still index-exact.
    assert log.batch_at(4) == 4

    def poisoned_iter():
        raise ValueError("corrupt shard")
        yield  # pragma: no cover

    bad = _BatchLog(lambda: poisoned_iter())
    with pytest.raises(ValueError):
        bad.batch_at(0)


def test_batch_log_wraps_and_forgets():
    """Past an epoch the stream re-opens; a forgotten prefix is replayed
    from the top, position-exact."""
    opened = []

    def make_iter():
        opened.append(1)
        return iter(range(3))

    log = _BatchLog(make_iter)
    assert [log.batch_at(i) for i in range(7)] == [0, 1, 2, 0, 1, 2, 0]
    log.forget_below(5)
    assert log.batch_at(5) == 2 and log.batch_at(1) == 1
    assert len(opened) >= 4


# -------------------------------------------------------------- tree codec


def test_encode_decode_tree_roundtrip():
    tree = {
        "w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "step": torch.tensor(7, dtype=torch.int32),
        "dead": torch.tensor(True),
        "nested": [torch.zeros(3, dtype=torch.float16), torch.ones((2, 2), dtype=torch.float64)],
        "bf16": torch.randn(5, generator=_gen(1)).to(torch.bfloat16),
        # An optimizer's state_dict: int keys, scalars, tuples, None.
        "optimizer": {"state": {0: {"momentum_buffer": torch.ones(2)}},
                      "param_groups": [{"lr": 0.1, "betas": (0.9, 0.999), "nesterov": False, "foreach": None,
                                        "params": [0]}]},
    }
    out = decode_tree(tree, encode_tree(tree))
    assert out["optimizer"]["param_groups"] == tree["optimizer"]["param_groups"]
    assert list(out["optimizer"]["state"]) == [0]
    flat_in, flat_out = _tensors(tree), _tensors(out)
    assert len(flat_in) == len(flat_out) == 7
    for a, b in zip(flat_in, flat_out):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # The blob carries its structure: a template without the optimizer's
    # slots still decodes them; a leaf of another shape raises.
    sparse = dict(tree, optimizer={"state": {}, "param_groups": []})
    assert torch.equal(decode_tree(sparse, encode_tree(tree))["optimizer"]["state"][0]["momentum_buffer"],
                       torch.ones(2))
    with pytest.raises(ValueError, match="template"):
        decode_tree(dict(tree, w=torch.zeros(4, 3)), encode_tree(tree))


# ---------------------------------------------------------------- KV stores


@pytest.fixture
def one_process_group():
    import datetime

    import torch.distributed as dist

    from test_torch_distributed import _free_port

    dist.init_process_group("gloo", init_method="tcp://localhost:%d" % _free_port(), world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


def _kv(kind, tmp_path):
    if kind == "file":
        return FileKV(str(tmp_path / "kv"))
    if kind == "memory":
        return InMemoryKV()
    return CoordinationKV()


def _text(value):
    return value.decode() if isinstance(value, bytes) else value


@pytest.mark.parametrize("kind", ["file", "memory", "store"])
def test_kv_contract(kind, tmp_path, request):
    if kind == "store":
        request.getfixturevalue("one_process_group")
    kv = _kv(kind, tmp_path)
    # Insert-if-absent: of racing writers exactly one wins, and the value
    # that stands is the winner's.
    wins = []
    barrier = threading.Barrier(8)

    def claim(i):
        barrier.wait()
        if kv.set("ns/claim/a/s0+4/0", "w%d" % i, overwrite=False):
            wins.append(i)

    threads = [threading.Thread(target=claim, args=(i,)) for i in range(8)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=30)
    assert len(wins) == 1
    assert _text(kv.try_get("ns/claim/a/s0+4/0")) == "w%d" % wins[0]
    assert not kv.set("ns/claim/a/s0+4/0", "late", overwrite=False)
    # Overwrite: last writer wins.
    kv.set("ns/lease/a", "1")
    kv.set("ns/lease/a", "2")
    assert _text(kv.get("ns/lease/a", timeout_secs=1.0)) == "2"
    # A bounded get of an absent key raises within its bound.
    start = time.monotonic()
    with pytest.raises(TimeoutError):
        kv.get("ns/absent", timeout_secs=0.2)
    assert time.monotonic() - start < 5.0
    assert kv.try_get("ns/absent") is None
    # Scan: the done markers under the prefix, nothing else.
    kv.set("ns/done/a/s0+4", "x", overwrite=False)
    kv.set("ns/done/b/s0+4", "y", overwrite=False)
    kv.set("ns/poison/b", "why", overwrite=False)
    done = {k: _text(v) for k, v in kv.scan("ns/done").items()}
    assert done == {"ns/done/a/s0+4": "x", "ns/done/b/s0+4": "y"}
    assert {k: _text(v) for k, v in kv.scan("ns/poison").items()} == {"ns/poison/b": "why"}
    # Delete.
    kv.delete("ns/done/a/s0+4")
    assert kv.try_get("ns/done/a/s0+4") is None
    assert list(kv.scan("ns/done")) == ["ns/done/b/s0+4"]
    # Bytes travel as bytes.
    kv.set("ns/state/blob", b"\x00\x01\xff")
    assert kv.get("ns/state/blob", timeout_secs=1.0) == b"\x00\x01\xff"


def test_drain_over_the_process_groups_store(one_process_group):
    """The elastic drain over `CoordinationKV` (blobs through the store:
    `encode_tree` runs when the world is larger, so it is forced here)
    ends bitwise where the in-memory drain does."""
    batches = list(linear_dataset()())[:4] * 2

    def drain(kv, via_blobs):
        it = _build([dnn_builder("a", 1), dnn_builder("b", 2)])
        executor = ElasticWorkQueueExecutor(it, _strategy(window_steps=4), kv=kv)
        if via_blobs:
            executor._process_count = 2  # publish every completion as a blob
        state = it.init_state(_gen(0), batches[0])
        result = executor.run_iteration(state, lambda i: batches[i], 0, 8, "adanet/wq/kv")
        return {name: {k: v.clone() for k, v in st.module.state_dict().items()}
                for name, st in result.state.subnetworks.items()}

    want = drain(InMemoryKV(), False)
    got = drain(CoordinationKV(), True)
    for name in want:
        for key in want[name]:
            assert torch.equal(got[name][key], want[name][key]), (name, key)


# ------------------------------------------------- in-process elastic runs


def test_elastic_strategy_rules():
    with pytest.raises(ValueError, match="unit_devices"):
        _strategy(unit_devices=2)
    it = _build([dnn_builder("a", 1)])
    with pytest.raises(TypeError):
        ElasticWorkQueueExecutor(it, RoundRobinStrategy([CPU]))
    bagged = dnn_builder("bagged", 1)
    bagged.train_input_fn = linear_dataset()
    with pytest.raises(ValueError, match="bagging"):
        ElasticWorkQueueExecutor(_build([bagged]), _strategy())


def test_elastic_executor_matches_lockstep_round_robin():
    """The queue drain reaches the lockstep RoundRobin oracle: same
    selected winner, and the subnetworks' parameters match the lockstep
    trajectory (same batches, same windowed math)."""
    batches = list(linear_dataset()())[:4] * 4  # 16 steps
    sample = batches[0]

    it_rr = _build([dnn_builder("a", 1), dnn_builder("b", 2)])
    ex_rr = RoundRobinExecutor(it_rr, RoundRobinStrategy([CPU]), sync_every=4)
    st_rr = ex_rr.init_state(_gen(0), sample)
    for start in range(0, 16, 4):
        st_rr, _ = ex_rr.train_steps(st_rr, batches[start:start + 4])

    it_wq = _build([dnn_builder("a", 1), dnn_builder("b", 2)])
    ex_wq = ElasticWorkQueueExecutor(it_wq, _strategy(window_steps=4, unit_devices=1), kv=InMemoryKV())
    st_wq = it_wq.init_state(_gen(0), sample)
    floors = []
    result = ex_wq.run_iteration(
        st_wq, batch_at=lambda i: batches[i], first_global_step=0, target_steps=16,
        queue_namespace="adanet/wq/test", forget_below=floors.append,
    )
    assert result.completed and result.steps_trained == 16
    assert result.dispatched_steps == 3 * 16  # a, b, ensemble
    # The batch-log trim floor is monotone and reaches the target once
    # every unit settles.
    assert floors == sorted(floors) and floors[-1] == 16
    state = result.state
    assert int(state.iteration_step) == 16

    assert it_rr.best_candidate_index(st_rr) == it_wq.best_candidate_index(state)
    for spec in it_rr.subnetwork_specs:
        want = st_rr.subnetworks[spec.name].module.state_dict()
        got = state.subnetworks[spec.name].module.state_dict()
        for key in want:
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=2e-5)
            assert torch.equal(got[key], want[key]), key
    assert it_rr.ema_losses(st_rr) == it_wq.ema_losses(state)
    frozen = it_wq.freeze_candidate(ex_wq.gather(state), it_wq.candidate_names()[0], sample)
    assert frozen.weighted_subnetworks


def test_elastic_beats_lockstep_on_heterogeneous_budgets():
    """Budget-capped candidates stop at their budget and free the queue:
    the drain dispatches strictly fewer steps than lockstep (every
    candidate for the whole iteration), the capped candidates finish
    first, and the full-budget candidate wins both runs with the same
    parameters and EMA (the JAX test times the two on the wall clock;
    here the work itself is counted)."""
    total = 96
    batches = list(linear_dataset()())

    def batch_at(i):
        return batches[i % len(batches)]

    def builders():
        return [
            _budgeted("full", 1),
            _budgeted("small1", 2, budget=8, learning_rate=1e-3),
            _budgeted("small2", 2, budget=8, hidden=4, learning_rate=1e-3),
        ]

    it_rr = _build(builders())
    ex_rr = RoundRobinExecutor(it_rr, RoundRobinStrategy([CPU]), sync_every=8)
    st_rr = ex_rr.init_state(_gen(0), batch_at(0))
    for start in range(0, total, 8):
        st_rr, _ = ex_rr.train_steps(st_rr, [batch_at(i) for i in range(start, start + 8)])

    it_wq = _build(builders())
    ex_wq = ElasticWorkQueueExecutor(it_wq, _strategy(window_steps=8, unit_devices=2 - 1), kv=InMemoryKV())
    finished = []
    run_subnetwork = ex_wq._run_subnetwork_unit

    def recording(unit, *args):
        out = run_subnetwork(unit, *args)
        if unit.end_step == ex_wq._candidate_caps(total)[unit.name]:
            finished.append(unit.name)
        return out

    ex_wq._run_subnetwork_unit = recording
    result = ex_wq.run_iteration(it_wq.init_state(_gen(0), batch_at(0)), batch_at, 0, total, "adanet/wq/hetero")

    assert result.dispatched_steps == total + 8 + 8 + total
    assert result.dispatched_steps < 4 * total
    assert finished == ["small1", "small2", "full"]
    best_rr = it_rr.best_candidate_index(st_rr)
    best_wq = it_wq.best_candidate_index(result.state)
    assert best_rr == best_wq and "full" in it_wq.candidate_names()[best_wq]
    name = it_wq.candidate_names()[best_wq]
    assert it_wq.ema_losses(result.state)[name] == pytest.approx(it_rr.ema_losses(st_rr)[name], rel=0.10)
    for key, value in st_rr.subnetworks["full"].module.state_dict().items():
        assert torch.equal(result.state.subnetworks["full"].module.state_dict()[key], value), key


def _estimator(d, strategy, replay_config=None):
    return Estimator(
        head=RegressionHead(),
        subnetwork_generator=SimpleGenerator([dnn_builder("a", 1), dnn_builder("b", 2)]),
        max_iteration_steps=8,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=_sgd(0.05))],
        max_iterations=2,
        model_dir=d,
        log_every_steps=0,
        device="cpu",
        replay_config=replay_config,
        placement_strategy=strategy,
    )


def _arch(d, t):
    with open(os.path.join(d, "architecture-%d.json" % t)) as f:
        return json.load(f)


def test_elastic_estimator_budget_stop_and_resume(tmp_path):
    """tests/test_scheduler.py::test_elastic_estimator_full_search_and_resume,
    its budget-stop half: stopped mid-iteration 0 at an OFF-GRID step
    (6, windows of 4), a fresh Estimator resumes to 16 (two iterations)
    and reaches the uninterrupted elastic search's architectures."""
    d_wq = str(tmp_path / "wq")
    _estimator(d_wq, _strategy(window_steps=4)).train(linear_dataset(), max_steps=100)
    d_res = str(tmp_path / "resume")
    _estimator(d_res, _strategy(window_steps=4)).train(linear_dataset(), max_steps=6)
    est = _estimator(d_res, _strategy(window_steps=4))
    assert est.latest_global_step() == 6
    est.train(linear_dataset(), max_steps=100)
    assert est.latest_global_step() == 16
    assert est.latest_iteration_number() == 2
    # The architectures, not the numbers: the resumed drain splits the
    # window [4, 8) at 6, so its ensemble unit reads members at step 6
    # where the uninterrupted one reads them at 8.
    assert [_arch(d_res, t)["subnetworks"] for t in range(2)] == [_arch(d_wq, t)["subnetworks"] for t in range(2)]


def test_elastic_poisoned_candidate_joins_quarantine():
    """A candidate whose units exhaust their lease attempts is poisoned
    into the CandidateState.dead path: selection excludes it and the
    survivor wins."""
    batches = list(linear_dataset()())[:4]
    it = _build([dnn_builder("a", 1), dnn_builder("b", 2)])
    executor = ElasticWorkQueueExecutor(it, _strategy(window_steps=4, max_attempts=1, lease_ttl_secs=30.0),
                                        kv=InMemoryKV())
    state = it.init_state(_gen(0), batches[0])
    # Unit execution order is deterministic: a@0 first. Fault exactly it;
    # with max_attempts=1 the release->reclaim path poisons 'a'.
    faults.arm("workunit.execute", "error", after=0, count=1)
    try:
        result = executor.run_iteration(state, lambda i: batches[i], 0, 4, "adanet/wq/poison")
    finally:
        faults.disarm()
    assert "a" in executor.dead_subnetworks()
    dead = executor.dead_candidate_names()
    assert any("a" in name for name in dead)
    gathered = executor.gather(result.state)
    for name in dead:
        gathered.candidates[name].dead = torch.ones_like(gathered.candidates[name].dead)
    best = it.best_candidate_index(gathered)
    assert "b" in it.candidate_names()[best]


# --------------------------------------------------------------- speculation


def _tensors(tree):
    out = []
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node[k] for k in sorted(node, key=str, reverse=True))
        elif isinstance(node, (list, tuple)):
            stack.extend(reversed(node))
        elif torch.is_tensor(node):
            out.append(node)
    return out


@pytest.fixture
def drains(monkeypatch):
    """Every `run_iteration`'s result, in order."""
    results = []
    run_iteration = ElasticWorkQueueExecutor.run_iteration

    def recording(self, *args, **kwargs):
        results.append(run_iteration(self, *args, **kwargs))
        return results[-1]

    monkeypatch.setattr(ElasticWorkQueueExecutor, "run_iteration", recording)
    return results


def test_speculation_is_bit_identical_and_reuses_windows(tmp_path, drains):
    """Speculative t+1 pre-training against the likely winner is grafted
    in as instant window completions when the winner holds: the search's
    frozen payloads are BIT-identical to the non-speculative run's."""
    d_off = str(tmp_path / "off")
    _estimator(d_off, _strategy(window_steps=4)).train(linear_dataset(), max_steps=100)
    d_on = str(tmp_path / "on")
    del drains[:]
    est = _estimator(d_on, _strategy(window_steps=4, speculate_steps=4))
    est.train(linear_dataset(), max_steps=100)
    # t = 0, the speculation of t = 1 (a window of each candidate), t = 1.
    assert [r.reused_steps for r in drains] == [0, 0, 4 * 2]
    assert drains[1].dispatched_steps == 4 * 2 and drains[1].steps_trained == 0
    for t in range(2):
        p_off = _tensors(ckpt_lib.restore_payload(d_off, ckpt_lib.frozen_filename(t)))
        p_on = _tensors(ckpt_lib.restore_payload(d_on, ckpt_lib.frozen_filename(t)))
        assert p_off and len(p_off) == len(p_on)
        for a, b in zip(p_off, p_on):
            assert torch.equal(a, b)


def test_speculation_discarded_on_winner_flip(tmp_path, caplog, drains):
    """A replay config forces a different winner than the EMA argmin the
    speculation bet on: the warm states must be discarded, and the run
    must match a no-speculation run of the same replay."""
    import logging

    # The EMA argmin at iteration 0 picks 'a'; replay index 1 forces 'b'.
    replay = ReplayConfig(best_ensemble_indices=[1, 0])
    d_flip = str(tmp_path / "flip")
    est = _estimator(d_flip, _strategy(window_steps=4, speculate_steps=4), replay_config=replay)
    with caplog.at_level(logging.INFO, logger="adanet_tpu_torch"):
        est.train(linear_dataset(), max_steps=100)
    assert est._speculation is None
    assert [r.reused_steps for r in drains] == [0, 0, 0]
    assert any("Discarding speculative warm start" in r.message for r in caplog.records)
    d_oracle = str(tmp_path / "oracle")
    _estimator(d_oracle, _strategy(window_steps=4), replay_config=replay).train(linear_dataset(), max_steps=100)
    assert [_arch(d_flip, t)["subnetworks"] for t in range(2)] == [
        _arch(d_oracle, t)["subnetworks"] for t in range(2)
    ]


# --------------------------------------------------- multi-host, one process


def test_multihost_executor_degenerate_single_process():
    """The multi-host RoundRobin executor with one process partitions the
    local devices (the reference's worker-modulo rule) and trains to
    usable selection and freeze state, as the in-process executor does."""
    devices = [torch.device("cuda", i) for i in range(8)]
    groups, owners = multihost_candidate_groups(3, devices, process_count=1, process_index=0)
    assert [len(g) for g in groups] == [3, 3, 2]
    assert owners == [[0], [0], [0]]

    sample = next(linear_dataset()())
    it = _build([dnn_builder("a", 1), dnn_builder("b", 2)])
    executor = MultiHostRoundRobinExecutor(it, RoundRobinStrategy([CPU]))
    assert executor.owns_ensemble and executor.owned_groups() == [0, 1, 2]
    state = executor.place(it.init_state(_gen(0), sample))
    it_rr = _build([dnn_builder("a", 1), dnn_builder("b", 2)])
    ex_rr = RoundRobinExecutor(it_rr, RoundRobinStrategy([CPU]))
    st_rr = ex_rr.place(it_rr.init_state(_gen(0), sample))
    first = None
    for batch in linear_dataset()():
        state, metrics = executor.train_step(state, batch)
        st_rr, m_rr = ex_rr.train_step(st_rr, batch)
        if first is None:
            first = float(metrics["adanet_loss/t0_a_grow_complexity_regularized"])
        assert {k: float(v) for k, v in metrics.items()} == {k: float(v) for k, v in m_rr.items()}
    assert np.isfinite(first)
    state = executor.gather(state)
    best = it.best_candidate_index(state)
    frozen = it.freeze_candidate(state, it.candidate_names()[best], sample)
    assert frozen.weighted_subnetworks
    assert executor.lost_peers == set() and executor.peer_lost_error is None


# ------------------------------------------------------- parity with JAX

FEATURES, CLASSES = 256, 10


def _digit_batches(n, seed=7, batch_size=32):
    from adanet_tpu_torch.examples.synthetic_digits import input_fn, make_dataset

    x, y = make_dataset(n * batch_size, seed=seed)
    return list(input_fn(x, y, batch_size)())


def _jax_elastic(batches, steps):
    import jax
    import optax

    from adanet_tpu.core.heads import MultiClassHead as JaxHead
    from adanet_tpu.core.iteration import IterationBuilder as JaxIterationBuilder
    from adanet_tpu.distributed import ElasticWorkQueueExecutor as JaxExecutor
    from adanet_tpu.distributed import ElasticWorkQueueStrategy as JaxStrategy
    from adanet_tpu.distributed import InMemoryKV as JaxKV
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
    executor = JaxExecutor(it, JaxStrategy(window_steps=4, unit_devices=1), kv=JaxKV())
    state = it.init_state(jax.random.PRNGKey(0), batches[0])
    result = executor.run_iteration(state, lambda i: batches[i], 0, steps, "adanet/wq/jax")
    state = result.state
    params = {
        name: {k: v.numpy() for k, v in convert_simple_dnn(jax.device_get(st.variables["params"])).items()}
        for name, st in state.subnetworks.items()
    }
    weights = {name: [float(np.asarray(w)) for w in est.params["weights"]] for name, est in state.ensembles.items()}
    return it.best_candidate_index(state), params, weights


def _torch_elastic(batches, steps):
    from adanet_tpu_torch.examples import simple_dnn
    from adanet_tpu_torch.utils.convert import WithInitialVariables

    generator = WithInitialVariables(
        simple_dnn.Generator(optimizer_fn=_sgd(0.05), layer_size=16, initial_num_layers=1, seed=0),
        FEATURES, CLASSES,
    )
    builder = IterationBuilder(MultiClassHead(CLASSES), [ComplexityRegularizedEnsembler(optimizer=_sgd(0.05))],
                               [GrowStrategy()], device="cpu")
    it = builder.build_iteration(0, generator.generate_candidates(None, 0, [], []), None, input_shape=(FEATURES,))
    executor = ElasticWorkQueueExecutor(it, _strategy(window_steps=4, unit_devices=1), kv=InMemoryKV())
    state = it.init_state(_gen(0), batches[0])
    state = executor.run_iteration(state, lambda i: batches[i], 0, steps, "adanet/wq/torch").state
    params = {name: {k: v.detach().numpy() for k, v in st.module.state_dict().items()}
              for name, st in state.subnetworks.items()}
    weights = {name: [float(w.detach()) for w in est.params["weights"]] for name, est in state.ensembles.items()}
    return it.best_candidate_index(state), params, weights


def test_elastic_iteration_matches_jax():
    batches = _digit_batches(8)
    want_best, want_params, want_weights = _jax_elastic(batches, 8)
    got_best, got_params, got_weights = _torch_elastic(batches, 8)
    assert got_best == want_best
    assert sorted(got_params) == sorted(want_params)
    for name, params in want_params.items():
        for key, value in params.items():
            np.testing.assert_allclose(got_params[name][key], value, atol=1e-5, rtol=1e-5, err_msg=key)
    for name, weights in want_weights.items():
        for got, want in zip(got_weights[name], weights):
            assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (name, got, want)
