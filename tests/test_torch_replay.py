"""The port's replay (`replay/` and the Estimator's `replay_config`).

- Copies of tests/test_estimator.py::test_replay and tests/test_store.py::
  test_replay_config_save_load_round_trip; `TPUEstimator` replays too.
- `replay.json` is written after every completed iteration (a search
  stopped after iteration 0 already has one index), and a search of both
  packages from the same `initial_variables` on the same data writes the
  same record (indices and architecture hashes).
- A replayed run takes the recorded winners without calling its
  Evaluator, and writes the same architecture files.
- `load_partial` of a missing model dir is an empty config.
"""

import json
import os

import optax
import pytest
import torch

import adanet_tpu
from adanet_tpu.ensemble import ComplexityRegularizedEnsembler as JaxEnsembler
from adanet_tpu.examples import simple_dnn as jax_simple_dnn

from adanet_tpu_torch import replay
from adanet_tpu_torch.core import TPUEstimator
from adanet_tpu_torch.core.estimator import Estimator
from adanet_tpu_torch.core.evaluator import Evaluator
from adanet_tpu_torch.core.heads import MultiClassHead, RegressionHead
from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
from adanet_tpu_torch.examples import simple_dnn
from adanet_tpu_torch.examples.synthetic_digits import input_fn, make_dataset
from adanet_tpu_torch.subnetwork.generator import SimpleGenerator
from adanet_tpu_torch.utils.convert import WithInitialVariables

from torch_port_common import dnn_builder, linear_dataset, one_torch_thread

STEPS = 25

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)


def _make_estimator(tmp_path, **kwargs):
    defaults = dict(
        head=RegressionHead(),
        subnetwork_generator=SimpleGenerator([dnn_builder("dnn", 1), dnn_builder("deep", 2)]),
        max_iteration_steps=8,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=lambda p: torch.optim.SGD(p, lr=0.05))],
        model_dir=str(tmp_path / "model"),
        log_every_steps=0,
        device="cpu",
    )
    defaults.update(kwargs)
    return Estimator(**defaults)


def _read(model_dir, name):
    with open(os.path.join(str(model_dir), name)) as f:
        return json.load(f)


def test_replay(tmp_path):
    """Replay reruns recorded choices without evaluation
    (reference: EstimatorReplayTest, estimator_test.py:3235)."""
    est = _make_estimator(tmp_path, max_iterations=2)
    est.train(linear_dataset(), max_steps=100)
    indices = _read(est.model_dir, "checkpoint.json")["replay_indices"]
    assert len(indices) == 2

    est2 = _make_estimator(
        tmp_path,
        model_dir=str(tmp_path / "replayed"),
        max_iterations=2,
        replay_config=replay.Config(best_ensemble_indices=indices),
    )
    est2.train(linear_dataset(), max_steps=100)
    assert _read(est2.model_dir, "checkpoint.json")["replay_indices"] == indices


def test_tpu_estimator_replays(tmp_path):
    """`TPUEstimator` passes `replay_config` through: a replayed windowed
    search takes the recorded winners."""
    est = _make_estimator(tmp_path, max_iterations=2)
    est.train(linear_dataset(), max_steps=100)
    indices = _read(est.model_dir, "checkpoint.json")["replay_indices"]
    flipped = [1 - i if i < 2 else i for i in indices]
    replayed = TPUEstimator(
        head=RegressionHead(), subnetwork_generator=SimpleGenerator([dnn_builder("dnn", 1), dnn_builder("deep", 2)]),
        max_iteration_steps=8, max_iterations=2, iterations_per_loop=4, log_every_steps=0, device="cpu",
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=lambda p: torch.optim.SGD(p, lr=0.05))],
        model_dir=str(tmp_path / "tpu"), replay_config=replay.Config(best_ensemble_indices=flipped),
    )
    replayed.train(linear_dataset(), max_steps=100)
    assert _read(replayed.model_dir, "checkpoint.json")["replay_indices"] == flipped
    assert _read(replayed.model_dir, replay.REPLAY_FILENAME)["best_ensemble_indices"] == flipped


def test_replay_config_save_load_round_trip(tmp_path):
    config = replay.Config(best_ensemble_indices=[0, 1, 1], architecture_hashes=["a" * 64, "b" * 64, "c" * 64])
    path = str(tmp_path / "replay.json")
    config.save(path)
    loaded = replay.Config.load(path)
    assert loaded.to_json() == config.to_json()
    assert loaded.get_best_ensemble_index(2) == 1
    assert loaded.get_best_ensemble_index(3) is None
    assert loaded.get_architecture_hash(1) == "b" * 64
    assert loaded.get_architecture_hash(7) is None
    # Hand-constructed configs (no hashes) still work everywhere.
    bare = replay.Config(best_ensemble_indices=[1])
    assert bare.get_architecture_hash(0) is None
    assert replay.Config.from_json(bare.to_json()).to_json() == bare.to_json()
    assert replay.load_partial(str(tmp_path / "missing")).to_json() == replay.Config().to_json()


def _adam(params):
    return torch.optim.Adam(params, lr=1e-3, eps=1e-8)


def _jax_estimator(model_dir):
    return adanet_tpu.Estimator(
        head=adanet_tpu.MultiClassHead(n_classes=10),
        subnetwork_generator=WithInitialVariables(
            jax_simple_dnn.Generator(optimizer_fn=lambda: optax.adam(1e-3), layer_size=16, initial_num_layers=1,
                                     seed=0),
            256, 10, convert=lambda v: v,
        ),
        max_iteration_steps=STEPS,
        max_iterations=2,
        ensemblers=[JaxEnsembler(optimizer=optax.adam(1e-3), use_fused_combine=True)],
        force_grow=True,
        model_dir=str(model_dir),
        log_every_steps=0,
    )


def _torch_estimator(model_dir, **kwargs):
    return Estimator(
        head=MultiClassHead(10),
        subnetwork_generator=WithInitialVariables(
            simple_dnn.Generator(optimizer_fn=_adam, layer_size=16, initial_num_layers=1, seed=0), 256, 10
        ),
        max_iteration_steps=STEPS,
        max_iterations=2,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=_adam, use_fused_combine=True)],
        force_grow=True,
        model_dir=str(model_dir),
        log_every_steps=0,
        device="cpu",
        **kwargs,
    )


def test_replay_record_written_each_iteration_as_jax(tmp_path):
    xtr, ytr = make_dataset(8 * 32, seed=7)
    want_est = _jax_estimator(tmp_path / "jax")
    want_est.train(input_fn(xtr, ytr, 32), max_steps=10**6)
    est = _torch_estimator(tmp_path / "torch")
    est.train(input_fn(xtr, ytr, 32), max_steps=STEPS)
    first = _read(tmp_path / "torch", replay.REPLAY_FILENAME)
    assert len(first["best_ensemble_indices"]) == len(first["architecture_hashes"]) == 1
    est.train(input_fn(xtr, ytr, 32), max_steps=10**6)
    got = _read(tmp_path / "torch", replay.REPLAY_FILENAME)
    want = _read(tmp_path / "jax", replay.REPLAY_FILENAME)
    assert got == want
    assert got["best_ensemble_indices"][:1] == first["best_ensemble_indices"]
    assert replay.Config.from_model_dir(str(tmp_path / "torch")).to_json() == got


def test_replayed_run_never_calls_its_evaluator(tmp_path):
    xtr, ytr = make_dataset(8 * 32, seed=7)
    xva, yva = make_dataset(64, seed=9)
    first = _torch_estimator(tmp_path / "first")
    first.train(input_fn(xtr, ytr, 32), max_steps=10**6)

    class Counting(Evaluator):
        calls = 0

        def evaluate(self, iteration, state):
            Counting.calls += 1
            return super().evaluate(iteration, state)

    replayed = _torch_estimator(
        tmp_path / "replayed", evaluator=Counting(input_fn(xva, yva, 32)),
        replay_config=replay.Config.from_model_dir(str(tmp_path / "first")),
    )
    replayed.train(input_fn(xtr, ytr, 32), max_steps=10**6)
    assert Counting.calls == 0
    for t in range(2):
        name = "architecture-%d.json" % t
        assert _read(tmp_path / "replayed", name) == _read(tmp_path / "first", name)
    assert _read(tmp_path / "replayed", replay.REPLAY_FILENAME) == _read(tmp_path / "first", replay.REPLAY_FILENAME)
    # The same Evaluator chooses when the record ends (no replay config).
    evaluated = _torch_estimator(tmp_path / "evaluated", evaluator=Counting(input_fn(xva, yva, 32)))
    evaluated.train(input_fn(xtr, ytr, 32), max_steps=10**6)
    assert Counting.calls == 2
