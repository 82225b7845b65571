"""The port's `Estimator` against the JAX package's, and its gate.

- A search of both packages from the same `initial_variables` (numpy,
  `utils.convert.convert_simple_dnn` for the port) on the same input_fn:
  2 iterations x 25 steps, fused combine on, with and without
  force_grow. The batches each pulls (input_fn re-invoked at its end)
  are the same sequence; `architecture-<t>.json` are equal as parsed
  JSON; `evaluate` agrees within atol 1e-4 x max(1, |value|).
- The torch copy of tests/test_convergence.py::
  test_search_beats_linear_baseline at the gate's configuration, on the
  CPU: accuracy >= 0.88 and above the linear baseline (0.76), with the
  fused combine off (the gate's) and on.
- train() stops where max_steps says, inside an iteration or at its
  end, and a later train() call goes on from there; the frozen payload
  (read through `checkpoint.restore_payload`) holds the winner's
  numbers; evaluate needs a trained model and a batch.
"""

import json
import os

import numpy as np
import optax
import pytest
import torch

import adanet_tpu
from adanet_tpu.ensemble import ComplexityRegularizedEnsembler as JaxEnsembler
from adanet_tpu.examples import simple_dnn as jax_simple_dnn

from adanet_tpu_torch.core import checkpoint
from adanet_tpu_torch.core.estimator import Estimator
from adanet_tpu_torch.core.heads import MultiClassHead
from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
from adanet_tpu_torch.examples import simple_dnn
from adanet_tpu_torch.examples.synthetic_digits import input_fn, make_dataset
from adanet_tpu_torch.utils.convert import WithInitialVariables

from torch_port_common import one_torch_thread

LINEAR_BASELINE_ACCURACY = 0.76  # tests/test_convergence.py
STEPS = 25


_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)


def _adam(params):
    return torch.optim.Adam(params, lr=1e-3, eps=1e-8)


def _logged_input_fn(x, y, log, batch_size=32):
    """input_fn over (x, y) that records the index of every batch it yields."""

    def fn():
        for i, start in enumerate(range(0, len(x), batch_size)):
            log.append(i)
            yield {"x": x[start:start + batch_size]}, y[start:start + batch_size]

    return fn


def _torch_estimator(model_dir, fused=True, force_grow=False, layer_size=16, steps=STEPS, initial=True, **kwargs):
    generator = simple_dnn.Generator(optimizer_fn=_adam, layer_size=layer_size, initial_num_layers=1, seed=0)
    if initial:
        generator = WithInitialVariables(generator, 256, 10)
    return Estimator(
        head=MultiClassHead(10),
        subnetwork_generator=generator,
        max_iteration_steps=steps,
        max_iterations=2,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=_adam, use_fused_combine=fused)],
        force_grow=force_grow,
        model_dir=str(model_dir),
        log_every_steps=0,
        device="cpu",
        **kwargs,
    )


def _architectures(model_dir):
    out = []
    for t in range(2):
        with open(os.path.join(str(model_dir), "architecture-%d.json" % t)) as f:
            out.append(json.load(f))
    return out


@pytest.mark.parametrize("force_grow", [False, True])
def test_search_matches_jax(tmp_path, force_grow):
    xtr, ytr = make_dataset(8 * 32, seed=7)  # 8 batches: the stream wraps every 8 steps
    xte, yte = make_dataset(256, seed=8)
    jax_log, torch_log = [], []
    want_est = adanet_tpu.Estimator(
        head=adanet_tpu.MultiClassHead(n_classes=10),
        subnetwork_generator=WithInitialVariables(
            jax_simple_dnn.Generator(optimizer_fn=lambda: optax.adam(1e-3), layer_size=16, initial_num_layers=1,
                                     seed=0),
            256, 10, convert=lambda v: v,
        ),
        max_iteration_steps=STEPS,
        max_iterations=2,
        ensemblers=[JaxEnsembler(optimizer=optax.adam(1e-3), use_fused_combine=True)],
        force_grow=force_grow,
        model_dir=str(tmp_path / "jax"),
        log_every_steps=0,
    )
    want_est.train(_logged_input_fn(xtr, ytr, jax_log), max_steps=10**6)
    want = want_est.evaluate(input_fn(xte, yte, 32))
    got_est = _torch_estimator(tmp_path / "torch", force_grow=force_grow)
    got_est.train(_logged_input_fn(xtr, ytr, torch_log), max_steps=10**6)
    got = got_est.evaluate(input_fn(xte, yte, 32))

    # One batch a step (an iteration's sizing batch is its first step's),
    # input_fn called again after every 8.
    assert torch_log == jax_log == [i % 8 for i in range(2 * STEPS)]
    assert _architectures(tmp_path / "torch") == _architectures(tmp_path / "jax")
    assert got["best_ensemble"] == want["best_ensemble"]
    assert got["global_step"] == want["global_step"] == 2 * STEPS
    assert got_est.latest_iteration_number() == want_est.latest_iteration_number() == 2
    for key in ("accuracy", "average_loss", "loss", "top_5_accuracy"):
        assert abs(got[key] - want[key]) <= 1e-4 * max(1.0, abs(want[key])), (key, got[key], want[key])


@pytest.mark.parametrize("fused", [False, True])
def test_search_beats_linear_baseline(tmp_path, fused):
    """The torch copy of the tier-1 gate, at its configuration: 4096
    training and 1024 test digits, batch 128, simple_dnn (adam 1e-3,
    128 wide, from one layer), the ensembler's weights by adam 1e-3,
    2 iterations x 400 steps."""
    xtr, ytr = make_dataset(4096, seed=7)
    xte, yte = make_dataset(1024, seed=8)
    est = _torch_estimator(tmp_path / "model", fused=fused, layer_size=128, steps=400, initial=False)
    est.train(input_fn(xtr, ytr), max_steps=10**6)
    metrics = est.evaluate(input_fn(xte, yte))
    assert metrics["accuracy"] >= 0.88, metrics
    assert metrics["accuracy"] > LINEAR_BASELINE_ACCURACY
    assert metrics["global_step"] == 800
    assert os.path.exists(tmp_path / "model" / "architecture-1.json")


def test_train_in_whole_iterations_across_calls(tmp_path):
    xtr, ytr = make_dataset(8 * 32, seed=7)
    xte, yte = make_dataset(128, seed=8)
    whole = _torch_estimator(tmp_path / "whole")
    whole.train(input_fn(xtr, ytr, 32), max_steps=2 * STEPS)
    parts = _torch_estimator(tmp_path / "parts")
    parts.train(input_fn(xtr, ytr, 32), max_steps=STEPS)
    assert (parts.latest_global_step(), parts.latest_iteration_number()) == (STEPS, 1)
    first = parts.evaluate(input_fn(xte, yte, 32))
    assert first["global_step"] == STEPS and first["best_ensemble"].startswith("t0_")
    parts.train(input_fn(xtr, ytr, 32), steps=STEPS - 7)
    assert (parts.latest_global_step(), parts.latest_iteration_number()) == (2 * STEPS - 7, 1)
    assert checkpoint.read_manifest(str(tmp_path / "parts")).iteration_state_file == "ckpt-%d.pt" % (2 * STEPS - 7)
    parts.train(input_fn(xtr, ytr, 32), steps=7)
    assert parts.latest_global_step() == 2 * STEPS and parts.latest_iteration_number() == 2
    assert _architectures(tmp_path / "parts")[0] == _architectures(tmp_path / "whole")[0]
    # Past max_iterations there is nothing left to train, whatever the steps.
    assert parts.train(input_fn(xtr, ytr, 32), steps=5).latest_global_step() == 2 * STEPS


def test_frozen_payload_and_evaluate_guards(tmp_path):
    xtr, ytr = make_dataset(4 * 32, seed=7)
    est = _torch_estimator(tmp_path / "m", steps=4)
    with pytest.raises(ValueError, match="train"):
        est.evaluate(input_fn(xtr, ytr, 32))
    with pytest.raises(ValueError, match="no batches"):
        _torch_estimator(tmp_path / "m", steps=4).train(input_fn(xtr, ytr, 32), max_steps=4).evaluate(lambda: iter(()))
    with pytest.raises(ValueError, match="at most one"):
        est.train(input_fn(xtr, ytr, 32), max_steps=3, steps=3)
    captured = []
    complete = est._complete_iteration

    def capture(*args):
        captured.append(complete(*args))
        return captured[-1]

    est._complete_iteration = capture
    est.train(input_fn(xtr, ytr, 32))
    payload = checkpoint.restore_payload(str(tmp_path / "m"), "frozen-1.pt")
    frozen = captured[-1]
    assert payload["name"] == frozen.name
    assert len(payload["members"]) == len(frozen.weighted_subnetworks)
    for entry, ws in zip(payload["members"], frozen.weighted_subnetworks):
        assert entry["complexity"] == ws.subnetwork.complexity
        assert entry["shared"] == {"value": ws.subnetwork.shared}
        assert torch.equal(entry["weight"]["value"], ws.weight)
        for key, value in ws.subnetwork.module.state_dict().items():
            assert torch.equal(entry["params"][key], value)
    assert payload["final_ema"]["value"] == frozen.final_ema
    assert np.isfinite(frozen.final_ema)
    one = est.evaluate(input_fn(xtr, ytr, 32), steps=1)
    assert set(one) >= {"accuracy", "loss", "average_loss", "top_5_accuracy", "best_ensemble", "global_step"}


def test_constructor_rejects_bad_arguments(tmp_path):
    with pytest.raises(ValueError, match="max_iteration_steps"):
        _torch_estimator(tmp_path, steps=0)


def test_data_pull_transient_reopens_pipeline(tmp_path):
    """As tests/test_robustness.py holds the JAX Estimator: a transient
    data-source fault re-opens the pipeline, a persistent one surfaces."""
    from adanet_tpu_torch.robustness import faults

    xtr, ytr = make_dataset(4 * 32, seed=7)
    est = _torch_estimator(tmp_path / "m", steps=4)
    try:
        faults.arm("data.pull", "transient", count=2)
        batch, data_iter = est._next_batch(input_fn(xtr, ytr, 32), None)
        assert batch is not None and data_iter is not None
        assert faults.armed()["data.pull"].trips == 2
        faults.arm("data.pull", "error", count=1)
        with pytest.raises(faults.InjectedFault):
            est._next_batch(input_fn(xtr, ytr, 32), data_iter)
    finally:
        faults.disarm()


class _SummarizingBuilder(simple_dnn._DNNBuilder):
    def build_subnetwork_summaries(self, subnetwork, features, labels):
        return {"mean_logit": subnetwork.logits.mean(), "logits": subnetwork.logits}


class _SummarizingGenerator(simple_dnn.Generator):
    def generate_candidates(self, *args, **kwargs):
        return [_SummarizingBuilder(_adam, 8, b._num_layers, False, 0.0, 0)
                for b in super().generate_candidates(*args, **kwargs)]


def test_train_summaries_are_written_at_the_log_cadence(tmp_path):
    xtr, ytr = make_dataset(4 * 32, seed=7)
    est = Estimator(
        head=MultiClassHead(10), subnetwork_generator=_SummarizingGenerator(initial_num_layers=1),
        max_iteration_steps=4, max_iterations=1,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=_adam, use_fused_combine=True)],
        model_dir=str(tmp_path), log_every_steps=2, device="cpu",
    )
    est.train(input_fn(xtr, ytr, 32))
    for scope in ("ensemble/t0_1_layer_dnn_grow_complexity_regularized", "subnetwork/t0_1_layer_dnn",
                  "subnetwork/t0_2_layer_dnn"):
        files = os.listdir(tmp_path / scope)
        assert files and all(os.path.getsize(tmp_path / scope / f) > 0 for f in files), scope
