"""The port's AutoEnsemble and bagging against the JAX package's.

Copies of tests/test_autoensemble.py for the port, but
`test_bagging_under_round_robin` (RoundRobin placement is not ported):
the lifecycle, bare-module and callable pools, a bagged candidate's own
input_fn, prediction-only and `initial_variables` candidates (the
mismatch error too), and the transfer-learning tutorial at its smoke
size. Besides:

- a bagged search of both packages (a bagged MLP beside a plain linear
  model, no dropout) from the same variables (numpy, carried across by
  `utils.convert.convert_module`), uninterrupted and stopped inside the
  bagged iteration then resumed by a fresh Estimator: the same batches
  on both streams, the same architecture files, and `evaluate` within
  1e-4 x max(1, |value|);
- two candidates built from one module share no parameters, across
  iterations either, and the user's module is left as it was;
- the copy of tests/test_prefetch.py::
  test_bagging_prefetchers_closed_per_iteration, also checking that a
  bagged stream's prefetcher is closed when its iteration ends;
- a bagged builder's distillation teachers come from its own batch;
- a bagged iteration takes single steps under `iterations_per_loop`; a
  bagged batch is cast under the bf16 policy (its weight column kept
  out), and the recompute on the shared batch leaves the batch-norm
  statistics moved once a step;
- the training and eval steps run with cuDNN's TF32 off (and the
  matmul's), torch's settings restored afterwards;
- under RUN_SLOW, the copy of test_bagging_improves_accuracy.
"""

import json
import os
import time

import flax.linen as flax_nn
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

import adanet_tpu
from adanet_tpu import AutoEnsembleEstimator as JaxAutoEnsembleEstimator
from adanet_tpu import AutoEnsembleSubestimator as JaxSubestimator
from adanet_tpu.ensemble import ComplexityRegularizedEnsembler as JaxEnsembler

from adanet_tpu_torch import AutoEnsembleEstimator, AutoEnsembleSubestimator, AutoEnsembleTPUEstimator
from adanet_tpu_torch.core import iteration as iteration_lib
from adanet_tpu_torch.core.heads import MultiClassHead, RegressionHead
from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
from adanet_tpu_torch.utils import prefetch as prefetch_lib
from adanet_tpu_torch.utils.convert import convert_module

from torch_port_common import dnn_builder, linear_dataset, numpy_variables, one_torch_thread, variable_shapes

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)


def _sgd(lr):
    return lambda params: torch.optim.SGD(params, lr=lr)


class _Linear(nn.Module):
    def __init__(self, out=1, dim=2):
        super().__init__()
        self.dense = nn.Linear(dim, out)

    def forward(self, features, training=False):
        x = features["x"] if isinstance(features, dict) else features
        return self.dense(x.float())


class _MLP(nn.Module):
    def __init__(self, out=1, dim=2):
        super().__init__()
        self.hidden = nn.Linear(dim, 8)
        self.logits = nn.Linear(8, out)

    def forward(self, features, training=False):
        x = features["x"] if isinstance(features, dict) else features
        return self.logits(torch.relu(self.hidden(x.float())))


class _JaxLinear(flax_nn.Module):
    out: int = 1

    @flax_nn.compact
    def __call__(self, features, training: bool = False):
        return flax_nn.Dense(self.out)(jnp.asarray(features["x"], jnp.float32))


class _JaxMLP(flax_nn.Module):
    out: int = 1

    @flax_nn.compact
    def __call__(self, features, training: bool = False):
        x = flax_nn.relu(flax_nn.Dense(8)(jnp.asarray(features["x"], jnp.float32)))
        return flax_nn.Dense(self.out)(x)


def _estimator(tmp_path, pool, steps=8, iterations=1, **kwargs):
    return AutoEnsembleEstimator(
        head=RegressionHead(),
        candidate_pool=pool,
        max_iteration_steps=steps,
        max_iterations=iterations,
        model_dir=str(tmp_path / "model"),
        log_every_steps=0,
        device="cpu",
        **kwargs,
    )


def _architecture(model_dir, t=0):
    with open(os.path.join(str(model_dir), "architecture-%d.json" % t)) as f:
        return json.load(f)


def test_auto_ensemble_lifecycle(tmp_path):
    est = _estimator(
        tmp_path,
        {"linear": AutoEnsembleSubestimator(_Linear(), optimizer=_sgd(0.05)),
         "dnn": AutoEnsembleSubestimator(_MLP(), optimizer=_sgd(0.05))},
        iterations=2,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=_sgd(0.05))],
    )
    est.train(linear_dataset(), max_steps=100)
    assert est.latest_iteration_number() == 2
    metrics = est.evaluate(linear_dataset())
    assert np.isfinite(metrics["average_loss"])
    assert _architecture(est.model_dir)["subnetworks"][0]["builder_name"] in ("linear", "dnn")
    assert AutoEnsembleTPUEstimator is AutoEnsembleEstimator


def test_bare_module_pool_and_list(tmp_path):
    est = _estimator(tmp_path, [_Linear(), _MLP()], steps=4)
    est.train(linear_dataset(), max_steps=10)
    assert est.latest_iteration_number() == 1
    names = sorted(json.load(open(os.path.join(est.model_dir, "candidate-metrics-0.json"))))
    assert names == ["t0_candidate_0_grow_complexity_regularized", "t0_candidate_1_grow_complexity_regularized"]


def test_callable_pool_receives_iteration_number(tmp_path):
    calls = []

    def pool(iteration_number):
        calls.append(iteration_number)
        return {"linear": AutoEnsembleSubestimator(_Linear(), _sgd(0.05))}

    est = _estimator(tmp_path, pool, steps=4, iterations=2)
    est.train(linear_dataset(), max_steps=100)
    assert 0 in calls and 1 in calls


def test_bagging_per_candidate_input_fn(tmp_path):
    seen = {"count": 0}

    def bag_input_fn():
        seen["count"] += 1
        return linear_dataset(seed=7)()

    est = _estimator(
        tmp_path,
        {"bagged": AutoEnsembleSubestimator(_MLP(), optimizer=_sgd(0.05), train_input_fn=bag_input_fn),
         "plain": AutoEnsembleSubestimator(_Linear(), optimizer=_sgd(0.05))},
    )
    est.train(linear_dataset(), max_steps=8)
    assert seen["count"] >= 1  # the dedicated pipeline was consumed
    assert est.latest_iteration_number() == 1


def test_prediction_only_candidate_never_trains(tmp_path):
    est = _estimator(
        tmp_path,
        {"frozen": AutoEnsembleSubestimator(_Linear(), prediction_only=True),
         "trained": AutoEnsembleSubestimator(_Linear(), optimizer=_sgd(0.1))},
        steps=12,
    )
    est.train(linear_dataset(), max_steps=12)
    # The trained candidate must win: the frozen one keeps its random init.
    assert _architecture(est.model_dir)["subnetworks"][0]["builder_name"] == "trained"


def _probe_subnetwork_params(est, input_fn, max_steps):
    """Trains `est` and captures every candidate's parameters (and the
    state) at each iteration's completion."""
    probes, states = {}, []

    class ProbeEstimator(type(est)):
        def _complete_iteration(self, iteration, state, *args, **kwargs):
            states.append(state)
            for name, st in state.subnetworks.items():
                for key, value in st.module.state_dict().items():
                    probes["%s/%s" % (name, key)] = value.detach().clone()
            return super()._complete_iteration(iteration, state, *args, **kwargs)

    est.__class__ = ProbeEstimator
    est.train(input_fn, max_steps=max_steps)
    return probes, states


def test_initial_variables_transfer(tmp_path):
    module = _MLP()
    pretrained = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(99)) for k, v in
                  module.state_dict().items()}
    est = _estimator(
        tmp_path,
        {"frozen": AutoEnsembleSubestimator(module, prediction_only=True, initial_variables=pretrained),
         "finetune": AutoEnsembleSubestimator(module, optimizer=_sgd(0.05), initial_variables=pretrained)},
    )
    probes, _ = _probe_subnetwork_params(est, linear_dataset(), 8)
    for key, value in pretrained.items():
        # Frozen: grafted weights verbatim, never updated.
        assert torch.equal(probes["frozen/inner.%s" % key], value)
    # Fine-tuned: started from the same weights but trained away.
    assert any(not torch.equal(probes["finetune/inner.%s" % key], value) for key, value in pretrained.items())

    bad = AutoEnsembleEstimator(
        head=RegressionHead(),
        candidate_pool={"bad": AutoEnsembleSubestimator(_Linear(), prediction_only=True,
                                                        initial_variables=pretrained)},
        max_iteration_steps=4, max_iterations=1, model_dir=str(tmp_path / "bad"), log_every_steps=0, device="cpu",
    )
    with pytest.raises(ValueError, match="initial_variables"):
        bad.train(linear_dataset(), max_steps=4)


def test_candidates_from_one_module_share_no_parameters(tmp_path):
    module = _MLP()
    before = {k: v.clone() for k, v in module.state_dict().items()}
    est = _estimator(
        tmp_path,
        {"a": AutoEnsembleSubestimator(module, optimizer=_sgd(0.05)),
         "b": AutoEnsembleSubestimator(module, optimizer=_sgd(0.1))},
        iterations=2,
    )
    probes, states = _probe_subnetwork_params(est, linear_dataset(), 100)
    pointers = [p.data_ptr() for state in states for st in state.subnetworks.values() for p in st.module.parameters()]
    pointers += [p.data_ptr() for state in states for frozen in state.frozen for p in frozen.parameters()]
    assert len(pointers) == len(set(pointers)) == 2 * 2 * 4 + 4
    assert not torch.equal(probes["a/inner.hidden.weight"], probes["b/inner.hidden.weight"])
    for key, value in module.state_dict().items():
        assert torch.equal(value, before[key])


def _jax_pool(variables, bagged_fn):
    return {
        "bagged": JaxSubestimator(_JaxMLP(), optimizer=optax.sgd(0.05), train_input_fn=bagged_fn,
                                  initial_variables=variables["bagged"]),
        "plain": JaxSubestimator(_JaxLinear(), optimizer=optax.sgd(0.05), initial_variables=variables["plain"]),
    }


def _torch_pool(variables, bagged_fn):
    return {
        "bagged": AutoEnsembleSubestimator(_MLP(), optimizer=_sgd(0.05), train_input_fn=bagged_fn,
                                           initial_variables=convert_module(variables["bagged"], _MLP())),
        "plain": AutoEnsembleSubestimator(_Linear(), optimizer=_sgd(0.05),
                                          initial_variables=convert_module(variables["plain"], _Linear())),
    }


def _logged(input_fn, log, tag):
    def fn():
        for i, batch in enumerate(input_fn()):
            log.append((tag, i))
            yield batch

    return fn


@pytest.mark.parametrize("stop", [None, 5])
def test_bagged_search_matches_jax(tmp_path, stop):
    """Both packages from the same variables over 2 iterations x 8 steps;
    with `stop`, training stops at that global step (inside the bagged
    iteration 0) and a fresh Estimator resumes it: both packages then
    open every stream afresh."""
    sample = {"x": np.zeros((2, 2), np.float32)}
    variables = {
        "bagged": numpy_variables(variable_shapes(_JaxMLP(), sample), seed=1),
        "plain": numpy_variables(variable_shapes(_JaxLinear(), sample), seed=2),
    }
    runs = {}
    for package in ("jax", "torch"):
        log = []
        bagged_fn = _logged(linear_dataset(seed=7), log, "bag")
        shared_fn = _logged(linear_dataset(), log, "shared")

        def make():
            if package == "jax":
                return JaxAutoEnsembleEstimator(
                    head=adanet_tpu.RegressionHead(), candidate_pool=_jax_pool(variables, bagged_fn),
                    max_iteration_steps=8, max_iterations=2,
                    ensemblers=[JaxEnsembler(optimizer=optax.sgd(0.05), use_fused_combine=True)],
                    model_dir=str(tmp_path / package), log_every_steps=0,
                )
            return AutoEnsembleEstimator(
                head=RegressionHead(), candidate_pool=_torch_pool(variables, bagged_fn),
                max_iteration_steps=8, max_iterations=2,
                ensemblers=[ComplexityRegularizedEnsembler(optimizer=_sgd(0.05), use_fused_combine=True)],
                model_dir=str(tmp_path / package), log_every_steps=0, device="cpu",
            )

        if stop is not None:
            make().train(shared_fn, max_steps=stop)
        est = make()
        est.train(shared_fn, max_steps=100)
        runs[package] = (log, est.evaluate(linear_dataset()))
    (jax_log, want), (torch_log, got) = runs["jax"], runs["torch"]
    assert torch_log == jax_log
    if stop is not None:
        # One pull of each stream a step; the resumed run opens both
        # streams afresh.
        assert torch_log[2 * stop:2 * stop + 2] == [("shared", 0), ("bag", 0)]
    for t in range(2):
        assert _architecture(tmp_path / "torch", t) == _architecture(tmp_path / "jax", t)
    assert got["best_ensemble"] == want["best_ensemble"]
    for key in ("average_loss", "loss"):
        assert abs(got[key] - want[key]) <= 1e-4 * max(1.0, abs(want[key])), (key, got[key], want[key])


def test_bagging_prefetchers_closed_per_iteration(tmp_path, monkeypatch):
    created = []

    class Recording(prefetch_lib.PrefetchIterator):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            created.append(self)

    monkeypatch.setattr(prefetch_lib, "PrefetchIterator", Recording)
    open_at_completion = []

    class Probe(AutoEnsembleEstimator):
        def _complete_iteration(self, *args, **kwargs):
            open_at_completion.append(len(self._open_prefetchers))
            return super()._complete_iteration(*args, **kwargs)

    est = Probe(
        head=RegressionHead(),
        candidate_pool={
            "bagged": AutoEnsembleSubestimator(_Linear(), optimizer=_sgd(0.05),
                                               train_input_fn=lambda: linear_dataset(seed=7)()),
            "plain": AutoEnsembleSubestimator(_Linear(), optimizer=_sgd(0.05)),
        },
        max_iteration_steps=6, max_iterations=2, model_dir=str(tmp_path / "model"), log_every_steps=0,
        prefetch_buffer=2, device="cpu",
    )
    est.train(linear_dataset(), max_steps=100)
    assert est.latest_iteration_number() == 2
    # The shared stream + one bagging stream per iteration (re-invoked on
    # exhaustion) all went through the prefetcher...
    assert len(created) >= 3
    # ...each iteration's bagged stream was closed before the iteration
    # completed (only the shared stream's stays open)...
    assert open_at_completion == [1, 1]
    # ...and none left a live worker behind.
    deadline = time.time() + 5.0
    while time.time() < deadline and any(it._thread.is_alive() for it in created):
        time.sleep(0.05)
    assert not any(it._thread.is_alive() for it in created)
    assert not est._open_prefetchers


def test_bagged_iteration_takes_single_steps(tmp_path, monkeypatch):
    windows, steps = [], []
    monkeypatch.setattr(iteration_lib.Iteration, "train_steps",
                        lambda self, state, batches: windows.append(len(batches)) or (state, {}))
    train_step = iteration_lib.Iteration.train_step

    def one(self, state, batch, extra_batches=None):
        steps.append(sorted(extra_batches or {}))
        return train_step(self, state, batch, extra_batches)

    monkeypatch.setattr(iteration_lib.Iteration, "train_step", one)
    est = _estimator(
        tmp_path,
        {"bagged": AutoEnsembleSubestimator(_Linear(), optimizer=_sgd(0.05),
                                            train_input_fn=linear_dataset(seed=7)),
         "plain": AutoEnsembleSubestimator(_Linear(), optimizer=_sgd(0.05))},
        iterations_per_loop=4,
    )
    est.train(linear_dataset(), max_steps=8)
    assert windows == [] and steps == [["bagged"]] * 8


class _NormProbe(nn.Module):
    """A batch-normed MLP recording the features its forwards see."""

    seen = []

    def __init__(self):
        super().__init__()
        self.hidden = nn.Linear(2, 4)
        self.norm = nn.BatchNorm1d(4)
        self.logits = nn.Linear(4, 1)

    def forward(self, features, training=False):
        _NormProbe.seen.append((training, sorted(features), features["x"].dtype, float(features["x"][0, 0])))
        return self.logits(self.norm(self.hidden(features["x"].float())))


def test_bagged_step_casts_its_batch_and_moves_statistics_once(tmp_path):
    """Under the bf16 policy the bagged batch is cast like the shared one
    (the weight column split out first, never reaching the module); the
    bagged subnetwork trains on its own batch, its ensemble-facing output
    is recomputed on the shared batch, and its batch-norm statistics move
    once a step (the recompute's moves are put back)."""
    _NormProbe.seen.clear()
    shared = [({"x": f["x"], "w": np.ones(len(y), np.float32)}, y) for f, y in linear_dataset()()]
    bagged = [({"x": f["x"], "w": np.ones(len(y), np.float32)}, y) for f, y in linear_dataset(seed=7)()]
    est = _estimator(tmp_path, {"bagged": AutoEnsembleSubestimator(_NormProbe(), optimizer=_sgd(0.05),
                                                                   train_input_fn=lambda: iter(bagged))},
                     steps=3, step_compute_dtype="bfloat16", weight_key="w")
    probes, _ = _probe_subnetwork_params(est, lambda: iter(shared), 3)
    assert int(probes["bagged/inner.norm.num_batches_tracked"]) == 3
    training = [entry for entry in _NormProbe.seen if entry[0]]
    # Per step: the training forward on the bagged batch, then the
    # recompute on the shared batch; all of them in bf16 without "w".
    assert [entry[1:3] for entry in training] == [(["x"], torch.bfloat16)] * 6
    own = [float(torch.tensor(b[0]["x"][0, 0]).bfloat16()) for b in bagged[:3]]
    common = [float(torch.tensor(b[0]["x"][0, 0]).bfloat16()) for b in shared[:3]]
    assert [entry[3] for entry in training] == [v for pair in zip(own, common) for v in pair]


def test_bagged_teachers_come_from_its_own_batch(tmp_path):
    """A bagged builder's distillation teachers are recomputed from the
    frozen members on its own batch (8 rows here; the shared one has
    16), as in the JAX step."""
    from adanet_tpu_torch.core.estimator import Estimator
    from adanet_tpu_torch.subnetwork.generator import SimpleGenerator

    rows = []

    def teacher_rows(builder):
        def loss(subnetwork, labels, head, context):
            if context is not None:
                rows.append((builder.name, context.previous_ensemble_logits.shape[0],
                             context.previous_subnetwork_logits.shape[0], subnetwork.logits.shape[0]))
            return None

        builder.build_subnetwork_loss = loss
        return builder

    bagged = teacher_rows(dnn_builder("bagged"))
    bagged.train_input_fn = linear_dataset(batch_size=8, seed=7)
    est = Estimator(RegressionHead(), SimpleGenerator([bagged, teacher_rows(dnn_builder("plain"))]),
                    max_iteration_steps=2, max_iterations=2, model_dir=str(tmp_path / "model"),
                    log_every_steps=0, device="cpu")
    est.train(linear_dataset(), max_steps=100)
    assert sorted(set(rows)) == [("bagged", 8, 8, 8), ("plain", 16, 16, 16)]


class _FlagProbe(_Linear):
    """Records the TF32 flags its forward runs under."""

    seen = []

    def forward(self, features, training=False):
        _FlagProbe.seen.append((training, torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return super().forward(features, training)


def test_steps_run_f32_convolutions_without_tf32(tmp_path):
    """Inside the training and eval steps cuDNN's TF32 is off as well as
    the matmul's (an f32 convolution of a user module is then f32, as an
    f32 Dense already was); torch's settings are put back afterwards."""
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, True
    try:
        _FlagProbe.seen.clear()
        est = _estimator(tmp_path, {"probe": AutoEnsembleSubestimator(_FlagProbe(), optimizer=_sgd(0.05))}, steps=2)
        est.train(linear_dataset(), max_steps=2)
        est.evaluate(linear_dataset())
        assert {training for training, _, _ in _FlagProbe.seen} == {True, False}
        assert {(cudnn, matmul) for _, cudnn, matmul in _FlagProbe.seen} == {(False, False)}
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def test_transfer_learning_tutorial_smoke(tmp_path):
    """The transfer-learning tutorial runs end to end on tiny settings
    and the frozen pretrained module lifts accuracy above chance."""
    from adanet_tpu_torch.examples.tutorials import transfer_learning

    metrics = transfer_learning.main([
        "--pretrain_steps=60", "--search_steps=40", "--iterations=1",
        "--model_dir=%s" % (tmp_path / "model"), "--device=cpu",
    ])
    assert metrics["accuracy"] > 0.3


@pytest.mark.slow
def test_bagging_improves_accuracy(tmp_path):
    """The copy of tests/test_autoensemble.py::test_bagging_improves_accuracy:
    an AllStrategy mean ensemble of three bootstrap-bagged MLPs on noisy
    digits beats the best single bagged member trained identically."""
    from adanet_tpu_torch.ensemble.mean import MeanEnsembler
    from adanet_tpu_torch.ensemble.strategy import AllStrategy
    from adanet_tpu_torch.examples.synthetic_digits import make_dataset

    xtr, ytr = make_dataset(2048, seed=3)
    xte, yte = make_dataset(1024, seed=4)
    noise_rng = np.random.RandomState(0)
    flip = noise_rng.rand(len(ytr)) < 0.25  # label noise -> variance
    ytr = np.where(flip, noise_rng.randint(0, 10, size=len(ytr)), ytr)
    xtr = xtr.reshape(len(xtr), -1).astype(np.float32)
    xte = xte.reshape(len(xte), -1).astype(np.float32)

    def stream(x, y, seed, batch=64):
        def input_fn():
            rng = np.random.RandomState(seed)
            idx = rng.randint(0, len(x), size=len(x))  # bootstrap resample
            for start in range(0, len(idx) - batch + 1, batch):
                take = idx[start:start + batch]
                yield {"x": x[take]}, y[take]

        return input_fn

    def eval_stream(batch=64):
        def input_fn():
            for start in range(0, len(xte) - batch + 1, batch):
                yield {"x": xte[start:start + batch]}, yte[start:start + batch]

        return input_fn

    def make_members(prefix):
        return {
            "%s_%d" % (prefix, k): AutoEnsembleSubestimator(
                _MLP(out=10, dim=256),
                optimizer=lambda params: torch.optim.Adam(params, lr=2e-3),
                train_input_fn=stream(xtr, ytr, seed=100 + k),
            )
            for k in range(3)
        }

    def run(pool, model_dir):
        est = AutoEnsembleEstimator(
            head=MultiClassHead(n_classes=10), candidate_pool=pool, ensemblers=[MeanEnsembler()],
            ensemble_strategies=[AllStrategy()], max_iteration_steps=150, max_iterations=1,
            model_dir=model_dir, log_every_steps=0, device="cpu",
        )
        est.train(stream(xtr, ytr, seed=9), max_steps=150)
        return est.evaluate(eval_stream())

    bagged = run(make_members("bag"), str(tmp_path / "bagged"))
    singles = [run({name: sub}, str(tmp_path / ("single_%s" % name))) for name, sub in make_members("bag").items()]
    best_single = max(s["accuracy"] for s in singles)
    assert bagged["accuracy"] >= best_single, (bagged["accuracy"], [s["accuracy"] for s in singles])
