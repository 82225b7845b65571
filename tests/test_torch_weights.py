"""Example weights (`weight_key`) through the port: copies of
tests/test_weights.py but its RoundRobin test.

The weight column is split out of the features (the models never see
it) and weights every loss and metric: the subnetworks' and the mixture
weights' training losses, the eval step and with it the Evaluator's
scores, and `evaluate`, whose batches combine by total example weight.
`split_example_weights` and `batch_metric_weight` are also held against
the JAX functions. Tolerances are the JAX tests' own: unit weights
against none abs 1e-6; the eval step against a numpy oracle rel 1e-4;
cross-batch aggregation abs 5e-3 (accuracy) and rel 2e-2 (loss).
"""

import numpy as np
import pytest
import torch

from adanet_tpu.core.iteration import split_example_weights as jax_split
from adanet_tpu.utils import batches as jax_batches

from adanet_tpu_torch.core.estimator import Estimator
from adanet_tpu_torch.core.evaluator import Evaluator
from adanet_tpu_torch.core.heads import BinaryClassificationHead
from adanet_tpu_torch.core.iteration import IterationBuilder, split_example_weights
from adanet_tpu_torch.ensemble import ComplexityRegularizedEnsembler, GrowStrategy
from adanet_tpu_torch.subnetwork.generator import SimpleGenerator
from adanet_tpu_torch.utils.batches import batch_metric_weight

from torch_port_common import dnn_builder, one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)


def _sgd(lr):
    return lambda params: torch.optim.SGD(params, lr=lr)


def _poisoned_dataset(n=64, dim=4, batch_size=16, seed=7, with_weights=True):
    """Every clean example twice: with its true label at weight 1 and with
    the flipped label at weight 0."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, dim).astype(np.float32)
    w_true = np.linspace(-1.0, 1.5, dim).astype(np.float32)
    y = (x @ w_true[:, None] > 0).astype(np.float32)
    xs = np.concatenate([x, x], axis=0)
    ys = np.concatenate([y, 1.0 - y], axis=0)
    weights = np.concatenate([np.ones((n, 1)), np.zeros((n, 1))], axis=0).astype(np.float32)
    order = rng.permutation(2 * n)
    xs, ys, weights = xs[order], ys[order], weights[order]

    def input_fn():
        for start in range(0, 2 * n, batch_size):
            feats = {"x": xs[start:start + batch_size]}
            if with_weights:
                feats["w"] = weights[start:start + batch_size]
            yield feats, ys[start:start + batch_size]

    def clean_eval_fn():
        for start in range(0, n, batch_size):
            feats = {"x": x[start:start + batch_size]}
            if with_weights:
                feats["w"] = np.ones((batch_size, 1), np.float32)
            yield feats, y[start:start + batch_size]

    return input_fn, clean_eval_fn


def _make_estimator(tmp_path, name, **kwargs):
    defaults = dict(
        head=BinaryClassificationHead(),
        subnetwork_generator=SimpleGenerator([dnn_builder("dnn", 1, learning_rate=0.2)]),
        max_iteration_steps=60,
        max_iterations=1,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=_sgd(0.05))],
        model_dir=str(tmp_path / name),
        log_every_steps=0,
        device="cpu",
    )
    defaults.update(kwargs)
    return Estimator(**defaults)


def test_split_example_weights():
    feats = {"x": np.ones((4, 2)), "w": np.arange(4.0)}
    model_feats, w = split_example_weights(feats, "w")
    assert set(model_feats) == {"x"}
    np.testing.assert_array_equal(np.asarray(w), np.arange(4.0))
    same, none = split_example_weights(feats, None)
    assert same is feats and none is None
    with pytest.raises(ValueError, match="weight_key"):
        split_example_weights({"x": np.ones(2)}, "w")
    with pytest.raises(ValueError, match="not a mapping"):
        split_example_weights(np.ones(2), "w")
    kept, none = split_example_weights({"x": np.ones(2)}, "w", require=False)
    assert none is None and set(kept) == {"x"}
    # The JAX function's results on the same inputs.
    for args in ((feats, "w"), (feats, None), ({"x": np.ones(2)}, "w", False)):
        got, want = split_example_weights(*args), jax_split(*args)
        assert (got[1] is None) == (want[1] is None)
        assert sorted(got[0]) == sorted(want[0])


def test_batch_metric_weight_matches_jax():
    w = np.random.RandomState(1).uniform(0.5, 1.5, (16, 1)).astype(np.float32)
    batch = ({"x": np.zeros((16, 3), np.float32), "w": w}, np.zeros((16,), np.float32))
    for key in (None, "w", "missing"):
        assert batch_metric_weight(batch, key) == jax_batches.batch_metric_weight(batch, key)
    torch_batch = ({"x": torch.zeros(16, 3), "w": torch.from_numpy(w)}, torch.zeros(16))
    assert batch_metric_weight(torch_batch, "w") == pytest.approx(float(w.sum()), rel=1e-6)


def test_unit_weights_match_unweighted(tmp_path):
    """All-ones weights reproduce the unweighted run."""
    train_p, eval_p = _poisoned_dataset(with_weights=False)
    _, eval_w = _poisoned_dataset(with_weights=True)

    def unit_weight_fn():
        for feats, labels in train_p():
            yield dict(feats, w=np.ones_like(labels)), labels

    est_w = _make_estimator(tmp_path, "weighted", weight_key="w")
    est_w.train(unit_weight_fn, max_steps=60)
    est_p = _make_estimator(tmp_path, "plain")
    est_p.train(train_p, max_steps=60)
    m_w = est_w.evaluate(eval_w)
    m_p = est_p.evaluate(eval_p)
    assert m_w["average_loss"] == pytest.approx(m_p["average_loss"], abs=1e-6)
    assert m_w["accuracy"] == pytest.approx(m_p["accuracy"], abs=1e-6)


def test_weights_shift_training(tmp_path):
    """Zero-weighting the flipped duplicates recovers the clean boundary;
    ignoring the weights cannot."""
    train_fn, clean_eval_fn = _poisoned_dataset()
    est = _make_estimator(tmp_path, "weighted", weight_key="w")
    est.train(train_fn, max_steps=60)
    weighted = est.evaluate(clean_eval_fn)
    train_plain, eval_plain = _poisoned_dataset(with_weights=False)
    est_plain = _make_estimator(tmp_path, "plain")
    est_plain.train(train_plain, max_steps=60)
    unweighted = est_plain.evaluate(eval_plain)
    assert weighted["accuracy"] >= 0.9
    assert unweighted["accuracy"] <= 0.75
    assert weighted["accuracy"] > unweighted["accuracy"] + 0.1


def test_missing_weight_column_raises(tmp_path):
    est = _make_estimator(tmp_path, "missing", weight_key="w")
    train_plain, _ = _poisoned_dataset(with_weights=False)
    with pytest.raises(ValueError, match="weight_key"):
        est.train(train_plain, max_steps=4)


def test_eval_step_and_evaluator_use_weights():
    """The eval step's loss is the weighted per-example cross-entropy of a
    numpy oracle, and the Evaluator's score is that loss."""
    head = BinaryClassificationHead()
    builder = IterationBuilder(head, [ComplexityRegularizedEnsembler()], [GrowStrategy()], weight_key="w",
                               device="cpu")
    iteration = builder.build_iteration(0, [dnn_builder("dnn", 1)], input_shape=(3,))
    rng = np.random.RandomState(0)
    x = rng.randn(16, 3).astype(np.float32)
    y = (rng.rand(16, 1) > 0.5).astype(np.float32)
    w = rng.rand(16, 1).astype(np.float32)
    batch = ({"x": x, "w": w}, y)
    state = iteration.init_state(torch.Generator().manual_seed(0), batch)
    results = iteration.eval_step(state, batch)
    name = iteration.candidate_names()[0]
    logits = iteration.candidate_forward(state, name, {"x": torch.from_numpy(x)}).logits.numpy()
    per_example = -(y * np.log(1.0 / (1.0 + np.exp(-logits)))
                    + (1.0 - y) * np.log(1.0 - 1.0 / (1.0 + np.exp(-logits))))
    expected = float((per_example * w).sum() / w.sum())
    assert float(results[name]["loss"]) == pytest.approx(expected, rel=1e-4)
    scores = Evaluator(lambda: iter([batch]), metric_name="loss").evaluate(iteration, state)
    assert scores[0] == pytest.approx(expected, rel=1e-4)


def test_cross_batch_weighted_aggregation(tmp_path):
    """Batches combine by total example weight, not batch size."""
    est = _make_estimator(tmp_path, "agg", weight_key="w")
    rng = np.random.RandomState(3)
    x = rng.randn(32, 4).astype(np.float32)
    y = (x @ np.linspace(-1, 1.5, 4).astype(np.float32)[:, None] > 0).astype(np.float32)

    def train_fn():
        for s in range(0, 32, 16):
            yield {"x": x[s:s + 16], "w": np.ones((16, 1), np.float32)}, y[s:s + 16]

    est.train(train_fn, max_steps=20)

    def eval_fn():
        yield {"x": x[:16], "w": np.full((16, 1), 1e-3, np.float32)}, 1.0 - y[:16]
        yield {"x": x[:16], "w": np.ones((16, 1), np.float32)}, y[:16]

    def clean_fn():
        yield {"x": x[:16], "w": np.ones((16, 1), np.float32)}, y[:16]

    mixed = est.evaluate(eval_fn)
    clean = est.evaluate(clean_fn)
    assert mixed["accuracy"] == pytest.approx(clean["accuracy"], abs=5e-3)
    assert mixed["average_loss"] == pytest.approx(clean["average_loss"], rel=2e-2)


def test_weights_stay_f32_under_the_bf16_step_policy(tmp_path):
    """Under `step_compute_dtype="bfloat16"` the model features are cast
    and the weight column is not: the heads get f32 weights."""
    seen = []
    head = BinaryClassificationHead()
    loss = head.loss

    def spy(logits, labels, weights=None):
        seen.append(None if weights is None else weights.dtype)
        return loss(logits, labels, weights)

    head.loss = spy
    train_fn, _ = _poisoned_dataset(n=16)
    est = _make_estimator(tmp_path, "bf16", head=head, weight_key="w", max_iteration_steps=2,
                          step_compute_dtype="bfloat16")
    est.train(train_fn, max_steps=2)
    assert seen and all(dtype == torch.float32 for dtype in seen)


def test_metric_fn_forms(tmp_path):
    """Copies of tests/test_estimator.py's metric_fn tests: the
    two-argument form adds a plain per-batch mean; under a `weight_key`
    the three-argument form gets the weights."""
    from adanet_tpu_torch.core.heads import RegressionHead

    from torch_port_common import linear_dataset

    def make(name, **kwargs):
        return _make_estimator(
            tmp_path, name, head=RegressionHead(), max_iteration_steps=8,
            subnetwork_generator=SimpleGenerator([dnn_builder("dnn", 1), dnn_builder("deep", 2)]), **kwargs)

    est = make("plain", metric_fn=lambda logits, labels: {"mean_abs_logit": torch.mean(torch.abs(logits))})
    est.train(linear_dataset(), max_steps=100)
    metrics = est.evaluate(linear_dataset())
    assert np.isfinite(metrics["mean_abs_logit"]) and metrics["mean_abs_logit"] > 0

    def weighted_dataset():
        for features, labels in linear_dataset()():
            yield dict(features, w=np.full((len(labels), 1), 2.0, dtype=np.float32)), labels

    est = make("weighted", weight_key="w",
               metric_fn=lambda logits, labels, weights: {"weight_total_mean": torch.mean(weights)})
    est.train(weighted_dataset, max_steps=50)
    assert est.evaluate(weighted_dataset)["weight_total_mean"] == pytest.approx(2.0)
    predictions = list(est.predict(weighted_dataset))
    assert len(predictions) == 4 and tuple(predictions[0]["predictions"].shape) == (16, 1)
