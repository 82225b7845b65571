"""Selection, reports and retained states through the port's Estimator.

- Copies of tests/test_estimator.py's `test_evaluator_based_selection`,
  `test_report_round_trip`, `test_multiple_strategies_and_ensemblers_
  lifecycle` (10 candidates at t = 0) and `test_multi_head_lifecycle` (up
  to its export block) on the `RegressionHead`, with the port's
  counterpart of tests/helpers.py's `DNNBuilder` (`torch_port_common.
  dnn_builder`).
- Copies of tests/test_core_units.py's report accessor, Evaluator
  objective and weighting, count-down timer, `evaluate_all_candidates`
  (live and retained) and candidate-metrics tests.
- A search of both packages from the same `initial_variables` with an
  Evaluator on held-out digits, a `ReportMaterializer`, mean candidates
  beside the weighted ones and example weights, at `test_search_matches_
  jax`'s size: Evaluator values, candidate-metrics losses and report
  metrics within atol 1e-4 x max(1, |value|), the same keys and flags,
  report names and `included_in_final_ensemble`, the same architecture
  files. Near-ties: a weighted candidate at 1/N equals the mean one over
  the same members at init, so the two can end within the tolerance of
  each other; the port's winner is always the objective of its own
  values, and it must be JAX's only where JAX's gap between its two best
  exceeds 10x the tolerance. An iteration whose winners differ ends the
  comparison (what follows grows from another ensemble).
- A multi-head search (digit, even, value) with mean candidates stopped
  inside iteration 1 and resumed by a fresh Estimator: the frozen
  payloads, architecture files and candidate metrics bitwise equal to an
  uninterrupted run's.
"""

import json
import os
import time

import numpy as np
import optax
import pytest
import torch

import adanet_tpu
from adanet_tpu.core.evaluator import Evaluator as JaxEvaluator
from adanet_tpu.core.report_materializer import ReportMaterializer as JaxReportMaterializer
from adanet_tpu.ensemble import ComplexityRegularizedEnsembler as JaxEnsembler
from adanet_tpu.ensemble import MeanEnsembler as JaxMeanEnsembler
from adanet_tpu.examples import simple_dnn as jax_simple_dnn

from adanet_tpu_torch.core import checkpoint as ckpt
from adanet_tpu_torch.core.estimator import Estimator
from adanet_tpu_torch.core.evaluator import Evaluator
from adanet_tpu_torch.core.heads import (
    BinaryClassificationHead,
    MultiClassHead,
    MultiHead,
    RegressionHead,
)
from adanet_tpu_torch.core.report_accessor import ReportAccessor
from adanet_tpu_torch.core.report_materializer import ReportMaterializer
from adanet_tpu_torch.core.timer import CountDownTimer
from adanet_tpu_torch.ensemble import (
    AllStrategy,
    ComplexityRegularizedEnsembler,
    GrowStrategy,
    MeanEnsembler,
    SoloStrategy,
)
from adanet_tpu_torch.examples import simple_dnn
from adanet_tpu_torch.examples.synthetic_digits import make_dataset
from adanet_tpu_torch.subnetwork.generator import SimpleGenerator
from adanet_tpu_torch.subnetwork.report import MaterializedReport
from adanet_tpu_torch.utils.convert import WithInitialVariables

from torch_port_common import dnn_builder, linear_dataset, one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)

TOL = 1e-4


def _sgd(lr):
    return lambda params: torch.optim.SGD(params, lr=lr)


def _make_estimator(tmp_path, **kwargs):
    defaults = dict(
        head=RegressionHead(),
        subnetwork_generator=SimpleGenerator([dnn_builder("dnn", 1), dnn_builder("deep", 2)]),
        max_iteration_steps=8,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=_sgd(0.05))],
        model_dir=str(tmp_path / "model"),
        log_every_steps=0,
        device="cpu",
    )
    defaults.update(kwargs)
    return Estimator(**defaults)


# ------------------------------------------------- tests/test_estimator.py


def test_evaluator_based_selection(tmp_path):
    est = _make_estimator(tmp_path, max_iterations=1, evaluator=Evaluator(input_fn=linear_dataset(), steps=2))
    est.train(linear_dataset(), max_steps=8)
    assert est.latest_iteration_number() == 1
    assert np.isfinite(est.evaluate(linear_dataset())["average_loss"])
    metrics = est.candidate_metrics(0)
    values = [metrics[name]["evaluator_objective"] for name in sorted(metrics)]
    best = [metrics[name]["best"] for name in sorted(metrics)]
    assert best.index(True) == int(np.nanargmin(values))


def test_report_round_trip(tmp_path):
    """Reports flow back into the generator."""
    seen = []

    class RecordingGenerator(SimpleGenerator):
        def generate_candidates(self, previous_ensemble, iteration_number, previous_ensemble_reports, all_reports,
                                config=None):
            seen.append((iteration_number, [r.name for r in previous_ensemble_reports], len(all_reports)))
            return super().generate_candidates(previous_ensemble, iteration_number, previous_ensemble_reports,
                                               all_reports, config)

    est = _make_estimator(
        tmp_path,
        subnetwork_generator=RecordingGenerator([dnn_builder("dnn", 1, with_report=True),
                                                 dnn_builder("deep", 2, with_report=True)]),
        max_iterations=2,
        report_materializer=ReportMaterializer(input_fn=linear_dataset(), steps=2),
    )
    est.train(linear_dataset(), max_steps=100)
    gen_calls = [c for c in seen if c[0] == 1]
    assert gen_calls and any(c[1] for c in gen_calls)
    reports = json.load(open(os.path.join(est.model_dir, "report", "iteration_reports.json")))
    assert set(reports) == {"0", "1"}
    assert {r["name"] for r in reports["0"]} == {"dnn", "deep"}
    included = [r["name"] for r in reports["0"] if r["included_in_final_ensemble"]]
    assert len(included) == 1
    assert gen_calls[0][1] == included and gen_calls[0][2] == 2
    assert "mean_logit" in reports["0"][0]["metrics"]
    assert "loss" in reports["0"][0]["metrics"]


def test_multiple_strategies_and_ensemblers_lifecycle(tmp_path):
    """Solo + Grow + All strategies x weighted + mean ensemblers."""
    est = _make_estimator(
        tmp_path,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=_sgd(0.05), adanet_lambda=0.01), MeanEnsembler()],
        ensemble_strategies=[GrowStrategy(), SoloStrategy(), AllStrategy()],
        max_iterations=2,
        max_iteration_steps=6,
    )
    est.train(linear_dataset(), max_steps=100)
    assert est.latest_iteration_number() == 2
    assert np.isfinite(est.evaluate(linear_dataset())["average_loss"])
    # grow(2) + solo(2) + all(1) = 5 candidate groups x 2 ensemblers.
    it0 = est._build_iteration(0, next(linear_dataset()()))
    assert len(it0.candidate_names()) == 10
    arch = json.load(open(os.path.join(est.model_dir, "architecture-0.json")))
    assert arch["ensembler_name"] in ("complexity_regularized", "mean")
    assert len(est.candidate_metrics(0)) == 10 and len(est.candidate_metrics(1)) == 11


def _two_head_data():
    rng = np.random.RandomState(0)
    x = rng.randn(64, 4).astype(np.float32)
    labels = {"reg": x.sum(axis=1, keepdims=True).astype(np.float32), "cls": rng.randint(0, 3, size=(64,))}

    def input_fn():
        for s in range(0, 64, 16):
            yield {"x": x[s:s + 16]}, {k: v[s:s + 16] for k, v in labels.items()}

    return input_fn


def test_multi_head_lifecycle(tmp_path):
    """Dict logits and labels through train, evaluate and predict."""
    head = MultiHead([RegressionHead(name="reg"), MultiClassHead(3, name="cls")])
    input_fn = _two_head_data()
    est = _make_estimator(
        tmp_path, head=head, subnetwork_generator=SimpleGenerator([dnn_builder("two_head", 1, learning_rate=0.05)]),
        max_iterations=2,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=_sgd(0.05), use_fused_combine=True), MeanEnsembler()],
    )
    est.train(input_fn, max_steps=100)
    assert est.latest_iteration_number() == 2
    metrics = est.evaluate(input_fn)
    assert np.isfinite(metrics["average_loss"])
    assert "cls/accuracy" in metrics
    preds = next(iter(est.predict(input_fn)))
    assert tuple(preds["reg/predictions"].shape) == (16, 1)
    assert tuple(preds["cls/class_ids"].shape) == (16,)


# ------------------------------------------------- tests/test_core_units.py


def test_report_accessor_round_trip(tmp_path):
    accessor = ReportAccessor(str(tmp_path))
    reports = [MaterializedReport(iteration_number=0, name="dnn", hparams={"depth": 2}, metrics={"loss": 0.5},
                                  included_in_final_ensemble=True)]
    accessor.write_iteration_report(0, reports)
    accessor.write_iteration_report(1, [])
    out = accessor.read_iteration_reports()
    assert len(out) == 2
    assert out[0][0].name == "dnn" and out[0][0].hparams == {"depth": 2}
    assert out[0][0].included_in_final_ensemble


def test_report_accessor_rewrite_is_idempotent(tmp_path):
    accessor = ReportAccessor(str(tmp_path))
    r = MaterializedReport(iteration_number=0, name="a")
    accessor.write_iteration_report(0, [r])
    accessor.write_iteration_report(0, [r])
    assert len(accessor.read_iteration_reports()) == 1


def test_evaluator_objective_fns():
    assert Evaluator(input_fn=None).objective_fn is np.nanargmin
    maximize = Evaluator(input_fn=None, metric_name="accuracy", objective="maximize")
    assert maximize.objective_fn is np.nanargmax
    assert maximize.metric_name == "accuracy"
    with pytest.raises(ValueError):
        maximize.objective_fn([float("nan"), float("nan")])


def test_evaluator_ragged_final_batch_is_example_weighted():
    class StubIteration:
        def candidate_names(self):
            return ["a"]

        def eval_step(self, state, batch):
            _, labels = batch
            return {"a": {"adanet_loss": torch.mean(torch.as_tensor(labels))}}

    def input_fn():
        yield {"x": np.zeros((4, 1))}, np.zeros((4,), np.float32)
        yield {"x": np.zeros((1, 1))}, np.full((1,), 8.0, np.float32)

    values = Evaluator(input_fn=input_fn).evaluate(StubIteration(), None)
    np.testing.assert_allclose(values, [1.6], rtol=1e-6)
    with pytest.raises(ValueError, match="no batches"):
        Evaluator(input_fn=lambda: iter(())).evaluate(StubIteration(), None)


def test_count_down_timer():
    timer = CountDownTimer(10.0)
    assert 9.0 < timer.secs_remaining() <= 10.0
    assert CountDownTimer(0.0).secs_remaining() == 0.0
    time.sleep(0.001)


def test_evaluate_all_candidates(tmp_path):
    est = _make_estimator(tmp_path, subnetwork_generator=SimpleGenerator([dnn_builder("a", 1), dnn_builder("b", 2)]),
                          max_iterations=1)
    est.train(linear_dataset(), max_steps=5)  # mid-iteration: every candidate is live
    results = est.evaluate_all_candidates(linear_dataset(), steps=2)
    assert set(results) == {"t0_a_grow_complexity_regularized", "t0_b_grow_complexity_regularized"}
    for metrics in results.values():
        assert np.isfinite(metrics["adanet_loss"])


def test_evaluate_all_candidates_after_completion(tmp_path):
    def make(name, **kwargs):
        return _make_estimator(
            tmp_path, subnetwork_generator=SimpleGenerator([dnn_builder("a", 1), dnn_builder("b", 2)]),
            max_iterations=2, model_dir=str(tmp_path / name), **kwargs,
        )

    est = make("kept", keep_candidate_states=True)
    est.train(linear_dataset(), max_steps=100)
    assert est.latest_iteration_number() == 2
    results = est.evaluate_all_candidates(linear_dataset(), steps=2)
    assert len(results) >= 2 and any(name.startswith("t1_") for name in results)
    for metrics in results.values():
        assert np.isfinite(metrics["adanet_loss"])
    # A fresh Estimator over the same model_dir rebuilds from disk.
    results2 = make("kept", keep_candidate_states=True).evaluate_all_candidates(linear_dataset(), steps=2)
    assert {n: round(m["adanet_loss"], 6) for n, m in results.items()} == {
        n: round(m["adanet_loss"], 6) for n, m in results2.items()}
    it0 = est.evaluate_all_candidates(linear_dataset(), steps=2, iteration_number=0)
    assert all(name.startswith("t0_") for name in it0)
    plain = make("plain")
    plain.train(linear_dataset(), max_steps=100)
    with pytest.raises(ValueError, match="keep_candidate_states"):
        plain.evaluate_all_candidates(linear_dataset(), steps=2)


def test_candidate_metrics_persisted_by_default(tmp_path):
    def make():
        return _make_estimator(tmp_path, subnetwork_generator=SimpleGenerator([dnn_builder("a", 1),
                                                                              dnn_builder("b", 2)]),
                               max_iterations=2)

    est = make()
    est.train(linear_dataset(), max_steps=100)
    assert est.latest_iteration_number() == 2
    for reader in (est, make()):
        metrics = reader.candidate_metrics()
        assert any(name.startswith("t1_") for name in metrics)
        assert sum(entry["best"] for entry in metrics.values()) == 1
        for entry in metrics.values():
            assert np.isfinite(entry["adanet_loss_ema"]) and not entry["dead"]
            assert "evaluator_objective" not in entry
    it0 = est.candidate_metrics(0)
    assert all(name.startswith("t0_") for name in it0) and len(it0) == 2
    with pytest.raises(ValueError, match="No candidate metrics"):
        est.candidate_metrics(7)
    assert os.listdir(os.path.join(est.model_dir, "ensemble", "t1_a_grow_complexity_regularized", "eval"))


# --------------------------------------------------- the slice against JAX


STEPS = 25


def _digits_fn(x, y, w=None, batch_size=32):
    def fn():
        for s in range(0, len(x), batch_size):
            n = len(y[s:s + batch_size])
            yield {"x": x[s:s + batch_size], "w": w[s:s + batch_size] if w is not None else np.ones(n, np.float32)
                   }, y[s:s + batch_size]

    return fn


def _read_json(model_dir, name):
    with open(os.path.join(model_dir, name)) as f:
        return json.load(f)


def _close(got, want, what):
    assert abs(got - want) <= TOL * max(1.0, abs(want)), (what, got, want)


def test_search_with_selection_reports_mean_and_weights_matches_jax(tmp_path):
    xtr, ytr = make_dataset(8 * 32, seed=7)
    xv, yv = make_dataset(128, seed=9)
    wtr = np.random.RandomState(0).uniform(0.5, 1.5, (len(ytr),)).astype(np.float32)
    train_fn, valid_fn = _digits_fn(xtr, ytr, wtr), _digits_fn(xv, yv)
    jax_dir, torch_dir = str(tmp_path / "jax"), str(tmp_path / "torch")
    adanet_tpu.Estimator(
        head=adanet_tpu.MultiClassHead(n_classes=10),
        subnetwork_generator=WithInitialVariables(
            jax_simple_dnn.Generator(optimizer_fn=lambda: optax.adam(1e-3), layer_size=16, initial_num_layers=1,
                                     seed=0), 256, 10, convert=lambda v: v),
        max_iteration_steps=STEPS, max_iterations=2,
        ensemblers=[JaxEnsembler(optimizer=optax.adam(1e-3), use_fused_combine=True), JaxMeanEnsembler()],
        evaluator=JaxEvaluator(valid_fn), report_materializer=JaxReportMaterializer(train_fn, steps=2),
        weight_key="w", model_dir=jax_dir, log_every_steps=0,
    ).train(train_fn, max_steps=10**6)

    def adam(params):
        return torch.optim.Adam(params, lr=1e-3, eps=1e-8)

    est = Estimator(
        head=MultiClassHead(10),
        subnetwork_generator=WithInitialVariables(
            simple_dnn.Generator(optimizer_fn=adam, layer_size=16, initial_num_layers=1, seed=0), 256, 10),
        max_iteration_steps=STEPS, max_iterations=2,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=adam, use_fused_combine=True), MeanEnsembler()],
        evaluator=Evaluator(valid_fn), report_materializer=ReportMaterializer(train_fn, steps=2),
        weight_key="w", model_dir=torch_dir, log_every_steps=0, device="cpu",
    )
    est.train(train_fn, max_steps=10**6)
    jax_reports = _read_json(jax_dir, "report/iteration_reports.json")
    torch_reports = _read_json(torch_dir, "report/iteration_reports.json")
    compared = 0
    for t in range(2):
        want = _read_json(jax_dir, "candidate-metrics-%d.json" % t)
        got = _read_json(torch_dir, "candidate-metrics-%d.json" % t)
        names = list(want)
        assert sorted(got) == sorted(want)
        values = [got[n]["evaluator_objective"] for n in names]
        for n in names:
            assert sorted(got[n]) == sorted(want[n])
            assert got[n]["dead"] == want[n]["dead"] and got[n]["global_step"] == want[n]["global_step"]
            for key in ("adanet_loss", "adanet_loss_ema", "evaluator_objective"):
                _close(got[n][key], want[n][key], (t, n, key))
        # Selection: the objective of the port's own values, always; JAX's
        # winner where JAX's two best are apart by more than 10x TOL.
        winner = [got[n]["best"] for n in names].index(True)
        assert winner == int(np.nanargmin(values))
        jax_winner = [want[n]["best"] for n in names].index(True)
        ordered = sorted(want[n]["evaluator_objective"] for n in names)
        if ordered[1] - ordered[0] > 10 * TOL * max(1.0, abs(ordered[0])):
            assert winner == jax_winner, (t, names, values)
        if winner != jax_winner:
            break
        assert _read_json(torch_dir, "architecture-%d.json" % t) == _read_json(jax_dir, "architecture-%d.json" % t)
        assert [(r["name"], r["included_in_final_ensemble"]) for r in torch_reports[str(t)]] == [
            (r["name"], r["included_in_final_ensemble"]) for r in jax_reports[str(t)]]
        for got_r, want_r in zip(torch_reports[str(t)], jax_reports[str(t)]):
            assert got_r["hparams"] == want_r["hparams"] and sorted(got_r["metrics"]) == sorted(want_r["metrics"])
            for key, value in want_r["metrics"].items():
                _close(got_r["metrics"][key], value, (t, got_r["name"], key))
        compared += 1
    assert compared >= 1
    assert sum(r["included_in_final_ensemble"] for r in torch_reports["0"]) == 1


# ------------------------------------------- multi-head stop and resume


def _multi_head_estimator(model_dir, steps=10):
    def adam(params):
        return torch.optim.Adam(params, lr=1e-3, eps=1e-8)

    head = MultiHead([MultiClassHead(10, name="digit"), BinaryClassificationHead(name="even"),
                      RegressionHead(name="value")])
    return Estimator(
        head=head, subnetwork_generator=simple_dnn.Generator(optimizer_fn=adam, layer_size=16, initial_num_layers=1),
        max_iteration_steps=steps, max_iterations=2,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=adam, use_bias=True), MeanEnsembler()],
        keep_candidate_states=True, model_dir=str(model_dir), log_every_steps=0, device="cpu",
    )


def _multi_head_batch():
    x, y = make_dataset(32, seed=7)
    labels = {"digit": y, "even": (y % 2 == 0).astype(np.float32), "value": y.astype(np.float32)}
    return {"x": x}, labels


def _equal_trees(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for key in want:
            _equal_trees(got[key], want[key], "%s/%s" % (path, key))
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _equal_trees(g, w, "%s/%d" % (path, i))
    elif torch.is_tensor(want):
        assert got.dtype == want.dtype and torch.equal(got, want), path
    else:
        assert got == want, (path, got, want)


def test_multi_head_search_with_mean_candidates_resumes_exactly(tmp_path):
    batch = _multi_head_batch()

    def data():
        while True:
            yield batch

    _multi_head_estimator(tmp_path / "whole").train(data, max_steps=10**6)
    for stop in (13, None):  # inside iteration 1, then to the end, each in a fresh Estimator
        _multi_head_estimator(tmp_path / "parts").train(data, max_steps=stop or 10**6)
    for t in range(2):
        for name in ("architecture-%d.json" % t, "candidate-metrics-%d.json" % t):
            assert (tmp_path / "parts" / name).read_bytes() == (tmp_path / "whole" / name).read_bytes()
        for name in ("frozen-%d.pt" % t, "iteration-final-%d.pt" % t):
            _equal_trees(ckpt.restore_payload(str(tmp_path / "parts"), name),
                         ckpt.restore_payload(str(tmp_path / "whole"), name))
    frozen = ckpt.restore_payload(str(tmp_path / "whole"), "frozen-1.pt")
    weights = [m["weight"].get("value") for m in frozen["members"]]
    assert all(w is None for w in weights) or all(sorted(w) == ["digit", "even", "value"] for w in weights)
    est = _multi_head_estimator(tmp_path / "whole")
    metrics = est.evaluate(lambda: iter([batch]))
    assert {"digit/accuracy", "even/auc", "value/average_loss"} <= set(metrics)
    everything = est.evaluate_all_candidates(lambda: iter([batch]))
    assert len(everything) == 5 and all(np.isfinite(m["adanet_loss"]) for m in everything.values())
