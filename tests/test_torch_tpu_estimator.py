"""The port's windowed Estimator (`core/tpu_estimator.py` and the
Estimator's `iterations_per_loop`), against itself and the JAX package.

Copies of tests/test_tpu_estimator.py's nine tests on the port's
simple_dnn search (MultiClassHead on the synthetic digits; the JAX tests
use a regression head the port does not have yet), with the window
results held bitwise equal to single steps where the JAX test holds them
at rtol 1e-4, and:

- the port's `TPUEstimator(iterations_per_loop=4)` against the JAX one
  from the same `initial_variables` on the same batches: the same
  architecture files and winner, eval metrics within atol 1e-4 x max(1,
  |value|);
- a non-finite step inside a window: the port's `Iteration.train_steps`
  over windows of 4 against the JAX `train_steps` (one `lax.scan`) on
  the same batches, one of them poisoned (the candidate it reaches is
  quarantined: step counts, dead flags, EMAs and losses as in JAX), and
  bitwise equal to the port's single steps;
- no host read inside a window and one a window (tensor reads to the
  host counted by stubbing `tolist`, `item` and the scalar conversions);
- windows with device prefetch (to the CPU here) and the bf16 step
  policy equal to single steps bitwise; a checkpoint fires when a window
  crosses its interval;
- under `debug`, `predict` and `TPUEstimator.predict` (padded or not)
  raise the JAX `predict`'s `FloatingPointError` on a non-finite
  feature, and the JAX `predict` raises it on the same batch;
- the torch copy of tests/test_convergence.py::
  test_bf16_step_trains_to_finite_metrics (tier-1), and under RUN_SLOW
  of test_nasnet_family_converges_bf16_steps (accuracy >= 0.88 and above
  the linear baseline, 0.76).
"""

import glob
import json
import logging
import os
import zlib

import jax
import numpy as np
import optax
import pytest
import torch

import adanet_tpu
from adanet_tpu.core.iteration import IterationBuilder as JaxIterationBuilder
from adanet_tpu.ensemble import ComplexityRegularizedEnsembler as JaxEnsembler
from adanet_tpu.ensemble import GrowStrategy as JaxGrow
from adanet_tpu.examples import simple_dnn as jax_simple_dnn
from adanet_tpu.core.heads import MultiClassHead as JaxHead

from adanet_tpu_torch.core import TPUEstimator
from adanet_tpu_torch.core import checkpoint
from adanet_tpu_torch.core import iteration as iteration_lib
from adanet_tpu_torch.core.estimator import Estimator
from adanet_tpu_torch.core.heads import MultiClassHead
from adanet_tpu_torch.core.iteration import IterationBuilder
from adanet_tpu_torch.ensemble.strategy import GrowStrategy
from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
from adanet_tpu_torch.examples import simple_dnn
from adanet_tpu_torch.examples.synthetic_digits import image_input_fn, input_fn, make_dataset
from adanet_tpu_torch.research.improve_nas import improve_nas, optimizer
from adanet_tpu_torch.subnetwork.generator import SimpleGenerator
from adanet_tpu_torch.utils import convert
from adanet_tpu_torch.utils.convert import WithInitialVariables, simple_dnn_variables

from torch_port_common import one_torch_thread

STEPS = 8
CLASSES = 10
LINEAR_BASELINE_ACCURACY = 0.76  # tests/test_convergence.py

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)

IMAGES, Y = make_dataset(8 * 32, seed=7)
X = IMAGES.reshape(len(IMAGES), -1)  # the flat features `input_fn` yields


def _input_fn(batch_size=32):
    return input_fn(IMAGES, Y, batch_size)


def _sgd(params):
    return torch.optim.SGD(params, lr=0.05)


def _estimator(model_dir, **kwargs):
    """A 2-iteration simple_dnn search on the CPU, from `initial_variables`."""
    defaults = dict(
        head=MultiClassHead(CLASSES),
        subnetwork_generator=WithInitialVariables(
            simple_dnn.Generator(layer_size=16, initial_num_layers=1, seed=0), X.shape[1], CLASSES),
        max_iteration_steps=STEPS,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=_sgd, use_fused_combine=True)],
        max_iterations=2,
        model_dir=str(model_dir),
        log_every_steps=0,
        device="cpu",
    )
    defaults.update(kwargs)
    return TPUEstimator(**defaults)


def _frozen(est, t=None):
    """The frozen winner payload of iteration t (the last by default)."""
    t = est.latest_iteration_number() - 1 if t is None else t
    return checkpoint.restore_payload(est.model_dir, checkpoint.frozen_filename(t))


def _assert_bitwise(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for key in a:
            _assert_bitwise(a[key], b[key], "%s/%s" % (path, key))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bitwise(x, y, "%s/%d" % (path, i))
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


# ------------------------------------------- copies of test_tpu_estimator.py


def test_multi_step_loop_matches_step_counts(tmp_path):
    est = _estimator(tmp_path, iterations_per_loop=4)
    est.train(_input_fn(), max_steps=100)
    assert est.latest_iteration_number() == 2
    assert est.latest_global_step() == 16
    assert np.isfinite(est.evaluate(_input_fn())["average_loss"])


def test_loop_clipped_by_max_steps(tmp_path):
    est = _estimator(tmp_path, iterations_per_loop=16)
    assert est._iterations_per_loop == 16 and _estimator(tmp_path / "d")._iterations_per_loop == 16
    est.train(_input_fn(), max_steps=5)
    assert est.latest_global_step() == 5


def test_multi_step_equivalent_to_single_step(tmp_path):
    """Windows leave results as they are: the frozen winners and the eval
    metrics of windows of 8 and of single steps are bitwise equal."""
    multi = _estimator(tmp_path / "m", iterations_per_loop=8)
    single = _estimator(tmp_path / "s", iterations_per_loop=1)
    multi.train(_input_fn(), max_steps=16)
    single.train(_input_fn(), max_steps=16)
    for t in range(2):
        _assert_bitwise(_frozen(multi, t), _frozen(single, t))
    assert multi.evaluate(_input_fn()) == single.evaluate(_input_fn())


def test_ragged_final_batch_falls_back(tmp_path):
    """A short final batch inside a window runs as single steps."""

    def ragged_input_fn():
        for size, start in ((32, 0), (32, 32), (32, 64), (7, 96)):
            yield {"x": X[start:start + size]}, Y[start:start + size]

    est = _estimator(tmp_path, iterations_per_loop=4, max_iterations=1)
    est.train(ragged_input_fn, max_steps=8)
    assert est.latest_global_step() == 8


def test_checkpoint_interval_crossing_with_loops(tmp_path, monkeypatch):
    """save_checkpoint_steps coprime to the window still checkpoints, when
    a window crosses a multiple of it (global step 4 crosses 3, 6 reaches
    6), and the stop inside the iteration saves again, as the JAX
    Estimator does (its manifest's generation counts both)."""
    saved = []
    save = Estimator._save_iteration_state

    def recording(self, info, t, state):
        saved.append(info.global_step)
        save(self, info, t, state)

    monkeypatch.setattr(Estimator, "_save_iteration_state", recording)
    est = _estimator(tmp_path, iterations_per_loop=4, max_iterations=1, save_checkpoint_steps=3)
    est.train(_input_fn(), max_steps=6)
    assert saved == [4, 6, 6]
    assert glob.glob(os.path.join(est.model_dir, "ckpt-*.pt"))


def test_padded_predict_batching(tmp_path):
    est = _estimator(tmp_path, max_iterations=1, predict_batch_size=16)
    est.train(_input_fn(), max_steps=8)

    def ragged_input_fn():
        for size, start in ((16, 0), (9, 16), (3, 25)):
            yield {"x": X[start:start + size]}, Y[start:start + size]

    padded = list(est.predict(ragged_input_fn))
    assert [p["logits"].shape[0] for p in padded] == [16, 9, 3]
    plain = list(est.predict(ragged_input_fn, predict_batch_size=0))
    for a, b in zip(padded, plain):
        np.testing.assert_allclose(a["logits"].numpy(), b["logits"].numpy(), rtol=1e-5, atol=1e-6)
        assert torch.equal(a["class_ids"], b["class_ids"])

    def oversized():
        yield {"x": np.zeros((17, X.shape[1]), np.float32)}, None

    with pytest.raises(ValueError, match="exceeds"):
        list(est.predict(oversized, predict_batch_size=16))
    with pytest.raises(ValueError, match="predict_batch_size"):
        _estimator(tmp_path / "bad", predict_batch_size=-1)


def test_predict_on_cpu_matches_device_predict(tmp_path, monkeypatch, caplog):
    """`embedding_tables_on_host` predicts on the CPU by the caller's
    choice (one warning an estimator), through a rebuild on the CPU that
    an ordinary predict never makes; the predictions are the same."""
    est = _estimator(tmp_path, max_iterations=1, embedding_tables_on_host=True)
    est.train(_input_fn(), max_steps=8)
    rebuilt_on = []
    on_device = Estimator._on_device

    def recording(self, device):
        rebuilt_on.append(torch.device(device).type)
        return on_device(self, device)

    monkeypatch.setattr(Estimator, "_on_device", recording)
    with caplog.at_level(logging.WARNING):
        host = list(est.predict(_input_fn()))
        host_again = list(est.predict(_input_fn()))
    assert rebuilt_on == ["cpu", "cpu"]
    assert sum("predicting on the CPU" in r.getMessage() for r in caplog.records) == 1
    rebuilt_on.clear()
    device = list(est.predict(_input_fn(), on_cpu=False))
    assert rebuilt_on == []
    padded = list(est.predict(_input_fn(), predict_batch_size=48))
    assert rebuilt_on == ["cpu"]
    assert len(host) == len(device) == 8
    for a, b, c, d in zip(host, host_again, device, padded):
        for other in (b, c, d):
            np.testing.assert_allclose(a["logits"].numpy(), other["logits"].numpy(), rtol=1e-5, atol=1e-6)


def test_metric_fn(tmp_path):
    def metric_fn(logits, labels):
        onehot = torch.nn.functional.one_hot(labels.reshape(-1).long(), CLASSES).float()
        return {"mean_abs_error": torch.mean(torch.abs(torch.softmax(logits, -1) - onehot))}

    est = _estimator(tmp_path, metric_fn=metric_fn, max_iterations=1)
    est.train(_input_fn(), max_steps=8)
    metrics = est.evaluate(_input_fn())
    assert "mean_abs_error" in metrics and np.isfinite(metrics["mean_abs_error"])
    assert 0.0 < metrics["mean_abs_error"] < 1.0


def test_profile_trace_written(tmp_path):
    from adanet_tpu_torch.utils import device_timing

    est = _estimator(tmp_path, max_iterations=1, profile_dir=str(tmp_path / "profile"), profile_steps=2)
    est.train(_input_fn(), max_steps=8)
    traces = glob.glob(os.path.join(str(tmp_path / "profile"), "iteration_0", "**", "*"), recursive=True)
    assert traces
    with open(os.path.join(str(tmp_path / "profile"), "iteration_0", "trace.json")) as f:
        assert json.load(f)["traceEvents"]
    # A CPU trace holds no CUDA kernel: no device time to report.
    assert device_timing.trace_device_seconds(str(tmp_path / "profile")) == (0.0, 0)
    with pytest.raises(ValueError, match="no CUDA kernel"):
        device_timing.time_steps_on_device(lambda: torch.ones(3).sum())


def test_trace_device_seconds_sums_kernel_events(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "a", "dur": 12.5},
        {"ph": "X", "cat": "kernel", "name": "b", "dur": 7.5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "dur": 100.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 50.0},
    ]
    with open(str(tmp_path / "trace.json"), "w") as f:
        json.dump({"traceEvents": events}, f)
    from adanet_tpu_torch.utils import device_timing

    seconds, count = device_timing.trace_device_seconds(str(tmp_path))
    assert count == 2 and seconds == pytest.approx(20e-6)
    with pytest.raises(FileNotFoundError):
        device_timing.trace_device_seconds(str(tmp_path / "none"))


# ---------------------------------------------------- against the JAX package


def test_windows_match_jax_tpu_estimator(tmp_path):
    want_est = adanet_tpu.TPUEstimator(
        head=adanet_tpu.MultiClassHead(n_classes=CLASSES),
        subnetwork_generator=WithInitialVariables(
            jax_simple_dnn.Generator(optimizer_fn=lambda: optax.sgd(0.01), layer_size=16, initial_num_layers=1,
                                     seed=0),
            X.shape[1], CLASSES, convert=lambda v: v,
        ),
        max_iteration_steps=STEPS,
        max_iterations=2,
        ensemblers=[JaxEnsembler(optimizer=optax.sgd(0.05), use_fused_combine=True)],
        model_dir=str(tmp_path / "jax"),
        log_every_steps=0,
        iterations_per_loop=4,
    )
    want_est.train(_input_fn(), max_steps=10**6)
    want = want_est.evaluate(_input_fn())
    got_est = _estimator(tmp_path / "torch", iterations_per_loop=4)
    got_est.train(_input_fn(), max_steps=10**6)
    got = got_est.evaluate(_input_fn())
    for t in range(2):
        with open(os.path.join(str(tmp_path / "jax"), "architecture-%d.json" % t)) as f:
            want_arch = json.load(f)
        with open(os.path.join(str(tmp_path / "torch"), "architecture-%d.json" % t)) as f:
            assert json.load(f) == want_arch
    assert got["best_ensemble"] == want["best_ensemble"]
    assert got["global_step"] == want["global_step"] == 2 * STEPS
    for key in ("loss", "average_loss", "accuracy"):
        assert abs(got[key] - want[key]) <= 1e-4 * max(1.0, abs(want[key])), (key, got[key], want[key])


def _fragile_parts(is_jax):
    """The `_Fragile` search of tests/test_torch_iteration.py (a linear
    candidate that adds the batch's `poison` column to its logits, and a
    one-layer DNN), both packages from the same numpy variables."""
    from test_torch_iteration import FEATURES, _adam, _adam_jax, _Fragile, _JaxFragile

    if is_jax:
        builders = [_JaxFragile(), jax_simple_dnn._DNNBuilder(_adam_jax, 16, 1, False, 0.0, 0)]
        factory = JaxIterationBuilder(JaxHead(CLASSES), [JaxEnsembler(optimizer=_adam_jax())], [JaxGrow()])
    else:
        builders = [_Fragile(), simple_dnn._DNNBuilder(_adam, 16, 1, False, 0.0, 0)]
        factory = IterationBuilder(MultiClassHead(CLASSES), [ComplexityRegularizedEnsembler(optimizer=_adam)],
                                   [GrowStrategy()], device="cpu")
    for builder, layers in zip(builders, (0, 1)):
        flax = simple_dnn_variables(layers, 16, FEATURES, CLASSES, zlib.crc32(builder.name.encode()))
        builder.initial_variables = flax if is_jax else convert.convert_variables(flax, ("params",))
    if is_jax:
        return factory.build_iteration(0, builders)
    return factory.build_iteration(0, builders, input_shape=(FEATURES,))


def test_nonfinite_step_inside_a_window_matches_jax():
    from test_torch_iteration import _close, _poisoned_batches

    data = _poisoned_batches(12, 5)  # step 6, inside the second window of 4
    windows = [data[i:i + 4] for i in range(0, 12, 4)]
    jax_iteration = _fragile_parts(True)
    jax_state = jax_iteration.init_state(jax.random.PRNGKey(0), data[0])
    want_last = []
    for window in windows:
        stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *window)
        jax_state, metrics = jax_iteration.train_steps(jax_state, stacked)
        want_last.append({k: float(v) for k, v in metrics.items()})
    runs = []
    for windowed in (True, False):
        iteration = _fragile_parts(False)
        state = iteration.init_state(torch.Generator().manual_seed(0), data[0])
        last = []
        for window in windows:
            if windowed:
                state, metrics = iteration.train_steps(state, window)
            else:
                for batch in window:
                    state, metrics = iteration.train_step(state, batch)
            last.append({k: float(v) for k, v in metrics.items()})
        runs.append((iteration, state, last))
    (iteration, state, got_last), (_, single_state, _) = runs
    _assert_bitwise(iteration_lib.state_payload(state), iteration_lib.state_payload(single_state))
    got_subs = iteration.host_counters(state)
    want_subs = {name: (int(st.step), bool(st.dead)) for name, st in jax_state.subnetworks.items()}
    assert got_subs == want_subs == {"fragile": (5, True), "1_layer_dnn": (12, False)}
    assert {n: bool(c.dead) for n, c in state.candidates.items()} == {
        n: bool(c.dead) for n, c in jax_state.candidates.items()}
    want_emas = jax_iteration.ema_losses(jax_state)
    got_emas = iteration.ema_losses(state)
    for name, value in want_emas.items():
        if np.isinf(value):
            assert np.isinf(got_emas[name])
        else:
            _close(got_emas[name], value, name)
    for got, want in zip(got_last, want_last):
        for key, value in want.items():
            if np.isfinite(value):
                _close(got[key], value, key)
            else:
                assert not np.isfinite(got[key]), key
    assert iteration.best_candidate_index(state) == jax_iteration.best_candidate_index(jax_state) == 1


# ------------------------------------------------- host reads and windows


def test_one_host_read_per_window(tmp_path, monkeypatch):
    """A window's steps read nothing on the host; the Estimator reads the
    counters once a window and nothing else between windows."""
    reads = []
    for name in ("tolist", "item", "__bool__", "__int__", "__float__", "__index__", "numpy"):
        original = getattr(torch.Tensor, name)

        def counted(self, *args, _original=original, _name=name, **kwargs):
            reads.append(_name)
            return _original(self, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, name, counted)
    marks = []
    run_window = iteration_lib.Iteration.train_steps

    def window(self, state, batches):
        marks.append(len(reads))
        out = run_window(self, state, batches)
        assert len(reads) == marks[-1], reads[marks[-1]:]
        return out

    monkeypatch.setattr(iteration_lib.Iteration, "train_steps", window)
    est = _estimator(tmp_path, iterations_per_loop=4, max_iterations=1, max_iteration_steps=16)
    est.train(_input_fn(), max_steps=16)
    assert len(marks) == 4
    assert [b - a for a, b in zip(marks, marks[1:])] == [1, 1, 1]
    assert reads[marks[0]:marks[-1]] == ["tolist"] * 3


def test_windows_with_prefetch_and_bf16_equal_single_steps(tmp_path):
    """Device prefetch (to the CPU here), the bf16 step policy and windows
    of 4 against single steps with neither prefetch: bitwise."""
    kwargs = dict(step_compute_dtype="bfloat16")
    single = _estimator(tmp_path / "s", iterations_per_loop=1, **kwargs)
    windowed = _estimator(tmp_path / "w", iterations_per_loop=4, prefetch_buffer=2, prefetch_to_device=True,
                          **kwargs)
    for est in (single, windowed):
        est.train(_input_fn(), max_steps=100)
        assert not est._open_prefetchers
    for t in range(2):
        _assert_bitwise(_frozen(windowed, t), _frozen(single, t))


def test_debug_rejects_non_finite_batches(tmp_path):
    def poisoned():
        x = X[:32].copy()
        x[3, 1] = np.nan
        yield {"x": x}, Y[:32]

    est = _estimator(tmp_path, debug=True, prefetch_buffer=2)
    with pytest.raises(FloatingPointError, match="debug=True"):
        est.train(poisoned, max_steps=2)
    assert not est._open_prefetchers
    with pytest.raises(ValueError, match="iterations_per_loop"):
        _estimator(tmp_path, iterations_per_loop=0)


def _poisoned_features(rows=32):
    x = X[:rows].copy()
    x[3, 1] = np.nan
    return {"x": x}


# The JAX package's message for a NaN in the features of a (features,
# labels) batch; TPUEstimator's padded path hands (features, None) on.
NAN_FEATURES = r"Non-finite values in input batch at \[0\]\['x'\] \(debug=True\)\."


@pytest.mark.parametrize("batch_size", [None, 0, 40])
def test_debug_predict_rejects_non_finite_features(tmp_path, batch_size):
    """`predict` and `TPUEstimator.predict` (padded to 40, and not padded)
    check every batch under `debug` before the model sees it, and raise
    the JAX `predict`'s `FloatingPointError`; without `debug` the NaN
    flows through to the predictions."""
    est = _estimator(tmp_path, debug=True, max_iterations=1)
    est.train(_input_fn(), max_steps=STEPS)

    def poisoned():
        yield _input_fn()().__next__()[0], None
        yield _poisoned_features(), Y[:32]

    predictions = est.predict(poisoned, predict_batch_size=batch_size)
    assert np.all(np.isfinite(next(predictions)["probabilities"].numpy()))
    with pytest.raises(FloatingPointError, match=NAN_FEATURES):
        next(predictions)
    with pytest.raises(FloatingPointError, match=r"at \['x'\] \(debug=True\)"):
        next(Estimator.predict(est, lambda: iter([_poisoned_features()])))
    quiet = _estimator(tmp_path, max_iterations=1)
    out = next(quiet.predict(lambda: iter([(_poisoned_features(), None)]), predict_batch_size=batch_size))
    assert not np.all(np.isfinite(out["probabilities"].numpy()))


def test_debug_predict_rejects_non_finite_features_in_jax(tmp_path):
    """The same check on the JAX side: its `predict` raises on the same
    batch with the message the port's matches."""
    jax_est = adanet_tpu.Estimator(
        head=adanet_tpu.MultiClassHead(n_classes=CLASSES),
        subnetwork_generator=jax_simple_dnn.Generator(layer_size=16, initial_num_layers=1, seed=0),
        max_iteration_steps=2,
        max_iterations=1,
        model_dir=str(tmp_path / "jax"),
        log_every_steps=0,
        debug=True,
    )
    jax_est.train(_input_fn(), max_steps=2)
    with pytest.raises(FloatingPointError, match=NAN_FEATURES):
        list(jax_est.predict(lambda: iter([(_poisoned_features(), Y[:32])])))


# ---------------------------------------------------------------- bf16 gates


def _gate_hparams(**overrides):
    base = dict(num_cells=3, num_conv_filters=8, use_aux_head=False, drop_path_keep_prob=1.0,
                dense_dropout_keep_prob=1.0, clip_gradients=5.0, weight_decay=1e-4, initial_learning_rate=1e-3)
    base.update(overrides)
    return improve_nas.Hparams(**base)


def _bf16_search(tmp_path, hparams, steps):
    def adam(params):
        return torch.optim.Adam(params, lr=1e-3, eps=1e-8)

    return Estimator(
        head=MultiClassHead(CLASSES),
        subnetwork_generator=SimpleGenerator([improve_nas.Builder(optimizer.fn_with_name("adam"), hparams, seed=0)]),
        max_iteration_steps=steps,
        max_iterations=1,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=adam)],
        model_dir=str(tmp_path / "model"),
        log_every_steps=0,
        step_compute_dtype="bfloat16",
        prefetch_buffer=2,
        prefetch_to_device=True,
        device="cpu",
    )


def test_bf16_step_trains_to_finite_metrics(tmp_path):
    xtr, ytr = make_dataset(512, seed=7)
    est = _bf16_search(tmp_path, _gate_hparams(num_cells=2, num_conv_filters=4), 8)
    est.train(image_input_fn(xtr, ytr), max_steps=8)
    metrics = est.evaluate(image_input_fn(*make_dataset(256, seed=8)))
    assert np.isfinite(metrics["loss"]), metrics
    assert np.isfinite(metrics["accuracy"]), metrics
    assert not est._open_prefetchers


@pytest.mark.slow
def test_nasnet_family_converges_bf16_steps_on_the_port(tmp_path):
    xtr, ytr = make_dataset(8192, seed=7)
    xte, yte = make_dataset(2048, seed=8)
    est = _bf16_search(tmp_path, _gate_hparams(), 300)
    est.train(image_input_fn(xtr, ytr), max_steps=10**6)
    metrics = est.evaluate(image_input_fn(xte, yte))
    assert metrics["accuracy"] >= 0.88, metrics
    assert metrics["accuracy"] > LINEAR_BASELINE_ACCURACY
