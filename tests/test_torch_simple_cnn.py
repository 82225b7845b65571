"""The port's `examples/simple_cnn.py` against the JAX package's.

- `SimpleCNN`'s forward from the same variables (numpy, carried across by
  `utils.convert.convert_simple_cnn`): in f32 within 1e-5 x max(1,
  |logit|); in bf16, the builder's form, within 0.9 x bf16's own effect
  on these logits (JAX's f32 forward against its bf16 one). That bound
  lies above the port's bf16 forward against itself with the variables
  moved by a relative 1e-7 (asserted; about 2e-7) and below the port's
  f32 forward against JAX's bf16 one (asserted: an f32 forward fails
  it); the 0.1 margin covers the f32 forwards' own 1e-5. Measured at
  these inputs (1 and 2 blocks): 4.08e-3 and 1.47e-3 against bounds of
  4.76e-3 and 1.91e-3, the f32 forward at 5.29e-3 and 2.12e-3: oneDNN's
  bf16 rounding order and XLA's differ by nearly as much as bf16 and
  f32 do.
- A copy of tests/test_examples.py::
  test_simple_cnn_generator_widens_and_deepens.
- A two-iteration CNN search of both packages in f32 compute from the
  same `initial_variables`, at test_search_matches_jax's size (8 x 32
  digit images, 2 x 25 steps, the fused combine on): the same batches,
  the same architecture files, and `evaluate` within 1e-4 x max(1,
  |value|).
- Under RUN_SLOW, the torch copies of tests/test_convergence.py::
  test_cnn_family_converges (>= 0.89) and
  test_search_converges_to_target_accuracy (>= 0.94, top-5 >= 0.99).
"""

import json
import os
import zlib

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import adanet_tpu
from adanet_tpu.ensemble import ComplexityRegularizedEnsembler as JaxEnsembler
from adanet_tpu.examples import simple_cnn as jax_simple_cnn
from adanet_tpu.subnetwork import SimpleGenerator as JaxSimpleGenerator

from adanet_tpu_torch.core.estimator import Estimator
from adanet_tpu_torch.core.heads import MultiClassHead
from adanet_tpu_torch.core.iteration import IterationBuilder
from adanet_tpu_torch.ensemble.strategy import GrowStrategy
from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
from adanet_tpu_torch.examples import simple_cnn, simple_dnn
from adanet_tpu_torch.examples.synthetic_digits import image_input_fn, input_fn, make_dataset
from adanet_tpu_torch.subnetwork.generator import SimpleGenerator
from adanet_tpu_torch.utils.convert import convert_simple_cnn

from torch_port_common import numpy_variables, one_torch_thread, variable_shapes

LINEAR_BASELINE_ACCURACY = 0.76  # tests/test_convergence.py
STEPS = 25

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)


def _adam(params):
    return torch.optim.Adam(params, lr=1e-3, eps=1e-8)


def _variables(blocks, channels, sample, seed, logits_dimension=10):
    module = jax_simple_cnn.SimpleCNN(logits_dimension=logits_dimension, num_blocks=blocks, channels=channels)
    return numpy_variables(variable_shapes(module, {"image": sample}), seed)


@pytest.mark.parametrize("blocks", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(blocks, dtype):
    x = np.random.RandomState(0).rand(8, 16, 16, 3).astype(np.float32)
    variables = _variables(blocks, 8, x, seed=3)
    want_module = jax_simple_cnn.SimpleCNN(logits_dimension=10, num_blocks=blocks, channels=8,
                                           compute_dtype=getattr(jnp, dtype))
    want = want_module.apply(variables, {"image": x}, training=False)
    module = simple_cnn.SimpleCNN(3, 10, blocks, channels=8, compute_dtype=getattr(torch, dtype))
    module.load_state_dict(convert_simple_cnn(variables))
    got = module({"image": torch.from_numpy(x)}, training=False)
    want_logits = np.asarray(want.logits)
    scale = max(1.0, float(np.abs(want_logits).max()))
    if dtype == "float32":
        bound = 1e-5 * scale
    else:
        f32 = jax_simple_cnn.SimpleCNN(logits_dimension=10, num_blocks=blocks, channels=8, compute_dtype=jnp.float32)
        bound = 0.9 * float(np.abs(np.asarray(f32.apply(variables, {"image": x}, training=False).logits)
                                   - want_logits).max())
        module_f32 = simple_cnn.SimpleCNN(3, 10, blocks, channels=8, compute_dtype=torch.float32)
        module_f32.load_state_dict(convert_simple_cnn(variables))
        f32_gap = np.abs(module_f32({"image": torch.from_numpy(x)}).logits.detach().numpy() - want_logits).max()
        assert f32_gap > bound, "an f32 forward passes the bf16 bound"
        for seed in (5, 11, 17):
            noise = torch.Generator().manual_seed(seed)
            module.load_state_dict({k: v * (1.0 + 1e-7 * torch.randn(v.shape, generator=noise))
                                    for k, v in convert_simple_cnn(variables).items()})
            moved = module({"image": torch.from_numpy(x)}).logits
            module.load_state_dict(convert_simple_cnn(variables))
            assert float((moved - module({"image": torch.from_numpy(x)}).logits).abs().max()) <= bound
    np.testing.assert_allclose(got.logits.detach().numpy(), want_logits, rtol=0, atol=bound)
    assert got.logits.dtype == torch.float32 and got.last_layer.shape == (8, 8)
    assert got.complexity == want.complexity == np.sqrt(blocks)
    assert got.shared == want.shared == {"num_blocks": blocks}


def test_simple_cnn_generator_widens_and_deepens():
    gen = simple_cnn.CNNGenerator(initial_num_blocks=1, channels=8)
    builders = gen.generate_candidates(None, 0, [], [])
    assert [b.name for b in builders] == ["cnn_1b_8c", "cnn_2b_8c"]

    batch = ({"image": np.zeros((4, 16, 16, 3), np.float32)}, np.zeros((4,), np.int32))
    factory = IterationBuilder(
        head=MultiClassHead(3),
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=lambda p: torch.optim.SGD(p, lr=0.01))],
        ensemble_strategies=[GrowStrategy()],
        device="cpu",
    )
    it = factory.build_iteration(0, builders, None, input_shape=(16, 16, 3))
    state = it.init_state(torch.Generator().manual_seed(0), batch)
    state, metrics = it.train_step(state, batch)
    for name in it.candidate_names():
        assert np.isfinite(float(metrics["adanet_loss/%s" % name]))


class _F32Builder(jax_simple_cnn.CNNBuilder):
    """The JAX builder computing in f32 (its SimpleCNN's compute_dtype)."""

    def build_subnetwork(self, logits_dimension, previous_ensemble=None):
        return jax_simple_cnn.SimpleCNN(logits_dimension=logits_dimension, num_blocks=self._num_blocks,
                                        channels=self._channels, compute_dtype=jnp.float32)


class _TorchF32Builder(simple_cnn.CNNBuilder):
    """The port's builder computing in f32."""

    def build_subnetwork(self, logits_dimension, previous_ensemble=None, *, input_shape):
        return simple_cnn.SimpleCNN(input_shape[-1], logits_dimension, self._num_blocks, self._channels,
                                    compute_dtype=torch.float32)


def _with_initial(builders, sample, convert):
    """`builders` carrying `initial_variables` drawn per builder name."""
    for builder in builders:
        seed = zlib.crc32(builder.name.encode()) & 0xFFFF
        builder.initial_variables = convert(_variables(builder._num_blocks, builder._channels, sample, seed))
    return builders


def _logged(x, y, log, batch_size=32):
    def fn():
        for i, start in enumerate(range(0, len(x), batch_size)):
            log.append(i)
            yield {"image": x[start:start + batch_size]}, y[start:start + batch_size]

    return fn


def _architectures(model_dir):
    return [json.load(open(os.path.join(str(model_dir), "architecture-%d.json" % t))) for t in range(2)]


def test_cnn_search_matches_jax(tmp_path):
    xtr, ytr = make_dataset(8 * 32, seed=7)
    xte, yte = make_dataset(128, seed=8)
    jax_log, torch_log = [], []
    want_est = adanet_tpu.Estimator(
        head=adanet_tpu.MultiClassHead(n_classes=10),
        subnetwork_generator=JaxSimpleGenerator(_with_initial(
            [_F32Builder(1, channels=8, learning_rate=0.02), _F32Builder(2, channels=8, learning_rate=0.02)],
            xtr[:2], lambda v: v)),
        max_iteration_steps=STEPS,
        max_iterations=2,
        ensemblers=[JaxEnsembler(optimizer=optax.adam(1e-3), use_fused_combine=True)],
        model_dir=str(tmp_path / "jax"),
        log_every_steps=0,
    )
    want_est.train(_logged(xtr, ytr, jax_log), max_steps=10**6)
    want = want_est.evaluate(image_input_fn(xte, yte, 32))
    got_est = Estimator(
        head=MultiClassHead(10),
        subnetwork_generator=SimpleGenerator(_with_initial(
            [_TorchF32Builder(b, channels=8, learning_rate=0.02) for b in (1, 2)],
            xtr[:2], convert_simple_cnn)),
        max_iteration_steps=STEPS,
        max_iterations=2,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=_adam, use_fused_combine=True)],
        model_dir=str(tmp_path / "torch"),
        log_every_steps=0,
        device="cpu",
    )
    got_est.train(_logged(xtr, ytr, torch_log), max_steps=10**6)
    got = got_est.evaluate(image_input_fn(xte, yte, 32))
    assert torch_log == jax_log == [i % 8 for i in range(2 * STEPS)]
    assert _architectures(tmp_path / "torch") == _architectures(tmp_path / "jax")
    assert got["best_ensemble"] == want["best_ensemble"]
    for key in ("accuracy", "average_loss", "loss", "top_5_accuracy"):
        assert abs(got[key] - want[key]) <= 1e-4 * max(1.0, abs(want[key])), (key, got[key], want[key])


@pytest.mark.slow
def test_cnn_family_converges(tmp_path):
    """The torch copy of tests/test_convergence.py::test_cnn_family_converges
    at its configuration (bf16 CNNs, batch 128, 2 x 400 steps)."""
    xtr, ytr = make_dataset(8192, seed=7)
    xte, yte = make_dataset(2048, seed=8)
    est = Estimator(
        head=MultiClassHead(10),
        subnetwork_generator=SimpleGenerator([
            simple_cnn.CNNBuilder(num_blocks=1, channels=32, learning_rate=0.02),
            simple_cnn.CNNBuilder(num_blocks=2, channels=32, learning_rate=0.02),
        ]),
        max_iteration_steps=400,
        max_iterations=2,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=_adam, use_fused_combine=True)],
        model_dir=str(tmp_path / "model"),
        log_every_steps=0,
        device="cpu",
    )
    est.train(image_input_fn(xtr, ytr), max_steps=10**6)
    metrics = est.evaluate(image_input_fn(xte, yte))
    assert metrics["accuracy"] >= 0.89, metrics
    assert metrics["accuracy"] > LINEAR_BASELINE_ACCURACY


@pytest.mark.slow
def test_search_converges_to_target_accuracy(tmp_path):
    """The torch copy of tests/test_convergence.py::
    test_search_converges_to_target_accuracy: 8192 digits, simple_dnn 256
    wide with dropout 0.1, 3 x 800 steps."""
    xtr, ytr = make_dataset(8192, seed=7)
    xte, yte = make_dataset(2048, seed=8)
    est = Estimator(
        head=MultiClassHead(10),
        subnetwork_generator=simple_dnn.Generator(optimizer_fn=_adam, layer_size=256, initial_num_layers=1,
                                                  dropout=0.1, seed=0),
        max_iteration_steps=800,
        max_iterations=3,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=_adam, use_fused_combine=True)],
        model_dir=str(tmp_path / "model"),
        log_every_steps=0,
        device="cpu",
    )
    est.train(input_fn(xtr, ytr), max_steps=10**6)
    metrics = est.evaluate(input_fn(xte, yte))
    assert metrics["accuracy"] >= 0.94, metrics
    assert metrics["top_5_accuracy"] >= 0.99, metrics
