"""The port's tutorials (`examples/tutorials/`) against the JAX package's.

- Each tutorial's `main` end to end on the CPU at tiny settings, and
  cifar10_cnn's `--data_dir` naming the archive files it misses (the
  tutorial on an archive: tests/test_torch_cifar.py).
- Their data against the JAX tutorials' (equal arrays): boston_housing's
  synthetic stand-in and input_fn, mnist_simple_dnn's stand-in and idx
  reader, cifar10_cnn's synthetic provider.
- Their models against the JAX tutorials' from the same variables
  (numpy, carried across by `utils.convert.convert_module`), within
  1e-5 x max(1, |output|): boston_housing's Linear and DNN,
  transfer_learning's ConvEncoder and LinearModel.
- transfer_learning's pretraining runs with TF32 off.
- adanet_objective's `run_search` in both packages from the same
  `initial_variables` at 2 x 10 steps: the same members, and accuracy
  within one test example.
- Under RUN_SLOW, the copy of tests/test_examples.py::
  test_adanet_objective_tutorial_lambda_flips_selection.
"""

import gzip
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adanet_tpu.examples import simple_dnn as jax_simple_dnn
from adanet_tpu.examples.tutorials import adanet_objective as jax_objective
from adanet_tpu.examples.tutorials import boston_housing as jax_boston
from adanet_tpu.examples.tutorials import cifar10_cnn as jax_cifar
from adanet_tpu.examples.tutorials import mnist_simple_dnn as jax_mnist
from adanet_tpu.examples.tutorials import transfer_learning as jax_transfer

from adanet_tpu_torch.examples import simple_dnn
from adanet_tpu_torch.examples.synthetic_digits import make_dataset
from adanet_tpu_torch.examples.tutorials import (
    adanet_objective,
    boston_housing,
    cifar10_cnn,
    mnist_simple_dnn,
    transfer_learning,
)
from adanet_tpu_torch.utils.convert import WithInitialVariables, convert_module

from torch_port_common import numpy_variables, one_torch_thread, variable_shapes

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)


def _batches(input_fn):
    return [(features, labels) for features, labels in input_fn()]


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for (gf, gl), (wf, wl) in zip(got, want):
        assert sorted(gf) == sorted(wf)
        for key in wf:
            np.testing.assert_array_equal(gf[key], wf[key])
        np.testing.assert_array_equal(gl, wl)


def test_boston_housing_tiny(tmp_path):
    metrics = boston_housing.main(["--max_steps=30", "--iterations=3", "--model_dir=%s" % tmp_path, "--device=cpu"])
    assert np.isfinite(metrics["average_loss"]) and metrics["global_step"] == 30


def test_boston_housing_data_and_models_match_jax():
    got, want = boston_housing.load_data(None), jax_boston.load_data(None)
    for part in range(2):
        _assert_same_batches(_batches(boston_housing.make_input_fn(*got[part])),
                             _batches(jax_boston.make_input_fn(*want[part])))
    features = {"x": got[0][0][:32]}
    for module, jax_module in ((boston_housing.Linear(), jax_boston.Linear()), (boston_housing.DNN(), jax_boston.DNN())):
        variables = numpy_variables(variable_shapes(jax_module, features), seed=4)
        module.load_state_dict(convert_module(variables, module))
        want_out = np.asarray(jax_module.apply(variables, features, training=False))
        got_out = module({"x": torch.from_numpy(features["x"])}).detach().numpy()
        np.testing.assert_allclose(got_out, want_out, rtol=0, atol=1e-5 * max(1.0, np.abs(want_out).max()))


def test_mnist_simple_dnn_tiny(tmp_path):
    metrics = mnist_simple_dnn.main(["--max_steps=6", "--iterations=2", "--batch_size=32",
                                     "--model_dir=%s" % tmp_path, "--device=cpu"])
    assert np.isfinite(metrics["loss"]) and metrics["global_step"] == 6


def test_mnist_simple_dnn_data_matches_jax(tmp_path):
    got, want = mnist_simple_dnn.load_mnist(None), jax_mnist.load_mnist(None)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    images = np.arange(3 * 4 * 5, dtype=np.uint8).reshape(3, 4, 5)
    path = str(tmp_path / "images-idx3-ubyte.gz")
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, 8, 3) + struct.pack(">III", 3, 4, 5) + images.tobytes())
    np.testing.assert_array_equal(mnist_simple_dnn._read_idx(path), jax_mnist._read_idx(path))
    np.testing.assert_array_equal(mnist_simple_dnn._read_idx(path), images)


def test_cifar10_cnn_tiny(tmp_path):
    metrics = cifar10_cnn.main(["--max_steps=4", "--iterations=2", "--batch_size=16", "--channels=4",
                                "--model_dir=%s" % tmp_path, "--device=cpu"])
    assert np.isfinite(metrics["loss"]) and metrics["global_step"] == 4
    with pytest.raises(FileNotFoundError, match="data_batch_1"):
        cifar10_cnn.main(["--data_dir=/nonexistent", "--device=cpu"])


def test_cifar10_cnn_data_matches_jax():
    got = cifar10_cnn.synthetic_provider(128)
    want = jax_cifar.synthetic_provider(128)
    assert got.num_classes == want.num_classes == 10
    _assert_same_batches(_batches(got.get_input_fn("train")), _batches(want.get_input_fn("train")))


def test_transfer_learning_models_match_jax():
    x, _ = make_dataset(16, seed=3)
    features = {"image": x}
    for module, jax_module in ((transfer_learning.ConvEncoder(), jax_transfer.ConvEncoder()),
                               (transfer_learning.LinearModel(), jax_transfer.LinearModel())):
        variables = numpy_variables(variable_shapes(jax_module, features), seed=5)
        module.load_state_dict(convert_module(variables, module))
        want_out = np.asarray(jax_module.apply(variables, features, training=False))
        got_out = module({"image": torch.from_numpy(x)}).detach().numpy()
        np.testing.assert_allclose(got_out, want_out, rtol=0, atol=1e-5 * max(1.0, np.abs(want_out).max()))


def test_transfer_learning_pretrain_is_seeded():
    x, y = make_dataset(256, noise=0.1, max_shift=0, seed=3)
    (a, loss_a), (b, loss_b) = (transfer_learning.pretrain(x, y, 3, device="cpu") for _ in range(2))
    assert loss_a == loss_b and np.isfinite(loss_a)
    assert all(torch.equal(a[key], b[key]) for key in a)


def test_transfer_learning_pretrain_runs_without_tf32(monkeypatch):
    """The pretraining loop's f32 convolutions run with TF32 off, as the
    search's steps do, and torch's flags are restored after it."""
    seen, forward = [], transfer_learning.ConvEncoder.forward

    def probe(self, features, training=False):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return forward(self, features, training)

    monkeypatch.setattr(transfer_learning.ConvEncoder, "forward", probe)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    x, y = make_dataset(256, noise=0.1, max_shift=0, seed=3)
    transfer_learning.pretrain(x, y, 2, device="cpu")
    assert seen == [(False, False)] * 2
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (True, True)


def test_adanet_objective_run_search_matches_jax(tmp_path, monkeypatch):
    """Both tutorials' `run_search`, their simple_dnn generators starting
    every candidate from the same numbers (`WithInitialVariables`)."""
    for module, package, convert in ((adanet_objective, simple_dnn, None),
                                     (jax_objective, jax_simple_dnn, lambda v: v)):
        generator = package.Generator

        def wrapped(*args, _generator=generator, _convert=convert, **kwargs):
            extra = {} if _convert is None else {"convert": _convert}
            return WithInitialVariables(_generator(*args, **kwargs), 256, 10, **extra)

        monkeypatch.setattr(module.simple_dnn, "Generator", wrapped)
    train, test = make_dataset(256, seed=7), make_dataset(256, seed=8)
    got = adanet_objective.run_search(0.3, train, test, 10, str(tmp_path / "torch"), device="cpu")
    want = jax_objective.run_search(0.3, train, test, 10, str(tmp_path / "jax"))
    assert got[0] == want[0]
    assert abs(got[1] - want[1]) <= 1.0 / 256, (got, want)


def test_adanet_objective_tiny(tmp_path):
    results = adanet_objective.main(["--steps", "5", "--train_size", "256", "--lambdas", "0.0,1.0",
                                     "--model_dir", str(tmp_path), "--device", "cpu"])
    assert sorted(results) == [0.0, 1.0]
    for members, accuracy in results.values():
        assert members and 0.0 <= accuracy <= 1.0


@pytest.mark.slow
def test_adanet_objective_tutorial_lambda_flips_selection(tmp_path):
    """The copy of tests/test_examples.py::
    test_adanet_objective_tutorial_lambda_flips_selection: with lambda=0
    the search grows deep members; with lambda=1 the complexity penalty
    prices the deep candidates out and shallow members win."""
    results = adanet_objective.main(["--steps", "120", "--train_size", "1024", "--lambdas", "0.0,1.0",
                                     "--model_dir", str(tmp_path / "objective"), "--device", "cpu"])
    free_members, _ = results[0.0]
    priced_members, _ = results[1.0]
    assert any("2_layer" in m or "3_layer" in m for m in free_members)
    assert priced_members  # all() below must not pass vacuously
    assert all("1_layer" in m for m in priced_members)
