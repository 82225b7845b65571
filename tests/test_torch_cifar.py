"""The port's CIFAR providers (`research/improve_nas/cifar10.py`,
`cifar100.py`) against the JAX package's, and the paths that read them.

- Copies of the five tests of tests/test_cifar_archives.py, against the
  port's providers and Estimator (synthetic archives in the published
  byte layout, written by that file's helpers).
- The port's batches bitwise equal to the JAX providers' for the same
  archive, seed and epoch: train (shuffled, augmented, natively) and
  test, two epochs each.
- The port's improve_nas trainer on `--dataset=cifar10` and `cifar100`
  from tiny archives (3 cells, 4 filters, 2 x 4 steps, on the CPU), and
  the cifar10_cnn tutorial with `--data_dir`.
- The slice as a whole: test_cifar10_archive_trains_an_estimator in
  both packages from the same simple_dnn variables (numpy, converted
  for the port): after 5 steps the evaluated losses agree within 1e-4 x
  max(1, |value|).
"""

import json
import os

import numpy as np
import optax
import pytest
import torch

from adanet_tpu_torch.research.improve_nas import cifar10, cifar100, trainer
from adanet_tpu_torch.utils.convert import WithInitialVariables

from test_cifar_archives import _write_cifar10_archive, _write_cifar100_archive
from torch_port_common import one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)


def test_cifar10_load_matches_archive_bytes(tmp_path):
    """_load concatenates the 5 train batches in order, decodes CHW->HWC."""
    expected = _write_cifar10_archive(str(tmp_path))
    provider = cifar10.Provider(str(tmp_path), batch_size=4)

    images, labels = provider._load("train")
    assert images.shape == (40, 32, 32, 3)
    assert images.dtype == np.float32
    raw = np.concatenate([expected["data_batch_%d" % i][0] for i in range(1, 6)], axis=0)
    want = raw.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1) / 255.0
    np.testing.assert_allclose(images, want.astype(np.float32))
    want_labels = np.concatenate([expected["data_batch_%d" % i][1] for i in range(1, 6)])
    np.testing.assert_array_equal(labels, want_labels)

    test_images, test_labels = provider._load("test")
    assert test_images.shape == (8, 32, 32, 3)
    np.testing.assert_array_equal(test_labels, expected["test_batch"][1])


def test_cifar10_input_fn_augments_and_batches(tmp_path):
    """The full _load -> augment -> standardize train path off the archive."""
    _write_cifar10_archive(str(tmp_path), examples_per_batch=16)
    provider = cifar10.Provider(str(tmp_path), batch_size=16, seed=7)

    batches = list(provider.get_input_fn("train")())
    assert len(batches) == 5  # 80 train examples at batch 16
    for features, labels in batches:
        assert features["image"].shape == (16, 32, 32, 3)
        assert labels.shape == (16,)
        assert features["image"].dtype == np.float32
        assert features["image"].min() < 0  # standardized

    # Eval path: deterministic, unaugmented, standardization-only.
    eval_a = list(provider.get_input_fn("test")())
    eval_b = list(provider.get_input_fn("test", shuffle=False)())
    assert len(eval_a) == 1
    np.testing.assert_array_equal(eval_a[0][0]["image"], eval_b[0][0]["image"])


def test_cifar10_missing_files_error_names_them(tmp_path):
    provider = cifar10.Provider(str(tmp_path), batch_size=4)
    with pytest.raises(FileNotFoundError, match="data_batch_1"):
        provider._load("train")


def test_cifar100_load_fine_labels(tmp_path):
    """CIFAR-100 archive layout: single train/test files, b'fine_labels'."""
    expected = _write_cifar100_archive(str(tmp_path))
    provider = cifar100.Provider(str(tmp_path), batch_size=4)

    images, labels = provider._load("train")
    assert images.shape == (12, 32, 32, 3)
    np.testing.assert_array_equal(labels, expected["train"][1])

    batches = list(provider.get_input_fn("train")())
    assert len(batches) == 3
    assert batches[0][0]["image"].shape == (4, 32, 32, 3)


def _flat(provider):
    def fn():
        for features, labels in provider.get_input_fn("train")():
            yield {"x": features["image"].reshape(len(labels), -1)}, labels

    return fn


def _port_estimator(model_dir, initial=False):
    from adanet_tpu_torch.core.estimator import Estimator
    from adanet_tpu_torch.core.heads import MultiClassHead
    from adanet_tpu_torch.examples.simple_dnn import Generator

    generator = Generator(optimizer_fn=lambda params: torch.optim.SGD(params, lr=0.01), layer_size=8, seed=0)
    if initial:
        generator = WithInitialVariables(generator, 32 * 32 * 3, 10)
    return Estimator(head=MultiClassHead(n_classes=10), subnetwork_generator=generator, max_iteration_steps=5,
                     model_dir=str(model_dir), device="cpu")


def test_cifar10_archive_trains_an_estimator(tmp_path):
    """The archive feeds a real (tiny) AdaNet search end to end."""
    _write_cifar10_archive(str(tmp_path), examples_per_batch=8)
    provider = cifar10.Provider(str(tmp_path), batch_size=8)
    estimator = _port_estimator(tmp_path / "model")
    estimator.train(_flat(provider), max_steps=5)
    metrics = estimator.evaluate(_flat(provider), steps=2)
    assert "loss" in metrics and np.isfinite(metrics["loss"])


def _jax_providers():
    from research.improve_nas.trainer import cifar10 as jax_cifar10
    from research.improve_nas.trainer import cifar100 as jax_cifar100

    return {"cifar10": jax_cifar10.Provider, "cifar100": jax_cifar100.Provider}


@pytest.mark.parametrize("dataset", ["cifar10", "cifar100"])
def test_batches_are_the_jax_providers(tmp_path, dataset):
    if dataset == "cifar10":
        _write_cifar10_archive(str(tmp_path), examples_per_batch=24, seed=3)
        port = cifar10.Provider(str(tmp_path), batch_size=16, seed=5)
    else:
        _write_cifar100_archive(str(tmp_path), examples=40, seed=4)
        port = cifar100.Provider(str(tmp_path), batch_size=8, seed=5)
    want = _jax_providers()[dataset](str(tmp_path), batch_size=port._batch_size, seed=5)
    assert port.num_classes == want.num_classes
    for partition in ("train", "test"):
        got_fn, want_fn = port.get_input_fn(partition), want.get_input_fn(partition)
        for _ in range(2):  # two epochs: each reseeds with seed + epoch
            got, ref = list(got_fn()), list(want_fn())
            assert len(got) == len(ref) > 0
            for (gf, gl), (wf, wl) in zip(got, ref):
                assert gf["image"].dtype == wf["image"].dtype == np.float32
                np.testing.assert_array_equal(gf["image"], wf["image"])
                np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("dataset", ["cifar10", "cifar100"])
def test_trainer_runs_cifar_archives_on_the_cpu(tmp_path, capsys, dataset):
    data = tmp_path / "data"
    if dataset == "cifar10":
        _write_cifar10_archive(str(data), examples_per_batch=8)
    else:
        _write_cifar100_archive(str(data), examples=40)
    argv = ["--dataset=%s" % dataset, "--data_dir=%s" % data, "--num_cells=3", "--num_conv_filters=4",
            "--boosting_iterations=2", "--train_steps=8", "--batch_size=8", "--device=cpu",
            "--model_dir", str(tmp_path / "model")]
    assert trainer.main(argv) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["global_step"] == 8
    assert 0.0 <= metrics["accuracy"] <= 1.0 and np.isfinite(metrics["loss"])
    assert metrics["best_ensemble"].startswith("t1_NasNet_A_3_4")
    for t in (0, 1):
        assert os.path.exists(tmp_path / "model" / ("architecture-%d.json" % t))


def test_cifar10_cnn_tutorial_takes_data_dir(tmp_path, capsys):
    from adanet_tpu_torch.examples.tutorials import cifar10_cnn

    _write_cifar10_archive(str(tmp_path / "data"), examples_per_batch=16)
    metrics = cifar10_cnn.main(["--data_dir=%s" % (tmp_path / "data"), "--max_steps=4", "--iterations=2",
                                "--batch_size=8", "--channels=4", "--model_dir=%s" % (tmp_path / "m"),
                                "--device=cpu"])
    assert "No --data_dir" not in capsys.readouterr().out
    assert np.isfinite(metrics["loss"]) and metrics["global_step"] == 4


def test_cifar10_archive_search_matches_jax(tmp_path):
    """The slice as a whole: tests/test_cifar_archives.py::
    test_cifar10_archive_trains_an_estimator in both packages, every
    candidate from the same simple_dnn variables."""
    import adanet_tpu
    from adanet_tpu.examples import simple_dnn as jax_simple_dnn
    from research.improve_nas.trainer import cifar10 as jax_cifar10

    _write_cifar10_archive(str(tmp_path), examples_per_batch=8)
    jax_provider = jax_cifar10.Provider(str(tmp_path), batch_size=8)
    want_est = adanet_tpu.Estimator(
        head=adanet_tpu.MultiClassHead(n_classes=10),
        subnetwork_generator=WithInitialVariables(
            jax_simple_dnn.Generator(optimizer_fn=lambda: optax.sgd(0.01), layer_size=8, seed=0),
            32 * 32 * 3, 10, convert=lambda v: v),
        max_iteration_steps=5,
        model_dir=str(tmp_path / "jax"),
    )
    want_est.train(_flat(jax_provider), max_steps=5)
    want = want_est.evaluate(_flat(jax_provider), steps=2)

    port_provider = cifar10.Provider(str(tmp_path), batch_size=8)
    got_est = _port_estimator(tmp_path / "torch", initial=True)
    got_est.train(_flat(port_provider), max_steps=5)
    got = got_est.evaluate(_flat(port_provider), steps=2)
    assert got["best_ensemble"] == want["best_ensemble"]
    assert got["global_step"] == want["global_step"] == 5
    for key in ("loss", "average_loss", "accuracy"):
        assert abs(got[key] - want[key]) <= 1e-4 * max(1.0, abs(want[key])), (key, got[key], want[key])
