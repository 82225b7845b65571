"""The port's native augmentation library (`ops/native_augment.py` over
its copy of the C++ source, `ops/csrc/augment.cc`) against the numpy
oracle and the JAX package's binding.

- Copies of tests/test_native_augment.py's test_native_builds,
  test_native_matches_numpy_exactly,
  test_native_matches_numpy_no_cutout_and_edge_offsets and
  test_augment_batch_backends_agree.
- The port's native output bitwise equal to the JAX binding's, and its
  source byte for byte `csrc/augment.cc`; its library is built under
  `adanet_tpu_torch/ops/.build/`.
"""

import os

import numpy as np

from adanet_tpu_torch.ops import native_augment
from adanet_tpu_torch.research.improve_nas import image_processing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _images(n=32, h=32, w=32, c=3, seed=0):
    return np.random.RandomState(seed).rand(n, h, w, c).astype(np.float32)


def test_native_builds():
    assert native_augment.get_lib() is not None, "g++ build failed"
    assert os.path.dirname(native_augment._SO) == os.path.join(REPO, "adanet_tpu_torch", "ops", ".build")


def test_native_matches_numpy_exactly():
    images = _images()
    rng = np.random.RandomState(1)
    n, h, w, _ = images.shape
    offsets = image_processing.sample_offsets(n, h, w, rng, pad=4)
    native = native_augment.augment_apply(images, *offsets, pad=4, cutout=16)
    oracle = image_processing.apply_numpy(images, *offsets, pad=4, cutout=16)
    np.testing.assert_array_equal(native, oracle)


def test_native_matches_numpy_no_cutout_and_edge_offsets():
    images = _images(n=4, h=8, w=8)
    n, h, w, _ = images.shape
    # Extreme offsets: full-pad shifts, all flips on.
    tops = np.full(n, 8, np.int32)
    lefts = np.zeros(n, np.int32)
    flips = np.ones(n, np.uint8)
    cys = np.zeros(n, np.int32)
    cxs = np.full(n, w - 1, np.int32)
    native = native_augment.augment_apply(images, tops, lefts, flips, cys, cxs, pad=4, cutout=0)
    oracle = image_processing.apply_numpy(images, tops, lefts, flips, cys, cxs, pad=4, cutout=0)
    np.testing.assert_array_equal(native, oracle)


def test_augment_batch_backends_agree():
    images = _images(n=8)
    out_native = image_processing.augment_batch(images, np.random.RandomState(7), backend="native")
    out_numpy = image_processing.augment_batch(images, np.random.RandomState(7), backend="numpy")
    np.testing.assert_array_equal(out_native, out_numpy)


def test_native_matches_the_jax_binding():
    from adanet_tpu.ops import native_augment as jax_native
    from research.improve_nas.trainer import image_processing as jax_processing

    images = _images(n=64, seed=3)
    for pad, cutout, seed in ((4, 16, 1), (4, 0, 2), (2, 8, 3)):
        n, h, w, _ = images.shape
        offsets = image_processing.sample_offsets(n, h, w, np.random.RandomState(seed), pad=pad)
        got = native_augment.augment_apply(images, *offsets, pad=pad, cutout=cutout)
        want = jax_native.augment_apply(images, *offsets, pad=pad, cutout=cutout)
        assert got is not None and want is not None
        np.testing.assert_array_equal(got, want)
    got = image_processing.augment_batch(images, np.random.RandomState(9))
    want = jax_processing.augment_batch(images, np.random.RandomState(9))
    np.testing.assert_array_equal(got, want)


def test_augment_source_is_the_jax_packages():
    with open(os.path.join(REPO, "adanet_tpu_torch", "ops", "csrc", "augment.cc"), "rb") as f:
        port = f.read()
    with open(os.path.join(REPO, "csrc", "augment.cc"), "rb") as f:
        original = f.read()
    assert port == original
