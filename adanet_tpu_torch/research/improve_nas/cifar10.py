"""CIFAR-10 input pipeline.

Analogue of reference `cifar10.Provider`
(reference: research/improve_nas/trainer/cifar10.py:38-157): standardized
images, pad-and-crop + flip + cutout augmentation for training, plain
standardization for eval. Loads the python-pickle CIFAR-10 archive from a
local directory (this environment has no network egress; point `data_dir`
at an extracted `cifar-10-batches-py`).
"""

from __future__ import annotations

import os
import pickle
from typing import Iterator, Optional, Tuple

import numpy as np

from adanet_tpu_torch.research.improve_nas import image_processing

_MEAN = np.array([0.49139968, 0.48215841, 0.44653091], np.float32)
_STD = np.array([0.24703223, 0.24348513, 0.26158784], np.float32)


def _load_batch(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        obj = pickle.load(f, encoding="bytes")
    data = obj[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    labels = np.asarray(
        obj.get(b"labels", obj.get(b"fine_labels")), np.int32
    )
    return data.astype(np.float32) / 255.0, labels


class Provider:
    """CIFAR-10 batches with reference augmentation."""

    num_classes = 10

    def __init__(
        self,
        data_dir: str,
        batch_size: int = 32,
        seed: int = 42,
        use_cutout: bool = True,
    ):
        self._data_dir = data_dir
        self._batch_size = batch_size
        self._seed = seed
        self._use_cutout = use_cutout
        self._cache = {}

    def _load(self, partition: str):
        if partition in self._cache:
            return self._cache[partition]
        base = self._data_dir
        if os.path.isdir(os.path.join(base, "cifar-10-batches-py")):
            base = os.path.join(base, "cifar-10-batches-py")
        if partition == "train":
            files = [
                os.path.join(base, "data_batch_%d" % i) for i in range(1, 6)
            ]
        else:
            files = [os.path.join(base, "test_batch")]
        missing = [f for f in files if not os.path.exists(f)]
        if missing:
            raise FileNotFoundError(
                "CIFAR-10 files not found: %s. Download and extract "
                "cifar-10-python.tar.gz into %s (no network egress here)."
                % (missing, self._data_dir)
            )
        images, labels = zip(*[_load_batch(f) for f in files])
        data = (
            np.concatenate(images, axis=0),
            np.concatenate(labels, axis=0),
        )
        self._cache[partition] = data
        return data

    def _standardize(self, images: np.ndarray) -> np.ndarray:
        return (images - _MEAN) / _STD

    def get_input_fn(
        self,
        partition: str = "train",
        shuffle: Optional[bool] = None,
    ):
        """Zero-arg callable yielding ({'image': ...}, labels) batches.

        Each invocation (= each epoch; the Estimator re-invokes on
        exhaustion) reshuffles and re-augments with a fresh per-epoch seed,
        like the reference tf.data pipeline. Deterministic given the
        provider seed and epoch count since construction.
        """
        if shuffle is None:
            shuffle = partition == "train"
        augment = partition == "train"
        epoch_counter = {"epoch": 0}

        def input_fn() -> Iterator:
            epoch = epoch_counter["epoch"]
            epoch_counter["epoch"] += 1
            images, labels = self._load(partition)
            rng = np.random.RandomState(self._seed + epoch)
            order = np.arange(len(images))
            if shuffle:
                rng.shuffle(order)
            for start in range(0, len(order), self._batch_size):
                idx = order[start : start + self._batch_size]
                if len(idx) < self._batch_size:
                    return  # drop remainder: static shapes for XLA
                batch = images[idx]
                if augment:
                    batch = image_processing.augment_batch(
                        batch, rng, use_cutout=self._use_cutout
                    )
                yield (
                    {"image": self._standardize(batch)},
                    labels[idx],
                )

        return input_fn
