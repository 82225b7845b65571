"""Fake image data provider for hermetic workload tests.

Analogue of reference `FakeImageProvider`
(reference: research/improve_nas/trainer/fake_data.py:26-80): deterministic
random tiny images with the CIFAR feature layout.
"""

from __future__ import annotations

import numpy as np


class FakeImageProvider:
    """Deterministic random images shaped like a tiny CIFAR."""

    def __init__(
        self,
        num_examples: int = 64,
        image_size: int = 8,
        num_classes: int = 3,
        batch_size: int = 16,
        seed: int = 42,
    ):
        self._num_classes = num_classes
        self._batch_size = batch_size
        rng = np.random.RandomState(seed)
        self._images = rng.randn(num_examples, image_size, image_size, 3).astype(
            np.float32
        )
        self._labels = rng.randint(0, num_classes, size=(num_examples,)).astype(
            np.int32
        )

    @property
    def num_classes(self) -> int:
        return self._num_classes

    def get_input_fn(self, partition: str = "train"):
        del partition  # same data for train/test in the fake provider

        def input_fn():
            n = len(self._images)
            for start in range(0, n, self._batch_size):
                yield (
                    {"image": self._images[start : start + self._batch_size]},
                    self._labels[start : start + self._batch_size],
                )

        return input_fn
