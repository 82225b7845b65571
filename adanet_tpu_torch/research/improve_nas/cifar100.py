"""CIFAR-100 input pipeline (reference: research/improve_nas/trainer/cifar100.py).

Same pipeline as cifar10 with the 100-class python-pickle archive
(`cifar-100-python`: files `train` and `test`, labels under b'fine_labels').
"""

from __future__ import annotations

import os

from adanet_tpu_torch.research.improve_nas import cifar10


class Provider(cifar10.Provider):
    """CIFAR-100 batches with reference augmentation."""

    num_classes = 100

    def _load(self, partition: str):
        if partition in self._cache:
            return self._cache[partition]
        base = self._data_dir
        if os.path.isdir(os.path.join(base, "cifar-100-python")):
            base = os.path.join(base, "cifar-100-python")
        filename = "train" if partition == "train" else "test"
        path = os.path.join(base, filename)
        if not os.path.exists(path):
            raise FileNotFoundError(
                "CIFAR-100 file not found: %s. Download and extract "
                "cifar-100-python.tar.gz into %s (no network egress here)."
                % (path, self._data_dir)
            )
        images, labels = cifar10._load_batch(path)
        self._cache[partition] = (images, labels)
        return self._cache[partition]
