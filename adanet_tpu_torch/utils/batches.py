"""Batch utilities shared by the training and evaluation paths.

Port of adanet_tpu/utils/batches.py, single process and without
example weights: `batch_metric_weight`, with its `weight_key` and its
multi-host gather, comes with them.
Batches come from an `input_fn` as numpy arrays (or tensors), nested in
dicts, lists and tuples, and `to_device` moves them to the device the
caller names; nothing is moved implicitly.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

#: Eval batches dispatched between host fetches of their metrics.
EVAL_FETCH_WINDOW = 32


def to_device(batch, device):
    """`batch` with every array leaf as a tensor on `device` (numpy arrays
    keep their dtype; tensors already there are not copied)."""
    if isinstance(batch, Mapping):
        return {key: to_device(value, device) for key, value in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(to_device(item, device) for item in batch)
    if isinstance(batch, np.ndarray) or np.isscalar(batch):
        return torch.as_tensor(np.asarray(batch)).to(device)
    if torch.is_tensor(batch):
        return batch.to(device)
    return batch


def _leaves(tree):
    if isinstance(tree, Mapping):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            yield from _leaves(item)
    else:
        yield tree


def feature_shape(features) -> Tuple[int, ...]:
    """One example's feature shape (without the batch dimension): of the
    features array, or of the only entry of a features mapping. Torch
    modules are built with it."""
    if isinstance(features, Mapping):
        if len(features) != 1:
            raise ValueError(
                "cannot tell the input shape of features with keys %s" % sorted(features)
            )
        (features,) = features.values()
    return tuple(int(d) for d in np.shape(features)[1:])


def batch_example_count(batch) -> int:
    """Number of examples in a (features, labels) batch: the leading
    dimension of the first array leaf."""
    for leaf in _leaves(batch):
        ndim = getattr(leaf, "ndim", None)
        if ndim is None:
            leaf = np.asarray(leaf)
            ndim = leaf.ndim
        if ndim >= 1:
            return int(leaf.shape[0])
    raise ValueError("Batch has no array leaves with a leading dimension.")


class WeightedMeanAccumulator:
    """Streams example-weighted means of per-batch metric means."""

    def __init__(self):
        self._totals: Dict[str, float] = {}
        self._examples = 0
        self._batches = 0

    @property
    def batches(self) -> int:
        return self._batches

    def add(self, metrics: Dict[str, float], example_count: float) -> None:
        """Accumulates one batch's metric means, weighted by its size."""
        for key, value in metrics.items():
            self._totals[key] = self._totals.get(key, 0.0) + float(value) * example_count
        self._examples += float(example_count)
        self._batches += 1

    def means(self) -> Dict[str, float]:
        if self._examples == 0:
            raise ValueError("No examples accumulated.")
        return {key: value / self._examples for key, value in self._totals.items()}
