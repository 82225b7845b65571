"""Batch utilities shared by the training and evaluation paths.

Port of adanet_tpu/utils/batches.py, single process:
`batch_metric_weight` (a batch's example count, or its total example
weight under a `weight_key`; the multi-host gather, `collective`, comes
with distributed placement). Batches come from an `input_fn` as numpy arrays (or tensors), nested in
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


def batch_metric_weight(batch, weight_key=None) -> float:
    """Aggregation weight of one batch for cross-batch metric averaging:
    the example count, or under `weight_key` the batch's total example
    weight (a batch's metric means are then weighted means over that
    total, as the reference's streamed `tf.metrics.mean(values,
    weights)`). The sum is taken on the host, from numpy or a tensor."""
    if weight_key is not None:
        features = batch[0] if isinstance(batch, tuple) else batch
        try:
            weights = features[weight_key]
        except (TypeError, KeyError, IndexError):
            weights = None
        if weights is not None:
            if torch.is_tensor(weights):
                weights = weights.detach().cpu().numpy()
            return float(np.sum(np.asarray(weights)))
    return float(batch_example_count(batch))


def read_scalars(tree: Mapping[str, Mapping[str, object]]) -> Dict[str, Dict[str, float]]:
    """`{outer: {inner: 0-d tensor or number}}` as Python floats, in one
    device-to-host copy (one `stack` of every value, then `tolist`), as
    the JAX package's single `device_get` of an eval step's results."""
    pairs = [(outer, inner, value) for outer, values in tree.items() for inner, value in values.items()]
    out: Dict[str, Dict[str, float]] = {outer: {} for outer in tree}
    if not pairs:
        return out
    tensors = [value for _, _, value in pairs if torch.is_tensor(value)]
    device = tensors[0].device if tensors else torch.device("cpu")
    stacked = torch.stack([
        torch.as_tensor(value, device=device).detach().to(torch.float32).reshape(()) for _, _, value in pairs
    ])
    for (outer, inner, _), value in zip(pairs, stacked.tolist()):
        out[outer][inner] = value
    return out


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
        """Accumulates one batch's metric means, weighted by its size
        (or its total example weight under `weight_key`)."""
        for key, value in metrics.items():
            self._totals[key] = self._totals.get(key, 0.0) + float(value) * example_count
        self._examples += float(example_count)
        self._batches += 1

    def means(self) -> Dict[str, float]:
        if self._examples == 0:
            raise ValueError("No examples accumulated.")
        return {key: value / self._examples for key, value in self._totals.items()}
