"""Uniform-average ensembler.

Port of adanet_tpu/ensemble/mean.py: the ensemble logits are the mean of
the members' logits (of each key's, for dict logits), and optionally the
members' mean last layer is exposed as a prediction. It has no
parameters (`init_ensemble` returns `{}`) and nothing to train
(`build_train_optimizer` returns None), so a mean candidate launches no
kernel: JAX has none there either.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from adanet_tpu_torch.ensemble.ensembler import Ensemble, Ensembler

MEAN_LAST_LAYER = "mean_last_layer"


@dataclasses.dataclass
class MeanEnsemble(Ensemble):
    """Mean-of-logits ensemble output.

    Attributes:
      logits: the mean of the members' logits (a dict for multi-head).
      subnetworks: the members' `Subnetwork` outputs.
      predictions: `{"mean_last_layer": ...}` with
        `add_mean_last_layer_predictions`, else None.
    """

    logits: Any
    subnetworks: List[Any]
    predictions: Optional[Any] = None


def _mean(tensors):
    return torch.mean(torch.stack(list(tensors), dim=0), dim=0)


def _mean_tree(values):
    """The mean of `values` (tensors, or dicts of tensors by key)."""
    if isinstance(values[0], dict):
        return {key: _mean([v[key] for v in values]) for key in sorted(values[0])}
    return _mean(values)


class MeanEnsembler(Ensembler):
    """Averages the members' logits uniformly."""

    def __init__(self, name: Optional[str] = None, add_mean_last_layer_predictions: bool = False):
        self._name = name
        self._add_mean_last_layer_predictions = add_mean_last_layer_predictions

    @property
    def name(self) -> str:
        return self._name or "mean"

    def to_spec(self) -> Dict[str, Any]:
        return {
            "kind": "mean",
            "name": self._name,
            "add_mean_last_layer_predictions": self._add_mean_last_layer_predictions,
        }

    @classmethod
    def from_spec(cls, spec: Dict[str, Any]) -> "MeanEnsembler":
        spec = dict(spec)
        spec.pop("kind", None)
        return cls(**spec)

    def init_ensemble(self, generator, subnetworks, previous_params=None):
        del generator, subnetworks, previous_params
        return {}

    def build_ensemble(self, params, subnetworks, previous_ensemble=None):
        del params, previous_ensemble
        logits = _mean_tree([s.logits for s in subnetworks])
        predictions = None
        if self._add_mean_last_layer_predictions:
            predictions = {MEAN_LAST_LAYER: _mean_tree([s.last_layer for s in subnetworks])}
        return MeanEnsemble(logits=logits, subnetworks=list(subnetworks), predictions=predictions)
