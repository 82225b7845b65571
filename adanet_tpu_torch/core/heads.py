"""Heads: task abstractions mapping logits to loss, predictions, metrics.

Port of adanet_tpu/core/heads.py: the `Head` base and `MultiClassHead`
(loss, predictions, eval metrics with top-k accuracy). The regression,
binary, multi-label and multi-head heads come with a later slice. Labels
are integer tensors of shape [B] (or [B, 1]); weights, where given, are
per-example [B] or [B, 1].
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Optional, Union

import torch
import torch.nn.functional as F


class Head(abc.ABC):
    """Computes loss, predictions and eval metrics from logits."""

    def __init__(self, name: str = "head"):
        self._name = name

    @property
    def name(self) -> str:
        return self._name

    @property
    @abc.abstractmethod
    def logits_dimension(self) -> Union[int, Dict[str, int]]:
        """Logits dimension subnetworks must produce."""

    @abc.abstractmethod
    def loss(self, logits, labels, weights=None):
        """Scalar mean training loss (the Phi in AdaNet's Equation 4)."""

    @abc.abstractmethod
    def predictions(self, logits) -> Dict[str, Any]:
        """Dict of prediction tensors from logits."""

    def eval_metrics(self, logits, labels, weights=None) -> Dict[str, Any]:
        """Dict of per-batch scalar metrics; engines average over batches."""
        return {"average_loss": self.loss(logits, labels, weights)}

    @abc.abstractmethod
    def to_spec(self) -> Dict[str, Any]:
        """JSON-serialisable constructor arguments, with a `type` key."""


def _weighted_mean(values, weights):
    if weights is None:
        return torch.mean(values)
    weights = torch.as_tensor(weights, dtype=values.dtype, device=values.device)
    # Accept [batch] and [batch, 1] weight conventions alike.
    while weights.dim() > values.dim() and weights.shape[-1] == 1:
        weights = weights.squeeze(-1)
    weights = torch.broadcast_to(weights, values.shape)
    return torch.sum(values * weights) / torch.clamp(torch.sum(weights), min=1e-12)


def _broadcast_weights(weights, target):
    """Per-example weights broadcast to a [batch, ...] target shape."""
    if weights is None:
        return None
    w = torch.as_tensor(weights, dtype=torch.float32, device=target.device)
    while w.dim() < target.dim():
        w = w[..., None]
    return torch.broadcast_to(w, target.shape)


def _check_logits_dimension(logits, expected: int, head_name: str) -> None:
    """Shape validation: a subnetwork whose logits have the wrong width
    fails here instead of mis-training. Rank-1 `(batch,)` logits
    (squeezed single-output) are accepted as they are."""
    if logits.dim() >= 2 and logits.shape[-1] != expected:
        raise ValueError(
            "%s expects logits with last dimension %d, got shape %s"
            % (head_name, expected, tuple(logits.shape))
        )


class MultiClassHead(Head):
    """Softmax cross-entropy head over `n_classes` with integer labels."""

    def __init__(
        self,
        n_classes: int,
        name: str = "multiclass_head",
        top_k: Optional[int] = None,
    ):
        """Args:
          n_classes: number of classes (logits dimension).
          top_k: emit a `top_<k>_accuracy` eval metric. Defaults to 5 when
            `n_classes > 5`, disabled otherwise; pass an explicit k to
            override.
        """
        super().__init__(name)
        if n_classes < 2:
            raise ValueError("n_classes must be >= 2, got %d" % n_classes)
        self._n_classes = n_classes
        if top_k is None:
            top_k = 5 if n_classes > 5 else 0
        if top_k < 0 or top_k > n_classes:
            raise ValueError("top_k=%d must be in [0, n_classes=%d]" % (top_k, n_classes))
        self._top_k = int(top_k)

    @property
    def logits_dimension(self) -> int:
        return self._n_classes

    def loss(self, logits, labels, weights=None):
        logits = logits.to(torch.float32)
        _check_logits_dimension(logits, self._n_classes, self.name)
        labels = torch.as_tensor(labels, device=logits.device).reshape(-1).long()
        per_example = F.cross_entropy(logits, labels, reduction="none")
        return _weighted_mean(per_example, weights)

    def predictions(self, logits):
        logits = logits.to(torch.float32)
        return {
            "logits": logits,
            "probabilities": torch.softmax(logits, dim=-1),
            # int32, the dtype of the JAX package's argmax.
            "class_ids": torch.argmax(logits, dim=-1).to(torch.int32),
        }

    def eval_metrics(self, logits, labels, weights=None):
        logits = logits.to(torch.float32)
        labels_i = torch.as_tensor(labels, device=logits.device).reshape(-1).long()
        accuracy = _weighted_mean((torch.argmax(logits, dim=-1) == labels_i).float(), weights)
        out = {"average_loss": self.loss(logits, labels, weights), "accuracy": accuracy}
        if self._top_k:
            # The label's logit must be among the k largest: count the
            # strictly larger logits (ties resolved optimistically, as
            # tf.math.in_top_k does).
            label_logit = torch.gather(logits, -1, labels_i[:, None])
            n_larger = torch.sum((logits > label_logit).float(), dim=-1)
            out["top_%d_accuracy" % self._top_k] = _weighted_mean(
                (n_larger < self._top_k).float(), weights
            )
        return out

    def to_spec(self) -> Dict[str, Any]:
        return {
            "type": "multiclass",
            "n_classes": self._n_classes,
            "name": self.name,
            "top_k": self._top_k,
        }


_HEADS = {"multiclass": MultiClassHead}


def head_from_spec(spec: Dict[str, Any]) -> Head:
    spec = dict(spec)
    kind = spec.pop("type")
    if kind not in _HEADS:
        raise ValueError("head type %r is not ported yet" % (kind,))
    return _HEADS[kind](**spec)
