"""Heads: task abstractions mapping logits to loss, predictions, metrics.

Port of adanet_tpu/core/heads.py: `RegressionHead` (mean squared
error), `BinaryClassificationHead` and `MultiLabelHead` (sigmoid
cross-entropy, as optax computes it, with accuracy, AUC, precision,
recall and the label and prediction means), `MultiClassHead` (softmax
cross-entropy with top-k accuracy) and `MultiHead` (dict logits, labels
and weights keyed by sub-head name, losses summed with `head_weights`,
predictions and metrics named `<head>/<key>`). Labels are reshaped to
the logits' shape ([B] and [B, 1] alike) except the multi-class head's
integer labels; weights, where given, are per-example [B] or [B, 1].
Every head has a `to_spec()` that `head_from_spec` rebuilds it from.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Mapping, Optional, Sequence, Union

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


def _binary_auc(probabilities, labels, weights=None):
    """Per-batch ROC AUC by the tie-corrected Mann-Whitney statistic:
    P(score(pos) > score(neg)), ties counted half, example-weighted. The
    scores are sorted once (stably) and each positive accumulates the
    negative weight strictly below it plus half the tied negative
    weight. A batch lacking one of the classes gives 0.5."""
    p = torch.as_tensor(probabilities).to(torch.float32).reshape(-1)
    y = torch.as_tensor(labels, device=p.device).to(torch.float32).reshape(-1)
    if weights is None:
        w = torch.ones_like(p)
    else:
        w = torch.as_tensor(weights, device=p.device).to(torch.float32).reshape(-1)
    pos_w = w * (y > 0.5).to(torch.float32)
    neg_w = w - pos_w
    order = torch.argsort(p, stable=True)
    sorted_p = p[order]
    sorted_pos_w = pos_w[order]
    sorted_neg_w = neg_w[order]
    # neg_below[k]: the negative weight of the first k sorted entries.
    neg_below = torch.cat([torch.zeros((1,), dtype=torch.float32, device=p.device), torch.cumsum(sorted_neg_w, 0)])
    left = torch.searchsorted(sorted_p, sorted_p, right=False)
    right = torch.searchsorted(sorted_p, sorted_p, right=True)
    strict = neg_below[left]
    tied = neg_below[right] - neg_below[left]
    numerator = torch.sum(sorted_pos_w * (strict + 0.5 * tied))
    n_pos = torch.sum(pos_w)
    n_neg = torch.sum(neg_w)
    defined = (n_pos > 0) & (n_neg > 0)
    return torch.where(
        defined, numerator / torch.clamp(n_pos * n_neg, min=1e-12), torch.full_like(numerator, 0.5)
    )


def _precision_recall(predicted, labels, weights=None):
    """(precision, recall) over {0, 1} tensors, optionally
    example-weighted; 0 where undefined."""
    predicted = predicted.to(torch.float32)
    labels = torch.as_tensor(labels, device=predicted.device).to(torch.float32)
    w = torch.ones_like(predicted) if weights is None else torch.as_tensor(weights).to(torch.float32)
    true_pos = torch.sum(w * predicted * labels)
    pred_pos = torch.sum(w * predicted)
    actual_pos = torch.sum(w * labels)
    zero = torch.zeros_like(true_pos)
    precision = torch.where(pred_pos > 0, true_pos / torch.clamp(pred_pos, min=1e-12), zero)
    recall = torch.where(actual_pos > 0, true_pos / torch.clamp(actual_pos, min=1e-12), zero)
    return precision, recall


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


def _labels_like(labels, logits):
    """Float labels in the logits' shape ([B] and [B, 1] alike)."""
    return torch.as_tensor(labels, device=logits.device).to(torch.float32).reshape(logits.shape)


class RegressionHead(Head):
    """Mean squared error regression head."""

    def __init__(self, label_dimension: int = 1, name: str = "regression_head"):
        super().__init__(name)
        self._label_dimension = label_dimension

    @property
    def logits_dimension(self) -> int:
        return self._label_dimension

    def loss(self, logits, labels, weights=None):
        _check_logits_dimension(logits, self._label_dimension, self.name)
        labels = _labels_like(labels, logits)
        per_example = torch.mean(torch.square(logits.to(torch.float32) - labels), dim=-1)
        return _weighted_mean(per_example, weights)

    def predictions(self, logits):
        return {"predictions": logits}

    def eval_metrics(self, logits, labels, weights=None):
        return {"average_loss": self.loss(logits, labels, weights)}

    def to_spec(self) -> Dict[str, Any]:
        return {"type": "regression", "label_dimension": self._label_dimension, "name": self.name}


def _sigmoid_cross_entropy(logits, labels):
    """optax's `sigmoid_binary_cross_entropy`, in its own arithmetic:
    -y log(sigmoid(x)) - (1 - y) log(sigmoid(-x))."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


class _SigmoidHead(Head):
    """Shared sigmoid cross-entropy body (independent labels per dimension)."""

    def __init__(self, logits_dimension: int, name: str):
        super().__init__(name)
        self._logits_dimension = logits_dimension

    @property
    def logits_dimension(self) -> int:
        return self._logits_dimension

    def loss(self, logits, labels, weights=None):
        logits = logits.to(torch.float32)
        _check_logits_dimension(logits, self._logits_dimension, self.name)
        labels = _labels_like(labels, logits)
        per_example = torch.mean(_sigmoid_cross_entropy(logits, labels), dim=-1)
        return _weighted_mean(per_example, weights)

    def eval_metrics(self, logits, labels, weights=None):
        """Accuracy, AUC, precision, recall, the label and prediction
        means and the majority-class baseline; for several labels, AUC,
        precision and recall are micro-averaged over (example, label)."""
        logits = logits.to(torch.float32)
        labels_f = _labels_like(labels, logits)
        probabilities = torch.sigmoid(logits)
        predicted = (logits > 0.0).to(torch.float32)
        accuracy = _weighted_mean(torch.mean((predicted == labels_f).to(torch.float32), dim=-1), weights)
        w_full = _broadcast_weights(weights, labels_f)
        precision, recall = _precision_recall(predicted, labels_f, w_full)
        label_mean = _weighted_mean(torch.mean(labels_f, dim=-1), weights)
        return {
            "average_loss": self.loss(logits, labels, weights),
            "accuracy": accuracy,
            "auc": _binary_auc(probabilities, labels_f, w_full),
            "precision": precision,
            "recall": recall,
            "label/mean": label_mean,
            "prediction/mean": _weighted_mean(torch.mean(probabilities, dim=-1), weights),
            # The accuracy of always predicting the majority class.
            "accuracy_baseline": torch.maximum(label_mean, 1.0 - label_mean),
        }


class BinaryClassificationHead(_SigmoidHead):
    """Sigmoid cross-entropy binary classification head (logits dim 1)."""

    def __init__(self, name: str = "binary_head"):
        super().__init__(1, name)

    def predictions(self, logits):
        probabilities = torch.sigmoid(logits.to(torch.float32))
        return {
            "logits": logits,
            "logistic": probabilities,
            "probabilities": torch.cat([1.0 - probabilities, probabilities], dim=-1),
            "class_ids": (probabilities > 0.5).to(torch.int32),
        }

    def to_spec(self) -> Dict[str, Any]:
        return {"type": "binary", "name": self.name}


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


class MultiLabelHead(_SigmoidHead):
    """Independent sigmoid cross-entropy over `n_classes` labels; labels
    are multi-hot [batch, n_classes]."""

    def __init__(self, n_classes: int, name: str = "multilabel_head"):
        if n_classes < 2:
            raise ValueError("n_classes must be >= 2, got %d" % n_classes)
        super().__init__(n_classes, name)

    def predictions(self, logits):
        logits = logits.to(torch.float32)
        probabilities = torch.sigmoid(logits)
        return {
            "logits": logits,
            "probabilities": probabilities,
            "class_ids": (probabilities > 0.5).to(torch.int32),
        }

    def to_spec(self) -> Dict[str, Any]:
        return {"type": "multilabel", "n_classes": self._logits_dimension, "name": self.name}


class MultiHead(Head):
    """Several heads over dict logits and labels keyed by each sub-head's
    name; the loss is the `head_weights`-weighted sum of the sub-heads'
    losses. Example weights, where given, are a dict too, and a sub-head
    without an entry is unweighted."""

    def __init__(
        self,
        heads: Sequence[Head],
        head_weights: Optional[Sequence[float]] = None,
        name: str = "multi_head",
    ):
        super().__init__(name)
        if not heads:
            raise ValueError("heads must be non-empty")
        names = [h.name for h in heads]
        if len(set(names)) != len(names):
            raise ValueError("Sub-head names must be unique, got %s" % names)
        if head_weights is not None and len(head_weights) != len(heads):
            raise ValueError("head_weights must align with heads")
        self._heads = list(heads)
        self._head_weights = list(head_weights) if head_weights is not None else [1.0] * len(heads)

    @property
    def heads(self) -> Sequence[Head]:
        return tuple(self._heads)

    @property
    def logits_dimension(self) -> Dict[str, int]:
        return {h.name: h.logits_dimension for h in self._heads}

    def loss(self, logits: Mapping[str, Any], labels, weights=None):
        total = 0.0
        for head, w in zip(self._heads, self._head_weights):
            total = total + w * head.loss(
                logits[head.name], labels[head.name], None if weights is None else weights.get(head.name)
            )
        return total

    def predictions(self, logits: Mapping[str, Any]):
        out = {}
        for head in self._heads:
            for key, value in head.predictions(logits[head.name]).items():
                out["%s/%s" % (head.name, key)] = value
        return out

    def eval_metrics(self, logits: Mapping[str, Any], labels, weights=None):
        out = {"average_loss": self.loss(logits, labels, weights)}
        for head in self._heads:
            sub = head.eval_metrics(
                logits[head.name], labels[head.name], None if weights is None else weights.get(head.name)
            )
            for key, value in sub.items():
                out["%s/%s" % (head.name, key)] = value
        return out

    def to_spec(self) -> Dict[str, Any]:
        return {
            "type": "multi_head",
            "heads": [h.to_spec() for h in self._heads],
            "head_weights": list(self._head_weights),
            "name": self.name,
        }


_HEADS = {
    "regression": RegressionHead,
    "binary": BinaryClassificationHead,
    "multiclass": MultiClassHead,
    "multilabel": MultiLabelHead,
}


def head_from_spec(spec: Dict[str, Any]) -> Head:
    """The head a `to_spec()` describes."""
    spec = dict(spec)
    kind = spec.pop("type")
    if kind == "multi_head":
        return MultiHead([head_from_spec(h) for h in spec.pop("heads")], **spec)
    if kind not in _HEADS:
        raise ValueError("unknown head type %r" % (kind,))
    return _HEADS[kind](**spec)
