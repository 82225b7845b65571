"""Heads: task abstractions mapping logits to predictions.

Port of adanet_tpu/core/heads.py, serving parts: the `Head` base and
`MultiClassHead.predictions`. Losses, eval metrics and the other heads
come with the training slice.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Union

import torch


class Head(abc.ABC):
    """Computes predictions (and, later, loss and metrics) from logits."""

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
    def predictions(self, logits) -> Dict[str, Any]:
        """Dict of prediction tensors from logits."""

    @abc.abstractmethod
    def to_spec(self) -> Dict[str, Any]:
        """JSON-serialisable constructor arguments, with a `type` key."""


class MultiClassHead(Head):
    """Softmax head over `n_classes` with integer labels."""

    def __init__(self, n_classes: int, name: str = "multiclass_head"):
        super().__init__(name)
        if n_classes < 2:
            raise ValueError("n_classes must be >= 2, got %d" % n_classes)
        self._n_classes = n_classes

    @property
    def logits_dimension(self) -> int:
        return self._n_classes

    def predictions(self, logits):
        logits = logits.to(torch.float32)
        return {
            "logits": logits,
            "probabilities": torch.softmax(logits, dim=-1),
            # int32, the dtype of the JAX package's argmax.
            "class_ids": torch.argmax(logits, dim=-1).to(torch.int32),
        }

    def to_spec(self) -> Dict[str, Any]:
        return {
            "type": "multiclass",
            "n_classes": self._n_classes,
            "name": self.name,
        }


_HEADS = {"multiclass": MultiClassHead}


def head_from_spec(spec: Dict[str, Any]) -> Head:
    spec = dict(spec)
    kind = spec.pop("type")
    if kind not in _HEADS:
        raise ValueError("head type %r is not ported yet" % (kind,))
    return _HEADS[kind](**spec)
