"""Search-space API: the `Subnetwork` record and the `Builder` interface.

Port of adanet_tpu/subnetwork/generator.py, forward parts only. The JAX
package makes `Subnetwork` a `flax.struct` pytree; here it is a plain
dataclass of tensors. A `Builder` returns an `nn.Module` whose
`forward(features, training=False)` returns a `Subnetwork`. Torch modules
are built with their input shapes known, so `build_subnetwork` takes the
feature shape as well. Optimizers, losses, reports and generators come
with the training slice.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Sequence


@dataclasses.dataclass
class Subnetwork:
    """An ensemble building block: the `h` in the AdaNet paper.

    Attributes:
      last_layer: output of the subnetwork's last hidden layer (used by
        MATRIX mixture weights).
      logits: logits of the shape the head expects.
      complexity: scalar r(h) entering the complexity regularization
        `(lambda * r(h) + beta) * |w|_1`.
      shared: small static payload shared with later iterations.
      extras: per-forward auxiliary outputs (e.g. aux-head logits).
    """

    last_layer: Any
    logits: Any
    complexity: Any = 0.0
    shared: Any = None
    extras: Any = None


class Builder(abc.ABC):
    """Interface for building one candidate subnetwork (forward parts).

    Builders must be deterministic: serving rebuilds a generation's
    members from their builder specs.
    """

    @property
    @abc.abstractmethod
    def name(self) -> str:
        """Unique name of this subnetwork within an iteration."""

    @abc.abstractmethod
    def build_subnetwork(
        self,
        logits_dimension,
        previous_ensemble=None,
        *,
        input_shape: Sequence[int],
    ):
        """Returns an `nn.Module`; `module(features, training=False)`
        returns a `Subnetwork`. `input_shape` is one example's feature
        shape (without the batch dimension)."""
