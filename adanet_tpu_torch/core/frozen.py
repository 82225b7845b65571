"""Frozen records of trained subnetworks and winning ensembles.

Port of adanet_tpu/core/frozen.py over torch modules. A frozen member
holds its `nn.Module` (parameters included, in eval mode) rather than a
Flax module plus a parameter tree, and the builder spec that rebuilds it
(`Builder.to_spec()`), which a serving generation records. The search
loop freezes an iteration's winner into these records
(`Iteration.freeze_candidate`): they are the `previous_ensemble` of the
next iteration and what `Estimator.evaluate` runs. A fresh process
rebuilds them instead (`rebuild_subnetwork`): the module from the
replayed builder, its numbers from the frozen payload
(`checkpoint.payload_into_frozen`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import torch

from adanet_tpu_torch.core.architecture import Architecture


@dataclasses.dataclass
class FrozenSubnetwork:
    """A trained, frozen subnetwork.

    Attributes:
      iteration_number: iteration that trained this subnetwork.
      name: its builder's name.
      module: the `nn.Module` holding its parameters.
      complexity: its scalar complexity r(h).
      shared: the `Subnetwork.shared` payload recorded at freeze time.
      builder_spec: the builder's `to_spec()`, enough to rebuild `module`
        given the feature shape.
    """

    iteration_number: int
    name: str
    module: Any
    complexity: Any = 0.0
    shared: Any = None
    builder_spec: Optional[Dict[str, Any]] = None

    def apply(self, features, training: bool = False):
        """Runs the frozen subnetwork's forward pass."""
        with torch.inference_mode(not training):
            return self.module(features, training=training)


def rebuild_subnetwork(
    builder, iteration_number: int, logits_dimension, previous_ensemble, input_shape
) -> FrozenSubnetwork:
    """A frozen member's record rebuilt from its builder: the module as
    `build_subnetwork` makes it (no gradients, eval mode), its numbers
    still the builder's initial ones until a payload is loaded onto it;
    the builder spec when the builder has one."""
    module = builder.build_subnetwork(
        logits_dimension, previous_ensemble=previous_ensemble, input_shape=tuple(input_shape)
    )
    module.requires_grad_(False).eval()
    to_spec = getattr(builder, "to_spec", None)
    return FrozenSubnetwork(
        iteration_number=iteration_number,
        name=builder.name,
        module=module,
        builder_spec=to_spec() if to_spec is not None else None,
    )


@dataclasses.dataclass
class FrozenWeightedSubnetwork:
    """A frozen member with its learned mixture weight."""

    subnetwork: FrozenSubnetwork
    weight: Any = None


@dataclasses.dataclass
class FrozenEnsemble:
    """The frozen winning ensemble of an iteration.

    Attributes:
      name: ensemble candidate name.
      iteration_number: the iteration this ensemble won.
      weighted_subnetworks: frozen members with learned weights, oldest first.
      ensembler_name: name of the ensembler that combined the members.
      ensembler_params: `{"weights": [...], "bias": ...}` tensors.
      architecture: the serializable `Architecture` record.
      final_ema: the training-loss EMA this ensemble finished its
        iteration with; the carried-over candidate of the next iteration
        competes at it.
    """

    name: str
    iteration_number: int
    weighted_subnetworks: List[FrozenWeightedSubnetwork]
    ensembler_name: str
    ensembler_params: Any
    architecture: Architecture
    final_ema: Optional[float] = None

    @property
    def subnetworks(self) -> Sequence[FrozenSubnetwork]:
        return tuple(ws.subnetwork for ws in self.weighted_subnetworks)

    def member_outputs(self, features, training: bool = False):
        """Forward passes of every frozen member on `features`."""
        return [
            ws.subnetwork.apply(features, training=training)
            for ws in self.weighted_subnetworks
        ]
