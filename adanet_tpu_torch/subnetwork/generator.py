"""Search-space API: subnetworks, builders and generators.

Port of adanet_tpu/subnetwork/generator.py. The JAX package makes
`Subnetwork` a `flax.struct` pytree; here it is a plain dataclass of
tensors. A `Builder` returns an `nn.Module` whose
`forward(features, training=False)` returns a `Subnetwork` (a module that
draws dropout masks also takes `generator=`, the `torch.Generator` the
engine passes to a training forward), and a factory
`params -> torch.optim.Optimizer` where the JAX builder returns an optax
transform. Torch modules are built with their input shapes known, so
`build_subnetwork` takes the feature shape as well. A module with an
`init_parameters(generator)` method is initialised by the engine from
the Estimator's seed after it is built.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, List, Optional, Sequence


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
    """Interface for building one candidate subnetwork.

    Builders must be deterministic: the engine and serving rebuild a
    generation's members from their builders.
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

    def build_train_optimizer(self, previous_ensemble=None):
        """Returns a factory `params -> torch.optim.Optimizer` that trains
        this subnetwork's parameters on its own loss (the JAX builder's
        optax transform)."""
        raise NotImplementedError("builder %r cannot be trained" % self.name)

    def build_subnetwork_report(self):
        """Optionally returns a `Report` of hparams/attributes/metrics;
        None means no report for this subnetwork."""
        return None

    def build_subnetwork_loss(self, subnetwork, labels, head, context):
        """Optional custom training loss for this subnetwork.

        Returns a scalar loss tensor, or None to use
        `head.loss(logits, labels)`. `context` carries teacher signals
        for distillation (None in this slice).
        """
        del subnetwork, labels, head, context
        return None

    def build_subnetwork_summaries(self, subnetwork, features, labels):
        """Optional per-step summary tensors for this subnetwork: a dict
        of tag to tensor, or None. Scalars are written as scalar
        summaries, higher-rank tensors as histograms, under
        `<model_dir>/subnetwork/t<t>_<name>/` at the estimator's
        `log_every_steps` cadence."""
        del subnetwork, features, labels
        return None


class Generator(abc.ABC):
    """Interface for generating the candidate pool each iteration.

    Implementations must be deterministic given the same arguments.
    """

    @abc.abstractmethod
    def generate_candidates(
        self,
        previous_ensemble,
        iteration_number: int,
        previous_ensemble_reports: Sequence[Any],
        all_reports: Sequence[Any],
        config: Optional[Any] = None,
    ) -> List[Builder]:
        """Generates `Builder`s to train this iteration.

        Args:
          previous_ensemble: frozen winning `FrozenEnsemble` of iteration
            t-1, or None at t=0.
          iteration_number: zero-based iteration (boosting round) t.
          previous_ensemble_reports: `MaterializedReport`s of members of the
            previous best ensemble.
          all_reports: all `MaterializedReport`s from all previous
            iterations.
          config: optional run configuration.

        Returns:
          A list of `Builder` instances with unique names.
        """


class SimpleGenerator(Generator):
    """Generates the same fixed pool of builders every iteration."""

    def __init__(self, subnetwork_builders: Sequence[Builder]):
        if not subnetwork_builders:
            raise ValueError("subnetwork_builders must be non-empty.")
        names = [b.name for b in subnetwork_builders]
        if len(set(names)) != len(names):
            raise ValueError("Builder names must be unique, got %s" % names)
        self._builders = list(subnetwork_builders)

    def generate_candidates(
        self,
        previous_ensemble,
        iteration_number,
        previous_ensemble_reports,
        all_reports,
        config=None,
    ) -> List[Builder]:
        del previous_ensemble, iteration_number  # fixed pool
        del previous_ensemble_reports, all_reports, config
        return list(self._builders)
