"""Ensemble and Ensembler interfaces.

TPU-native re-design of the reference ensembler API
(reference: adanet/ensemble/ensembler.py:26-150). The reference builds
mixture-weight variables inside a TF graph; here an `Ensembler` is a pair of
pure functions over pytrees: `init_ensemble` creates the trainable ensemble
parameters (e.g. mixture weights) from the *shapes* of member subnetwork
outputs, and `build_ensemble` combines concrete member outputs with those
parameters inside a jit-compiled step. `build_train_optimizer` supplies the
optax transform for the ensemble parameters (analogue of `build_train_op`,
reference: adanet/ensemble/ensembler.py:103-150).
"""

from __future__ import annotations

import abc
from typing import Any, Optional, Sequence


class Ensemble:
    """Marker base for ensemble output pytrees.

    Analogue of reference `adanet.ensemble.Ensemble`
    (reference: adanet/ensemble/ensembler.py:26-55). Concrete classes are
    flax.struct dataclasses (`ComplexityRegularized`, `MeanEnsemble`) and
    must expose a `logits` field (`jnp.ndarray`, or dict for multi-head) plus
    everything their ensembler needs to reconstruct predictions.
    """


class Ensembler(abc.ABC):
    """Interface for combining subnetworks into an ensemble.

    Analogue of reference `adanet.ensemble.Ensembler`
    (reference: adanet/ensemble/ensembler.py:58-150), functionalized for JAX.
    """

    @property
    @abc.abstractmethod
    def name(self) -> str:
        """This ensembler's name; appears in candidate/ensemble names."""

    @abc.abstractmethod
    def init_ensemble(
        self,
        rng,
        subnetworks: Sequence[Any],
        previous_params: Optional[Any] = None,
    ):
        """Creates the ensemble's trainable parameter pytree.

        Args:
          rng: `jax.random` key.
          subnetworks: member `Subnetwork`s, ordered first (oldest, from the
            previous ensemble) to most recent. May be abstract
            (`jax.eval_shape` outputs); only shapes/dtypes are read.
          previous_params: optional ensembler-specific structure holding the
            previously learned parameters for members kept from the previous
            ensemble, used for warm starting (e.g. for
            `ComplexityRegularizedEnsembler` a dict
            `{"weights": [w_or_None, ...], "bias": bias_or_None}` aligned
            with `subnetworks`). Analogue of `warm_start_mixture_weights`
            (reference: adanet/ensemble/weighted.py:259-283).

        Returns:
          A parameter pytree (possibly empty for parameterless ensemblers).
        """

    @abc.abstractmethod
    def build_ensemble(
        self,
        params,
        subnetworks: Sequence[Any],
        previous_ensemble: Optional[Any] = None,
    ) -> Ensemble:
        """Combines member outputs into an `Ensemble` pytree.

        Called inside jit. `subnetworks` are concrete `Subnetwork` outputs in
        the same order as `init_ensemble` saw them; gradients through member
        outputs are stopped by the engine, so only `params` receives
        gradients (the reference achieves the same via variable scoping,
        adanet/core/ensemble_builder.py:143-209).
        """

    def build_train_optimizer(self):
        """Returns the optax transform for the ensemble params, or None.

        None means the ensemble parameters are not trained (the reference
        returns `tf.no_op()`, adanet/ensemble/weighted.py:606-617), leaving
        e.g. uniform-average mixture weights.
        """
        return None
