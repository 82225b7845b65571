"""Ensemble search strategies.

Faithful analogue of the reference strategies
(reference: adanet/ensemble/strategy.py:26-117): given this iteration's
candidate subnetwork builders and the members of the previous best ensemble,
produce the ensemble `Candidate`s to train and compare this iteration.
"""

from __future__ import annotations

import abc
from typing import Any, Optional, Sequence, Tuple


class Candidate:
    """An ensemble candidate found during the search phase.

    Analogue of reference `adanet.ensemble.Candidate`
    (reference: adanet/ensemble/strategy.py:26-48).

    Attributes:
      name: string name of this ensemble candidate.
      subnetwork_builders: `adanet_tpu_torch.subnetwork.Builder`s to train and
        include this iteration.
      previous_ensemble_subnetworks: frozen members (of the previous best
        ensemble) to keep; a subset is equivalent to pruning.
    """

    def __init__(
        self,
        name: str,
        subnetwork_builders: Sequence[Any],
        previous_ensemble_subnetworks: Optional[Sequence[Any]],
    ):
        self.name = name
        self.subnetwork_builders: Tuple[Any, ...] = tuple(subnetwork_builders)
        self.previous_ensemble_subnetworks: Tuple[Any, ...] = tuple(
            previous_ensemble_subnetworks or []
        )

    def __repr__(self):
        return "Candidate(name=%r, builders=%r, previous=%r)" % (
            self.name,
            [b.name for b in self.subnetwork_builders],
            len(self.previous_ensemble_subnetworks),
        )


class Strategy(abc.ABC):
    """An abstract ensemble strategy (reference: strategy.py:51-78)."""

    @abc.abstractmethod
    def generate_ensemble_candidates(
        self,
        subnetwork_builders: Sequence[Any],
        previous_ensemble_subnetworks: Optional[Sequence[Any]],
    ) -> Sequence[Candidate]:
        """Generates ensemble candidates to search over this iteration."""


class SoloStrategy(Strategy):
    """Each subnetwork alone — an ensemble of one.

    Analogue of reference `SoloStrategy` (strategy.py:81-96): equivalent to
    pruning all previous members and adding a single new subnetwork.
    """

    def generate_ensemble_candidates(
        self, subnetwork_builders, previous_ensemble_subnetworks
    ):
        del previous_ensemble_subnetworks
        return [
            Candidate("{}_solo".format(b.name), [b], None)
            for b in subnetwork_builders
        ]


class GrowStrategy(Strategy):
    """Greedily grows the ensemble, one subnetwork at a time.

    Analogue of reference `GrowStrategy` (strategy.py:99-108): one candidate
    per builder, each being previous members + that builder.
    """

    def generate_ensemble_candidates(
        self, subnetwork_builders, previous_ensemble_subnetworks
    ):
        return [
            Candidate(
                "{}_grow".format(b.name), [b], previous_ensemble_subnetworks
            )
            for b in subnetwork_builders
        ]


class AllStrategy(Strategy):
    """Ensembles all of this iteration's subnetworks together.

    Analogue of reference `AllStrategy` (strategy.py:111-117).
    """

    def generate_ensemble_candidates(
        self, subnetwork_builders, previous_ensemble_subnetworks
    ):
        return [
            Candidate(
                "all", subnetwork_builders, previous_ensemble_subnetworks
            )
        ]
