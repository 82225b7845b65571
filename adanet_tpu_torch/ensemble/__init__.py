"""Ensembling: the ensembler interface, strategies and ensemblers."""

from adanet_tpu_torch.ensemble.mean import MeanEnsemble, MeanEnsembler  # noqa: F401
from adanet_tpu_torch.ensemble.strategy import AllStrategy, GrowStrategy, SoloStrategy  # noqa: F401
from adanet_tpu_torch.ensemble.weighted import (  # noqa: F401
    ComplexityRegularizedEnsembler,
    MixtureWeightType,
)


def ensembler_from_spec(spec):
    """The ensembler a serving generation's `to_spec()` records: a mean
    ensembler (`"kind": "mean"`) or a complexity-regularized one."""
    if spec.get("kind") == "mean":
        return MeanEnsembler.from_spec(spec)
    return ComplexityRegularizedEnsembler.from_spec(spec)
