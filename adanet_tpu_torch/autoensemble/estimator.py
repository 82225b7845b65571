"""AutoEnsembleEstimator: ensemble arbitrary user models automatically.

Port of adanet_tpu/autoensemble/estimator.py: an `Estimator` whose
generator wraps a fixed pool of user `nn.Module`s. One class covers the
reference's `AutoEnsembleTPUEstimator` as well, which is an alias, as in
the JAX package.
"""

from __future__ import annotations

from adanet_tpu_torch.autoensemble.common import _GeneratorFromCandidatePool
from adanet_tpu_torch.core.estimator import Estimator


class AutoEnsembleEstimator(Estimator):
    """Learns to ensemble a pool of user models.

    Args:
      head: a `Head`.
      candidate_pool: dict of name -> candidate, list of candidates, or
        callable `(iteration_number) -> pool`. A candidate is an
        `AutoEnsembleSubestimator`, or a bare `nn.Module` (wrapped with
        the default optimizer).
      max_iteration_steps: steps per AdaNet iteration.
      **kwargs: forwarded to `Estimator` (ensemblers, ensemble_strategies,
        evaluator, force_grow, model_dir, device, ...).
    """

    def __init__(self, head, candidate_pool, max_iteration_steps: int, **kwargs):
        super().__init__(
            head=head,
            subnetwork_generator=_GeneratorFromCandidatePool(candidate_pool),
            max_iteration_steps=max_iteration_steps,
            **kwargs,
        )


# One class serves the card and the CPU; the reference's TPU class is an
# alias.
AutoEnsembleTPUEstimator = AutoEnsembleEstimator
