"""AutoEnsemble: automatically ensemble arbitrary user models.

Port of adanet_tpu/autoensemble/__init__.py.
"""

from adanet_tpu_torch.autoensemble.common import AutoEnsembleSubestimator
from adanet_tpu_torch.autoensemble.estimator import AutoEnsembleEstimator
from adanet_tpu_torch.autoensemble.estimator import AutoEnsembleTPUEstimator

__all__ = [
    "AutoEnsembleEstimator",
    "AutoEnsembleSubestimator",
    "AutoEnsembleTPUEstimator",
]
