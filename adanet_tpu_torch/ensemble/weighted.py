"""The AdaNet complexity-regularized ensembler, forward.

Port of adanet_tpu/ensemble/weighted.py: `build_ensemble` combines member
logits as `bias + sum_j w_j h_j` and computes the complexity term
`sum_j (lambda * r(h_j) + beta) * |w_j|_1`. SCALAR and VECTOR weights
multiply member logits; with `use_fused_combine` and same-shape
single-head logits (the JAX `_can_fuse` rule) the combine is one launch
of K1 (`ops/ensemble_kernels.py`) on the members' logits as they lie.
MATRIX weights right-multiply each member's last layer in full f32 (TF32
off, as the JAX package runs them at `Precision.HIGHEST`).

Parameters are `{"weights": [tensor per member], "bias": tensor or None}`
(`utils.convert.convert_ensembler_params`). Initialisation, warm start,
multi-head logits and training come with the training slice.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
from typing import Any, Dict, List, Optional

import torch

from adanet_tpu_torch.ops.ensemble_kernels import fused_weighted_combine_members


class MixtureWeightType(str, enum.Enum):
    """Mixture weight types (reference: adanet/ensemble/weighted.py:27-40)."""

    SCALAR = "scalar"
    VECTOR = "vector"
    MATRIX = "matrix"


@dataclasses.dataclass
class WeightedSubnetwork:
    subnetwork: Any
    weight: Any
    logits: Any


@dataclasses.dataclass
class ComplexityRegularized:
    """An AdaNet-weighted ensemble output."""

    weighted_subnetworks: List[WeightedSubnetwork]
    bias: Any
    logits: Any
    complexity_regularization: Any


@contextlib.contextmanager
def _full_f32_matmul():
    """TF32 off for the MATRIX combine (JAX: Precision.HIGHEST)."""
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous


class ComplexityRegularizedEnsembler:
    """Forward of the AdaNet mixture-weight ensembler."""

    def __init__(
        self,
        mixture_weight_type: MixtureWeightType = MixtureWeightType.SCALAR,
        adanet_lambda: float = 0.0,
        adanet_beta: float = 0.0,
        use_bias: bool = False,
        name: Optional[str] = None,
        use_fused_combine: bool = False,
    ):
        self._mixture_weight_type = MixtureWeightType(mixture_weight_type)
        self._adanet_lambda = float(adanet_lambda)
        self._adanet_beta = float(adanet_beta)
        self._use_bias = use_bias
        self._name = name
        self._use_fused_combine = use_fused_combine

    def to_spec(self) -> Dict[str, Any]:
        return {
            "mixture_weight_type": self._mixture_weight_type.value,
            "adanet_lambda": self._adanet_lambda,
            "adanet_beta": self._adanet_beta,
            "use_bias": self._use_bias,
            "name": self._name,
            "use_fused_combine": self._use_fused_combine,
        }

    @classmethod
    def from_spec(cls, spec: Dict[str, Any]) -> "ComplexityRegularizedEnsembler":
        return cls(**spec)

    # ----------------------------------------------------------------- apply

    def _weighted_logits(self, weight, subnetwork):
        """One member's weighted logits (reference: weighted.py:400-454)."""
        if self._mixture_weight_type != MixtureWeightType.MATRIX:
            return subnetwork.logits * weight
        last_layer = subnetwork.last_layer
        if last_layer.dim() > 3:
            raise NotImplementedError(
                "Last layers with more than 3 dimensions are not supported "
                "with matrix mixture weights."
            )
        with _full_f32_matmul():
            if last_layer.dim() == 3:
                b, t, d = last_layer.shape
                out = torch.matmul(last_layer.reshape(-1, d), weight)
                return out.reshape(b, t, weight.shape[-1])
            return torch.matmul(last_layer, weight)

    def _can_fuse(self, subnetworks) -> bool:
        if not self._use_fused_combine:
            return False
        if self._mixture_weight_type == MixtureWeightType.MATRIX:
            return False
        if isinstance(subnetworks[0].logits, dict):
            return False
        shape = subnetworks[0].logits.shape
        return all(s.logits.shape == shape for s in subnetworks)

    def _build_fused(self, weights, subnetworks, bias):
        """K1 path: one launch reads each member's logits where they lie
        (cast to f32 only where they are not, as the JAX path casts every
        member), with the weights prepared once per version by the
        wrapper; the per-member weighted logits are not materialised."""
        logits = fused_weighted_combine_members(
            [s.logits if s.logits.dtype is torch.float32 else s.logits.float() for s in subnetworks],
            weights,
            bias,
        )
        return ComplexityRegularized(
            weighted_subnetworks=[
                WeightedSubnetwork(subnetwork=s, weight=w, logits=None)
                for w, s in zip(weights, subnetworks)
            ],
            bias=bias,
            logits=logits,
            complexity_regularization=self._complexity_regularization(weights, subnetworks),
        )

    def build_ensemble(self, params, subnetworks, previous_ensemble=None):
        del previous_ensemble
        weights = params["weights"]
        if len(weights) != len(subnetworks):
            raise ValueError(
                "Got %d weights for %d subnetworks" % (len(weights), len(subnetworks))
            )
        if isinstance(subnetworks[0].logits, dict):
            raise NotImplementedError("multi-head ensembles come with a later slice")
        bias = params.get("bias") if self._use_bias else None
        if self._can_fuse(subnetworks):
            return self._build_fused(weights, subnetworks, bias)
        weighted = [
            WeightedSubnetwork(
                subnetwork=s, weight=w, logits=self._weighted_logits(w, s)
            )
            for w, s in zip(weights, subnetworks)
        ]
        logits = weighted[0].logits
        for ws in weighted[1:]:
            logits = logits + ws.logits
        if bias is not None:
            logits = logits + bias
        return ComplexityRegularized(
            weighted_subnetworks=weighted,
            bias=bias,
            logits=logits,
            complexity_regularization=self._complexity_regularization(weights, subnetworks),
        )

    def _adanet_gamma(self, complexity):
        """lambda * r(h) + beta (reference: weighted.py:363-369)."""
        if self._adanet_lambda == 0.0:
            return self._adanet_beta
        return self._adanet_lambda * torch.as_tensor(complexity, dtype=torch.float32) + self._adanet_beta

    def _complexity_regularization(self, weights, subnetworks):
        """sum_j (lambda r(h_j) + beta) |w_j|_1 (reference: weighted.py:563-604)."""
        device = weights[0].device if torch.is_tensor(weights[0]) else None
        total = torch.zeros((), dtype=torch.float32, device=device)
        if self._adanet_lambda == 0.0 and self._adanet_beta == 0.0:
            return total
        for weight, subnetwork in zip(weights, subnetworks):
            l1 = torch.sum(torch.abs(torch.as_tensor(weight).to(torch.float32)))
            gamma = self._adanet_gamma(subnetwork.complexity)
            if torch.is_tensor(gamma):
                gamma = gamma.to(l1.device)
            total = total + gamma * l1
        return total
