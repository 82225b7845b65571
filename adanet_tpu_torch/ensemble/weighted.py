"""The AdaNet complexity-regularized ensembler.

Port of adanet_tpu/ensemble/weighted.py: `build_ensemble` combines member
logits as `bias + sum_j w_j h_j` and computes the complexity term
`sum_j (lambda * r(h_j) + beta) * |w_j|_1`. SCALAR and VECTOR weights
multiply member logits; with `use_fused_combine` and same-shape
single-head logits (the JAX `_can_fuse` rule) the combine is one launch
of K1 (`ops/ensemble_kernels.py`) on the members' logits as they lie.
Under autograd the member weights are stacked into K1's
`torch.autograd.Function`, whose backward gives each member its
gradient. MATRIX weights right-multiply each member's last layer in full
f32 (TF32 off, as the JAX package runs them at `Precision.HIGHEST`).

Parameters are `{"weights": [tensor per member]}` plus `"bias"` with
`use_bias` (`init_ensemble`; `utils.convert.convert_ensembler_params`
carries the JAX package's across): 1/N for SCALAR and VECTOR weights,
zeros for MATRIX ones and the bias, or warm-started from the previous
ensemble's, or from `mixture_weight_initializer(generator, shape,
dtype)`. The optimizer is a factory `params -> torch.optim.Optimizer`
(or None: the weights keep their init). Multi-head (dict) logits get a
weight and a bias per sorted key, and the complexity term is summed over
the keys; as in JAX, dict logits and MATRIX weights never take the fused
combine, so a multi-head candidate launches no K1.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
from typing import Any, Dict, List, Optional

import torch

from adanet_tpu_torch.ensemble.ensembler import Ensemble, Ensembler
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
class ComplexityRegularized(Ensemble):
    """An AdaNet-weighted ensemble output."""

    weighted_subnetworks: List[WeightedSubnetwork]
    bias: Any
    logits: Any
    complexity_regularization: Any


def _sorted_keys(maybe_dict):
    return sorted(maybe_dict) if isinstance(maybe_dict, dict) else None


def _lookup(maybe_dict, key):
    return maybe_dict[key] if key is not None else maybe_dict


def _first_tensor(tree):
    return next(iter(tree.values())) if isinstance(tree, dict) else tree


@contextlib.contextmanager
def full_f32_matmul():
    """TF32 off for f32 matrix products and convolutions: the MATRIX
    combine (JAX: Precision.HIGHEST) and the training and eval steps'
    Dense and convolution layers (cuDNN's TF32 is on by torch's default,
    which would run an f32 convolution at a 10-bit mantissa)."""
    previous = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = previous


class ComplexityRegularizedEnsembler(Ensembler):
    """Learns mixture weights minimizing the complexity-regularized loss.

    Args (those of the JAX ensembler):
      optimizer: a factory `params -> torch.optim.Optimizer`, or None
        (the mixture weights keep their init, as the reference's no-op
        train op leaves them).
      mixture_weight_type: a `MixtureWeightType`.
      mixture_weight_initializer: `fn(generator, shape, dtype) -> tensor`
        replacing the default init (1/N, or zeros for MATRIX); it draws
        from the CPU generator the engine passes to `init_ensemble`.
      warm_start_mixture_weights: initialize the weights of members kept
        from the previous ensemble from their learned values.
      adanet_lambda, adanet_beta: the complexity penalty's lambda and beta.
      use_bias: add a trainable bias to the ensemble logits.
      name: defaults to "complexity_regularized".
      use_fused_combine: combine SCALAR/VECTOR weights through K1.
    """

    def __init__(
        self,
        optimizer=None,
        mixture_weight_type: MixtureWeightType = MixtureWeightType.SCALAR,
        mixture_weight_initializer=None,
        warm_start_mixture_weights: bool = False,
        adanet_lambda: float = 0.0,
        adanet_beta: float = 0.0,
        use_bias: bool = False,
        name: Optional[str] = None,
        use_fused_combine: bool = False,
    ):
        self._optimizer = optimizer
        self._mixture_weight_type = MixtureWeightType(mixture_weight_type)
        self._mixture_weight_initializer = mixture_weight_initializer
        self._warm_start_mixture_weights = warm_start_mixture_weights
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

    @property
    def name(self) -> str:
        return self._name or "complexity_regularized"

    # ------------------------------------------------------------------ init

    def _weight_shape(self, subnetwork, key=None):
        """Weight shape per type (reference: weighted.py:417-426)."""
        logits_size = _lookup(subnetwork.logits, key).shape[-1]
        if self._mixture_weight_type == MixtureWeightType.SCALAR:
            return ()
        if self._mixture_weight_type == MixtureWeightType.VECTOR:
            return (logits_size,)
        last_layer = _lookup(subnetwork.last_layer, key)
        if last_layer is None:
            raise ValueError("MATRIX mixture weights require subnetworks to expose last_layer.")
        return (last_layer.shape[-1], logits_size)

    def _init_one_weight(self, generator, subnetwork, n, device, key=None):
        shape = self._weight_shape(subnetwork, key)
        if self._mixture_weight_initializer is not None:
            w = self._mixture_weight_initializer(generator, shape, torch.float32)
        elif self._mixture_weight_type == MixtureWeightType.MATRIX:
            w = torch.zeros(shape, dtype=torch.float32)
        else:
            w = torch.full(shape, 1.0 / n, dtype=torch.float32)
        return torch.as_tensor(w, dtype=torch.float32).to(device)

    def init_ensemble(self, generator, subnetworks, previous_params=None):
        """Returns `{"weights": [...]}` (plus `"bias"` with `use_bias`)
        f32 tensors on the members' device; for dict logits each weight
        and the bias are dicts by sorted key.

        `previous_params["weights"]` is aligned with `subnetworks`; its
        non-None entries warm-start that member's weight when
        `warm_start_mixture_weights`. The bias is warm-started from
        `previous_params["bias"]` only when the engine passes one (it
        withholds it when the previous ensemble was pruned).
        """
        n = len(subnetworks)
        device = _first_tensor(subnetworks[0].logits).device
        prev_weights = prev_bias = None
        if previous_params is not None:
            prev_weights = previous_params.get("weights")
            prev_bias = previous_params.get("bias")

        def kept(value):
            return torch.as_tensor(value).detach().clone().to(device)

        weights = []
        for i, subnetwork in enumerate(subnetworks):
            prev = None
            if self._warm_start_mixture_weights and prev_weights is not None and i < len(prev_weights):
                prev = prev_weights[i]
            keys = _sorted_keys(subnetwork.logits)
            if keys is None:
                weights.append(kept(prev) if prev is not None else self._init_one_weight(generator, subnetwork, n, device))
            else:
                weights.append({
                    key: kept(prev[key]) if prev is not None
                    else self._init_one_weight(generator, subnetwork, n, device, key)
                    for key in keys
                })
        params: Dict[str, Any] = {"weights": weights}
        if self._use_bias:
            logits = subnetworks[0].logits
            keys = _sorted_keys(logits)
            if keys is None:
                params["bias"] = self._init_bias(logits, prev_bias, device)
            else:
                params["bias"] = {
                    key: self._init_bias(logits[key], None if prev_bias is None else prev_bias[key], device)
                    for key in keys
                }
        return params

    def _init_bias(self, logits, prev, device):
        """Zeros, or the warm-started prior (reference: weighted.py:490-516)."""
        if prev is not None and self._warm_start_mixture_weights:
            return torch.as_tensor(prev).detach().clone().to(device)
        dim = 1 if logits.dim() == 1 else logits.shape[-1]
        return torch.zeros((dim,), dtype=torch.float32, device=device)

    def build_train_optimizer(self):
        """The optimizer factory `params -> torch.optim.Optimizer`, or None."""
        return self._optimizer

    # ----------------------------------------------------------------- apply

    def _weighted_logits(self, weight, subnetwork, key=None):
        """One member's weighted logits (reference: weighted.py:400-454)."""
        if self._mixture_weight_type != MixtureWeightType.MATRIX:
            return _lookup(subnetwork.logits, key) * weight
        last_layer = _lookup(subnetwork.last_layer, key)
        if last_layer.dim() > 3:
            raise NotImplementedError(
                "Last layers with more than 3 dimensions are not supported "
                "with matrix mixture weights."
            )
        with full_f32_matmul():
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
        bias = params.get("bias") if self._use_bias else None
        if self._can_fuse(subnetworks):
            return self._build_fused(weights, subnetworks, bias)
        keys = _sorted_keys(subnetworks[0].logits)
        weighted = [
            WeightedSubnetwork(
                subnetwork=s,
                weight=w,
                logits=self._weighted_logits(w, s) if keys is None
                else {key: self._weighted_logits(w[key], s, key) for key in keys},
            )
            for w, s in zip(weights, subnetworks)
        ]
        if keys is None:
            logits = self._sum_logits([ws.logits for ws in weighted], bias)
            complexity = self._complexity_regularization(weights, subnetworks)
        else:
            logits = {
                key: self._sum_logits([ws.logits[key] for ws in weighted], None if bias is None else bias[key])
                for key in keys
            }
            complexity = sum(self._complexity_regularization(weights, subnetworks, key) for key in keys)
        return ComplexityRegularized(
            weighted_subnetworks=weighted,
            bias=bias,
            logits=logits,
            complexity_regularization=complexity,
        )

    @staticmethod
    def _sum_logits(member_logits, bias):
        """bias + the sum of the weighted logits (reference: weighted.py:544-556)."""
        logits = member_logits[0]
        for other in member_logits[1:]:
            logits = logits + other
        if bias is not None:
            logits = logits + bias
        return logits

    def _adanet_gamma(self, complexity):
        """lambda * r(h) + beta (reference: weighted.py:363-369)."""
        if self._adanet_lambda == 0.0:
            return self._adanet_beta
        return self._adanet_lambda * torch.as_tensor(complexity, dtype=torch.float32) + self._adanet_beta

    def _complexity_regularization(self, weights, subnetworks, key=None):
        """sum_j (lambda r(h_j) + beta) |w_j|_1 (reference: weighted.py:563-604)."""
        first = _lookup(weights[0], key)
        device = first.device if torch.is_tensor(first) else None
        total = torch.zeros((), dtype=torch.float32, device=device)
        if self._adanet_lambda == 0.0 and self._adanet_beta == 0.0:
            return total
        for weight, subnetwork in zip(weights, subnetworks):
            l1 = torch.sum(torch.abs(torch.as_tensor(_lookup(weight, key)).to(torch.float32)))
            gamma = self._adanet_gamma(subnetwork.complexity)
            if torch.is_tensor(gamma):
                gamma = gamma.to(l1.device)
            total = total + gamma * l1
        return total
