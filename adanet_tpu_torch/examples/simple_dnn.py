"""The canonical simple_dnn search space.

Port of adanet_tpu/examples/simple_dnn.py: at every iteration propose two
candidates, one with the depth of the previous best subnetwork and one a
layer deeper, with complexity sqrt(depth) and the previous depth read
from the frozen subnetwork's `shared` state. `_SimpleDNN` names its
`nn.Linear`s `dense_<i>` and `logits` (`logits_<head>` for each head of
dict logits dimensions, by sorted name), the Flax module's names, so that
`utils.convert.convert_simple_dnn` carries a JAX subnetwork's variables
onto its `state_dict` unchanged but for the kernels' transpose.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from functools import partial
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from adanet_tpu_torch.subnetwork.generator import Builder, Generator, Subnetwork
from adanet_tpu_torch.subnetwork.report import Report

_NUM_LAYERS_KEY = "num_layers"


class _SimpleDNN(nn.Module):
    """Fully-connected stack producing a `Subnetwork`. Its parameters are
    left uninitialised: the engine calls `init_parameters` with the
    Estimator's generator (or grafts a builder's `initial_variables`)."""

    def __init__(self, input_dim: int, logits_dimension, num_layers: int, layer_size: int, dropout: float):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        width = input_dim
        for i in range(num_layers):
            setattr(self, "dense_%d" % i, nn.utils.skip_init(nn.Linear, width, layer_size))
            width = layer_size
        if isinstance(logits_dimension, Mapping):
            self.heads = sorted(logits_dimension)
            for key in self.heads:
                setattr(self, "logits_%s" % key, nn.utils.skip_init(nn.Linear, width, logits_dimension[key]))
        else:
            self.heads = None
            self.logits = nn.utils.skip_init(nn.Linear, width, logits_dimension)

    def init_parameters(self, generator: torch.Generator) -> None:
        """Flax's default Dense init from `generator`: LeCun-normal
        kernels (a normal truncated at two standard deviations, variance
        1/fan_in) and zero biases."""
        with torch.no_grad():
            for layer in self.children():
                std = math.sqrt(1.0 / layer.in_features) / 0.87962566103423978
                nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
                layer.bias.zero_()

    def forward(self, features, training: bool = False, generator: Optional[torch.Generator] = None):
        x = features["x"] if isinstance(features, Mapping) else features
        x = x.to(torch.float32)
        if x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        for i in range(self.num_layers):
            x = torch.relu(getattr(self, "dense_%d" % i)(x))
            if self.dropout > 0 and training:
                keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - self.dropout
                x = torch.where(keep, x / (1.0 - self.dropout), torch.zeros_like(x))
        # complexity = sqrt(depth), the Rademacher-style capacity growth
        # (reference: adanet/examples/simple_dnn.py:90).
        if self.heads is None:
            logits = self.logits(x)
        else:
            logits = {key: getattr(self, "logits_%s" % key)(x) for key in self.heads}
        return Subnetwork(
            last_layer=x,
            logits=logits,
            complexity=math.sqrt(max(self.num_layers, 1)),
            shared={_NUM_LAYERS_KEY: self.num_layers},
        )


class _DNNBuilder(Builder):
    """Builds a DNN subnetwork (reference: simple_dnn.py:44-160)."""

    def __init__(
        self,
        optimizer_fn,
        layer_size: int,
        num_layers: int,
        learn_mixture_weights: bool,
        dropout: float,
        seed: int,
    ):
        self._optimizer_fn = optimizer_fn
        self._layer_size = layer_size
        self._num_layers = num_layers
        self._learn_mixture_weights = learn_mixture_weights
        self._dropout = dropout
        self._seed = seed

    @property
    def name(self) -> str:
        """E.g. "1_layer_dnn" (reference: simple_dnn.py:148-156)."""
        if self._num_layers == 0:
            return "linear"
        return "{}_layer_dnn".format(self._num_layers)

    def build_subnetwork(self, logits_dimension, previous_ensemble=None, *, input_shape: Sequence[int]):
        return _SimpleDNN(
            input_dim=int(np.prod(input_shape)),
            logits_dimension=logits_dimension,
            num_layers=self._num_layers,
            layer_size=self._layer_size,
            dropout=self._dropout,
        )

    def build_train_optimizer(self, previous_ensemble=None):
        optimizer_fn = self._optimizer_fn
        return lambda named_parameters: optimizer_fn([p for _, p in named_parameters])

    def build_subnetwork_report(self) -> Report:
        return Report(
            hparams={"layer_size": self._layer_size, _NUM_LAYERS_KEY: self._num_layers},
            attributes={"complexity": math.sqrt(max(self._num_layers, 1))},
            metrics={"mean_abs_logit": lambda s, f, l: torch.mean(torch.abs(
                s.logits if not isinstance(s.logits, Mapping)
                else torch.cat([v for _, v in sorted(s.logits.items())], -1)
            ))},
        )


class Generator(Generator):
    """Generates same-depth and depth+1 DNN candidates per iteration.

    Reference: adanet/examples/simple_dnn.py:163-213. `optimizer_fn` is
    a factory `params -> torch.optim.Optimizer` (default SGD, lr 0.01).
    """

    def __init__(
        self,
        optimizer_fn=None,
        layer_size: int = 64,
        initial_num_layers: int = 0,
        learn_mixture_weights: bool = False,
        dropout: float = 0.0,
        seed: Optional[int] = None,
    ):
        if initial_num_layers < 0:
            raise ValueError("initial_num_layers must be >= 0.")
        self._optimizer_fn = optimizer_fn or (lambda params: torch.optim.SGD(params, lr=0.01))
        self._layer_size = layer_size
        self._initial_num_layers = initial_num_layers
        self._learn_mixture_weights = learn_mixture_weights
        self._dropout = dropout
        self._seed = seed

    def generate_candidates(
        self,
        previous_ensemble,
        iteration_number,
        previous_ensemble_reports,
        all_reports,
        config=None,
    ) -> List[Builder]:
        """Same-depth + one-deeper candidates (reference: simple_dnn.py:194-213)."""
        num_layers = self._initial_num_layers
        if previous_ensemble:
            last = previous_ensemble.weighted_subnetworks[-1].subnetwork
            shared = last.shared or {}
            num_layers = int(shared.get(_NUM_LAYERS_KEY, num_layers))
        # `seed` and `learn_mixture_weights` are kept for the reference's
        # API: initialisation follows the Estimator's seed, and the
        # ensembler owns the mixture weights.
        seed = self._seed
        if seed is not None:
            seed += iteration_number
        make = partial(
            _DNNBuilder,
            optimizer_fn=self._optimizer_fn,
            layer_size=self._layer_size,
            learn_mixture_weights=self._learn_mixture_weights,
            dropout=self._dropout,
            seed=seed or 0,
        )
        return [make(num_layers=num_layers), make(num_layers=num_layers + 1)]
