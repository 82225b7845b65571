"""A CIFAR-scale CNN search space.

Port of adanet_tpu/examples/simple_cnn.py: conv blocks (two 3x3 SAME
convolutions with relu, then a 2x2 max-pool), a global mean pool, then
dropout and the f32 `logits` Dense, as a `Subnetwork` with complexity
sqrt(num_blocks) and the depth in `shared`. `CNNGenerator` proposes a
same-depth and a one-deeper CNN each iteration, the depth read from the
previous winner's last member.

The features are NHWC, as in the JAX package; they are permuted to NCHW
once. `compute_dtype` (bf16 by default) is the Flax `nn.Conv(dtype=...)`:
the input, kernels and biases are cast to it, the convolutions, relus and
pools run in it, and the mean pool sums in f32 and rounds back to it
(`jnp.mean`) before the cast to f32. The layers carry the Flax names
(`conv_<i>_a`, `conv_<i>_b`, `logits`), so that `utils.convert.
convert_simple_cnn` carries a JAX subnetwork's variables across.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from adanet_tpu_torch.examples.simple_dnn import lecun_normal_
from adanet_tpu_torch.subnetwork.generator import Builder, Generator, Subnetwork

_NUM_BLOCKS_KEY = "num_blocks"


class SimpleCNN(nn.Module):
    """Conv blocks -> global average pool -> dense, as a `Subnetwork`.
    Its parameters are left uninitialised: the engine calls
    `init_parameters` with the Estimator's generator."""

    def __init__(
        self,
        in_channels: int,
        logits_dimension: int,
        num_blocks: int,
        channels: int = 64,
        dropout: float = 0.0,
        compute_dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.num_blocks = num_blocks
        self.dropout = dropout
        self.compute_dtype = compute_dtype
        width = in_channels
        for i in range(num_blocks):
            setattr(self, "conv_%d_a" % i, nn.utils.skip_init(nn.Conv2d, width, channels, 3, padding=1))
            setattr(self, "conv_%d_b" % i, nn.utils.skip_init(nn.Conv2d, channels, channels, 3, padding=1))
            width = channels
        self.logits = nn.utils.skip_init(nn.Linear, width, logits_dimension)

    def init_parameters(self, generator: torch.Generator) -> None:
        """Flax's defaults from `generator`: LeCun-normal kernels (fan-in
        over the receptive field for the convolutions) and zero biases."""
        with torch.no_grad():
            for layer in self.children():
                lecun_normal_(layer.weight, layer.weight[0].numel(), generator)
                layer.bias.zero_()

    def forward(self, features, training: bool = False, generator: Optional[torch.Generator] = None):
        x = features["image"] if isinstance(features, Mapping) else features
        dtype = self.compute_dtype
        x = x.to(dtype).permute(0, 3, 1, 2)
        for i in range(self.num_blocks):
            for part in ("a", "b"):
                conv = getattr(self, "conv_%d_%s" % (i, part))
                x = torch.relu(F.conv2d(x, conv.weight.to(dtype), conv.bias.to(dtype), padding=1))
            x = F.max_pool2d(x, 2, 2)
        # Global average pool: f32 sums, the mean rounded to the compute
        # dtype (jnp.mean), then f32 for the head.
        x = x.float().mean(dim=(2, 3)).to(dtype).float()
        if self.dropout > 0 and training:
            keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - self.dropout
            x = torch.where(keep, x / (1.0 - self.dropout), torch.zeros_like(x))
        return Subnetwork(
            last_layer=x,
            logits=self.logits(x),
            complexity=math.sqrt(max(self.num_blocks, 1)),
            shared={_NUM_BLOCKS_KEY: self.num_blocks},
        )


class CNNBuilder(Builder):
    """Builds a `SimpleCNN` trained by SGD with momentum 0.9 (torch's
    `SGD(momentum=0.9)` is `optax.sgd(lr, momentum=0.9)`)."""

    def __init__(
        self,
        num_blocks: int,
        channels: int = 64,
        learning_rate: float = 0.05,
        dropout: float = 0.0,
    ):
        self._num_blocks = num_blocks
        self._channels = channels
        self._learning_rate = learning_rate
        self._dropout = dropout

    @property
    def name(self) -> str:
        return "cnn_%db_%dc" % (self._num_blocks, self._channels)

    def build_subnetwork(self, logits_dimension, previous_ensemble=None, *, input_shape: Sequence[int]):
        return SimpleCNN(
            in_channels=int(input_shape[-1]),
            logits_dimension=logits_dimension,
            num_blocks=self._num_blocks,
            channels=self._channels,
            dropout=self._dropout,
        )

    def build_train_optimizer(self, previous_ensemble=None):
        learning_rate = self._learning_rate
        return lambda named: torch.optim.SGD([p for _, p in named], lr=learning_rate, momentum=0.9)


class CNNGenerator(Generator):
    """Proposes same-depth and one-deeper CNNs each iteration."""

    def __init__(
        self,
        initial_num_blocks: int = 1,
        channels: int = 64,
        learning_rate: float = 0.05,
        dropout: float = 0.0,
    ):
        self._initial_num_blocks = initial_num_blocks
        self._channels = channels
        self._learning_rate = learning_rate
        self._dropout = dropout

    def generate_candidates(
        self,
        previous_ensemble,
        iteration_number,
        previous_ensemble_reports,
        all_reports,
        config=None,
    ) -> List[Builder]:
        num_blocks = self._initial_num_blocks
        if previous_ensemble:
            last = previous_ensemble.weighted_subnetworks[-1].subnetwork
            shared = last.shared or {}
            num_blocks = int(shared.get(_NUM_BLOCKS_KEY, num_blocks))

        def make(blocks):
            return CNNBuilder(
                num_blocks=blocks,
                channels=self._channels,
                learning_rate=self._learning_rate,
                dropout=self._dropout,
            )

        return [make(num_blocks), make(num_blocks + 1)]
