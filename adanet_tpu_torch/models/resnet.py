"""ResNet v1.5 in PyTorch: the ImageNet-class AutoEnsemble candidate family.

Port of adanet_tpu/models/resnet.py with the same numerics: convolutions
in the compute dtype (bf16 by default), batch norm in f32 with f32
output, so the residual stream, the global mean pool and the logits are
f32; the stride of a downsampling block on its 3x3 (v1.5); the CIFAR
stem (3x3, no max-pool) with `small_inputs`. `ResNetBuilder` makes it an
AdaNet candidate.

The features are NHWC, as in the JAX package; they are permuted to NCHW
once, which leaves them in channels-last memory, the layout cuDNN's
bf16 convolutions run fastest in. Convolutions pad as TF "SAME" does
(Flax's default): explicitly, the extra row and column bottom and right
at stride 2 (the 7x7/s2 stem pads 224 by (2, 3), a v1.5 3x3/s2 on 56 by
(0, 1)). The stem max-pool pads by one with -inf.

`batch_norm` is Flax's `nn.BatchNorm(momentum=0.9, dtype=float32)`,
which EfficientNet shares: in training the batch mean and the biased
variance E[x^2] - E[x]^2 (clipped at 0), in f32; y = (x - mean) *
(rsqrt(var + 1e-5) * scale) + bias; the running statistics move as
`ra = 0.9 * ra + 0.1 * batch` (not torch's unbiased variance nor its
reversed momentum). Parameters `scale` and `bias`, buffers `mean` and
`var`, as the Flax tree names them, so `utils.convert.convert_resnet`
maps one onto the other by path. Parameters are left uninitialised at
construction: the engine calls `init_parameters(generator)` (Flax's
defaults).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from adanet_tpu_torch.examples.simple_dnn import lecun_normal_
from adanet_tpu_torch.ops.sepconv_kernels import same_pads
from adanet_tpu_torch.subnetwork.generator import Builder, Subnetwork

# blocks-per-stage for the standard depths
RESNET_DEPTHS = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}
_BOTTLENECK_MIN_DEPTH = 50

BN_MOMENTUM, BN_EPSILON = 0.9, 1e-5


class Conv(nn.Module):
    """Flax `nn.Conv` on NCHW tensors: weight `[O, I/groups, k, k]`, TF
    "SAME" padding, input, weight and bias cast to `dtype`."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1, stride: int = 1, groups: int = 1,
                 bias: bool = False):
        super().__init__()
        self.kernel, self.stride, self.groups = kernel, stride, groups
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def init_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = x.to(dtype)
        _, pt, pb = same_pads(x.shape[2], self.kernel, self.stride)
        _, pl, pr = same_pads(x.shape[3], self.kernel, self.stride)
        if pt or pb or pl or pr:
            x = F.pad(x, (pl, pr, pt, pb))
        bias = None if self.bias is None else self.bias.to(dtype)
        return F.conv2d(x, self.weight.to(dtype), bias, stride=self.stride, groups=self.groups)


class BatchNorm(nn.Module):
    """Flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)` over
    the channels of an NCHW tensor; f32 output."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def init_parameters(self, generator: torch.Generator) -> None:
        del generator
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor, training: bool) -> torch.Tensor:
        x = x.float()
        if training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.mul_(BN_MOMENTUM).add_(mean.detach() * (1.0 - BN_MOMENTUM))
                self.var.mul_(BN_MOMENTUM).add_(var.detach() * (1.0 - BN_MOMENTUM))
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + BN_EPSILON) * self.scale
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


def batch_norm(channels: int) -> BatchNorm:
    """Family-wide BatchNorm: float32 statistics, momentum 0.9."""
    return BatchNorm(channels)


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Flax's default init of every `Conv`, `BatchNorm` and `nn.Linear`
    (LeCun-normal kernels, zero biases) below `module`, in module order."""
    for layer in module.modules():
        if isinstance(layer, (Conv, BatchNorm)):
            layer.init_parameters(generator)
        elif isinstance(layer, nn.Linear):
            lecun_normal_(layer.weight, layer.in_features, generator)
            with torch.no_grad():
                layer.bias.zero_()


class _Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1 bottleneck (v1.5: stride on the 3x3)."""

    def __init__(self, in_ch: int, filters: int, stride: int):
        super().__init__()
        self.proj = self.proj_bn = None
        if stride != 1 or in_ch != 4 * filters:
            self.proj = Conv(in_ch, 4 * filters, 1, stride)
            self.proj_bn = batch_norm(4 * filters)
        self.conv1, self.bn1 = Conv(in_ch, filters, 1), batch_norm(filters)
        self.conv2, self.bn2 = Conv(filters, filters, 3, stride), batch_norm(filters)
        self.conv3, self.bn3 = Conv(filters, 4 * filters, 1), batch_norm(4 * filters)

    def forward(self, x, training: bool, dtype):
        shortcut = x
        if self.proj is not None:
            shortcut = self.proj_bn(self.proj(x, dtype), training)
        y = torch.relu(self.bn1(self.conv1(x, dtype), training))
        y = torch.relu(self.bn2(self.conv2(y, dtype), training))
        y = self.bn3(self.conv3(y, dtype), training)
        return torch.relu(y + shortcut.to(y.dtype))


class _BasicBlock(nn.Module):
    """3x3 -> 3x3 block for the shallow (18/34) depths."""

    def __init__(self, in_ch: int, filters: int, stride: int):
        super().__init__()
        self.proj = self.proj_bn = None
        if stride != 1 or in_ch != filters:
            self.proj = Conv(in_ch, filters, 1, stride)
            self.proj_bn = batch_norm(filters)
        self.conv1, self.bn1 = Conv(in_ch, filters, 3, stride), batch_norm(filters)
        self.conv2, self.bn2 = Conv(filters, filters, 3), batch_norm(filters)

    def forward(self, x, training: bool, dtype):
        shortcut = x
        if self.proj is not None:
            shortcut = self.proj_bn(self.proj(x, dtype), training)
        y = torch.relu(self.bn1(self.conv1(x, dtype), training))
        y = self.bn2(self.conv2(y, dtype), training)
        return torch.relu(y + shortcut.to(y.dtype))


def image_nchw(features) -> torch.Tensor:
    """The NHWC image of `features` (a tensor, or a mapping with `image`)
    as an NCHW view (channels-last memory)."""
    x = features["image"] if isinstance(features, Mapping) else features
    return x.permute(0, 3, 1, 2)


class ResNet(nn.Module):
    """ResNet backbone emitting an AdaNet `Subnetwork`."""

    def __init__(
        self,
        logits_dimension: int,
        depth: int = 50,
        width: int = 64,
        compute_dtype: torch.dtype = torch.bfloat16,
        small_inputs: bool = False,  # CIFAR-style stem (3x3, no max-pool)
        in_channels: int = 3,
    ):
        super().__init__()
        if depth not in RESNET_DEPTHS:
            raise ValueError("depth must be one of %s" % sorted(RESNET_DEPTHS))
        self.depth, self.width = depth, width
        self.compute_dtype, self.small_inputs = compute_dtype, small_inputs
        self.stem = Conv(in_channels, width, 3) if small_inputs else Conv(in_channels, width, 7, 2)
        self.stem_bn = batch_norm(width)
        bottleneck = depth >= _BOTTLENECK_MIN_DEPTH
        block_cls = _Bottleneck if bottleneck else _BasicBlock
        channels = width
        self.blocks = []
        for stage, num_blocks in enumerate(RESNET_DEPTHS[depth]):
            filters = width * (2**stage)
            for block in range(num_blocks):
                name = "stage%d_block%d" % (stage, block)
                setattr(self, name, block_cls(channels, filters, 2 if (block == 0 and stage > 0) else 1))
                self.blocks.append(name)
                channels = 4 * filters if bottleneck else filters
        self.logits = nn.Linear(channels, logits_dimension)

    def init_parameters(self, generator: torch.Generator) -> None:
        init_parameters(self, generator)

    def forward(self, features, training: bool = False, generator: Optional[torch.Generator] = None):
        del generator  # no random draws
        dtype = self.compute_dtype
        x = image_nchw(features).to(dtype)
        x = torch.relu(self.stem_bn(self.stem(x, dtype), training))
        if not self.small_inputs:
            x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x, training, dtype)
        pooled = x.mean(dim=(2, 3)).float()
        return Subnetwork(
            last_layer=pooled,
            logits=self.logits(pooled),
            complexity=float(self.depth) ** 0.5,
            shared={"depth": self.depth, "width": self.width},
        )


def _sgd_momentum(learning_rate: float):
    """`optax.sgd(learning_rate, momentum=0.9)` as a factory over
    `(name, parameter)` pairs."""
    from adanet_tpu_torch.research.improve_nas.optimizer import Chain, Rule, constant_schedule

    return lambda named: Chain([p for _, p in named], Rule("momentum", constant_schedule(learning_rate)))


class ResNetBuilder(Builder):
    """AdaNet builder over the ResNet family. `optimizer` is a factory
    `[(name, parameter), ...] -> torch.optim.Optimizer`; by default
    `optax.sgd(0.1, momentum=0.9)`'s rule."""

    def __init__(
        self,
        depth: int = 50,
        width: int = 64,
        optimizer=None,
        small_inputs: bool = False,
        compute_dtype: torch.dtype = torch.bfloat16,
        name: str = None,
    ):
        self._depth = depth
        self._width = width
        self._optimizer = optimizer or _sgd_momentum(0.1)
        self._small_inputs = small_inputs
        self._compute_dtype = compute_dtype
        self._name = name

    @property
    def name(self) -> str:
        return self._name or "resnet%d_w%d" % (self._depth, self._width)

    def build_subnetwork(self, logits_dimension, previous_ensemble=None, *, input_shape: Sequence[int] = (3,)):
        return ResNet(
            logits_dimension=logits_dimension,
            depth=self._depth,
            width=self._width,
            small_inputs=self._small_inputs,
            compute_dtype=self._compute_dtype,
            in_channels=int(input_shape[-1]),
        )

    def build_train_optimizer(self, previous_ensemble=None):
        return self._optimizer
