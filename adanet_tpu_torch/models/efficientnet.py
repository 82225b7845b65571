"""EfficientNet in PyTorch: the second ImageNet-class candidate family.

Port of adanet_tpu/models/efficientnet.py: MBConv blocks (expand ->
depthwise -> squeeze-excite -> project) with convolutions in the compute
dtype (bf16 by default) and batch norm in f32 (`resnet.batch_norm`, the
Flax layer's semantics), compound width/depth scaling for every variant
of `EFFICIENTNET_SCALING`, stochastic depth on the residual branches,
and the stride-1 stem with `small_inputs`. Convolutions pad as TF "SAME"
does (a 5x5 stride-2 depthwise on 112 pads by (1, 2)).

The squeeze-excite 1x1 convolutions carry biases and run in the compute
dtype (silu and sigmoid there too), then scale the f32 features, as the
Flax module's do. Stochastic depth drops a block's whole residual branch
per example: keep where u < 1 - drop_rate (`jax.random.bernoulli`'s
rule), the survivors divided by the keep probability. The U[0, 1) draws,
one [B] vector a dropping block in block order, come from `_uniform`
with the forward's `generator`, so that a test can hand both packages
the same draws. Layer names follow the Flax tree (`stage<s>_block<b>.
depthwise`, `.se.Conv_0`), so `utils.convert.convert_efficientnet` maps
one onto the other by path.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from adanet_tpu_torch.models.resnet import Conv, batch_norm, image_nchw, init_parameters
from adanet_tpu_torch.subnetwork.generator import Builder, Subnetwork

# (expand_ratio, channels, repeats, stride, kernel) per stage — B0 table.
_B0_STAGES: Tuple[Tuple[int, int, int, int, int], ...] = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)

# (width_mult, depth_mult) compound-scaling coefficients.
EFFICIENTNET_SCALING = {
    "b0": (1.0, 1.0),
    "b1": (1.0, 1.1),
    "b2": (1.1, 1.2),
    "b3": (1.2, 1.4),
}


def _round_channels(channels: float, divisor: int = 8) -> int:
    rounded = max(divisor, int(channels + divisor / 2) // divisor * divisor)
    if rounded < 0.9 * channels:  # never round down by more than 10%
        rounded += divisor
    return rounded


def _round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * repeats))


def _uniform(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """U[0, 1) f32 draws of stochastic depth, from `generator` (the
    default generator of `device` when None)."""
    if generator is not None:
        device = generator.device
    return torch.rand(shape, generator=generator, device=device)


class _SqueezeExcite(nn.Module):
    def __init__(self, channels: int, reduced: int):
        super().__init__()
        self.Conv_0 = Conv(channels, reduced, 1, bias=True)
        self.Conv_1 = Conv(reduced, channels, 1, bias=True)

    def forward(self, x, dtype):
        pooled = x.mean(dim=(2, 3), keepdim=True)
        s = nn.functional.silu(self.Conv_0(pooled, dtype))
        s = self.Conv_1(s, dtype)
        return x * torch.sigmoid(s).to(x.dtype)


class _MBConv(nn.Module):
    def __init__(self, in_filters: int, expand_ratio: int, filters: int, stride: int, kernel: int,
                 drop_rate: float):
        super().__init__()
        self.stride, self.drop_rate = stride, drop_rate
        self.residual = stride == 1 and in_filters == filters
        expanded = in_filters * expand_ratio
        self.expand = self.expand_bn = None
        if expand_ratio != 1:
            self.expand, self.expand_bn = Conv(in_filters, expanded, 1), batch_norm(expanded)
        self.depthwise = Conv(expanded, expanded, kernel, stride, groups=expanded)
        self.dw_bn = batch_norm(expanded)
        self.se = _SqueezeExcite(expanded, max(1, in_filters // 4))
        self.project, self.project_bn = Conv(expanded, filters, 1), batch_norm(filters)

    def forward(self, x, training: bool, dtype, generator=None):
        inputs = x
        if self.expand is not None:
            x = nn.functional.silu(self.expand_bn(self.expand(x, dtype), training))
        x = nn.functional.silu(self.dw_bn(self.depthwise(x, dtype), training))
        x = self.se(x, dtype)
        x = self.project_bn(self.project(x, dtype), training)
        if self.residual:
            if training and self.drop_rate > 0.0:
                # Stochastic depth: drop the whole residual branch.
                keep = 1.0 - self.drop_rate
                mask = _uniform((x.shape[0],), generator, x.device) < keep
                x = mask.to(x.dtype).reshape(-1, 1, 1, 1) * x / keep
            x = x + inputs.to(x.dtype)
        return x


class EfficientNet(nn.Module):
    """EfficientNet backbone emitting an AdaNet `Subnetwork`."""

    def __init__(
        self,
        logits_dimension: int,
        variant: str = "b0",
        compute_dtype: torch.dtype = torch.bfloat16,
        drop_path_rate: float = 0.2,
        small_inputs: bool = False,  # stride-1 stem for CIFAR-size images
        in_channels: int = 3,
    ):
        super().__init__()
        if variant not in EFFICIENTNET_SCALING:
            raise ValueError("variant must be one of %s" % sorted(EFFICIENTNET_SCALING))
        width_mult, depth_mult = EFFICIENTNET_SCALING[variant]
        self.variant, self.compute_dtype = variant, compute_dtype
        self.width_mult, self.depth_mult = width_mult, depth_mult
        stem = _round_channels(32 * width_mult)
        self.stem = Conv(in_channels, stem, 3, 1 if small_inputs else 2)
        self.stem_bn = batch_norm(stem)
        self.total_blocks = sum(_round_repeats(r, depth_mult) for _, _, r, _, _ in _B0_STAGES)
        self.blocks = []
        channels, block_index = stem, 0
        for stage, (expand, out_channels, repeats, stride, kernel) in enumerate(_B0_STAGES):
            out = _round_channels(out_channels * width_mult)
            for block in range(_round_repeats(repeats, depth_mult)):
                name = "stage%d_block%d" % (stage, block)
                setattr(self, name, _MBConv(channels, expand, out, stride if block == 0 else 1, kernel,
                                            drop_path_rate * block_index / max(self.total_blocks, 1)))
                self.blocks.append(name)
                channels = out
                block_index += 1
        head = _round_channels(1280 * width_mult)
        self.head = Conv(channels, head, 1)
        self.head_bn = batch_norm(head)
        self.logits = nn.Linear(head, logits_dimension)

    def init_parameters(self, generator: torch.Generator) -> None:
        init_parameters(self, generator)

    def forward(self, features, training: bool = False, generator: Optional[torch.Generator] = None):
        dtype = self.compute_dtype
        x = image_nchw(features).to(dtype)
        x = nn.functional.silu(self.stem_bn(self.stem(x, dtype), training))
        for name in self.blocks:
            x = getattr(self, name)(x, training, dtype, generator)
        x = nn.functional.silu(self.head_bn(self.head(x, dtype), training))
        pooled = x.mean(dim=(2, 3)).float()
        return Subnetwork(
            last_layer=pooled,
            logits=self.logits(pooled),
            complexity=float(self.total_blocks) ** 0.5,
            # The compound-scaling coefficients identify the variant for
            # next-iteration generators.
            shared={"width_mult": self.width_mult, "depth_mult": self.depth_mult},
        )


def _rmsprop(learning_rate: float, **kwargs):
    """`optax.rmsprop(learning_rate, **kwargs)` as a factory over `(name,
    parameter)` pairs."""
    from adanet_tpu_torch.research.improve_nas.optimizer import Chain, rmsprop

    return lambda named: Chain([p for _, p in named], rmsprop(learning_rate, **kwargs))


class EfficientNetBuilder(Builder):
    """AdaNet builder over the EfficientNet family. `optimizer` is a
    factory `[(name, parameter), ...] -> torch.optim.Optimizer`; by
    default `optax.rmsprop(0.016, decay=0.9, momentum=0.9)`'s rule."""

    def __init__(
        self,
        variant: str = "b0",
        optimizer=None,
        small_inputs: bool = False,
        compute_dtype: torch.dtype = torch.bfloat16,
        name: str = None,
    ):
        self._variant = variant
        self._optimizer = optimizer or _rmsprop(0.016, momentum=0.9)
        self._small_inputs = small_inputs
        self._compute_dtype = compute_dtype
        self._name = name

    @property
    def name(self) -> str:
        return self._name or "efficientnet_%s%s" % (self._variant, "_small" if self._small_inputs else "")

    def build_subnetwork(self, logits_dimension, previous_ensemble=None, *, input_shape: Sequence[int] = (3,)):
        return EfficientNet(
            logits_dimension=logits_dimension,
            variant=self._variant,
            small_inputs=self._small_inputs,
            compute_dtype=self._compute_dtype,
            in_channels=int(input_shape[-1]),
        )

    def build_train_optimizer(self, previous_ensemble=None):
        return self._optimizer
