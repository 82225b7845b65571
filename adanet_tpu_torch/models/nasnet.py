"""NASNet-A in PyTorch, training and eval.

Port of adanet_tpu/models/nasnet.py (itself after the reference's
research/improve_nas/trainer/nasnet.py and nasnet_utils.py): the normal
and reduction cells with their fixed operation lists, factorized
reduction, the CIFAR stem and the final classifier, with the same
numerics: NHWC activations, convolutions in the compute dtype (bf16 by
default), batch norm in f32 with its output cast back to the compute
dtype, the global mean pool in the compute dtype and then f32, and f32
logits.

Torch modules are built with their input shapes known, so `NasNetA`
takes the example shape `(H, W, C)` and works out every cell's shapes
when it is built; the cell wiring is then fixed, as the Flax version's
is once traced. Parameter names follow the Flax tree
(`cell_3.block0_left_sep.depthwise_0.weight` is Flax's
`cell_3/block0_left_sep/depthwise_0/kernel`), so `utils.convert` maps
one onto the other by path. Batch norm keeps Flax's names: parameters
`scale` and `bias`, buffers `mean`, `var` and `count`.

Training (`forward(images, training=True, generator=...)`) follows the
Flax module's training branch:

- batch norm normalises with the batch's mean and biased variance (f32)
  and moves its statistics with the warmup-scheduled momentum
  `min(0.9997, count / (count + 10))`, `count` then growing by one. The
  layers hand their batch statistics to the forward, which updates every
  layer's statistics at its end in a few batched operations
  (`_update_statistics`);
- drop-path (v3 schedule): each cell's keep probability is scaled by its
  depth and by the progress `min(step / total_training_steps, 1)`, where
  `step` (the Flax `schedule/step` variable, a buffer here) grows by one
  each training forward. The U[0, 1) draws come from `generator`, one
  [drops, batch] draw a cell before the cell runs (`_uniform`), so a
  rematerialised cell recomputes with the same masks;
- the auxiliary head after the cell before the second reduction (when
  the feature map is at least 5 x 5), and dense dropout before the
  logits;
- `remat` recomputes each cell in the backward (`torch.utils.checkpoint`);
  the recompute neither moves the statistics again nor draws new masks.

The ImageNet stem (`stem_type="imagenet"`, NASNet-A Mobile and Large)
is a 3 x 3 stride-2 VALID `conv0` and its batch norm, then two stride-2
reduction cells `cell_stem_0` and `cell_stem_1` at 1/4 and 1/2 of the
filters (at least 1), an 8x reduction before the main cells; the stem
cells count in the drop-path depth schedule, as in the Flax module.
`cifar_config`, `mobile_imagenet_config` and `large_imagenet_config` are
the JAX package's presets.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from adanet_tpu_torch.ops.sepconv_kernels import fused_sep_conv, same_pads

# NASNet-A cell specifications (reference: nasnet_utils.py:483-532).
_NORMAL_OPERATIONS = (
    "separable_5x5_2",
    "separable_3x3_2",
    "separable_5x5_2",
    "separable_3x3_2",
    "avg_pool_3x3",
    "none",
    "avg_pool_3x3",
    "avg_pool_3x3",
    "separable_3x3_2",
    "none",
)
_NORMAL_HIDDENSTATE_INDICES = (0, 1, 1, 1, 0, 1, 1, 1, 0, 0)
_NORMAL_USED_HIDDENSTATES = (1, 0, 0, 0, 0, 0, 0)

_REDUCTION_OPERATIONS = (
    "separable_5x5_2",
    "separable_7x7_2",
    "max_pool_3x3",
    "separable_7x7_2",
    "avg_pool_3x3",
    "separable_5x5_2",
    "none",
    "avg_pool_3x3",
    "separable_3x3_2",
    "max_pool_3x3",
)
_REDUCTION_HIDDENSTATE_INDICES = (0, 1, 0, 1, 0, 1, 3, 2, 2, 0)
_REDUCTION_USED_HIDDENSTATES = (1, 1, 1, 0, 0, 0, 0)

#: One example's activation shape, NHWC without the batch: (H, W, C).
Shape = Tuple[int, int, int]

#: Batch-norm statistics' schedule (the Flax `_DebiasedBatchNorm`'s
#: slim defaults): momentum min(BN_MOMENTUM, count / (count + BN_WARMUP)).
BN_MOMENTUM = 0.9997
BN_WARMUP = 10.0


@dataclasses.dataclass
class _Train:
    """What a training forward hands its layers: the drop-path progress
    (0-d f32), and the list each batch norm appends `(layer, batch mean,
    batch variance)` to; None while a rematerialised cell is recomputed
    (its statistics were taken in the forward)."""

    progress: torch.Tensor
    stats: Optional[list]


def _uniform(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """U[0, 1) f32 draws of drop-path and dropout, from `generator` (the
    default generator of `device` when None)."""
    if generator is not None:
        device = generator.device
    return torch.rand(shape, generator=generator, device=device)


def _drop_path(x: torch.Tensor, keep_prob: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Drops whole examples' branch outputs (reference:
    nasnet_utils.py:137-148): mask `floor(keep_prob + u)` from the
    per-example draws `u` [B], survivors scaled by 1 / keep_prob."""
    mask = torch.floor(keep_prob + u.reshape(-1, 1, 1, 1))
    return x * (1.0 / keep_prob).to(x.dtype) * mask.to(x.dtype)


def _dropout(x: torch.Tensor, keep_prob: float, u: torch.Tensor) -> torch.Tensor:
    """Flax `nn.Dropout`: keeps where `u < keep_prob`, scaled by 1 / keep_prob."""
    return torch.where(u < keep_prob, x / keep_prob, torch.zeros_like(x))


def _update_statistics(stats) -> None:
    """The statistics update of every batch norm of one training forward
    (`_Train.stats`), as the Flax layer makes its own: per layer
    m = min(momentum, count / (count + warmup)), then mean and var <-
    m * old + (1 - m) * batch, and count + 1; batched over the layers."""
    if not stats:
        return
    with torch.no_grad():
        layers = [layer for layer, _, _ in stats]
        sizes = [layer.mean.numel() for layer in layers]
        counts = torch.stack([layer.count for layer in layers])
        m = torch.clamp(counts / (counts + BN_WARMUP), max=BN_MOMENTUM)
        m = torch.cat([mi.expand(n) for mi, n in zip(m.unbind(), sizes)])
        for index, name in ((1, "mean"), (2, "var")):
            old = [getattr(layer, name) for layer in layers]
            new = m * torch.cat(old) + (1.0 - m) * torch.cat([s[index] for s in stats])
            torch._foreach_copy_(old, new.split(sizes))
        torch._foreach_add_([layer.count for layer in layers], 1.0)


@dataclasses.dataclass(frozen=True)
class NasNetConfig:
    """Hyperparameters (reference: nasnet.py cifar_config, 47-65)."""

    num_classes: int = 10
    num_cells: int = 18
    num_conv_filters: int = 32
    stem_multiplier: float = 3.0
    filter_scaling_rate: float = 2.0
    num_reduction_layers: int = 2
    drop_path_keep_prob: float = 0.6
    dense_dropout_keep_prob: float = 1.0
    use_aux_head: bool = True
    aux_head_weight: float = 0.4
    total_training_steps: int = 937500
    stem_type: str = "cifar"  # or "imagenet"
    compute_dtype: Any = torch.bfloat16
    remat: bool = False
    # Route every separable conv through the fused kernel (K2,
    # ops/sepconv_kernels.py): the depthwise result stays f32 into the
    # pointwise product. False runs two convolutions with the depthwise
    # result rounded to the compute dtype, as the unfused Flax path does.
    use_pallas_sep_conv: bool = False


def cifar_config(**overrides) -> NasNetConfig:
    """NASNet-A (6@768) CIFAR preset: `NasNetConfig`'s defaults."""
    return dataclasses.replace(NasNetConfig(), **overrides)


def mobile_imagenet_config(**overrides) -> NasNetConfig:
    """NASNet-A Mobile ImageNet preset (reference: nasnet.py
    mobile_imagenet_config via build_nasnet_mobile)."""
    base = NasNetConfig(
        num_classes=1001,
        num_cells=12,
        num_conv_filters=44,
        stem_multiplier=1.0,
        drop_path_keep_prob=1.0,
        dense_dropout_keep_prob=0.5,
        total_training_steps=250000,
        stem_type="imagenet",
    )
    return dataclasses.replace(base, **overrides)


def large_imagenet_config(**overrides) -> NasNetConfig:
    """NASNet-A Large ImageNet preset (reference: nasnet.py
    large_imagenet_config via build_nasnet_large)."""
    base = NasNetConfig(
        num_classes=1001,
        num_cells=18,
        num_conv_filters=168,
        stem_multiplier=3.0,
        drop_path_keep_prob=0.7,
        dense_dropout_keep_prob=0.5,
        total_training_steps=250000,
        stem_type="imagenet",
    )
    return dataclasses.replace(base, **overrides)


def calc_reduction_layers(num_cells: int, num_reduction_layers: int) -> List[int]:
    """Which cell indices get reduction cells (reference: nasnet_utils.py:52-59)."""
    return [
        int(float(pool_num) / (num_reduction_layers + 1) * num_cells)
        for pool_num in range(1, num_reduction_layers + 1)
    ]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _pair(v: Union[int, Sequence[int]]) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _lecun_normal_(weight: torch.Tensor, fan_in: int, generator=None) -> None:
    """Flax's default kernel init: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class _Conv(nn.Module):
    """Flax `nn.Conv` without bias on NHWC tensors: weight `[O, I/groups,
    kh, kw]`, TF "SAME" padding padded explicitly (the extra row and
    column go bottom and right) or "VALID", computed in `dtype`."""

    def __init__(self, in_ch, out_ch, kernel=1, stride=1, groups=1, padding="SAME"):
        super().__init__()
        self.kernel = _pair(kernel)
        self.stride = stride
        self.groups = groups
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, *self.kernel))

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        y = x.to(dtype).permute(0, 3, 1, 2)
        if self.padding == "SAME":
            _, pt, pb = same_pads(x.shape[1], self.kernel[0], self.stride)
            _, pl, pr = same_pads(x.shape[2], self.kernel[1], self.stride)
            if pt or pb or pl or pr:
                y = F.pad(y, (pl, pr, pt, pb))
        y = F.conv2d(y, self.weight.to(dtype), stride=self.stride, groups=self.groups)
        return y.permute(0, 2, 3, 1)


class _Dense(nn.Module):
    """Flax `nn.Dense(dtype=float32)`: weight `[out, in]`, bias `[out]`."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.weight, self.bias)


class _DebiasedBatchNorm(nn.Module):
    """The Flax `_DebiasedBatchNorm`.

    Training (`train` given) normalises with the batch's mean and biased
    variance over every axis but the last, in f32, and appends them to
    `train.stats` for `_update_statistics`. Eval uses the statistics only
    once trained (`count > 0`); before that the mean is 0 and the
    variance 1. Normalisation and affine run in f32; the result is cast
    to `out_dtype` (the compute dtype).
    """

    def __init__(self, features: int, out_dtype=None, epsilon: float = 1e-3):
        super().__init__()
        self.out_dtype = out_dtype
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.zeros(features))
        self.register_buffer("count", torch.zeros(()))

    def forward(self, x: torch.Tensor, train: Optional[_Train] = None) -> torch.Tensor:
        xf = x.float()
        if train is not None:
            var, mean = torch.var_mean(xf, dim=tuple(range(xf.dim() - 1)), correction=0)
            if train.stats is not None:
                train.stats.append((self, mean.detach(), var.detach()))
        else:
            trained = self.count > 0
            mean = torch.where(trained, self.mean, torch.zeros_like(self.mean))
            var = torch.where(trained, self.var, torch.ones_like(self.var))
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        y = y * self.scale + self.bias
        if self.out_dtype is not None:
            y = y.to(self.out_dtype)
        return y


class _SepConv(nn.Module):
    """Stacked relu -> depthwise -> pointwise -> bn, `num_layers` times
    (reference: nasnet_utils.py:183-211). Only the first layer is
    strided. With `use_fused`, each relu + depthwise + pointwise triple is
    one launch of K2."""

    def __init__(self, in_shape: Shape, filters, kernel, stride, num_layers, compute_dtype, use_fused):
        super().__init__()
        self.in_shape = tuple(in_shape)
        self.filters = filters
        self.kernel = kernel
        self.stride = stride
        self.num_layers = num_layers
        self.compute_dtype = compute_dtype
        self.use_fused = use_fused
        h, w, c = in_shape
        for layer in range(num_layers):
            self.add_module("depthwise_%d" % layer, _Conv(c, c, kernel, stride, groups=c))
            self.add_module("pointwise_%d" % layer, _Conv(c, filters, 1))
            self.add_module("bn_%d" % layer, _DebiasedBatchNorm(filters, compute_dtype))
            h, w, c = _ceil_div(h, stride), _ceil_div(w, stride), filters
            stride = 1
        self.out_shape = (h, w, c)

    def launch_shapes(self) -> List[Tuple[Shape, int, int, int]]:
        """(input shape, filters, kernel, stride) of each layer, in order:
        the shapes K2 is launched at, per example."""
        out = []
        (h, w, c), stride = self.in_shape, self.stride
        for _ in range(self.num_layers):
            out.append(((h, w, c), self.filters, self.kernel, stride))
            h, w, c, stride = _ceil_div(h, stride), _ceil_div(w, stride), self.filters, 1
        return out

    def forward(self, x: torch.Tensor, train: Optional[_Train] = None) -> torch.Tensor:
        dtype = self.compute_dtype
        stride = self.stride
        for layer in range(self.num_layers):
            depthwise = getattr(self, "depthwise_%d" % layer)
            pointwise = getattr(self, "pointwise_%d" % layer)
            if self.use_fused:
                x = fused_sep_conv(x.to(dtype), depthwise.weight, pointwise.weight, stride)
            else:
                x = pointwise(depthwise(torch.relu(x), dtype), dtype)
            x = getattr(self, "bn_%d" % layer)(x, train)
            stride = 1
        return x


class _FactorizedReduction(nn.Module):
    """Stride-2 reduction without information loss
    (reference: nasnet_utils.py:92-134): two stride-2 1x1 paths, the
    second shifted by one pixel (padded bottom and right)."""

    def __init__(self, in_shape: Shape, filters: int, stride: int, compute_dtype):
        super().__init__()
        self.stride = stride
        self.compute_dtype = compute_dtype
        h, w, c = in_shape
        if stride == 1:
            self.path_conv = _Conv(c, filters, 1)
            self.path_bn = _DebiasedBatchNorm(filters, compute_dtype)
            self.out_shape = (h, w, filters)
        else:
            self.path1_conv = _Conv(c, filters // 2, 1)
            self.path2_conv = _Conv(c, filters // 2 + filters % 2, 1)
            self.final_path_bn = _DebiasedBatchNorm(filters, compute_dtype)
            self.out_shape = (_ceil_div(h, stride), _ceil_div(w, stride), filters)

    def forward(self, x: torch.Tensor, train: Optional[_Train] = None) -> torch.Tensor:
        dtype = self.compute_dtype
        if self.stride == 1:
            return self.path_bn(self.path_conv(x, dtype), train)
        s = self.stride
        # A 1x1 stride-s average pool is a subsample.
        path1 = self.path1_conv(x[:, ::s, ::s, :], dtype)
        path2 = F.pad(x[:, 1:, 1:, :], (0, 0, 0, 1, 0, 1))[:, ::s, ::s, :]
        path2 = self.path2_conv(path2, dtype)
        return self.final_path_bn(torch.cat([path1, path2], dim=-1), train)


def _pool(x: torch.Tensor, kind: str, window: int, stride: int) -> torch.Tensor:
    """Flax SAME pooling on NHWC: the average counts padded cells, the
    max pads with -inf."""
    _, pt, pb = same_pads(x.shape[1], window, stride)
    _, pl, pr = same_pads(x.shape[2], window, stride)
    y = x.permute(0, 3, 1, 2)
    if kind == "max":
        y = F.pad(y, (pl, pr, pt, pb), value=float("-inf"))
        y = F.max_pool2d(y, window, stride)
    else:
        y = F.pad(y, (pl, pr, pt, pb))
        y = F.avg_pool2d(y, window, stride)
    return y.permute(0, 2, 3, 1)


class _NasNetCell(nn.Module):
    """One NASNet-A cell (reference: nasnet_utils.py:250-480). In
    training, every branch but a "none" one goes through drop-path at
    this cell's keep probability (`keep_prob`)."""

    def __init__(
        self,
        operations: Sequence[str],
        hiddenstate_indices: Sequence[int],
        used_hiddenstates: Sequence[int],
        filters: int,
        stride: int,
        net_shape: Shape,
        prev_shape: Optional[Shape],
        compute_dtype,
        use_pallas_sep_conv: bool,
        cell_num: int = 0,
        total_num_cells: int = 1,
        drop_path_keep_prob: float = 1.0,
    ):
        super().__init__()
        self.filters = filters
        # v3 drop-path schedule, the depth part (nasnet_utils.py:436-480).
        layer_ratio = (cell_num + 1) / float(total_num_cells)
        self.depth_keep_prob = 1.0 - layer_ratio * (1.0 - drop_path_keep_prob)
        #: Branches that drop-path applies to, each one draw a forward.
        self.drop_paths = sum(op != "none" for op in operations)
        self.compute_dtype = compute_dtype
        self.use_pallas_sep_conv = use_pallas_sep_conv
        h, w, c = net_shape

        # Match the previous layer to this one (nasnet_utils.py:283-301).
        if prev_shape is None:
            self.prev_mode = "current"
            prev_out = net_shape
        elif prev_shape[1] != w:
            self.prev_mode = "factorized"
            self.reduce_prev = _FactorizedReduction(prev_shape, filters, 2, compute_dtype)
            prev_out = self.reduce_prev.out_shape
        elif prev_shape[2] != filters:
            self.prev_mode = "1x1"
            self.prev_1x1 = _Conv(prev_shape[2], filters, 1)
            self.prev_bn = _DebiasedBatchNorm(filters, compute_dtype)
            prev_out = (prev_shape[0], prev_shape[1], filters)
        else:
            self.prev_mode = "same"
            prev_out = prev_shape

        self.beginning_1x1 = _Conv(c, filters, 1)
        self.beginning_bn = _DebiasedBatchNorm(filters, compute_dtype)

        states: List[Shape] = [(h, w, filters), prev_out]
        self._blocks = []
        for block in range(5):
            pair = []
            shapes = []
            for side, k in (("left", 2 * block), ("right", 2 * block + 1)):
                idx = hiddenstate_indices[k]
                shape, op = self._make_operation(
                    states[idx], operations[k], stride, idx < 2, "block%d_%s" % (block, side)
                )
                pair.append((idx, op, operations[k] != "none"))
                shapes.append(shape)
            if shapes[0] != shapes[1]:
                raise ValueError("block %d branches disagree: %s" % (block, shapes))
            self._blocks.append(tuple(pair))
            states.append(shapes[0])

        # Concat the unused states, factorized-reducing shape mismatches
        # (nasnet_utils.py:404-431).
        final = states[-1]
        self._combine = []
        channels = 0
        for idx, used in enumerate(used_hiddenstates):
            if used:
                continue
            state = states[idx]
            name = None
            if state[1] != final[1] or state[2] != final[2]:
                name = "reduction_%d" % idx
                s = 2 if state[1] != final[1] else 1
                self.add_module(name, _FactorizedReduction(state, final[2], s, compute_dtype))
            self._combine.append((idx, name))
            channels += final[2]
        self.out_shape = (final[0], final[1], channels)

    def _make_operation(self, in_shape: Shape, operation: str, stride: int, is_original: bool, name: str):
        """Builds one branch op; returns (output shape, op record)."""
        h, w, c = in_shape
        if stride > 1 and not is_original:
            stride = 1
        out_hw = (_ceil_div(h, stride), _ceil_div(w, stride))
        if "separable" in operation:
            parts = operation.split("_")
            sep = _SepConv(
                in_shape,
                self.filters,
                int(parts[1].split("x")[0]),
                stride,
                int(parts[2]),
                self.compute_dtype,
                self.use_pallas_sep_conv,
            )
            self.add_module("%s_sep" % name, sep)
            return sep.out_shape, ("sep", "%s_sep" % name)
        if operation == "none":
            if stride > 1 or c != self.filters:
                self.add_module("%s_1x1" % name, _Conv(c, self.filters, 1, stride))
                self.add_module("%s_bn1" % name, _DebiasedBatchNorm(self.filters, self.compute_dtype))
                return out_hw + (self.filters,), ("relu_conv", name)
            return in_shape, ("identity", None)
        if "pool" in operation:
            kind = operation.split("_")[0]
            window = int(operation.split("_")[-1].split("x")[0])
            conv_name = None
            if c != self.filters:
                conv_name = name
                self.add_module("%s_1x1" % name, _Conv(c, self.filters, 1))
                self.add_module("%s_bn1" % name, _DebiasedBatchNorm(self.filters, self.compute_dtype))
            return out_hw + (self.filters,), ("pool", (kind, window, stride, conv_name))
        raise ValueError("Unimplemented operation %r" % operation)

    def _apply_operation(self, x: torch.Tensor, op, train: Optional[_Train]) -> torch.Tensor:
        kind, arg = op
        dtype = self.compute_dtype
        if kind == "sep":
            return getattr(self, arg)(x, train)
        if kind == "relu_conv":
            x = getattr(self, "%s_1x1" % arg)(torch.relu(x), dtype)
            return getattr(self, "%s_bn1" % arg)(x, train)
        if kind == "pool":
            pool_kind, window, stride, conv_name = arg
            x = _pool(x, pool_kind, window, stride)
            if conv_name is not None:
                x = getattr(self, "%s_1x1" % conv_name)(x, dtype)
                x = getattr(self, "%s_bn1" % conv_name)(x, train)
            return x
        return x

    def keep_prob(self, progress: torch.Tensor) -> torch.Tensor:
        """Drop-path keep probability at training `progress` (0-d f32):
        the depth-scaled one, scaled again by progress."""
        return 1.0 - progress * (1.0 - self.depth_keep_prob)

    def forward(
        self,
        net: torch.Tensor,
        prev: Optional[torch.Tensor],
        train: Optional[_Train] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """`noise` [drop_paths, B]: drop-path's draws, in branch order
        (training only; None: no drop-path)."""
        dtype = self.compute_dtype
        if self.prev_mode == "current":
            prev = net
        elif self.prev_mode == "factorized":
            prev = self.reduce_prev(torch.relu(prev), train)
        elif self.prev_mode == "1x1":
            prev = self.prev_bn(self.prev_1x1(torch.relu(prev), dtype), train)
        x = self.beginning_bn(self.beginning_1x1(torch.relu(net), dtype), train)
        draws = keep_prob = None
        if noise is not None:
            draws, keep_prob = iter(noise), self.keep_prob(train.progress)
        states = [x, prev]
        for pair in self._blocks:
            hs = []
            for idx, op, dropped in pair:
                h = self._apply_operation(states[idx], op, train)
                if dropped and draws is not None:
                    h = _drop_path(h, keep_prob, next(draws))
                hs.append(h)
            states.append(hs[0] + hs[1])
        parts = [
            states[idx] if name is None else getattr(self, name)(states[idx], train)
            for idx, name in self._combine
        ]
        return torch.cat(parts, dim=-1)


class _AuxHead(nn.Module):
    """Auxiliary classifier (reference: nasnet.py:235-258): relu, 5 x 5
    stride-3 VALID average pool, 1x1 conv to 128 and batch norm, relu, a
    VALID conv over the whole map to 768 and batch norm, relu, f32 Dense.
    It runs only in training."""

    def __init__(self, in_shape: Shape, num_classes: int, compute_dtype):
        super().__init__()
        h, w, c = in_shape
        pooled = ((h - 5) // 3 + 1, (w - 5) // 3 + 1)
        self.proj = _Conv(c, 128, 1)
        self.aux_bn0 = _DebiasedBatchNorm(128, compute_dtype)
        self.full = _Conv(128, 768, pooled, padding="VALID")
        self.aux_bn1 = _DebiasedBatchNorm(768, compute_dtype)
        self.aux_logits = _Dense(768, num_classes)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, train: _Train) -> torch.Tensor:
        dtype = self.compute_dtype
        x = F.avg_pool2d(torch.relu(x).permute(0, 3, 1, 2), 5, 3).permute(0, 2, 3, 1)
        x = torch.relu(self.aux_bn0(self.proj(x, dtype), train))
        x = torch.relu(self.aux_bn1(self.full(x, dtype), train))
        return self.aux_logits(x.reshape(x.shape[0], -1))


class NasNetA(nn.Module):
    """The full NASNet-A network (reference: nasnet.py:460-555).

    `forward(images, training=False, generator=None)` takes NHWC images
    of `input_shape` and returns `(logits, aux_logits, pooled)`;
    `aux_logits` is None outside training or without the auxiliary head.
    The buffer `step` is the Flax `schedule/step`.
    """

    def __init__(self, config: NasNetConfig, input_shape: Sequence[int]):
        super().__init__()
        cfg = config
        self.config = cfg
        if cfg.stem_type not in ("cifar", "imagenet"):
            raise ValueError("stem_type must be 'cifar' or 'imagenet', got %r" % (cfg.stem_type,))
        num_stem_cells = 2 if cfg.stem_type == "imagenet" else 0
        h, w, c = (int(d) for d in input_shape)
        dtype = cfg.compute_dtype
        reduction_indices = calc_reduction_layers(cfg.num_cells, cfg.num_reduction_layers)
        aux_cell_index = reduction_indices[1] - 1 if len(reduction_indices) >= 2 else -1
        total_num_cells = cfg.num_cells + cfg.num_reduction_layers + num_stem_cells
        self.register_buffer("step", torch.zeros(()))
        self._aux_after = None

        if num_stem_cells:
            # ImageNet stem (reference: nasnet.py:260-286): a stride-2
            # VALID conv halves the input; the stem cells follow below.
            stem_filters = int(32 * cfg.stem_multiplier)
            self.conv0 = _Conv(c, stem_filters, 3, 2, padding="VALID")
            self.conv0_bn = _DebiasedBatchNorm(stem_filters, dtype)
            self._stem = ("conv0", "conv0_bn")
            h, w = (h - 3) // 2 + 1, (w - 3) // 2 + 1
        else:
            stem_filters = int(cfg.num_conv_filters * cfg.stem_multiplier)
            self.stem_conv = _Conv(c, stem_filters, 3)
            self.stem_bn = _DebiasedBatchNorm(stem_filters, dtype)
            self._stem = ("stem_conv", "stem_bn")
        shapes: List[Optional[Shape]] = [None, (h, w, stem_filters)]
        self._cells: List[str] = []

        def add_cell(kind, filters, stride, name):
            spec = {
                "normal": (_NORMAL_OPERATIONS, _NORMAL_HIDDENSTATE_INDICES, _NORMAL_USED_HIDDENSTATES),
                "reduction": (
                    _REDUCTION_OPERATIONS,
                    _REDUCTION_HIDDENSTATE_INDICES,
                    _REDUCTION_USED_HIDDENSTATES,
                ),
            }[kind]
            cell = _NasNetCell(
                *spec,
                filters=filters,
                stride=stride,
                net_shape=shapes[-1],
                prev_shape=shapes[-2],
                compute_dtype=dtype,
                use_pallas_sep_conv=cfg.use_pallas_sep_conv,
                cell_num=len(self._cells),
                total_num_cells=total_num_cells,
                drop_path_keep_prob=cfg.drop_path_keep_prob,
            )
            self.add_module(name, cell)
            self._cells.append(name)
            shapes.append(cell.out_shape)

        stem_scaling = 1.0 / cfg.filter_scaling_rate**num_stem_cells
        for stem_num in range(num_stem_cells):
            add_cell(
                "reduction",
                max(1, int(cfg.num_conv_filters * stem_scaling)),
                2,
                "cell_stem_%d" % stem_num,
            )
            stem_scaling *= cfg.filter_scaling_rate
        filter_scaling = 1.0
        for cell_num in range(cfg.num_cells):
            if cell_num in reduction_indices:
                filter_scaling *= cfg.filter_scaling_rate
                add_cell(
                    "reduction",
                    int(cfg.num_conv_filters * filter_scaling),
                    2,
                    "reduction_cell_%d" % reduction_indices.index(cell_num),
                )
            add_cell("normal", int(cfg.num_conv_filters * filter_scaling), 1, "cell_%d" % cell_num)
            out = shapes[-1]
            if (
                cfg.use_aux_head
                and cell_num == aux_cell_index
                and cfg.num_classes
                and out[0] >= 5
                and out[1] >= 5
            ):
                self.aux_head = _AuxHead(out, cfg.num_classes, dtype)
                self._aux_after = "cell_%d" % cell_num
        self.logits = _Dense(shapes[-1][2], cfg.num_classes)

    def forward(self, images: torch.Tensor, training: bool = False, generator=None):
        cfg = self.config
        dtype = cfg.compute_dtype
        train = None
        if training:
            progress = torch.clamp(self.step / float(cfg.total_training_steps), max=1.0)
            with torch.no_grad():
                self.step.add_(1.0)
            train = _Train(progress=progress, stats=[])
        drop_path = train is not None and cfg.drop_path_keep_prob < 1.0
        conv, bn = (getattr(self, name) for name in self._stem)
        net = bn(conv(images, dtype), train)
        outputs = [None, net]
        aux_logits = None
        for name in self._cells:
            cell = getattr(self, name)
            noise = None
            if drop_path:
                noise = _uniform((cell.drop_paths, images.shape[0]), generator, images.device)
            net = self._run_cell(cell, net, outputs[-2], train, noise)
            if train is not None and name == self._aux_after:
                aux_logits = self.aux_head(net, train)
            outputs.append(net)
        net = torch.relu(net)
        pooled = net.mean(dim=(1, 2)).float()
        out = pooled
        if train is not None and cfg.dense_dropout_keep_prob < 1.0:
            # Flax's 1 - rate, rate = 1 - keep, in double as Flax has it.
            keep_prob = 1.0 - (1.0 - cfg.dense_dropout_keep_prob)
            out = _dropout(out, keep_prob, _uniform(out.shape, generator, images.device))
        logits = self.logits(out)
        if train is not None:
            _update_statistics(train.stats)
        return logits, aux_logits, pooled

    def _run_cell(self, cell, net, prev, train, noise):
        if train is None or not self.config.remat:
            return cell(net, prev, train, noise)
        calls = []

        def run(net, prev):
            # The backward's recompute reuses the forward's draws and
            # leaves the statistics to the forward.
            again = dataclasses.replace(train, stats=None) if calls else train
            calls.append(None)
            return cell(net, prev, again, noise)

        return checkpoint(run, net, prev, use_reentrant=False, preserve_rng_state=False)

    def sepconv_launch_shapes(self) -> List[Tuple[Shape, int, int, int]]:
        """Every K2 launch of one forward, in order (see
        `_SepConv.launch_shapes`)."""
        return [
            shape
            for module in self.modules()
            if isinstance(module, _SepConv)
            for shape in module.launch_shapes()
        ]


def init_parameters(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Flax's default initialisation from a `torch.Generator`: LeCun
    normal kernels, zero biases, unit batch-norm scales."""
    for sub in module.modules():
        if isinstance(sub, _Conv):
            kh, kw = sub.kernel
            _lecun_normal_(sub.weight, sub.weight.shape[1] * kh * kw, generator)
        elif isinstance(sub, _Dense):
            _lecun_normal_(sub.weight, sub.weight.shape[1], generator)
            with torch.no_grad():
                sub.bias.zero_()
