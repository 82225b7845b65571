"""Transformer encoder subnetworks with optional sequence parallelism.

Port of adanet_tpu/models/transformer.py. Attention runs as exact ring
attention over a `parallel.SequenceMesh` when the config has one
(`sp_mesh`), else as full attention; either way a long-context candidate
trains inside the AdaNet search like any other.

The arithmetic follows the Flax modules: parameters are f32 and cast to
`compute_dtype` where they are used; the embeddings come out in the
compute dtype and the residual stream stays in it; every LayerNorm runs
in f32 (epsilon 1e-6) and returns f32; the dense layers compute in the
compute dtype; the MLP's GELU is the tanh approximation; the pooled
output is the f32 mean over the sequence and the logits layer is f32.

Parameters keep the Flax names and layouts (`qkv` kernel [D, 3, H, Dh],
`proj` kernel [H, Dh, D], dense kernels [in, out]), so that
`utils.convert.convert_transformer` carries a Flax tree over by path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from adanet_tpu_torch.parallel.ring_attention import full_attention, ring_attention
from adanet_tpu_torch.subnetwork.generator import Builder, Subnetwork


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32_000
    num_layers: int = 2
    num_heads: int = 4
    model_dim: int = 128
    mlp_dim: int = 512
    max_seq_len: int = 2048
    dropout: float = 0.0
    causal: bool = True
    compute_dtype: Any = torch.bfloat16
    # Sequence parallelism: the mesh (a `parallel.SequenceMesh`) and axis
    # to ring-shard attention over.
    sp_mesh: Optional[Any] = None
    sp_axis: str = "sp"


def _truncated_normal_(t: torch.Tensor, std: float, generator) -> None:
    """Flax's variance-scaling "normal": a normal truncated at two
    standard deviations, scaled to `std`."""
    std = std / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class _Dense(nn.Module):
    """`y = x . kernel + bias` over the last `in_dims` axes of x, in
    `dtype` (Flax's `Dense` / `DenseGeneral`)."""

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int], use_bias: bool, dtype):
        super().__init__()
        self.in_shape, self.out_shape, self.dtype = tuple(in_shape), tuple(out_shape), dtype
        self.kernel = nn.Parameter(torch.empty(self.in_shape + self.out_shape))
        self.bias = nn.Parameter(torch.empty(self.out_shape)) if use_bias else None

    def init_parameters(self, generator) -> None:
        _truncated_normal_(self.kernel.data, math.sqrt(1.0 / math.prod(self.in_shape)), generator)
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x):
        n_in = len(self.in_shape)
        lead = x.shape[: x.dim() - n_in]
        kernel = self.kernel.to(self.dtype).reshape(math.prod(self.in_shape), -1)
        y = torch.matmul(x.to(self.dtype).reshape(-1, kernel.shape[0]), kernel)
        y = y.reshape(tuple(lead) + self.out_shape)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class _LayerNorm(nn.Module):
    """Flax `LayerNorm(dtype=float32)`: f32 statistics and output."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def init_parameters(self, generator) -> None:
        self.scale.data.fill_(1.0)
        self.bias.data.zero_()

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.scale, self.bias, eps=1e-6)


class _Embed(nn.Module):
    def __init__(self, num: int, dim: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(num, dim))

    def init_parameters(self, generator) -> None:
        _truncated_normal_(self.embedding.data, math.sqrt(1.0 / self.embedding.shape[1]), generator)

    def forward(self, ids):
        return self.embedding[ids].to(self.dtype)


def _dropout(x, rate: float, training: bool, generator):
    if rate <= 0 or not training:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class _Attention(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        heads = config.num_heads
        dim = config.model_dim // heads
        self.qkv = _Dense((config.model_dim,), (3, heads, dim), False, config.compute_dtype)
        self.proj = _Dense((heads, dim), (config.model_dim,), False, config.compute_dtype)

    def forward(self, x):
        cfg = self.config
        qkv = self.qkv(x)
        q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
        if cfg.sp_mesh is not None:
            out = ring_attention(q, k, v, cfg.sp_mesh, axis_name=cfg.sp_axis, causal=cfg.causal)
        else:
            out = full_attention(q, k, v, causal=cfg.causal)
        return self.proj(out)


class _Block(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        self.ln1 = _LayerNorm(config.model_dim)
        self.attention = _Attention(config)
        self.ln2 = _LayerNorm(config.model_dim)
        self.mlp_in = _Dense((config.model_dim,), (config.mlp_dim,), True, config.compute_dtype)
        self.mlp_out = _Dense((config.mlp_dim,), (config.model_dim,), True, config.compute_dtype)

    def forward(self, x, training: bool, generator=None):
        rate = self.config.dropout
        y = _dropout(self.attention(self.ln1(x)), rate, training, generator)
        x = x + y
        y = F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh")
        y = _dropout(self.mlp_out(y), rate, training, generator)
        return x + y


class TransformerEncoder(nn.Module):
    """Token ids [batch, seq] -> (pooled [batch, dim] f32, per-token
    features)."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        self.embed = _Embed(config.vocab_size, config.model_dim, config.compute_dtype)
        self.pos_embed = _Embed(config.max_seq_len, config.model_dim, config.compute_dtype)
        self.blocks = nn.ModuleList(_Block(config) for _ in range(config.num_layers))
        self.ln_f = _LayerNorm(config.model_dim)

    def forward(self, token_ids, training: bool = False, generator=None):
        cfg = self.config
        if token_ids.shape[1] > cfg.max_seq_len:
            raise ValueError(
                "Sequence length %d exceeds max_seq_len %d (position embeddings would silently clamp)."
                % (token_ids.shape[1], cfg.max_seq_len)
            )
        x = self.embed(token_ids.long())
        positions = torch.arange(token_ids.shape[1], device=token_ids.device)
        x = x + self.pos_embed(positions)[None]
        for block in self.blocks:
            x = block(x, training, generator)
        x = self.ln_f(x)
        return x.mean(dim=1).float(), x


class _TransformerSubnetworkModule(nn.Module):
    def __init__(self, config: TransformerConfig, logits_dimension: int):
        super().__init__()
        self.config = config
        self.encoder = TransformerEncoder(config)
        self.logits = _Dense((config.model_dim,), (logits_dimension,), True, torch.float32)

    def init_parameters(self, generator: torch.Generator) -> None:
        """Flax's default inits from `generator`: LeCun-normal kernels
        (truncated), zero biases, unit LayerNorm scales, embeddings with
        variance 1/dim."""
        with torch.no_grad():
            for module in self.modules():
                if module is not self and hasattr(module, "init_parameters"):
                    module.init_parameters(generator)

    def forward(self, features, training: bool = False, generator: Optional[torch.Generator] = None):
        tokens = features["tokens"] if isinstance(features, dict) else features
        pooled, _ = self.encoder(tokens, training=training, generator=generator)
        cfg = self.config
        return Subnetwork(
            last_layer=pooled,
            logits=self.logits(pooled),
            complexity=math.sqrt(cfg.num_layers),
            shared={"num_layers": cfg.num_layers, "model_dim": cfg.model_dim},
        )


def adamw(learning_rate: float = 1e-3, weight_decay: float = 1e-4) -> Callable:
    """`optax.adamw(learning_rate)` with optax's defaults (b1 0.9, b2
    0.999, eps 1e-8, weight decay 1e-4 on every parameter), as an
    optimizer factory: torch's AdamW decays by lr * weight_decay * p
    from the step's starting parameters, as optax does."""
    return lambda params: torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                            weight_decay=weight_decay)


class TransformerBuilder(Builder):
    """AdaNet builder over transformer encoders (sequence classification).

    `optimizer` is a factory `params -> torch.optim.Optimizer`; the
    default is `adamw(1e-3)`, the JAX builder's `optax.adamw(1e-3)`."""

    def __init__(self, config: TransformerConfig, optimizer: Optional[Callable] = None, name: Optional[str] = None):
        self._config = config
        self._optimizer = optimizer or adamw(1e-3)
        self._name = name

    @property
    def name(self) -> str:
        return self._name or "transformer_%dl_%dd" % (self._config.num_layers, self._config.model_dim)

    def build_subnetwork(self, logits_dimension, previous_ensemble=None, *, input_shape=None):
        return _TransformerSubnetworkModule(self._config, logits_dimension)

    def build_train_optimizer(self, previous_ensemble=None):
        optimizer = self._optimizer
        return lambda named_parameters: optimizer([p for _, p in named_parameters])
