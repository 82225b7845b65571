"""K1: fused mixture-weight combine, `bias + sum_n w_n * logits_n`.

Port of adanet_tpu/ops/ensemble_kernels.py. The kernel is hand-written
CUDA (`csrc/combine_kernel.cu`, replacing the Pallas `_combine_kernel`):
one thread per output element, the member sum in f32 registers, the
stacked logits read once. It is bound by bytes; see the source note.

`combine_reference` is the plain PyTorch version. `fused_weighted_combine`
takes it only for CPU tensors; a CUDA tensor launches the kernel or
raises. Forward only: the backward comes with the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from adanet_tpu_torch.ops import _build


def combine_reference(
    stacked_logits: torch.Tensor,
    weights: torch.Tensor,
    bias: Optional[torch.Tensor],
) -> torch.Tensor:
    """bias + sum_n w_n * logits_n.

    stacked_logits: [N, B, C]; weights: [N] (scalar per member) or [N, C]
    (vector per member); bias: [C] or None.
    """
    if weights.dim() == 1:
        w = weights[:, None, None]
    else:
        w = weights[:, None, :]
    out = torch.sum(stacked_logits * w, dim=0)
    if bias is not None:
        out = out + bias
    return out


def fused_weighted_combine(
    stacked_logits: torch.Tensor,
    weights: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K1 wrapper: plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (f32 logits, weights and bias; raises on anything else)."""
    if stacked_logits.device.type == "cpu":
        return combine_reference(stacked_logits, weights, bias)
    if stacked_logits.device.type != "cuda":
        raise ValueError(
            "fused_weighted_combine: unsupported device %s" % stacked_logits.device
        )
    n, b, c = stacked_logits.shape
    if weights.shape not in ((n,), (n, c)):
        raise ValueError(
            "weights of shape %s do not fit logits %s"
            % (tuple(weights.shape), tuple(stacked_logits.shape))
        )
    if bias is not None and tuple(bias.shape) != (c,):
        raise ValueError("bias of shape %s, want (%d,)" % (tuple(bias.shape), c))
    tensors = [stacked_logits, weights] + ([bias] if bias is not None else [])
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError("fused_weighted_combine takes float32, got %s" % t.dtype)
        if t.device != stacked_logits.device:
            raise ValueError("fused_weighted_combine: tensors on different devices")
    stacked_logits = stacked_logits.contiguous()
    weights = weights.contiguous()
    bias = bias.contiguous() if bias is not None else None
    out = torch.empty((b, c), dtype=torch.float32, device=stacked_logits.device)
    code = _build.library("combine")(
        stacked_logits.data_ptr(),
        weights.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        out.data_ptr(),
        n,
        b,
        c,
        int(weights.dim() == 2),
        _build.stream_handle(stacked_logits),
    )
    if code:
        _build.check(code, "combine_forward")
    fused_weighted_combine.launches += 1
    return out


fused_weighted_combine.launches = 0
