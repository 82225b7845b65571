"""K2: fused relu -> depthwise -> pointwise separable convolution.

Port of adanet_tpu/ops/sepconv_kernels.py. The kernel is hand-written
CUDA (`csrc/sepconv_kernel.cu`, replacing the Pallas `_sepconv_kernel`):
one block per tile of output pixels of one image, relu and the depthwise
taps in f32 into shared memory with the TF "SAME" halo bounds-checked
(no padded copy of x), then the pointwise product from shared memory,
stored in the input dtype. The source note says what bounds it.

Layouts: activations NHWC, as at the JAX package's boundary; weights in
PyTorch's conv layouts, depthwise `[C, 1, k, k]` and pointwise
`[F, C, 1, 1]` (what `utils.convert` makes of Flax's `[k, k, 1, C]` and
`[1, 1, C, F]`).

`sep_conv_reference` is the plain PyTorch version, with the kernel's
arithmetic: weights rounded to the input dtype, the depthwise result kept
in f32 into the pointwise product (the Pallas path; the unfused Flax path
rounds it to the compute dtype in between). `fused_sep_conv` takes it
only for CPU tensors. A CUDA tensor launches the kernel or raises: there
is no fallback by size, since the kernel tiles any shape that fits one
pixel's channels in shared memory. Forward only.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from adanet_tpu_torch.ops import _build

#: Shared memory one block may use on Hopper (bytes).
MAX_SHARED_BYTES = 227 * 1024
DEFAULT_TILE_P = 32


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int, int]:
    """TF/Flax 'SAME' padding (out, lo, hi) for one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    lo = total // 2
    return out, lo, total - lo


def sep_conv_reference(
    x: torch.Tensor, dw: torch.Tensor, pw: torch.Tensor, stride: int
) -> torch.Tensor:
    """relu -> SAME depthwise (stride) -> 1x1 pointwise, f32 inside.

    x: [B, H, W, C]; dw: [C, 1, k, k]; pw: [F, C, 1, 1] -> [B, H', W', F]
    in x's dtype.
    """
    _, h, w, c = x.shape
    k = dw.shape[-1]
    _, pt, pb = same_pads(h, k, stride)
    _, pl, pr = same_pads(w, k, stride)
    y = torch.relu(x).float().permute(0, 3, 1, 2)
    y = F.pad(y, (pl, pr, pt, pb))
    y = F.conv2d(y, dw.to(x.dtype).float(), stride=stride, groups=c)
    y = F.conv2d(y, pw.to(x.dtype).float())
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def tiles(c: int, f: int, k: int, tile_p: int = DEFAULT_TILE_P) -> Tuple[int, int]:
    """(tile_p, tile_f): pixels and output channels per block, shrunk
    until the block's f32 shared memory fits."""
    tile_f = f

    def need(tp, tf):
        return 4 * (tp * c + c * (tf + 1) + k * k * c)

    while need(tile_p, tile_f) > MAX_SHARED_BYTES:
        if tile_f > 32:
            tile_f = (tile_f + 1) // 2
        elif tile_p > 1:
            tile_p //= 2
        elif tile_f > 1:
            tile_f = (tile_f + 1) // 2
        else:
            raise ValueError(
                "sep-conv with C=%d, k=%d does not fit one block's shared "
                "memory" % (c, k)
            )
    return tile_p, tile_f


def fused_sep_conv(
    x: torch.Tensor, dw: torch.Tensor, pw: torch.Tensor, stride: int = 1
) -> torch.Tensor:
    """K2 wrapper: relu -> depthwise(k x k, SAME, stride) -> pointwise.

    CPU tensors take `sep_conv_reference`; CUDA tensors (x bf16 or f32
    NHWC, weights any float dtype) launch the kernel or raise.
    """
    if x.device.type == "cpu":
        return sep_conv_reference(x, dw, pw, stride)
    if x.device.type != "cuda":
        raise ValueError("fused_sep_conv: unsupported device %s" % x.device)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("fused_sep_conv takes float32 or bfloat16, got %s" % x.dtype)
    b, h, w, c = x.shape
    f, k = pw.shape[0], dw.shape[-1]
    if tuple(dw.shape) != (c, 1, k, k) or tuple(pw.shape) != (f, c, 1, 1):
        raise ValueError(
            "weights %s / %s do not fit x %s"
            % (tuple(dw.shape), tuple(pw.shape), tuple(x.shape))
        )
    if dw.device != x.device or pw.device != x.device:
        raise ValueError("fused_sep_conv: tensors on different devices")
    h_out, pt, _ = same_pads(h, k, stride)
    w_out, pl, _ = same_pads(w, k, stride)
    tile_p, tile_f = tiles(c, f, k)
    x = x.contiguous()
    dw = dw.to(torch.float32).contiguous()
    pw = pw.to(torch.float32).contiguous()
    out = torch.empty((b, h_out, w_out, f), dtype=x.dtype, device=x.device)
    fn = _build.library("sepconv")
    code = fn(
        x.data_ptr(),
        dw.data_ptr(),
        pw.data_ptr(),
        out.data_ptr(),
        b,
        h,
        w,
        c,
        f,
        k,
        stride,
        h_out,
        w_out,
        pt,
        pl,
        tile_p,
        tile_f,
        int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(code, "sepconv_forward")
    fused_sep_conv.launches += 1
    return out


fused_sep_conv.launches = 0
