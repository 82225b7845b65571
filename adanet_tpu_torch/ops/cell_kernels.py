"""K3: one fused NASNet-A cell (folded-affine form).

Port of adanet_tpu/ops/cell_kernels.py. A NASNet-A cell chains ten
branch ops (separable convs, pools, identities) into five blocks, sums
each block's two branches, concatenates the unused states and, in a
reduction cell, factorized-reduces any unused full-resolution state.
Every batch norm is a per-channel (scale, bias) pair: the inference form
after statistics are folded in, under which the cell is a pure function
of its inputs (the training path keeps `models/nasnet.py`'s per-op
composition).

The kernel is hand-written CUDA (`csrc/cell_kernel.cu`, replacing the
Pallas `_cell_kernel`). The TPU kernel holds a batch tile's whole state
list in VMEM; a Hopper block has 227 KB of shared memory, so the port
runs the cell as a sequence of launches of four kernels on one stream
(1x1 product, separable layer, 3x3 pool or copy, bf16 cast), each
writing or adding into a channel slot of an f32 state buffer, with the
unused states written straight into their slots of the output (the
source note says what bounds it).

`cell_reference` is the plain PyTorch version with `_cell_body`'s
arithmetic: f32 inside, the output cast to `cur`'s dtype, explicit
TF-SAME pads. `fused_cell` takes it only for CPU tensors. A CUDA tensor
launches the kernels or raises. Where the JAX wrapper silently falls
back to its reference (a spatial mismatch between `prev` and `cur`, an
unsupported op) this one raises. It is differentiable: the backward
recomputes the cell through `cell_reference` under autograd, as the JAX
custom VJP takes `jax.vjp` of its reference.

Layouts: activations NHWC; depthwise `[C, 1, k, k]`, pointwise
`[F, C, 1, 1]`, a 1x1 `w` as `[F, C]` (what `utils.convert.
convert_cell_params` makes of the JAX tree); affines always f32.

Tiles: `tile_p` output pixels per block, from the store-persisted
autotuner (`ops/tuning.py`, family "cell") when it has a winner for this
workload and device, else `DEFAULT_TILE_P`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from adanet_tpu_torch._device import resolve_device
from adanet_tpu_torch.ops import _build, tuning
from adanet_tpu_torch.ops.sepconv_kernels import MAX_SHARED_BYTES, same_pads

DEFAULT_TILE_P = 64


@dataclasses.dataclass(frozen=True)
class CellSpec:
    """Static structure of one cell: the NASNet-A wiring tables.

    `operations[2b]`/`operations[2b+1]` are block b's left/right branch
    ops applied to `states[hiddenstate_indices[2b]]` /
    `states[hiddenstate_indices[2b+1]]`; `used_hiddenstates[i] == 0`
    marks `states[i]` for the final concat. `stride` > 1 makes this a
    reduction cell: branch ops consuming an ORIGINAL input (state index
    < 2) apply the stride, later states are already reduced.

    Supported ops: `separable_<k>x<k>_<n>`, `avg_pool_3x3`,
    `max_pool_3x3`, `none`.
    """

    operations: Tuple[str, ...]
    hiddenstate_indices: Tuple[int, ...]
    used_hiddenstates: Tuple[int, ...]
    stride: int = 1

    def __post_init__(self):
        if len(self.operations) != len(self.hiddenstate_indices):
            raise ValueError("operations / hiddenstate_indices mismatch")
        if len(self.operations) % 2:
            raise ValueError("operations must pair up into blocks")
        if len(self.used_hiddenstates) != 2 + self.num_blocks:
            raise ValueError(
                "used_hiddenstates must cover 2 inputs + %d blocks"
                % self.num_blocks
            )

    @property
    def num_blocks(self) -> int:
        return len(self.operations) // 2


NORMAL_CELL = CellSpec(
    operations=(
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
    ),
    hiddenstate_indices=(0, 1, 1, 1, 0, 1, 1, 1, 0, 0),
    used_hiddenstates=(1, 0, 0, 0, 0, 0, 0),
    stride=1,
)
REDUCTION_CELL = CellSpec(
    operations=(
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
    ),
    hiddenstate_indices=(0, 1, 0, 1, 0, 1, 3, 2, 2, 0),
    used_hiddenstates=(1, 1, 1, 0, 0, 0, 0),
    stride=2,
)


def _parse_separable(operation: str) -> Tuple[int, int]:
    parts = operation.split("_")
    return int(parts[1].split("x")[0]), int(parts[2])


def _branch_stride(spec: CellSpec, state_index: int) -> int:
    """The stride a branch applies: reductions hit original inputs only."""
    return spec.stride if state_index < 2 else 1


def _lecun_normal(generator, shape, fan_in, dtype, device):
    """Flax's lecun_normal: truncated normal (at 2 std), variance 1/fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    w = torch.empty(shape)
    torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    return w.to(device=device, dtype=dtype)


def init_cell_params(
    generator: torch.Generator,
    spec: CellSpec,
    prev_channels: int,
    cur_channels: int,
    filters: int,
    dtype=torch.float32,
    device="cuda",
) -> Dict[str, Any]:
    """The cell's parameter tree for `spec`, drawn from `generator`.

    The structure of the JAX `init_cell_params`, in the port's layouts:
    `begin` (1x1 of `cur`), `prev` (present iff prev_channels !=
    filters), `blocks[b]` = {"left", "right"} branches (separable:
    {"layers": (dw, pw, scale, bias)...}; strided `none`: a 1x1; else
    {}), and `reductions` {str(i): {w1, w2, scale, bias}} for every
    unused full-resolution state of a stride-2 cell. Affines are f32,
    weights `dtype`.
    """
    dev = resolve_device(device)

    def affine():
        return {
            "scale": torch.ones(filters, device=dev),
            "bias": torch.zeros(filters, device=dev),
        }

    def conv1x1(in_ch):
        return {"w": _lecun_normal(generator, (filters, in_ch), in_ch, dtype, dev), **affine()}

    def branch(operation, stride):
        if "separable" in operation:
            kernel, num_layers = _parse_separable(operation)
            return {
                "layers": tuple(
                    {
                        "dw": _lecun_normal(
                            generator, (filters, 1, kernel, kernel), kernel * kernel, dtype, dev
                        ),
                        "pw": _lecun_normal(generator, (filters, filters, 1, 1), filters, dtype, dev),
                        **affine(),
                    }
                    for _ in range(num_layers)
                )
            }
        if operation == "none" and stride > 1:
            return conv1x1(filters)
        return {}

    params: Dict[str, Any] = {"begin": conv1x1(cur_channels)}
    if prev_channels != filters:
        params["prev"] = conv1x1(prev_channels)
    params["blocks"] = tuple(
        {
            side: branch(
                spec.operations[2 * b + k],
                _branch_stride(spec, spec.hiddenstate_indices[2 * b + k]),
            )
            for k, side in enumerate(("left", "right"))
        }
        for b in range(spec.num_blocks)
    )
    reductions: Dict[str, Any] = {}
    if spec.stride > 1:
        for idx, used in enumerate(spec.used_hiddenstates):
            if not used and idx < 2:
                half = filters // 2
                reductions[str(idx)] = {
                    "w1": _lecun_normal(generator, (half, filters), filters, dtype, dev),
                    "w2": _lecun_normal(generator, (filters - half, filters), filters, dtype, dev),
                    **affine(),
                }
    params["reductions"] = reductions
    return params


def output_shape(
    spec: CellSpec, batch: int, h: int, w: int, filters: int
) -> Tuple[int, int, int, int]:
    h_out = -(-h // spec.stride)
    w_out = -(-w // spec.stride)
    num_unused = sum(1 for u in spec.used_hiddenstates if not u)
    return (batch, h_out, w_out, filters * num_unused)


# --------------------------------------------------------------- plain version


def _affine(x, p):
    return x * p["scale"].float() + p["bias"].float()


def _project(y, w):
    """[..., C] x w [F, C] -> [..., F], f32."""
    return torch.matmul(y, w.float().t())


def _conv1x1(x, p, stride):
    """relu -> 1x1 conv (stride by subsampling) -> affine, f32."""
    y = torch.relu(x).float()
    if stride > 1:
        y = y[:, ::stride, ::stride, :]
    return _affine(_project(y, p["w"]), p)


def _sepconv_layer(x, layer, stride):
    """relu -> k x k depthwise (TF SAME) -> 1x1 pointwise -> affine."""
    k = layer["dw"].shape[-1]
    _, h, w, c = x.shape
    _, pt, pb = same_pads(h, k, stride)
    _, pl, pr = same_pads(w, k, stride)
    y = F.pad(torch.relu(x).float().permute(0, 3, 1, 2), (pl, pr, pt, pb))
    y = F.conv2d(y, layer["dw"].float(), stride=stride, groups=c)
    y = _project(y.permute(0, 2, 3, 1), layer["pw"][:, :, 0, 0])
    return _affine(y, layer)


def _pool(x, kind: str, stride: int):
    """3x3 SAME pool: count_include_pad avg (always / 9), -inf-padded max."""
    _, h, w, _ = x.shape
    _, pt, pb = same_pads(h, 3, stride)
    _, pl, pr = same_pads(w, 3, stride)
    fill = 0.0 if kind == "avg" else float("-inf")
    y = F.pad(x.float().permute(0, 3, 1, 2), (pl, pr, pt, pb), value=fill)
    pool = F.avg_pool2d if kind == "avg" else F.max_pool2d
    return pool(y, 3, stride).permute(0, 2, 3, 1)


def _factorized_reduction(x, p):
    """Two-path stride-2 reduction, no leading relu: path 1 reads
    x[2i, 2j], path 2 x[2i+1, 2j+1] (zero past the bottom/right edge)."""
    xf = x.float()
    path1 = _project(xf[:, ::2, ::2, :], p["w1"])
    shifted = F.pad(xf, (0, 0, 0, 1, 0, 1))[:, 1:, 1:, :]
    path2 = _project(shifted[:, ::2, ::2, :], p["w2"])
    return _affine(torch.cat([path1, path2], dim=-1), p)


def _apply_branch(x, operation, params, stride):
    if "separable" in operation:
        y = x
        for layer_index, layer in enumerate(params["layers"]):
            y = _sepconv_layer(y, layer, stride if layer_index == 0 else 1)
        return y
    if "pool" in operation:
        return _pool(x, operation.split("_")[0], stride)
    if operation == "none":
        if stride > 1:
            return _conv1x1(x, params, stride)
        return x.float()
    raise ValueError("Unsupported cell operation %r" % operation)


def cell_reference(prev, cur, params, spec: CellSpec):
    """Plain PyTorch cell (folded-affine form), the kernel's arithmetic.

    prev, cur: [B, H, W, C_prev] / [B, H, W, C_cur] at the same spatial
    resolution. Returns [B, H', W', filters * num_unused] in cur's dtype.
    """
    x = _conv1x1(cur, params["begin"], 1)
    prev_state = _conv1x1(prev, params["prev"], 1) if "prev" in params else prev.float()
    states = [x, prev_state]
    for b, block in enumerate(params["blocks"]):
        pair = []
        for k, side in enumerate(("left", "right")):
            idx = spec.hiddenstate_indices[2 * b + k]
            pair.append(
                _apply_branch(
                    states[idx], spec.operations[2 * b + k], block[side], _branch_stride(spec, idx)
                )
            )
        states.append(pair[0] + pair[1])
    final = states[-1]
    to_combine = []
    for idx, used in enumerate(spec.used_hiddenstates):
        if used:
            continue
        state = states[idx]
        if state.shape[1] != final.shape[1]:
            state = _factorized_reduction(state, params["reductions"][str(idx)])
        to_combine.append(state)
    return torch.cat(to_combine, dim=-1).to(cur.dtype)


# --------------------------------------------------------------- tiles


def cell_filters(params) -> int:
    return int(params["begin"]["w"].shape[0])


def tune_spec(prev_shape, cur_shape, dtype, filters: int, spec: CellSpec) -> Dict[str, Any]:
    """The autotuner's workload identity: the JAX `_tune_spec` dict."""
    return {
        "prev_shape": list(prev_shape),
        "cur_shape": list(cur_shape),
        "dtype": str(dtype).replace("torch.", ""),
        "filters": int(filters),
        "operations": list(spec.operations),
        "hiddenstate_indices": list(spec.hiddenstate_indices),
        "used_hiddenstates": list(spec.used_hiddenstates),
        "stride": spec.stride,
    }


def sep_layer_tiles(c: int, f: int, k: int, tile_p: int) -> Tuple[int, int]:
    """(tile_p, tile_f) of one separable layer: shrunk (channels first,
    down to 32, then pixels) until the block's shared memory fits."""
    tile_f = f

    def need(tp, tf):
        return 4 * (tp * (c + 1) + c * (tf + 1) + k * k * c)

    while need(tile_p, tile_f) > MAX_SHARED_BYTES:
        if tile_f > 32:
            tile_f = (tile_f + 1) // 2
        elif tile_p > 1:
            tile_p //= 2
        elif tile_f > 1:
            tile_f = (tile_f + 1) // 2
        else:
            raise ValueError(
                "separable layer with C=%d, k=%d does not fit one block's "
                "shared memory" % (c, k)
            )
    return tile_p, tile_f


def tile_candidates(batch: int, h: int, w: int, filters: int, spec: CellSpec) -> List[int]:
    """`tile_p` candidates for the autotuner, largest first, up to the
    cell's largest launch (its input resolution). The largest block is
    the separable layer's at the spec's largest kernel, with whole rows
    of output channels (the 1x1 and pool kernels use 25 KB of static
    shared memory or none)."""
    k = max((_parse_separable(op)[0] for op in spec.operations if "separable" in op), default=1)
    per_pixel = 4 * (filters + 1)
    fixed = 4 * (filters * (filters + 1) + k * k * filters)
    return tuning.candidate_tile_sizes(batch * h * w, per_pixel, fixed, MAX_SHARED_BYTES)


def select_tile_p(prev_shape, cur_shape, dtype, filters: int, spec: CellSpec, device) -> int:
    """The tuned `tile_p` for this workload on `device` when the store
    has one, else `DEFAULT_TILE_P`."""
    tuned = tuning.lookup(
        "cell", tune_spec(prev_shape, cur_shape, dtype, filters, spec), device=device
    )
    if tuned:
        candidate = tuned.get("tile_p")
        if isinstance(candidate, int) and candidate > 0:
            return candidate
    return DEFAULT_TILE_P


# --------------------------------------------------------------- kernel path


@dataclasses.dataclass
class _Slot:
    """A channel slot of an NHWC buffer: `tensor[..., offset:offset+F]`."""

    tensor: torch.Tensor
    offset: int
    h: int
    w: int

    @property
    def ptr(self) -> int:
        return self.tensor.data_ptr() + self.offset * self.tensor.element_size()

    @property
    def stride(self) -> int:
        return int(self.tensor.shape[-1])


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _threads_along_f(f: int) -> int:
    return 8 if f <= 32 else 16


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


class _Launcher:
    """Launches K3's kernels for one cell call; counts them."""

    def __init__(self, batch: int, tile_p: int, device):
        self.batch = batch
        self.tile_p = tile_p
        self.device = device
        self.kernels = 0

    def _done(self, code: int, what: str) -> None:
        _build.check(code, what)
        self.kernels += 1

    def conv1x1(self, src: _Slot, dst: _Slot, p, stride=1, shift=0, relu=True,
                accumulate=False, w=None, scale=None, bias=None) -> None:
        w = _f32(p["w"] if w is None else w)
        scale = _f32(p["scale"] if scale is None else scale)
        bias = _f32(p["bias"] if bias is None else bias)
        f, c = w.shape
        code = _build.library("cell", "cell_conv1x1")(
            src.ptr, src.stride, w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            dst.ptr, dst.stride, int(accumulate), self.batch, src.h, src.w, c, f,
            stride, shift, int(relu), dst.h, dst.w, self.tile_p, _threads_along_f(f),
            int(src.tensor.dtype == torch.bfloat16), _stream(dst.tensor),
        )
        self._done(code, "cell_conv1x1")

    def sep_layer(self, src: _Slot, dst: _Slot, layer, stride, accumulate) -> None:
        dw, pw = _f32(layer["dw"]), _f32(layer["pw"])
        scale, bias = _f32(layer["scale"]), _f32(layer["bias"])
        f, c, k = pw.shape[0], dw.shape[0], dw.shape[-1]
        _, pt, _ = same_pads(src.h, k, stride)
        _, pl, _ = same_pads(src.w, k, stride)
        tile_p, tile_f = sep_layer_tiles(c, f, k, self.tile_p)
        code = _build.library("cell", "cell_sep_layer")(
            src.ptr, src.stride, dw.data_ptr(), pw.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), dst.ptr, dst.stride, int(accumulate), self.batch,
            src.h, src.w, c, f, k, stride, dst.h, dst.w, pt, pl, tile_p, tile_f,
            _threads_along_f(tile_f), _stream(dst.tensor),
        )
        self._done(code, "cell_sep_layer")

    def pool(self, src: _Slot, dst: _Slot, channels: int, mode: str, stride=1,
             accumulate=False) -> None:
        _, pt, _ = same_pads(src.h, 3, stride)
        _, pl, _ = same_pads(src.w, 3, stride)
        code = _build.library("cell", "cell_pool")(
            src.ptr, src.stride, dst.ptr, dst.stride, int(accumulate), self.batch,
            src.h, src.w, channels, {"copy": 0, "avg": 1, "max": 2}[mode], stride,
            dst.h, dst.w, pt, pl, self.tile_p, int(src.tensor.dtype == torch.bfloat16),
            _stream(dst.tensor),
        )
        self._done(code, "cell_pool")

    def cast(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        code = _build.library("cell", "cell_cast_bf16")(
            src.data_ptr(), dst.data_ptr(), src.numel(), _stream(dst)
        )
        self._done(code, "cell_cast_bf16")

    def scratch(self, h: int, w: int, f: int) -> _Slot:
        t = torch.empty((self.batch, h, w, f), dtype=torch.float32, device=self.device)
        return _Slot(t, 0, h, w)

    def branch(self, src: _Slot, dst: _Slot, operation, params, stride, f, accumulate):
        if "separable" in operation:
            layers = params["layers"]
            x = src
            for i, layer in enumerate(layers):
                s = stride if i == 0 else 1
                last = i == len(layers) - 1
                out = dst if last else self.scratch(-(-x.h // s), -(-x.w // s), f)
                self.sep_layer(x, out, layer, s, accumulate and last)
                x = out
        elif "pool" in operation:
            self.pool(src, dst, f, operation.split("_")[0], stride, accumulate)
        elif operation == "none" and stride > 1:
            self.conv1x1(src, dst, params, stride=stride, accumulate=accumulate)
        elif operation == "none":
            self.pool(src, dst, f, "copy", 1, accumulate)
        else:
            raise ValueError("Unsupported cell operation %r" % operation)


def _check_supported(spec: CellSpec) -> None:
    for op in spec.operations:
        if not (op.startswith("separable_") or op in ("avg_pool_3x3", "max_pool_3x3", "none")):
            raise ValueError("Unsupported cell operation %r" % op)


def _forward_cuda(prev, cur, params, spec: CellSpec, tile_p: int):
    """Runs the cell through K3's kernels; returns (output, kernels
    launched)."""
    if cur.dtype not in (torch.float32, torch.bfloat16) or prev.dtype != cur.dtype:
        raise TypeError(
            "fused_cell takes float32 or bfloat16 prev/cur of one dtype, got %s / %s"
            % (prev.dtype, cur.dtype)
        )
    if prev.device != cur.device:
        raise ValueError("fused_cell: prev and cur on different devices")
    b, h, w, _ = cur.shape
    f = cell_filters(params)
    if "prev" not in params and prev.shape[-1] != f:
        raise ValueError("prev has %d channels and no projection to %d" % (prev.shape[-1], f))
    prev, cur = prev.contiguous(), cur.contiguous()
    out_shape = output_shape(spec, b, h, w, f)
    ho, wo = out_shape[1], out_shape[2]
    out = torch.empty(out_shape, dtype=cur.dtype, device=cur.device)
    acc = out if cur.dtype == torch.float32 else torch.empty(out_shape, dtype=torch.float32, device=cur.device)
    unused = [i for i, used in enumerate(spec.used_hiddenstates) if not used]
    reduced = (ho, wo) if spec.stride > 1 else (h, w)
    resolution = [(h, w), (h, w)] + [reduced] * spec.num_blocks

    run = _Launcher(b, tile_p, cur.device)
    states: List[_Slot] = []
    for i, (hi, wi) in enumerate(resolution):
        if i in unused and (hi, wi) == (ho, wo):
            states.append(_Slot(acc, unused.index(i) * f, hi, wi))
        else:
            states.append(run.scratch(hi, wi, f))
    run.conv1x1(_Slot(cur, 0, h, w), states[0], params["begin"])
    if "prev" in params:
        run.conv1x1(_Slot(prev, 0, h, w), states[1], params["prev"])
    else:
        run.pool(_Slot(prev, 0, h, w), states[1], f, "copy")
    for blk, block in enumerate(params["blocks"]):
        for k, side in enumerate(("left", "right")):
            idx = spec.hiddenstate_indices[2 * blk + k]
            run.branch(
                states[idx], states[2 + blk], spec.operations[2 * blk + k], block[side],
                _branch_stride(spec, idx), f, accumulate=k == 1,
            )
    for j, idx in enumerate(unused):
        if resolution[idx] == (ho, wo):
            continue
        p = params["reductions"][str(idx)]
        half = p["w1"].shape[0]
        for shift, wname, lo, hi in ((0, "w1", 0, half), (1, "w2", half, f)):
            run.conv1x1(
                states[idx], _Slot(acc, j * f + lo, ho, wo), p, stride=2, shift=shift,
                relu=False, w=p[wname], scale=p["scale"][lo:hi], bias=p["bias"][lo:hi],
            )
    if acc is not out:
        run.cast(acc, out)
    return out, run.kernels


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flatten(tree[key], prefix + (key,))
    elif isinstance(tree, (tuple, list)):
        for i, item in enumerate(tree):
            yield from _flatten(item, prefix + (i,))
    else:
        yield prefix, tree


def _unflatten(like, leaves):
    """Rebuilds `like`'s structure with `leaves` in `_flatten` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        if isinstance(node, (tuple, list)):
            return tuple(build(item) for item in node)
        return next(it)

    return build(like)


class _FusedCell(torch.autograd.Function):
    """Forward through K3; backward through `cell_reference` under
    autograd (one extra forward, the JAX `_fused_bwd` trade)."""

    @staticmethod
    def forward(ctx, prev, cur, spec, like, tile_p, *leaves):
        params = _unflatten(like, leaves)
        out, kernels = _forward_cuda(prev, cur, params, spec, tile_p)
        fused_cell.device_kernels += kernels
        ctx.spec, ctx.like = spec, like
        ctx.save_for_backward(prev, cur, *leaves)
        return out

    @staticmethod
    def backward(ctx, grad):
        prev, cur, *leaves = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(True) for t in (prev, cur, *leaves)]
        with torch.enable_grad():
            out = cell_reference(inputs[0], inputs[1], _unflatten(ctx.like, inputs[2:]), ctx.spec)
        grads = torch.autograd.grad(out, inputs, grad, allow_unused=True)
        return (grads[0], grads[1], None, None, None, *grads[2:])


def fused_cell(prev, cur, params, spec: CellSpec):
    """K3 wrapper: one NASNet-A cell (folded-affine form).

    prev: [B, H, W, C_prev]; cur: [B, H, W, C_cur]; params from
    `init_cell_params` (or `utils.convert.convert_cell_params`). Returns
    [B, H', W', filters * num_unused] in cur's dtype. CPU tensors take
    `cell_reference`; CUDA tensors (float32 or bfloat16) launch the
    kernels or raise. Raises on a spatial mismatch between prev and cur
    (the model reduces `prev` upstream) and on an unsupported op.
    """
    if tuple(prev.shape[1:3]) != tuple(cur.shape[1:3]):
        raise ValueError(
            "fused_cell: prev %s and cur %s differ in spatial size; reduce prev "
            "first" % (tuple(prev.shape), tuple(cur.shape))
        )
    _check_supported(spec)
    if cur.device.type == "cpu" and prev.device.type == "cpu":
        return cell_reference(prev, cur, params, spec)
    if cur.device.type != "cuda":
        raise ValueError("fused_cell: unsupported device %s" % cur.device)
    tile_p = select_tile_p(prev.shape, cur.shape, cur.dtype, cell_filters(params), spec, cur.device)
    out = _launch(prev, cur, params, spec, tile_p)
    fused_cell.last_tile_p = tile_p
    return out


def _launch(prev, cur, params, spec: CellSpec, tile_p: int):
    """One counted run of K3 at a given `tile_p` (the autotuner's entry)."""
    leaves = [leaf for _, leaf in _flatten(params)]
    out = _FusedCell.apply(prev, cur, spec, params, tile_p, *leaves)
    fused_cell.launches += 1
    return out


fused_cell.launches = 0
#: CUDA kernels launched by K3 in all (several per `fused_cell` call).
fused_cell.device_kernels = 0
#: The `tile_p` of the last call on the card.
fused_cell.last_tile_p = None
