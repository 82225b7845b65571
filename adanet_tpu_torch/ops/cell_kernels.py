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
(1x1 product, separable layer, 3x3 pools or copies, bf16 cast), each
writing or adding into a channel slot of an f32 state buffer, with the
unused states written straight into their slots of the output (the
source note says what bounds it and what the design does about it).

`cell_reference` is the plain PyTorch version with `_cell_body`'s
arithmetic: f32 inside, the output cast to `cur`'s dtype, explicit
TF-SAME pads. `fused_cell` takes it only for CPU tensors. A CUDA tensor
launches the kernels or raises. Where the JAX wrapper silently falls
back to its reference (a spatial mismatch between `prev` and `cur`, an
unsupported op) this one raises. It is differentiable: the backward
recomputes the cell through `cell_reference` under autograd, as the JAX
custom VJP takes `jax.vjp` of its reference; a call that wants no
gradient skips autograd.

Layouts: activations NHWC; depthwise `[C, 1, k, k]`, pointwise
`[F, C, 1, 1]`, a 1x1 `w` as `[F, C]` (what `utils.convert.
convert_cell_params` makes of the JAX tree); affines always f32. The
kernels read the weights as `prepared_weight` lays them out, once per
tensor and version: 1x1 and pointwise as [C, F] f32, depthwise as
[k*k, C] f32.

Schedule: `cell_schedule` turns a cell signature (shapes, dtype,
filters, spec, whether `prev` is projected) into its launches in stream
order, each with its slots and its kernel's plan, sized from the output
and the card's SM count. `fused_cell` works the schedule out once per
signature per process and keeps it in `_SCHEDULES`, which `tuning`
drops whenever its own memo is dropped; a call then only binds pointers.
The pixel tile (`tile_p`, output pixels per block) comes from the
store-persisted autotuner (`ops/tuning.py`, family "cell") when it has
a winner for this workload and device, else it is `AUTO` and the
planner sizes every tile. The tile changes only how the work is cut,
never a result.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from adanet_tpu_torch._device import resolve_device
from adanet_tpu_torch.ops import _build, tuning
from adanet_tpu_torch.ops import sepconv_kernels as sk
from adanet_tpu_torch.ops.sepconv_kernels import same_pads

#: `tile_p` that asks the planner to size every tile (no tuned winner).
AUTO = sk.AUTO
DEFAULT_TILE_P = AUTO
#: Most input channels per shared-memory stage of the 1x1 kernel (a
#: multiple of 32; the planner takes fewer where C or shared memory asks).
CONV_CHUNK = 128
POOL_MODES = {"copy": 0, "avg": 1, "max": 2}
#: The kernels' plan structs, field for field.
CONV_FIELDS = (
    "B", "H", "W", "C", "F", "S", "shift", "relu", "Ho", "Wo", "x_stride", "o_stride",
    "accumulate", "tp", "tf", "kc", "lda", "ldb", "smem", "mma", "is_bf16",
)
SEP_FIELDS = sk.PLAN_FIELDS + ("x_stride", "o_stride", "accumulate", "mma")
POOL_FIELDS = ("B", "C", "Ho", "Wo", "o_stride", "accumulate", "nsrc", "is_bf16", "blocks") + tuple(
    name + str(i) for i in (0, 1) for name in ("H", "W", "S", "pt", "pl", "mode", "x_stride")
)
CAST_FIELDS = ("n", "blocks")
_FIELDS = {"conv1x1": CONV_FIELDS, "sep_layer": SEP_FIELDS, "pool": POOL_FIELDS, "cast": CAST_FIELDS}


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


def tile_candidates(batch: int, h: int, w: int, filters: int, spec: CellSpec) -> List[int]:
    """`tile_p` candidates for the autotuner: `AUTO` (the planned tiles)
    first, so that a sweep never stores a fixed tile worse than the plan,
    then the powers of two from the first that covers the cell's largest
    launch (its input resolution) down to 16 whose register tile holds
    all F output channels."""
    pixels = tuning.candidate_tile_sizes(batch * h * w, sk._ceil(filters, 8), 0, sk.TILE_OUTPUTS)
    return [AUTO] + pixels


def select_tile_p(prev_shape, cur_shape, dtype, filters: int, spec: CellSpec, device) -> int:
    """The tuned `tile_p` for this workload on `device` when the store
    has one, else `AUTO`."""
    tuned = tuning.lookup(
        "cell", tune_spec(prev_shape, cur_shape, dtype, filters, spec), device=device
    )
    if tuned:
        candidate = tuned.get("tile_p")
        if isinstance(candidate, int) and candidate > 0:
            return candidate
    return AUTO


# --------------------------------------------------------------- schedule


@dataclasses.dataclass(frozen=True)
class Slot:
    """A channel slot of an NHWC region: channels `offset .. offset +
    channels` of the [B, h, w, stride] region that starts at element
    `base` of `buffer` ("cur", "prev", "out", or "scratch", the call's one
    f32 allocation)."""

    buffer: str
    base: int
    h: int
    w: int
    stride: int
    offset: int
    channels: int


@dataclasses.dataclass
class Step:
    """One launch of the schedule: `kind` ("conv1x1", "sep_layer",
    "pool", "cast") reads `srcs` and writes, or with
    fields["accumulate"] adds into, `dst`. `fields` is the kernel's plan
    struct (`*_FIELDS`); `weights` are (parameter path, layout, first
    element) in the kernel's argument order; `modes` a pool's source
    modes ("copy", "avg", "max")."""

    kind: str
    srcs: Tuple[Slot, ...]
    dst: Slot
    fields: Dict[str, int]
    blocks: int
    weights: Tuple[Tuple[tuple, str, int], ...] = ()
    modes: Tuple[str, ...] = ()


#: Buffers of a call, in the order of the values `_launch_schedule`
#: passes; the step's weights follow them.
_BUFFERS = ("cur", "prev", "out", "scratch", None)
_KINDS = {"conv1x1": 0, "sep_layer": 1, "pool": 2, "cast": 3}


@dataclasses.dataclass
class CellSchedule:
    """Every launch of one cell signature, in stream order, with the
    scratch the call allocates (f32 elements) and its output shape;
    packed for `cell_forward` once: `program` (per step its kind, its
    plan's length and fields), `ptr_slots` (per pointer argument, the
    index of its base among the call's buffers and weights, and its byte
    offset) and `weight_groups` (per step, the parameter dict it reads
    and its leaves' names and layouts)."""

    tile_p: int
    steps: List[Step]
    scratch_elems: int
    out_shape: Tuple[int, int, int, int]
    elem_bytes: Dict[str, int]
    device_index: int = -1

    def __post_init__(self):
        program, slots, groups = [], [], []
        n_weights = 0
        for step in self.steps:
            fields = [step.fields[name] for name in _FIELDS[step.kind]]
            program += [_KINDS[step.kind], len(fields)] + fields
            args = [self._ptr(src) for src in step.srcs]
            if step.kind == "pool" and len(args) == 1:
                args.append((_BUFFERS.index(None), 0))
            leaves = []
            for path, layout, first in step.weights:
                args.append((len(_BUFFERS) + n_weights, 4 * first))
                leaves.append((path[-1], layout))
                n_weights += 1
            if leaves:  # a step's weights are leaves of one parameter dict
                groups.append((step.weights[0][0][:-1], tuple(leaves)))
            slots += args + [self._ptr(step.dst)]
        self.program = (ctypes.c_int * len(program))(*program)
        self.ptr_slots = tuple(slots)
        self.ptr_base = np.array([base for base, _ in slots], dtype=np.int64)
        self.ptr_offset = np.array([offset for _, offset in slots], dtype=np.uint64)
        self.weight_groups = tuple(groups)

    @property
    def min_blocks(self) -> int:
        return min(step.blocks for step in self.steps)

    def _ptr(self, slot: Slot):
        return (_BUFFERS.index(slot.buffer), (slot.base + slot.offset) * self.elem_bytes[slot.buffer])


class _Planner:
    """Plans each kernel's launch for one cell signature."""

    def __init__(self, batch: int, bf16: bool, tile_p: int, sms: int):
        self.batch, self.bf16, self.tile_p, self.sms = batch, bf16, tile_p, sms

    def _in_bf16(self, slot: Slot) -> int:
        return int(self.bf16 and slot.buffer in ("cur", "prev"))

    def conv(self, src: Slot, dst: Slot, path, stride=1, shift=0, relu=True,
             accumulate=False, w="w", lo=0) -> Step:
        """1x1: pixels x output channels a block, the tile's outputs at most
        TILE_OUTPUTS; AUTO halves pixels to 32, then channels to 32, then
        pixels to 16, then channels to 8, until the grid has `sms`
        blocks."""
        c, f = src.channels, dst.channels
        pixels = self.batch * dst.h * dst.w
        tf = sk._ceil(f, 8)
        if self.tile_p > 0:
            tp = min(sk._ceil(self.tile_p, 16), sk.TILE_OUTPUTS // 8)
        else:
            tp = 128
            while tp * tf > sk.TILE_OUTPUTS and tp > 16:
                tp //= 2
        while tp * tf > sk.TILE_OUTPUTS:
            tf = sk._half(tf)

        def blocks():
            return -(-pixels // tp) * -(-f // tf)

        while self.tile_p <= 0 and blocks() < self.sms:
            if tp > 32:
                tp //= 2
            elif tf > 32:
                tf = sk._half(tf)
            elif tp > 16:
                tp //= 2
            elif tf > 8:
                tf = sk._half(tf)
            else:
                break
        tf = min(tf, f)
        in_bf16 = self._in_bf16(src)
        elem = 2 if in_bf16 else 4
        ldb = sk._ceil(tf, 16) + 8

        def lda(kc):  # rows of 16 k + 8 bytes: the fragment loads hit 32 banks
            return kc + (8 if in_bf16 else 4)

        def shared(kc):  # pixel offsets, then two stages of input and weights
            return 8 * tp + 2 * (tp * lda(kc) * elem + kc * ldb * 4)

        # The widest chunk (fewest waits), C rounded to 32, whose blocks
        # still fit the grid on the SMs in one wave (and two an SM at most).
        per_sm = -(-blocks() // max(1, self.sms))
        budget = min(sk.SHARED_TARGET_BYTES, sk.MAX_SHARED_BYTES // max(1, per_sm) - 1024)
        kc = min(CONV_CHUNK, sk._ceil(c, 32))
        while kc > 32 and shared(kc) > budget:
            kc -= 32
        fields = dict(
            B=self.batch, H=src.h, W=src.w, C=c, F=f, S=stride, shift=shift, relu=int(relu),
            Ho=dst.h, Wo=dst.w, x_stride=src.stride, o_stride=dst.stride,
            accumulate=int(accumulate), tp=tp, tf=tf, kc=kc, lda=lda(kc), ldb=ldb,
            smem=shared(kc), mma=int(self.bf16), is_bf16=in_bf16,
        )
        weights = ((path + (w,), "t", 0), (path + ("scale",), "f32", lo), (path + ("bias",), "f32", lo))
        return Step("conv1x1", (src,), dst, fields, blocks(), weights)

    def sep_layer(self, src: Slot, dst: Slot, path, k: int, stride: int, accumulate: bool) -> Step:
        """K2's plan (`sepconv_kernels.launch_plan`) at f32 staging; a
        tuned tile at most the pixels whose register tile holds 8
        channels."""
        f = dst.channels
        tile = min(self.tile_p, sk.TILE_OUTPUTS // 8) if self.tile_p > 0 else AUTO
        plan = sk.launch_plan((self.batch, src.h, src.w, src.channels), torch.float32, f, k,
                              stride, tile, self.sms)
        fields = dict(plan.fields, x_stride=src.stride, o_stride=dst.stride,
                      accumulate=int(accumulate), mma=int(self.bf16))
        weights = tuple((path + (name,), layout, 0) for name, layout in
                        (("dw", "t"), ("pw", "t"), ("scale", "f32"), ("bias", "f32")))
        return Step("sep_layer", (src,), dst, fields, plan.blocks, weights)

    def pool(self, sources, dst: Slot, accumulate=False) -> Step:
        """`sources`: one or two (slot, mode, stride), summed."""
        c = dst.channels
        fields = dict(B=self.batch, C=c, Ho=dst.h, Wo=dst.w, o_stride=dst.stride,
                      accumulate=int(accumulate), nsrc=len(sources),
                      is_bf16=self._in_bf16(sources[0][0]))
        for i in range(2):
            src, mode, stride = sources[i] if i < len(sources) else (None, "copy", 1)
            h = src.h if src else 0
            w = src.w if src else 0
            fields.update({
                "H%d" % i: h, "W%d" % i: w, "S%d" % i: stride,
                "pt%d" % i: same_pads(h, 3, stride)[1] if src else 0,
                "pl%d" % i: same_pads(w, 3, stride)[1] if src else 0,
                "mode%d" % i: POOL_MODES[mode], "x_stride%d" % i: src.stride if src else 0,
            })
        vec = 4 if c % 4 == 0 else 1
        fields["blocks"] = -(-self.batch * dst.h * dst.w * (c // vec) // sk.THREADS)
        return Step("pool", tuple(s for s, _, _ in sources), dst, fields, fields["blocks"],
                    modes=tuple(m for _, m, _ in sources))

    def cast(self, src: Slot, dst: Slot) -> Step:
        n = self.batch * dst.h * dst.w * dst.stride
        blocks = max(1, min(-(-n // (8 * sk.THREADS)), 4096))
        return Step("cast", (src,), dst, dict(n=n, blocks=blocks), blocks)


def _pool_mode(operation: str, stride: int):
    """A pool's or identity's mode, None for a branch with weights."""
    if "pool" in operation:
        return operation.split("_")[0]
    if operation == "none" and stride == 1:
        return "copy"
    return None


def cell_schedule(
    prev_shape, cur_shape, dtype, filters: int, spec: CellSpec, has_prev: bool,
    tile_p: int = AUTO, sms: int = sk.H100_SMS,
) -> CellSchedule:
    """The launch schedule of one cell signature: every kernel step in
    stream order with its slots and plan, and the call's scratch.

    States live in f32: those in the output at its resolution in their
    channel slot of the output (f32 cells) or of an f32 copy of it in the
    scratch (bf16 cells, cast at the end), the others in regions of the
    scratch, with one region the inner layers of separable branches
    share. A block whose two branches are both pools or identities is
    one pool launch."""
    b, h, w, c_cur = (int(d) for d in cur_shape)
    c_prev, f = int(prev_shape[-1]), int(filters)
    bf16 = dtype == torch.bfloat16
    out_shape = output_shape(spec, b, h, w, f)
    _, ho, wo, c_out = out_shape
    unused = [i for i, used in enumerate(spec.used_hiddenstates) if not used]
    reduced = (ho, wo) if spec.stride > 1 else (h, w)
    resolution = [(h, w), (h, w)] + [reduced] * spec.num_blocks
    size = [0]

    def region(hh, ww, channels):
        base = size[0]
        size[0] += sk._ceil(b * hh * ww * channels, 64)
        return base

    acc = Slot("scratch" if bf16 else "out", region(ho, wo, c_out) if bf16 else 0,
               ho, wo, c_out, 0, c_out)
    states = []
    for i, (hi, wi) in enumerate(resolution):
        if i in unused and (hi, wi) == (ho, wo):
            states.append(dataclasses.replace(acc, offset=unused.index(i) * f, channels=f))
        else:
            states.append(Slot("scratch", region(hi, wi, f), hi, wi, f, 0, f))
    mid = region(h, w, f)
    plan = _Planner(b, bf16, tile_p, sms)
    steps = [plan.conv(Slot("cur", 0, h, w, c_cur, 0, c_cur), states[0], ("begin",))]
    prev = Slot("prev", 0, h, w, c_prev, 0, c_prev)
    if has_prev:
        steps.append(plan.conv(prev, states[1], ("prev",)))
    else:
        steps.append(plan.pool(((prev, "copy", 1),), states[1]))
    for blk in range(spec.num_blocks):
        dst = states[2 + blk]
        branches = []
        for k, side in enumerate(("left", "right")):
            idx = spec.hiddenstate_indices[2 * blk + k]
            op, stride = spec.operations[2 * blk + k], _branch_stride(spec, idx)
            branches.append((states[idx], op, stride, ("blocks", blk, side), _pool_mode(op, stride)))
        if all(mode for *_, mode in branches):
            steps.append(plan.pool(tuple((s, mode, st) for s, _, st, _, mode in branches), dst))
            continue
        for k, (src, op, stride, path, mode) in enumerate(branches):
            accumulate = k == 1
            if mode:
                steps.append(plan.pool(((src, mode, stride),), dst, accumulate))
            elif "separable" in op:
                kernel, layers = _parse_separable(op)
                x = src
                for i in range(layers):
                    s = stride if i == 0 else 1
                    last = i == layers - 1
                    out = dst if last else Slot("scratch", mid, -(-x.h // s), -(-x.w // s), f, 0, f)
                    steps.append(plan.sep_layer(x, out, path + ("layers", i), kernel, s,
                                                accumulate and last))
                    x = out
            else:  # strided identity: a 1x1 projection
                steps.append(plan.conv(src, dst, path, stride=stride, accumulate=accumulate))
    for j, idx in enumerate(unused):
        if resolution[idx] == (ho, wo):
            continue
        half = f // 2
        for shift, wname, lo, hi in ((0, "w1", 0, half), (1, "w2", half, f)):
            dst = dataclasses.replace(acc, offset=j * f + lo, channels=hi - lo)
            steps.append(plan.conv(states[idx], dst, ("reductions", str(idx)), stride=2,
                                   shift=shift, relu=False, w=wname, lo=lo))
    if bf16:
        steps.append(plan.cast(acc, Slot("out", 0, ho, wo, c_out, 0, c_out)))
    elem = 2 if bf16 else 4
    return CellSchedule(tile_p, steps, size[0], out_shape,
                        {"cur": elem, "prev": elem, "out": elem, "scratch": 4})


# (prev shape, cur shape, dtypes, devices, filters, spec, has prev,
# tile_p or None) -> CellSchedule. Dropped with tuning's memo
# (clear_cache, set_default_store, record), so a tile tuned in this
# process is launched.
_SCHEDULES: Dict[tuple, CellSchedule] = {}
tuning.register_memo(_SCHEDULES)


def schedule_for(prev, cur, params, spec: CellSpec, tile_p=None) -> CellSchedule:
    """The memoised schedule of K3 for these tensors: at `tile_p`, or
    (None) at the tuned tile or `AUTO`, whose lookup this runs once per
    signature per process. Validates the signature the first time."""
    f = cell_filters(params)
    has_prev = "prev" in params
    key = (prev.shape, cur.shape, prev.dtype, cur.dtype, prev.get_device(), cur.get_device(),
           f, spec, has_prev, tile_p)
    sched = _SCHEDULES.get(key)
    if sched is not None:
        return sched
    if cur.dtype not in (torch.float32, torch.bfloat16) or prev.dtype != cur.dtype:
        raise TypeError(
            "fused_cell takes float32 or bfloat16 prev/cur of one dtype, got %s / %s"
            % (prev.dtype, cur.dtype)
        )
    if prev.device != cur.device:
        raise ValueError("fused_cell: prev and cur on different devices")
    if not has_prev and prev.shape[-1] != f:
        raise ValueError("prev has %d channels and no projection to %d" % (prev.shape[-1], f))
    if params["begin"]["w"].shape[1] != cur.shape[-1]:
        raise ValueError("begin takes %d channels, cur has %d"
                         % (params["begin"]["w"].shape[1], cur.shape[-1]))
    tile = tile_p
    if tile is None:
        tile = select_tile_p(prev.shape, cur.shape, cur.dtype, f, spec, cur.device)
    sched = cell_schedule(prev.shape, cur.shape, cur.dtype, f, spec, has_prev, tile,
                          sk._sm_count(cur.device))
    sched.device_index = cur.get_device()
    _SCHEDULES[key] = sched
    return sched


_LAYOUTS = {
    # [F, C], [F, C, 1, 1] -> [C, F]; depthwise [C, 1, k, k] -> [k*k, C].
    "t": lambda t: t.reshape(t.shape[0], -1).t().float().contiguous(),
    "f32": lambda t: t.float().contiguous(),
}


def prepared_weight(t: torch.Tensor, layout: str) -> torch.Tensor:
    """A weight as K3 reads it: "t" transposed to [C, F] (1x1 and
    pointwise) or [k*k, C] (depthwise), "f32" as it is (affines); f32 and
    contiguous. Prepared once per tensor and version (`sepconv_kernels.
    prepare`, K2's memo)."""
    return sk.prepare(t, layout, _LAYOUTS[layout])


def _bind_weights(sched: CellSchedule, params):
    """(addresses, prepared tensors kept for the call, whether any weight
    needs a gradient) of the schedule's weights in `params`, in its
    order. A weight is checked for its device when it is prepared."""
    ptrs, keep, grad = [], [], False
    for parent, leaves in sched.weight_groups:
        node = params
        for key in parent:
            node = node[key]
        for name, layout in leaves:
            leaf = node[name]
            grad = grad or leaf.requires_grad
            entry = sk._PREPARED.get((id(leaf), layout))
            if entry is not None and entry[0]() is leaf and entry[1] == leaf._version:
                ptrs.append(entry[3])
                continue
            if leaf.get_device() != sched.device_index:
                raise ValueError("fused_cell: parameter %s on another device" % (parent + (name,),))
            prepared = prepared_weight(leaf, layout)
            keep.append(prepared)
            ptrs.append(prepared.data_ptr())
    return ptrs, keep, grad


def _launch_schedule(sched: CellSchedule, prev, cur, weight_ptrs) -> torch.Tensor:
    """Allocates the output and the scratch and launches every step on
    the current stream, in one C call; returns the output."""
    prev, cur = prev.contiguous(), cur.contiguous()
    out = torch.empty(sched.out_shape, dtype=cur.dtype, device=cur.device)
    scratch = 0
    if sched.scratch_elems:
        scratch = torch.empty(sched.scratch_elems, dtype=torch.float32, device=cur.device)
    values = np.array([cur.data_ptr(), prev.data_ptr(), out.data_ptr(),
                       scratch.data_ptr() if sched.scratch_elems else 0, 0] + weight_ptrs,
                      dtype=np.uint64)
    ptrs = values[sched.ptr_base] + sched.ptr_offset
    failed = ctypes.c_int(-1)
    code = _build.library("cell", "cell_forward")(
        sched.program, len(sched.steps), ptrs.ctypes.data, ctypes.byref(failed),
        _build.stream_handle(cur),
    )
    if code:
        _build.check(code, "cell_forward, step %d (%s)" % (failed.value, sched.steps[failed.value].kind))
    fused_cell.device_kernels += len(sched.steps)
    return out


def _check_supported(spec: CellSpec) -> None:
    for op in spec.operations:
        if not (op.startswith("separable_") or op in ("avg_pool_3x3", "max_pool_3x3", "none")):
            raise ValueError("Unsupported cell operation %r" % op)


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
    def forward(ctx, prev, cur, spec, sched, like, *leaves):
        params = _unflatten(like, leaves)
        out = _launch_schedule(sched, prev, cur, _bind_weights(sched, params)[0])
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
    sched = schedule_for(prev, cur, params, spec)
    fused_cell.last_tile_p = sched.tile_p
    return _run(prev, cur, params, spec, sched)


def _launch(prev, cur, params, spec: CellSpec, tile_p: int):
    """One counted run of K3 at a given `tile_p` (the autotuner's entry;
    `AUTO` plans the tiles)."""
    _check_supported(spec)
    return _run(prev, cur, params, spec, schedule_for(prev, cur, params, spec, tile_p))


def _run(prev, cur, params, spec: CellSpec, sched: CellSchedule):
    """One counted run of a schedule; through autograd only where a
    gradient is wanted."""
    ptrs, _keep, grad = _bind_weights(sched, params)
    if torch.is_grad_enabled() and (grad or prev.requires_grad or cur.requires_grad):
        leaves = [leaf for _, leaf in _flatten(params)]
        out = _FusedCell.apply(prev, cur, spec, sched, params, *leaves)
    else:
        out = _launch_schedule(sched, prev, cur, ptrs)
    fused_cell.launches += 1
    return out


fused_cell.launches = 0
#: CUDA kernels launched by K3 in all (several per `fused_cell` call).
fused_cell.device_kernels = 0
#: The `tile_p` of the last call on the card (`AUTO`: planned).
fused_cell.last_tile_p = None
