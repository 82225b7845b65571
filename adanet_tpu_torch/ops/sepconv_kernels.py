"""K2: fused relu -> depthwise -> pointwise separable convolution.

Port of adanet_tpu/ops/sepconv_kernels.py. The kernel is hand-written
CUDA (`csrc/sepconv_kernel.cu`, replacing the Pallas `_sepconv_kernel`):
one block per tile of output rows, columns and channels of one image; per
chunk of input channels it stages the input rows with their TF "SAME"
halo in shared memory once (16-byte loads, relu, in x's dtype), runs the
depthwise taps from there into an f32 tile, and accumulates the pointwise
product in registers (tensor cores, TF32 in and f32 out, for bf16;
CUDA-core FMAs for f32); the result is stored in the input dtype. The
source note says what bounds it. The kernel reads the pointwise weight
as `pointwise_t` prepares it, transposed to [C, F] in x's dtype, once
per weight tensor and version.

Layouts: activations NHWC, as at the JAX package's boundary; weights in
PyTorch's conv layouts, depthwise `[C, 1, k, k]` and pointwise
`[F, C, 1, 1]` (what `utils.convert` makes of Flax's `[k, k, 1, C]` and
`[1, 1, C, F]`).

`sep_conv_reference` is the plain PyTorch version, with the kernel's
arithmetic: weights rounded to the input dtype, the depthwise result kept
in f32 into the pointwise product (the Pallas path; the unfused Flax path
rounds it to the compute dtype in between). `fused_sep_conv` takes it
only for CPU tensors. A CUDA tensor launches the kernel or raises: there
is no fallback by size, since the kernel streams input channels in chunks
and so tiles any shape. Where a gradient is wanted the launch goes through
`_FusedSepConv`, whose backward recomputes through `sep_conv_reference`
under autograd (the JAX `_fused_bwd`, a `jax.vjp` of the reference);
under `no_grad` or `inference_mode` the wrapper launches directly.
Called on the fake tensors of a trace (`torch.export`), the wrapper puts
the custom op `adanet_tpu_torch::sep_conv` into the graph instead: its implementation is the wrapper itself for every device (the
kernel on a CUDA tensor, `sep_conv_reference` on a CPU one), and
`register_fake` gives the NHWC output's shape. Programs are exported
under `no_grad`; the op carries no gradient.

Launch plan: `launch_plan` turns a signature (x shape, dtype, k, F,
stride) and a pixel tile into the kernel's tile, grid and shared memory.
The pixel tile (`tile_p`, output pixels per block) comes from the
store-persisted autotuner (`ops/tuning.py`, family "sepconv") when it has
a winner for this workload and device, as the JAX wrapper consults it
before its VMEM heuristic; else it is `AUTO`, and the planner sizes the
tile from the output and the card's SM count. `fused_sep_conv` works the
plan out once per signature per process (the JAX package looks up once
per trace) and keeps it in `_PLANS`, which `tuning` drops whenever its
own memo is dropped. The tile changes only how the work is cut, never a
result.
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor

from adanet_tpu_torch.ops import _build, tuning

#: Shared memory one block may use on Hopper (bytes).
MAX_SHARED_BYTES = 227 * 1024
#: The planner keeps a block under this, so that two fit an SM.
SHARED_TARGET_BYTES = MAX_SHARED_BYTES // 2
#: Threads a block (the kernel's kThreads).
THREADS = 256
#: Outputs one block holds in registers, 16 a thread: a 4 x 4 tile of
#: pixels x channels (f32), or four 16 x 8 tensor-core tiles a warp
#: (bf16), counted with the pixels padded to 16 and the channels to 8.
TILE_OUTPUTS = 16 * THREADS
#: Output columns of a depthwise item (the kernel's kCols); a tile's
#: width is a multiple of it.
TILE_COLS = 4
#: Widest tile the automatic plan starts from (output columns).
MAX_TILE_W = 32
#: Largest input-channel chunk.
MAX_CHUNK = 128
#: `tile_p` that asks the planner to size the tile from the output size
#: and the SM count (no tuned winner).
AUTO = 0
DEFAULT_TILE_P = AUTO
#: SMs of an H100 SXM; the plan of a CUDA launch reads the device's own.
H100_SMS = 132

#: The kernel's `Plan` struct, field for field.
PLAN_FIELDS = (
    "B", "H", "W", "C", "F", "K", "S", "Ho", "Wo", "pt", "pl",
    "th", "tw", "tf", "cc", "tiles_w", "rh", "rw", "xs_len", "a_ld", "b_ld", "o_ld",
    "dw_len", "smem", "is_bf16",
)


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


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def _ceil4(n: int) -> int:
    return _ceil(n, 4)


def _outputs(tile_p: int, tile_f: int) -> int:
    """Register-tile outputs of a block: pixels padded to 16, channels to 8."""
    return _ceil(tile_p, 16) * _ceil(tile_f, 8)


def _half(n: int, m: int = 8) -> int:
    """About half of `n`, a multiple of `m`, at least `m`."""
    return max(m, _ceil(-(-n // 2), m))


def tiles(c: int, f: int, k: int, tile_p: int = DEFAULT_TILE_P) -> Tuple[int, int]:
    """(tile_p, tile_f): output pixels and output channels per block.

    `tile_p` is `AUTO` (the planner sizes it) or a pixel count; `tile_f`
    is F, halved (a multiple of 4) until the block's register tile holds
    the tile's outputs. Shared memory does not bound it: the kernel
    streams the C input channels in chunks (`launch_plan`), so `c` and
    `k` change the chunk, not the tile."""
    tile_f = f
    if tile_p > 0:
        while _outputs(tile_p, tile_f) > TILE_OUTPUTS and tile_f > 8:
            tile_f = _half(tile_f)
    return tile_p, tile_f


@dataclasses.dataclass
class LaunchPlan:
    """One K2 launch's tile, grid and shared memory (`PLAN_FIELDS` plus
    what the wrapper needs), for one signature and pixel tile."""

    tile: Tuple[int, int]  # (tile_p, tile_f) as selected
    fields: Dict[str, int]
    tiles_h: int
    tiles_f: int
    out_shape: Tuple[int, int, int, int]
    device_index: int = -1
    _array: Any = None

    @property
    def grid(self) -> Tuple[int, int, int]:
        return (self.tiles_h * self.fields["tiles_w"], self.fields["B"], self.tiles_f)

    @property
    def blocks(self) -> int:
        g = self.grid
        return g[0] * g[1] * g[2]

    @property
    def params(self) -> int:
        """Address of the int array the kernel reads its Plan from."""
        if self._array is None:
            self._array = (ctypes.c_int * len(PLAN_FIELDS))(
                *(self.fields[name] for name in PLAN_FIELDS)
            )
        return ctypes.addressof(self._array)


def launch_plan(
    x_shape, dtype, f: int, k: int, stride: int, tile_p: int = AUTO, sms: int = H100_SMS
) -> LaunchPlan:
    """The launch plan of K2 for x of `x_shape` (NHWC) and `dtype`.

    With `tile_p` AUTO the tile starts at whole output rows (up to
    MAX_TILE_W columns) and all F channels, shrinks its rows until the
    register tile holds it, then splits until the grid has `sms` blocks:
    rows while a tile keeps 32 pixels, output channels down to 64, rows
    down to 16 pixels, channels down to 16, then rows and columns. A
    tuned `tile_p` sets the pixels per block instead (whole rows where
    they fit). The input-channel chunk is the largest power of two (8 to
    MAX_CHUNK, no more than C needs) whose shared memory stays under
    SHARED_TARGET_BYTES."""
    b, h, w, c = (int(d) for d in x_shape)
    ho, pt, _ = same_pads(h, k, stride)
    wo, pl, _ = same_pads(w, k, stride)
    tile = tiles(c, f, k, tile_p)
    tile_p, tf = tile
    if tile_p > 0:
        tw = _ceil4(min(wo, tile_p))
        th = max(1, min(ho, tile_p // tw))
    else:
        tw = _ceil4(min(wo, MAX_TILE_W))
        th = max(ho, 1)

        def blocks():
            return -(-ho // th) * -(-wo // tw) * b * -(-f // tf)

        while _outputs(th * tw, tf) > TILE_OUTPUTS:
            if th > 1:
                th = -(-th // 2)
            elif tf > 8:
                tf = _half(tf)
            else:
                tw = _half(tw, TILE_COLS)
        while blocks() < sms:
            if th > 1 and th * tw >= 64:
                th = -(-th // 2)
            elif tf > 64:
                tf = _half(tf)
            elif th > 1 and th * tw >= 32:
                th = -(-th // 2)
            elif tf > 16:
                tf = _half(tf)
            elif th > 1:
                th = -(-th // 2)
            elif tw > TILE_COLS:
                tw = _half(tw, TILE_COLS)
            else:
                break
    tf = min(tf, f) if f > 0 else 1
    # Row strides of 16 k + 8 elements: the tensor-core fragment loads
    # (8 rows x 4 columns a warp) and the output tile's stores hit 32 banks.
    a_ld = _ceil(th * tw, 16) + 8
    b_ld = o_ld = _ceil(tf, 16) + 8
    rh = (th - 1) * stride + k
    rw = (tw - 1) * stride + k
    elem = 2 if dtype == torch.bfloat16 else 4

    def xs_len(cc):  # floats
        return _ceil4(-(-elem * rh * rw * cc // 4))

    def shared(cc):
        staged = 4 * (xs_len(cc) + _ceil4(cc * k * k) + cc * a_ld) + elem * cc * b_ld
        return max(staged, elem * _ceil(th * tw, 16) * o_ld)  # the output tile overlays it

    cc = 8
    while cc < c and cc < MAX_CHUNK:
        cc *= 2
    while cc > 8 and shared(cc) > SHARED_TARGET_BYTES:
        cc //= 2
    if shared(cc) > MAX_SHARED_BYTES:
        raise ValueError(
            "sep-conv with k=%d at a %dx%d tile does not fit one block's shared "
            "memory" % (k, th, tw)
        )
    fields = dict(
        B=b, H=h, W=w, C=c, F=f, K=k, S=stride, Ho=ho, Wo=wo, pt=pt, pl=pl,
        th=th, tw=tw, tf=tf, cc=cc, tiles_w=-(-wo // tw), rh=rh, rw=rw, xs_len=xs_len(cc), a_ld=a_ld,
        b_ld=b_ld, o_ld=o_ld, dw_len=_ceil4(cc * k * k), smem=shared(cc),
        is_bf16=int(dtype == torch.bfloat16),
    )
    return LaunchPlan(
        tile=tile,
        fields=fields,
        tiles_h=-(-ho // th),
        tiles_f=-(-f // tf) if f > 0 else 0,
        out_shape=(b, ho, wo, f),
    )


def tune_spec(x_shape, dtype, kernel: int, filters: int, stride: int) -> Dict[str, Any]:
    """The autotuner's workload identity: the JAX `_sepconv_tune_spec`
    dict, so one workload has one spec fingerprint in both packages."""
    return {
        "x_shape": list(x_shape),
        "dtype": str(dtype).replace("torch.", ""),
        "kernel": int(kernel),
        "filters": int(filters),
        "stride": int(stride),
    }


def tile_candidates(h: int, w: int, c: int, f: int, k: int, stride: int) -> List[int]:
    """`tile_p` candidates for the autotuner: `AUTO` (the planned tile)
    first, so that a sweep never stores a fixed tile slower than the
    plan, then the powers of two from the first that covers one image's
    output pixels down to 16 whose register tile holds all F channels."""
    h_out, w_out = -(-h // stride), -(-w // stride)
    return [AUTO] + tuning.candidate_tile_sizes(h_out * w_out, _ceil(f, 8), 0, TILE_OUTPUTS)


def select_tiles(x_shape, dtype, c: int, f: int, k: int, stride: int, device) -> Tuple[int, int]:
    """(tile_p, tile_f): the tuned `tile_p` for this workload on `device`
    when the store has one, else `AUTO`, through `tiles()`."""
    tile_p = DEFAULT_TILE_P
    tuned = tuning.lookup("sepconv", tune_spec(x_shape, dtype, k, f, stride), device=device)
    if tuned:
        candidate = tuned.get("tile_p")
        if isinstance(candidate, int) and candidate > 0:
            tile_p = candidate
    return tiles(c, f, k, tile_p)


# (x shape, dtype, dw shape, pw shape, stride, device index, tile_p or
# None) -> LaunchPlan. Dropped with tuning's memo (clear_cache,
# set_default_store, record), so a tile tuned in this process is launched.
_PLANS: Dict[tuple, LaunchPlan] = {}
tuning.register_memo(_PLANS)


def plan_for(x, dw, pw, stride: int, tile_p=None) -> LaunchPlan:
    """The memoised launch plan of K2 for these tensors: at `tile_p`, or
    (None) at the tuned or automatic tile, whose lookup this runs once
    per signature per process. Validates the signature the first time."""
    key = (x.shape, x.dtype, dw.shape, pw.shape, stride, x.get_device(), tile_p)
    plan = _PLANS.get(key)
    if plan is not None:
        return plan
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("fused_sep_conv takes float32 or bfloat16, got %s" % x.dtype)
    if x.dim() != 4:
        raise ValueError("fused_sep_conv takes NHWC x, got shape %s" % (tuple(x.shape),))
    c = x.shape[-1]
    f, k = pw.shape[0], dw.shape[-1]
    if tuple(dw.shape) != (c, 1, k, k) or tuple(pw.shape) != (f, c, 1, 1):
        raise ValueError(
            "weights %s / %s do not fit x %s"
            % (tuple(dw.shape), tuple(pw.shape), tuple(x.shape))
        )
    tile = tile_p
    if tile is None:
        tile = select_tiles(x.shape, x.dtype, c, f, k, stride, x.device)[0]
    plan = launch_plan(x.shape, x.dtype, f, k, stride, tile, _sm_count(x.device))
    plan.device_index = x.get_device()
    _PLANS[key] = plan
    return plan


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def fused_sep_conv(
    x: torch.Tensor, dw: torch.Tensor, pw: torch.Tensor, stride: int = 1
) -> torch.Tensor:
    """K2 wrapper: relu -> depthwise(k x k, SAME, stride) -> pointwise.

    CPU tensors take `sep_conv_reference`; CUDA tensors (x bf16 or f32
    NHWC, weights any float dtype) launch the kernel or raise; a traced
    call records the custom op `sep_conv`.
    """
    if isinstance(x, FakeTensor):
        return sep_conv(x, dw, pw, int(stride))
    if not x.is_cuda:
        if x.device.type == "cpu":
            return sep_conv_reference(x, dw, pw, stride)
        raise ValueError("fused_sep_conv: unsupported device %s" % x.device)
    return _on_card(x, dw, pw, stride)


def _on_card(x, dw, pw, stride: int) -> torch.Tensor:
    """The CUDA branch of `fused_sep_conv`: one counted launch, through
    `_FusedSepConv` where a gradient is wanted."""
    plan = plan_for(x, dw, pw, stride)
    if torch.is_grad_enabled() and (x.requires_grad or dw.requires_grad or pw.requires_grad):
        return _FusedSepConv.apply(x, dw, pw, stride, plan)
    return _run(plan, x, dw, pw)


class _FusedSepConv(torch.autograd.Function):
    """Forward through K2; backward through `sep_conv_reference` under
    autograd (one extra forward, the JAX `_fused_bwd` trade)."""

    @staticmethod
    def forward(ctx, x, dw, pw, stride, plan):
        ctx.stride = stride
        ctx.save_for_backward(x, dw, pw)
        return _run(plan, x, dw, pw)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = sep_conv_reference(*inputs, ctx.stride)
        gx, gdw, gpw = torch.autograd.grad(out, inputs, grad)
        return gx, gdw, gpw, None, None


def _launch(x, dw, pw, stride: int, tile: Tuple[int, int]) -> torch.Tensor:
    """One counted launch of K2 at `tile_p` = tile[0] (the autotuner's
    entry; tile_f follows from it)."""
    if not x.is_cuda:
        raise ValueError("_launch takes CUDA tensors")
    return _run(plan_for(x, dw, pw, stride, tile[0]), x, dw, pw)


# (id(tensor), layout) -> (weakref to the tensor, its version, the
# prepared tensor, its address). An entry is used only for the same live
# tensor at the same version: a weight changed in place is prepared again.
# A group of tensors prepared together (`prepare_all`) is keyed by the
# tuple of their ids, and its entry holds a tuple of weakrefs and one of
# versions.
_PREPARED: Dict[Tuple[Any, Any], tuple] = {}


def prepare(t: torch.Tensor, layout, make) -> torch.Tensor:
    """`make(t)`, the weight `t` in the layout a kernel reads, prepared
    once per tensor, version and `layout` (K1's, K2's and K3's weights);
    an inference tensor, which has no version counter, every call."""
    key = (id(t), layout)
    entry = _PREPARED.get(key)
    if entry is not None and entry[0]() is t and entry[1] == t._version:
        return entry[2]
    with torch.no_grad():
        prepared = make(t)
    prepare.made += 1
    if not t.is_inference():
        ref = weakref.ref(t, lambda _, key=key, memo=_PREPARED: memo.pop(key, None))
        _PREPARED[key] = (ref, t._version, prepared, prepared.data_ptr())
    return prepared


def prepare_all(ts: Sequence[torch.Tensor], layout, make) -> torch.Tensor:
    """`make(ts)` for a group of tensors read as one (K1's member
    weights, stacked), prepared once per group, version of every member
    and `layout`: an in-place change to any member prepares again, and
    any member's death drops the entry. With an inference tensor (or a
    number) among them, every call."""
    key = (tuple(map(id, ts)), layout)
    entry = _PREPARED.get(key)
    # Every member is live while its entry is (its death drops the
    # entry before its id can be reused), so the versions decide.
    if entry is not None and entry[1] == tuple([t._version for t in ts]):
        return entry[2]
    with torch.no_grad():
        prepared = make(ts)
    prepare.made += 1
    if all(torch.is_tensor(t) and not t.is_inference() for t in ts):
        def drop(_, key=key, memo=_PREPARED):
            memo.pop(key, None)

        refs = tuple(weakref.ref(t, drop) for t in ts)
        _PREPARED[key] = (refs, tuple(t._version for t in ts), prepared, prepared.data_ptr())
    return prepared


#: Preparations made (`make` called) by `prepare` and `prepare_all`.
prepare.made = 0


def pointwise_t(pw: torch.Tensor, dtype) -> torch.Tensor:
    """The pointwise weight [F, C, 1, 1] as the kernel reads it: [C, F],
    rounded to `dtype`, prepared once per tensor, version and dtype."""
    return prepare(pw, dtype, lambda t: t.reshape(t.shape[0], -1).t().to(dtype).contiguous())


def _run(plan: LaunchPlan, x, dw, pw) -> torch.Tensor:
    if dw.get_device() != plan.device_index or pw.get_device() != plan.device_index:
        raise ValueError("fused_sep_conv: tensors on different devices")
    if dw.dtype is not torch.float32:
        dw = dw.float()
    x = x.contiguous()
    dw = dw.contiguous()
    pwt = pointwise_t(pw, x.dtype)
    out = x.new_empty(plan.out_shape)
    code = _build.library("sepconv")(
        x.data_ptr(), dw.data_ptr(), pwt.data_ptr(), out.data_ptr(), plan.params,
        _build.stream_handle(x),
    )
    if code:
        _build.check(code, "sepconv_forward")
    fused_sep_conv.launches += 1
    fused_sep_conv.last_tiles = plan.tile
    return out


fused_sep_conv.launches = 0


@torch.library.custom_op("adanet_tpu_torch::sep_conv", mutates_args=())
def sep_conv(x: torch.Tensor, dw: torch.Tensor, pw: torch.Tensor, stride: int) -> torch.Tensor:
    """K2 as a custom op, what a traced `fused_sep_conv` records. Runs
    the wrapper."""
    return fused_sep_conv(x, dw, pw, stride)


@sep_conv.register_fake
def _sep_conv_fake(x, dw, pw, stride):
    return x.new_empty((x.shape[0], -(-x.shape[1] // stride), -(-x.shape[2] // stride), pw.shape[0]))
#: (tile_p, tile_f) of the last launch, as selected (tile_p AUTO: planned).
fused_sep_conv.last_tiles = None
