"""K1: fused mixture-weight combine, `bias + sum_n w_n * logits_n`.

Port of adanet_tpu/ops/ensemble_kernels.py. The kernel is hand-written
CUDA (`csrc/combine_kernel.cu`, replacing the Pallas `_combine_kernel`).
It computes what `_combine_kernel` computes: the members summed in f32
in order n = 0..N-1, the bias added last, the result in the logits'
dtype (f32 or bf16 on the card; the plain version takes any). Weights
are [N] (scalar per member) or [N, C] (vector per member), the bias [C]
or None.

Two entry points launch the one kernel:

- `fused_weighted_combine(stacked_logits, weights, bias)`, the JAX
  signature, on a stacked [N, B, C] tensor;
- `fused_weighted_combine_members(member_logits, weights, bias)` on a
  sequence of N [B, C] tensors, read where they lie (no stack), with
  `weights` a [N] / [N, C] tensor or one [] / [C] tensor per member.

Weights are prepared once per tensor version into f32 [N] or [N, C],
in the memo K2 and K3 share (`sepconv_kernels.prepare`, keyed by every
member weight's id and version), so a served call stacks nothing. The
checks and the launch plan are memoised per signature (`plan_for`); a
call then allocates the output, binds pointers and makes one C call.

`combine_reference` is the plain PyTorch version. A wrapper takes it
only for CPU tensors; a CUDA tensor launches the kernel or raises.

Called on the fake tensors of a trace (`torch.export`), both entry
points put the custom op `adanet_tpu_torch::weighted_combine` into the
graph instead of launching: a `ctypes` call cannot run on fake tensors.
The test is the tensor's type, not a process-wide flag, so a thread
that serves while another exports still launches directly. The op's implementation is the wrapper itself, for every
device, so a loaded program launches K1 through the same counter, plan
and weight memo on a CUDA tensor and runs `combine_reference` on a CPU
one; `register_fake` gives the [B, C] output in the logits' dtype. The
op is for inference (programs are exported under `no_grad`); gradients
keep going through the `autograd.Function`s below.
Where a gradient is wanted, both entry points go through
`torch.autograd.Function`s whose backward is the JAX `_bwd` in plain
PyTorch (two products and a sum there too): one gradient per member in
the sequence form.
"""

from __future__ import annotations

import array
import ctypes
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch._subclasses.fake_tensor import FakeTensor

from adanet_tpu_torch.ops import _build
from adanet_tpu_torch.ops import sepconv_kernels as sk

#: Threads a block at most (the kernel's kThreads).
THREADS = 128
#: Most members a launch's pointer table holds (the kernel's kMaxTable,
#: under 4 KB of parameters); more members are stacked first.
MAX_MEMBERS = 448

#: The kernel's `Plan` struct, field for field (int64 each).
PLAN_FIELDS = (
    "n", "bc", "c", "is_bf16", "vector_weights", "has_bias", "vec", "threads", "blocks", "stride",
)

Weights = Union[torch.Tensor, Sequence[torch.Tensor]]


def combine_reference(logits, weights: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """bias + sum_n w_n * logits_n, as `_combine_kernel` computes it.

    logits: [N, B, C], or a sequence of N [B, C] tensors of one dtype;
    weights: [N] or [N, C]; bias: [C] or None. Sums in f32 from a zero,
    members in order, the bias last; the result in the logits' dtype.
    """
    dtype = logits[0].dtype
    w = weights.float()
    acc = torch.zeros(logits[0].shape, dtype=torch.float32, device=logits[0].device)
    for n, member in enumerate(logits):
        acc = acc + member.float() * w[n]
    if bias is not None:
        acc = acc + bias.float()
    return acc.to(dtype)


@dataclasses.dataclass
class CombinePlan:
    """One signature's launch: the wide variant (16-byte accesses) for
    aligned pointers, the scalar one otherwise; each a `PLAN_FIELDS`
    dict, held as the int64 array the kernel reads."""

    wide: Dict[str, int]
    scalar: Dict[str, int]
    out_shape: Tuple[int, ...]
    device_index: int = -1

    def __post_init__(self):
        self.stride = self.wide["stride"]
        self._arrays = tuple(
            (ctypes.c_longlong * len(PLAN_FIELDS))(*(v[name] for name in PLAN_FIELDS))
            for v in (self.wide, self.scalar)
        )
        self.addresses = tuple(ctypes.addressof(a) for a in self._arrays)

    def params(self, wide: bool) -> int:
        """Address of the Plan the kernel reads (the wide variant's if
        `wide`)."""
        return self.addresses[0 if wide else 1]


def launch_plan(
    n: int, b: int, c: int, dtype, vector_weights: bool, has_bias: bool, stacked: bool,
) -> CombinePlan:
    """K1's launch for N members of [B, C] logits of `dtype`.

    A variant of `vec` elements a thread (16 bytes' worth, or 1) has
    `bc // vec` whole vectors and `bc % vec` elements past them; each is
    one item, and each item one thread, the tail's in a warp of its own
    after the vectors': one block of as many warps as the items need at
    small sizes (3 warps at [2, 32, 10] f32), blocks of THREADS threads
    beyond. `stacked` members lie `b * c` elements apart
    in one tensor (stride mode), else each has a pointer in the table."""
    bc = b * c
    elem = 2 if dtype == torch.bfloat16 else 4
    variants = []
    for vec in (16 // elem, 1):
        nvec, tail = bc // vec, bc % vec
        items = max((-(-nvec // 32) * 32 if tail else nvec) + tail, 1)
        threads = min(THREADS, -(-items // 32) * 32)
        variants.append(
            dict(
                n=n, bc=bc, c=c, is_bf16=int(dtype == torch.bfloat16),
                vector_weights=int(vector_weights), has_bias=int(has_bias), vec=vec,
                threads=threads, blocks=-(-items // threads), stride=elem * bc if stacked else 0,
            )
        )
    return CombinePlan(wide=variants[0], scalar=variants[1], out_shape=(b, c))


def aligned(member_ptrs: Sequence[int], out_ptr: int, stride: int = 0) -> bool:
    """Whether the members, the output and the members' stride allow
    16-byte accesses: the wide variant's condition, which the C entry
    checks again before it launches."""
    bits = out_ptr | stride
    for p in member_ptrs:
        bits |= p
    return not bits & 15


# (n, logits shape, dtype, and the devices of logits, weights and bias,
# weights shape, bias shape or None, stacked) -> CombinePlan. The devices
# are in the key, so a call whose weights or bias lie elsewhere misses
# and is refused.
_PLANS: Dict[tuple, CombinePlan] = {}


def plan_for(n: int, first: torch.Tensor, w: torch.Tensor, bias, stacked: bool) -> CombinePlan:
    """The memoised plan of K1 for members like `first` and prepared f32
    weights `w`; validates the signature the first time."""
    key = (n, first.shape, first.dtype, first.device, w.device, None if bias is None else bias.device,
           w.shape, None if bias is None else bias.shape, stacked)
    plan = _PLANS.get(key)
    if plan is not None:
        return plan
    if first.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("fused_weighted_combine takes float32 or bfloat16 logits, got %s" % first.dtype)
    if first.dim() != 2:
        raise ValueError("member logits must be [B, C], got %s" % (tuple(first.shape),))
    b, c = first.shape
    if tuple(w.shape) not in ((n,), (n, c)):
        raise ValueError("weights of shape %s do not fit %d members of %s" % (tuple(w.shape), n, tuple(first.shape)))
    if bias is not None and tuple(bias.shape) != (c,):
        raise ValueError("bias of shape %s, want (%d,)" % (tuple(bias.shape), c))
    for t in (w, bias):
        if t is not None and t.device != first.device:
            raise ValueError("fused_weighted_combine: tensors on different devices")
    plan = launch_plan(n, b, c, first.dtype, w.dim() == 2, bias is not None, stacked)
    plan.device_index = first.get_device()
    _PLANS[key] = plan
    return plan


def _stack_f32(ts) -> torch.Tensor:
    return torch.stack([torch.as_tensor(t).float() for t in ts])


def prepared_weights(weights: Weights) -> torch.Tensor:
    """The weights as the kernel reads them: f32, contiguous, [N] or
    [N, C]. One member weight a tensor is stacked once per tensor version
    (`sepconv_kernels.prepare_all`); a stacked tensor goes through `_f32`."""
    if torch.is_tensor(weights):
        return _f32(weights)
    return sk.prepare_all(weights, "combine", _stack_f32)


def _f32(t: torch.Tensor) -> torch.Tensor:
    """`t` as an f32 contiguous tensor: itself if it is one, else
    converted once per tensor version (`sepconv_kernels.prepare`)."""
    if t.dtype is torch.float32 and t.is_contiguous():
        return t
    return sk.prepare(t, "combine", lambda x: x.float().contiguous())


def _wants_grad(*groups) -> bool:
    if not torch.is_grad_enabled():
        return False
    for group in groups:
        for t in group:
            if torch.is_tensor(t) and t.requires_grad:
                return True
    return False


def _run(plan: CombinePlan, member_ptrs, w, bias, out, stream) -> torch.Tensor:
    """One counted K1 launch: the member table (or the stacked base),
    then the weights, the bias and the output, as one array of
    addresses, in one C call (the bias as f32, converted once per
    version if it is not)."""
    if bias is not None:
        bias = _f32(bias)
    out_ptr = out.data_ptr()
    ptrs = array.array("Q", member_ptrs)
    ptrs.extend((w.data_ptr(), 0 if bias is None else bias.data_ptr(), out_ptr))
    wide = aligned(member_ptrs, out_ptr, plan.stride)
    code = _build.library("combine")(plan.params(wide), ptrs.buffer_info()[0], stream)
    if code:
        _build.check(code, "combine_forward")
    fused_weighted_combine.launches += 1
    return out


def fused_weighted_combine(
    stacked_logits: torch.Tensor,
    weights: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K1 on stacked [N, B, C] logits (the JAX signature): the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors (logits f32
    or bf16, weights and bias any float dtype; raises on anything else)."""
    if _wants_grad((stacked_logits, weights, bias)):
        return _CombineStacked.apply(stacked_logits, weights, bias)
    if isinstance(stacked_logits, FakeTensor):
        return weighted_combine([stacked_logits], [weights], bias, False)
    if not stacked_logits.is_cuda:
        if stacked_logits.device.type == "cpu":
            return combine_reference(stacked_logits, weights, bias)
        raise ValueError("fused_weighted_combine: unsupported device %s" % stacked_logits.device)
    if stacked_logits.dim() != 3:
        raise ValueError("stacked logits must be [N, B, C], got %s" % (tuple(stacked_logits.shape),))
    stacked_logits = stacked_logits.contiguous()
    w = prepared_weights(weights)
    plan = plan_for(stacked_logits.shape[0], stacked_logits[0], w, bias, stacked=True)
    out = stacked_logits.new_empty(plan.out_shape)
    return _run(plan, (stacked_logits.data_ptr(),), w, bias, out,
                _build.stream_handle(stacked_logits))


def fused_weighted_combine_members(
    member_logits: Sequence[torch.Tensor],
    weights: Weights,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K1 on a sequence of N [B, C] member logits of one shape and dtype,
    read where they lie: the same kernel as `fused_weighted_combine` with
    a table of member pointers (past MAX_MEMBERS the members are stacked).
    `weights`: [N] / [N, C], or one [] / [C] tensor per member."""
    if _wants_grad(member_logits, (weights,) if torch.is_tensor(weights) else weights, (bias,)):
        # Stacked under autograd, so that each member weight gets its share.
        w = weights if torch.is_tensor(weights) else _stack_f32(weights)
        return _CombineMembers.apply(w, bias, *member_logits)
    if isinstance(member_logits[0], FakeTensor):
        per_member = not torch.is_tensor(weights)
        return weighted_combine(list(member_logits), list(weights) if per_member else [weights], bias, per_member)
    first = member_logits[0]
    if not first.is_cuda:
        if first.device.type == "cpu":
            return combine_reference(member_logits, prepared_weights(weights), bias)
        raise ValueError("fused_weighted_combine: unsupported device %s" % first.device)
    if len(member_logits) > MAX_MEMBERS:
        return fused_weighted_combine(torch.stack(tuple(member_logits)), prepared_weights(weights), bias)
    return _launch_members(member_logits, weights, bias, _build.stream_handle(first))


def _launch_members(member_logits, weights, bias, stream) -> torch.Tensor:
    """The sequence form's launch: every member checked against the
    first (shape, dtype, device), its address taken where it lies (a
    member that is not contiguous is copied, and the copy kept until the
    launch is queued)."""
    first = member_logits[0]
    w = prepared_weights(weights)
    plan = plan_for(len(member_logits), first, w, bias, stacked=False)
    shape, dtype, device = first.shape, first.dtype, plan.device_index
    ptrs, held = [], []
    for t in member_logits:
        if t.shape != shape or t.dtype is not dtype or t.get_device() != device:
            raise ValueError("member logits differ in shape, dtype or device")
        if not t.is_contiguous():
            t = t.contiguous()
        held.append(t)
        ptrs.append(t.data_ptr())
    # The output is [B, C] in the logits' dtype: a contiguous member's like.
    return _run(plan, ptrs, w, bias, torch.empty_like(held[0]), stream)


fused_weighted_combine.launches = 0


@torch.library.custom_op("adanet_tpu_torch::weighted_combine", mutates_args=())
def weighted_combine(
    logits: List[torch.Tensor], weights: List[torch.Tensor], bias: Optional[torch.Tensor], per_member: bool
) -> torch.Tensor:
    """K1 as a custom op, what a traced entry point records: `logits`
    one stacked [N, B, C] tensor or N [B, C] members, `weights` one
    stacked tensor or (`per_member`) one a member. Runs the wrapper."""
    w = list(weights) if per_member else weights[0]
    if len(logits) == 1 and logits[0].dim() == 3:
        return fused_weighted_combine(logits[0], w, bias)
    return fused_weighted_combine_members(list(logits), w, bias)


@weighted_combine.register_fake
def _weighted_combine_fake(logits, weights, bias, per_member):
    first = logits[0]
    return first.new_empty(first.shape[-2:])


def _combine_backward(logits, weights, bias, g):
    """The JAX `_bwd`: d_logits = w g, d_weights the products of logits
    and g summed over rows (and columns for scalar weights), d_bias the
    sum of g over rows; in the inputs' dtypes."""
    g = g.float()
    w = weights.float()
    d_logits, d_weights = [], []
    for n, member in enumerate(logits):
        d_logits.append((w[n] * g).to(member.dtype))
        product = member.float() * g
        d_weights.append(product.sum() if weights.dim() == 1 else product.sum(0))
    d_weights = torch.stack(d_weights).to(weights.dtype)
    d_bias = g.sum(0).to(bias.dtype) if bias is not None else None
    return d_logits, d_weights, d_bias


class _CombineStacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stacked_logits, weights, bias):
        ctx.save_for_backward(stacked_logits, weights, bias)
        return fused_weighted_combine(stacked_logits, weights, bias)

    @staticmethod
    def backward(ctx, g):
        stacked_logits, weights, bias = ctx.saved_tensors
        d_logits, d_weights, d_bias = _combine_backward(stacked_logits, weights, bias, g)
        return torch.stack(d_logits), d_weights, d_bias


class _CombineMembers(torch.autograd.Function):
    """The sequence form: one gradient per member."""

    @staticmethod
    def forward(ctx, weights, bias, *member_logits):
        ctx.save_for_backward(weights, bias, *member_logits)
        return fused_weighted_combine_members(member_logits, weights, bias)

    @staticmethod
    def backward(ctx, g):
        weights, bias, *member_logits = ctx.saved_tensors
        d_logits, d_weights, d_bias = _combine_backward(member_logits, weights, bias, g)
        return (d_weights, d_bias, *d_logits)
