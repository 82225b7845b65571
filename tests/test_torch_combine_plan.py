"""K1's host side on the CPU: the launch plan and the per-signature memo.

The CUDA kernel (`ops/csrc/combine_kernel.cu`) cannot run here, so what
surrounds it is checked in Python:

- the plan, executed by a model of the kernel's indexing (each thread's
  whole vectors by grid stride, then its one tail element), writes every
  element of [0, B*C) exactly once: at the serving sizes (one block), at
  the byte-bound shapes [4, 4096, 1001] f32 and [4, 8192, 1001] bf16 (at
  least one block per SM of an H100's 132), at odd C, and in the scalar
  variant that misaligned member pointers take;
- the column of each element's vector weight and bias, as the kernel
  steps it, is the flat index mod C at any C;
- the plan is the kernel's `Plan` struct field for field, and the
  constants the two sides share agree;
- checks and plan run once per signature, and refuse what the kernel
  does not take, also weights or a bias on another device after a hit;
- member weights are prepared once per version, also when the calls are
  made inside `torch.inference_mode`, as served.
"""

import os
import re

import numpy as np
import pytest
import torch

from adanet_tpu_torch.ops import _build
from adanet_tpu_torch.ops import ensemble_kernels as ek
from adanet_tpu_torch.ops import sepconv_kernels as sk

SMS = 132
BUCKETS = (1, 2, 4, 8, 16, 32)
BYTE_BOUND = [
    pytest.param(4, 4096, 1001, torch.float32, id="4-4096-1001-f32"),
    pytest.param(4, 8192, 1001, torch.bfloat16, id="4-8192-1001-bf16"),
]


def _source() -> str:
    with open(os.path.join(_build.CSRC_DIR, "combine_kernel.cu")) as f:
        return f.read()


def thread_elements(fields):
    """(thread, elements it writes), as the kernel indexes: thread t below
    B*C // vec writes the vec elements from t * vec; the tail's threads
    start at the next warp, t0 = B*C // vec rounded up to 32, and thread
    t >= t0 writes element (B*C // vec) * vec + t - t0 if below B*C."""
    vec, bc = fields["vec"], fields["bc"]
    nvec = bc // vec
    t0 = -(-nvec // 32) * 32
    for thread in range(fields["blocks"] * fields["threads"]):
        if thread < nvec:
            yield thread, np.arange(thread * vec, (thread + 1) * vec)
        elif vec > 1 and thread >= t0 and nvec * vec + thread - t0 < bc:
            yield thread, np.array([nvec * vec + thread - t0])


def assert_covers_once(fields):
    counts = np.zeros(fields["bc"], np.int64)
    for _, elements in thread_elements(fields):
        np.add.at(counts, elements, 1)
    assert counts.min() == 1 and counts.max() == 1, fields


def plans(n, b, c, dtype, stacked=False):
    """The plan of every weight kind and bias combination."""
    for vector in (False, True):
        for bias in (False, True):
            yield ek.launch_plan(n, b, c, dtype, vector, bias, stacked)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b", BUCKETS)
def test_serving_sizes_are_one_block_covering_every_element(b, dtype):
    for stacked in (False, True):
        for plan in plans(2, b, 10, dtype, stacked):
            for fields in (plan.wide, plan.scalar):
                assert_covers_once(fields)
                assert fields["threads"] % 32 == 0 and fields["threads"] <= ek.THREADS
            # [2, 32, 10] f32: 80 vectors of 4, one block of 3 warps.
            assert plan.wide["blocks"] == 1
            assert plan.wide["vec"] == (4 if dtype == torch.float32 else 8)
            assert plan.out_shape == (b, 10)
    assert ek.launch_plan(2, 32, 10, torch.float32, False, False, False).wide["threads"] == 96


@pytest.mark.parametrize("n,b,c,dtype", BYTE_BOUND)
def test_byte_bound_shapes_fill_the_card(n, b, c, dtype):
    for plan in plans(n, b, c, dtype):
        wide = plan.wide
        assert wide["vec"] * (2 if dtype == torch.bfloat16 else 4) == 16
        assert wide["blocks"] >= SMS and wide["threads"] == ek.THREADS
        # One item a thread: the grid is as large as the output.
        assert wide["blocks"] == -(-(b * c) // (wide["vec"] * ek.THREADS))
        assert plan.scalar["blocks"] == -(-b * c // ek.THREADS) >= SMS
    assert_covers_once(ek.launch_plan(n, b, c, dtype, True, True, False).wide)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,c", [(1, 1), (1, 3), (3, 7), (5, 1001), (33, 13), (40, 1001)])
def test_odd_classes_take_the_wide_path_with_a_tail(b, c, dtype):
    for plan in plans(3, b, c, dtype):
        vec = plan.wide["vec"]
        assert vec > 1  # the column follows the flat index: no need to go narrow
        assert_covers_once(plan.wide)
        assert_covers_once(plan.scalar)
        tails = {t for t, e in thread_elements(plan.wide) if len(e) % vec}
        assert len(tails) == (b * c) % vec
        # The tail runs in warps of its own, none of them a vector's.
        vectors = {t // 32 for t, e in thread_elements(plan.wide) if len(e) == vec}
        assert not {t // 32 for t in tails} & vectors


def test_misaligned_members_take_the_scalar_variant():
    plan = ek.launch_plan(2, 32, 10, torch.float32, True, True, False)
    base, out = 1 << 20, 1 << 24
    assert ek.aligned([base, base + 4096], out)
    assert plan.params(ek.aligned([base, base + 4096], out)) == plan.addresses[0]
    for ptrs in ([base + 4, base + 4096], [base, base + 4098]):
        assert not ek.aligned(ptrs, out)
        assert plan.params(ek.aligned(ptrs, out)) == plan.addresses[1]
        assert_covers_once(plan.scalar)
    assert not ek.aligned([base], out + 2)
    # A stacked [2, 1, 10] f32 tensor: members 40 bytes apart.
    stacked = ek.launch_plan(2, 1, 10, torch.float32, False, False, True)
    assert stacked.stride == 40 and not ek.aligned([base], out, stacked.stride)
    assert_covers_once(stacked.scalar)
    assert ek.launch_plan(2, 32, 10, torch.float32, False, False, True).stride == 1280


def kernel_columns(fields):
    """(element, column) pairs as the kernel derives the columns: a
    thread's first element's index mod C (`column`), then up by one an
    element, wrapping at C (`columns`)."""
    c = fields["c"]
    for _, elements in thread_elements(fields):
        col = int(elements[0]) % c
        for e in elements:
            yield int(e), col
            col += 1
            if col == c:
                col = 0


@pytest.mark.parametrize("c", [1, 3, 7, 10, 1001])
def test_columns_follow_the_flat_index(c):
    """The column each element's vector weight and bias come from is
    its flat index mod C, at every C (also below a vector's width, where
    one vector wraps more than once) and in both variants."""
    assert "if (++col == c) col = 0;" in _source()
    b = 3 if c == 1001 else 40
    for dtype in (torch.float32, torch.bfloat16):
        for fields in (ek.launch_plan(2, b, c, dtype, True, True, False).wide,
                       ek.launch_plan(2, b, c, dtype, True, True, False).scalar):
            pairs = np.array(list(kernel_columns(fields)))
            assert len(pairs) == b * c
            np.testing.assert_array_equal(pairs[:, 1], pairs[:, 0] % c)


def test_plan_is_the_kernels_struct_and_shares_its_constants():
    source = _source()
    struct = source.split("struct Plan {")[1].split("};")[0]
    fields = re.findall(r"long long (\w+);", struct)
    assert tuple(fields) == ek.PLAN_FIELDS
    plan = ek.launch_plan(2, 32, 10, torch.float32, True, False, False)
    assert tuple(plan.wide) == ek.PLAN_FIELDS and tuple(plan.scalar) == ek.PLAN_FIELDS
    values = np.ctypeslib.as_array(plan._arrays[0])
    assert list(values) == [plan.wide[name] for name in ek.PLAN_FIELDS]

    def constant(name):
        return int(re.search(r"constexpr int %s = (\d+);" % name, source).group(1))

    assert constant("kThreads") == ek.THREADS
    assert constant("kMaxTable") == ek.MAX_MEMBERS
    # The table and the other arguments (three pointers, two int64, four
    # int) stay under 4 KB of kernel parameters.
    assert 8 * ek.MAX_MEMBERS + 3 * 8 + 2 * 8 + 4 * 4 <= 4096


def test_plan_and_checks_run_once_per_signature(monkeypatch):
    made = []
    launch_plan = ek.launch_plan
    monkeypatch.setattr(ek, "launch_plan", lambda *a, **k: made.append(a) or launch_plan(*a, **k))
    monkeypatch.setattr(ek, "_PLANS", {})
    first = torch.zeros(6, 9)
    w = torch.ones(3)
    plan = ek.plan_for(3, first, w, None, False)
    assert ek.plan_for(3, first, w, None, False) is plan
    assert ek.plan_for(3, torch.ones(6, 9), torch.zeros(3), None, False) is plan
    assert len(made) == 1
    assert ek.plan_for(3, first, w, None, True) is not plan  # stacked: another signature
    vector = ek.plan_for(3, first, torch.ones(3, 9), torch.ones(9), False)
    assert vector.wide["vector_weights"] == 1 and vector.wide["has_bias"] == 1
    assert len(made) == 3


@pytest.mark.parametrize(
    "first,w,bias,error",
    [
        (torch.zeros(4, 5, dtype=torch.float16), torch.ones(2), None, TypeError),
        (torch.zeros(4, 5), torch.ones(3), None, ValueError),
        (torch.zeros(4, 5), torch.ones(2, 4), None, ValueError),
        (torch.zeros(4, 5), torch.ones(2), torch.ones(4), ValueError),
        (torch.zeros(4, 5, 1), torch.ones(2), None, ValueError),
    ],
)
def test_plan_rejects_what_the_kernel_does_not_take(monkeypatch, first, w, bias, error):
    monkeypatch.setattr(ek, "_PLANS", {})
    with pytest.raises(error):
        ek.plan_for(2, first, w, bias, False)


def test_plan_memo_refuses_weights_or_bias_on_another_device(monkeypatch):
    """A call that matches a memoised signature but whose weights or bias
    lie on another device than the logits misses the memo and is refused
    (the kernel would read a host pointer)."""
    monkeypatch.setattr(ek, "_PLANS", {})
    first, w, bias = torch.zeros(4, 5), torch.ones(2, 5), torch.ones(5)
    ek.plan_for(2, first, w, bias, False)
    ek.plan_for(2, first, w, bias, False)
    with pytest.raises(ValueError, match="different devices"):
        ek.plan_for(2, first, w.to("meta"), bias, False)
    with pytest.raises(ValueError, match="different devices"):
        ek.plan_for(2, first, w, bias.to("meta"), False)


def test_vector_member_weights_are_prepared_once_under_inference_mode():
    """As served: member weights made outside inference mode, the calls
    inside it. The stacked f32 [N, C] weights are made once per version."""
    weights = [torch.full((7,), 0.5), torch.full((7,), -1.5, dtype=torch.bfloat16)]
    with torch.inference_mode():
        first = ek.prepared_weights(weights)
        before = sk.prepare.made
        for _ in range(3):
            assert ek.prepared_weights(weights) is first
        assert sk.prepare.made == before
    assert first.shape == (2, 7) and first.dtype == torch.float32
    with torch.no_grad():
        weights[0].add_(1.0)
    with torch.inference_mode():
        assert torch.equal(ek.prepared_weights(weights)[0], torch.full((7,), 1.5))
    assert sk.prepare.made == before + 1


def test_member_weights_are_prepared_once_per_version():
    weights = [torch.tensor(0.5), torch.tensor(-1.5)]
    before = sk.prepare.made
    first = ek.prepared_weights(weights)
    assert first.dtype == torch.float32 and torch.equal(first, torch.tensor([0.5, -1.5]))
    assert ek.prepared_weights(weights) is first
    assert sk.prepare.made == before + 1
    with torch.no_grad():
        weights[1].add_(1.0)
    again = ek.prepared_weights(weights)
    assert again is not first and torch.equal(again, torch.tensor([0.5, -0.5]))
    assert sk.prepare.made == before + 2
    # An f32 contiguous [N] tensor is read as it is; another dtype once.
    stacked = torch.tensor([1.0, 2.0])
    assert ek.prepared_weights(stacked) is stacked
    half = torch.tensor([1.0, 2.0], dtype=torch.bfloat16)
    assert ek.prepared_weights(half) is ek.prepared_weights(half)
    # Any member's death drops the group's entry.
    key = (tuple(map(id, weights)), "combine")
    assert key in sk._PREPARED
    del weights[0]
    assert key not in sk._PREPARED
