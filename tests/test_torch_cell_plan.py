"""K3's launch plan and schedule on the CPU, without a card.

`cell_kernels.cell_schedule` turns a cell signature into its launches in
stream order, each with its slots and its kernel's plan. These tests hold
the plan at every NASNet-A (6@768) CIFAR cell signature and the
autotuner's two cells (coverage, shared memory, at least one block per
SM at bucket 32), the schedule memo and its store reads, the weights
prepared once per tensor version, and the schedule itself: executed here
step by step by plain-PyTorch stand-ins of the four kernels, it must
equal `cell_reference` and the JAX package's `cell_reference` on
numpy-seeded inputs (f32 atol 1e-5; bf16 one ulp of the output against
the port's reference, both rounding once from f32). That holds slot
offsets, the accumulate flags and the fused pool pairs without a card;
the CUDA kernels themselves are held by `chip_smoke.py`.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adanet_tpu_torch.ops import cell_kernels as ck
from adanet_tpu_torch.ops import sepconv_kernels as sk
from adanet_tpu_torch.ops import tuning
from adanet_tpu_torch.store import ArtifactStore
from test_torch_cell import FILTERS, _bf16_ulp, _inputs, _jax_params, _jitted_reference, _port_params, _specs

SMS = 132
# (C_prev, C_cur, filters, cell, H = W): NASNet-A (6@768) CIFAR's 11 cell
# signatures (prev at cur's resolution) and the autotuner's two cells.
SIGNATURES = [
    (96, 96, 32, "normal", 32),
    (96, 192, 32, "normal", 32),
    (192, 192, 32, "normal", 32),
    (192, 192, 64, "reduction", 32),
    (64, 256, 64, "normal", 16),
    (256, 384, 64, "normal", 16),
    (384, 384, 64, "normal", 16),
    (384, 384, 128, "reduction", 16),
    (128, 512, 128, "normal", 8),
    (512, 768, 128, "normal", 8),
    (768, 768, 128, "normal", 8),
    (32, 32, 32, "normal", 32),
    (32, 32, 64, "reduction", 32),
]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _clean_tuning_state(monkeypatch):
    monkeypatch.delenv("ADANET_TUNE_STORE", raising=False)
    tuning.clear_cache()
    tuning.set_default_store(None)
    yield
    tuning.clear_cache()
    tuning.set_default_store(None)


def _spec(kind):
    return ck.NORMAL_CELL if kind == "normal" else ck.REDUCTION_CELL


def _schedule(signature, batch, dtype, tile_p=ck.AUTO):
    cp, cc, f, kind, hw = signature
    return ck.cell_schedule(
        (batch, hw, hw, cp), (batch, hw, hw, cc), dtype, f, _spec(kind), cp != f, tile_p, SMS
    )


def _region_end(slot, batch):
    return slot.base + batch * slot.h * slot.w * slot.stride


def _check_covers(step, batch):
    """The step's grid covers its output slot, and by no more than one
    tile in each dimension."""
    fields, dst = step.fields, step.dst
    if step.kind == "sep_layer":
        assert (fields["Ho"], fields["Wo"], fields["F"]) == (dst.h, dst.w, dst.channels)
        tiles_h = -(-dst.h // fields["th"])
        tiles_f = -(-dst.channels // fields["tf"])
        assert fields["tiles_w"] * fields["tw"] >= dst.w > (fields["tiles_w"] - 1) * fields["tw"]
        assert tiles_h * fields["th"] >= dst.h > (tiles_h - 1) * fields["th"]
        assert step.blocks == tiles_h * fields["tiles_w"] * batch * tiles_f
        assert _ceil16(fields["th"] * fields["tw"]) * _ceil8(fields["tf"]) <= sk.TILE_OUTPUTS
    elif step.kind == "conv1x1":
        pixels = batch * dst.h * dst.w
        assert (fields["Ho"], fields["Wo"], fields["F"]) == (dst.h, dst.w, dst.channels)
        assert fields["tp"] % 16 == 0 and fields["tp"] * _ceil8(fields["tf"]) <= sk.TILE_OUTPUTS
        assert step.blocks == -(-pixels // fields["tp"]) * -(-dst.channels // fields["tf"])
        assert fields["C"] == step.srcs[0].channels
    elif step.kind == "pool":
        items = batch * dst.h * dst.w * dst.channels
        vec = 4 if dst.channels % 4 == 0 else 1
        assert step.blocks * sk.THREADS * vec >= items > (step.blocks - 1) * sk.THREADS * vec
        assert fields["nsrc"] == len(step.srcs) == len(step.modes)
    else:
        assert step.kind == "cast"
        assert fields["n"] == batch * dst.h * dst.w * dst.stride


def _ceil8(n):
    return -(-n // 8) * 8


def _ceil16(n):
    return -(-n // 16) * 16


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("batch", [1, 8, 32])
@pytest.mark.parametrize("signature", SIGNATURES, ids=lambda s: "%d-%d-%d-%s-%d" % s)
def test_plan_covers_fits_and_fills_the_card(signature, batch, dtype):
    """Every launch of every signature covers its output, fits a block's
    227 KB, and at bucket 32 has at least one block per SM."""
    sched = _schedule(signature, batch, DTYPES[dtype])
    assert sched.tile_p == ck.AUTO
    assert sched.out_shape == ck.output_shape(_spec(signature[3]), batch, signature[4], signature[4], signature[2])
    for step in sched.steps:
        _check_covers(step, batch)
        assert step.fields.get("smem", 0) <= sk.MAX_SHARED_BYTES
        for slot in step.srcs + (step.dst,):
            assert slot.offset + slot.channels <= slot.stride
            if slot.buffer == "scratch":
                assert _region_end(slot, batch) <= sched.scratch_elems
    if batch == 32:
        assert sched.min_blocks >= SMS, [(s.kind, s.blocks) for s in sched.steps]
    # bf16 ends in the cast; the pool pairs are one launch each.
    kinds = [s.kind for s in sched.steps]
    assert (kinds[-1] == "cast") == (dtype == "bf16")
    pairs = sum(1 for s in sched.steps if s.kind == "pool" and len(s.srcs) == 2)
    assert pairs == (2 if signature[3] == "normal" else 1)


def test_kernel_launches_per_call():
    """bf16: 16 launches a normal cell (18 in the first design: the two
    pool pairs are one launch each), 17 a reduction cell."""
    assert len(_schedule((768, 768, 128, "normal", 8), 32, torch.bfloat16).steps) == 16
    assert len(_schedule((384, 384, 128, "reduction", 16), 32, torch.bfloat16).steps) == 17
    assert len(_schedule((768, 768, 128, "normal", 8), 32, torch.float32).steps) == 15


def test_tuned_tile_is_honoured():
    """A tuned `tile_p` sets the pixels of every 1x1 and separable block
    (the pool and cast kernels are not tiled by pixels)."""
    for tile in (16, 64):
        sched = _schedule((192, 192, 64, "reduction", 32), 32, torch.bfloat16, tile)
        assert sched.tile_p == tile
        for step in sched.steps:
            if step.kind == "conv1x1":
                assert step.fields["tp"] == tile
            elif step.kind == "sep_layer":
                assert step.fields["th"] * step.fields["tw"] <= tile
    # A tile larger than a block's register tile is cut to it.
    sched = _schedule((96, 96, 32, "normal", 32), 32, torch.float32, 4096)
    for step in sched.steps:
        _check_covers(step, 32)


def test_candidates_start_with_the_plan():
    cands = ck.tile_candidates(64, 32, 32, 64, ck.REDUCTION_CELL)
    assert cands[0] == ck.AUTO and ck.DEFAULT_TILE_P == ck.AUTO
    assert cands[1:] == [64, 32, 16]  # tile * 64 channels <= 4096 outputs


def _cpu_cell(signature=(6, 8, 4, "normal", 8), batch=2, dtype=torch.float32):
    cp, cc, f, kind, hw = signature
    gen = torch.Generator().manual_seed(0)
    params = ck.init_cell_params(gen, _spec(kind), cp, cc, f, device="cpu")
    prev = torch.randn(batch, hw, hw, cp, generator=gen).to(dtype)
    cur = torch.randn(batch, hw, hw, cc, generator=gen).to(dtype)
    return prev, cur, params, _spec(kind)


def test_one_plan_and_one_store_read_per_signature(tmp_path, monkeypatch):
    monkeypatch.setattr(sk, "_sm_count", lambda device: SMS)
    store = ArtifactStore(str(tmp_path / "store"))
    reads = []
    get_ref = store.get_ref
    monkeypatch.setattr(store, "get_ref", lambda kind, name: reads.append(name) or get_ref(kind, name))
    tuning.set_default_store(store)
    prev, cur, params, spec = _cpu_cell()
    first = ck.schedule_for(prev, cur, params, spec)
    assert ck.schedule_for(prev, cur, params, spec) is first
    assert len(reads) == 1 and first.tile_p == ck.AUTO
    # Another signature (dtype) is planned and looked up once more.
    other = ck.schedule_for(prev.bfloat16(), cur.bfloat16(), params, spec)
    assert other is not first and len(reads) == 2
    # A tuned tile recorded in this process drops the memo and is planned.
    tuning.record(store, "cell", ck.tune_spec(prev.shape, cur.shape, cur.dtype, 4, spec),
                  {"tile_p": 32, "device": "cpu"}, device=cur.device)
    tuned = ck.schedule_for(prev, cur, params, spec)
    assert tuned is not first and tuned.tile_p == 32
    tuning.clear_cache()
    assert not ck._SCHEDULES
    assert ck.schedule_for(prev, cur, params, spec).tile_p == 32
    # An explicit tile (the autotuner's entry) reads no store.
    count = len(reads)
    assert ck.schedule_for(prev, cur, params, spec, ck.AUTO).tile_p == ck.AUTO
    assert len(reads) == count


def test_prepared_weights_follow_the_tensor_version():
    rng = np.random.RandomState(4)
    w = torch.from_numpy(rng.randn(12, 8).astype(np.float32)).to(torch.bfloat16)
    pw = torch.from_numpy(rng.randn(12, 8, 1, 1).astype(np.float32))
    dw = torch.from_numpy(rng.randn(8, 1, 5, 5).astype(np.float32))
    scale = torch.from_numpy(rng.randn(12).astype(np.float32))
    got = ck.prepared_weight(w, "t")
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(got, w.float().t())
    assert ck.prepared_weight(w, "t") is got
    assert torch.equal(ck.prepared_weight(pw, "t"), pw[:, :, 0, 0].t())
    taps = ck.prepared_weight(dw, "t")
    assert tuple(taps.shape) == (25, 8)
    assert torch.equal(taps, dw[:, 0].reshape(8, 25).t())
    assert ck.prepared_weight(scale, "f32") is scale  # already f32 and contiguous
    with torch.no_grad():
        w.mul_(2)
        dw.add_(1)
    again = ck.prepared_weight(w, "t")
    assert again is not got and torch.equal(again, w.float().t())
    assert torch.equal(ck.prepared_weight(dw, "t"), dw[:, 0].reshape(8, 25).t())
    key = (id(pw), "t")
    assert key in sk._PREPARED
    del pw
    assert key not in sk._PREPARED


# --------------------------------------------------------------- the schedule on the CPU


def _execute(sched, prev, cur, params, batch):
    """Runs `sched` with a plain-PyTorch stand-in for each kernel step on
    buffers laid out as the CUDA path lays them out; returns the output."""
    n_out = math.prod(sched.out_shape)
    out_dtype = cur.dtype
    bufs = {
        "cur": cur.contiguous().reshape(-1),
        "prev": prev.contiguous().reshape(-1),
        # NaN scratch: a region read before it is written shows.
        "scratch": torch.full((sched.scratch_elems,), float("nan")),
        "out": torch.full((n_out,), float("nan"), dtype=out_dtype),
    }
    if out_dtype == torch.bfloat16:
        bufs["out"] = torch.zeros(n_out, dtype=out_dtype)

    def view(slot):
        region = bufs[slot.buffer][slot.base:_region_end(slot, batch)]
        return region.view(batch, slot.h, slot.w, slot.stride)[..., slot.offset:slot.offset + slot.channels]

    def weight(entry):
        path, layout, first = entry
        leaf = params
        for key in path:
            leaf = leaf[key]
        return ck.prepared_weight(leaf, layout)[first:]

    for step in sched.steps:
        f = step.fields
        dst = view(step.dst)
        if step.kind == "conv1x1":
            x = view(step.srcs[0]).float()
            if f["relu"]:
                x = torch.relu(x)
            if f["shift"]:
                x = torch.nn.functional.pad(x, (0, 0, 0, 1, 0, 1))[:, 1:, 1:, :]
            x = x[:, :: f["S"], :: f["S"], :]
            w_cf, scale, bias = (weight(e) for e in step.weights)
            y = (x @ w_cf) * scale[: f["F"]] + bias[: f["F"]]
        elif step.kind == "sep_layer":
            dw_t, pw_cf, scale, bias = (weight(e) for e in step.weights)
            c, k = f["C"], f["K"]
            dw = dw_t.t().reshape(c, 1, k, k)
            pw = pw_cf.t()[:, :, None, None]
            y = sk.sep_conv_reference(view(step.srcs[0]), dw, pw, f["S"]) * scale + bias
        elif step.kind == "pool":
            y = 0
            for i, (src, mode) in enumerate(zip(step.srcs, step.modes)):
                x = view(src).float()
                y = y + (x if mode == "copy" else ck._pool(x, mode, f["S%d" % i]))
        else:
            dst.copy_(view(step.srcs[0]).to(dst.dtype))
            continue
        if f["accumulate"]:
            dst += y
        else:
            dst.copy_(y)
    return bufs["out"].view(sched.out_shape)


# (spec, prev channels, cur channels, size): with and without the prev
# projection; odd 9x9 inputs reach the SAME halo of stride-2 ops and the
# factorized reduction's zero fill (tiny_reduction).
SCHEDULE_CASES = [
    ("normal", 6, 8, 8),
    ("normal", 4, 6, 8),
    ("reduction", 4, 8, 8),
    ("reduction", 8, 4, 9),
    ("tiny", 12, 8, 8),
    ("tiny_reduction", 6, 8, 9),
    ("tiny_reduction", 8, 8, 8),
]


@pytest.mark.parametrize("name,c_prev,c_cur,hw", SCHEDULE_CASES)
def test_schedule_on_plain_stand_ins_matches_the_jax_reference(name, c_prev, c_cur, hw):
    jspec, spec = _specs(name)
    prev, cur, params = _inputs(name, c_prev, c_cur, seed=c_prev + 3 * c_cur + hw, h=hw, w=hw)
    port_params = _port_params(params)
    f = FILTERS[name]
    sched = ck.cell_schedule(prev.shape, cur.shape, torch.float32, f, spec, "prev" in port_params, ck.AUTO, SMS)
    got = _execute(sched, torch.from_numpy(prev), torch.from_numpy(cur), port_params, 2)
    want = ck.cell_reference(torch.from_numpy(prev), torch.from_numpy(cur), port_params, spec)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    jax_want = np.asarray(_jitted_reference(jspec)(jnp.asarray(prev), jnp.asarray(cur), _jax_params(params)))
    np.testing.assert_allclose(got.numpy(), jax_want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["normal", "reduction", "tiny_reduction"])
def test_schedule_on_plain_stand_ins_bf16(name):
    """bf16: the states stay f32 and the cast step rounds once, as
    `cell_reference` does: within one bf16 ulp of its output."""
    _, spec = _specs(name)
    prev, cur, params = _inputs(name, 6, 8, seed=21, h=9, w=9)
    port_params = _port_params(params)
    prev_t = torch.from_numpy(prev).to(torch.bfloat16)
    cur_t = torch.from_numpy(cur).to(torch.bfloat16)
    sched = ck.cell_schedule(prev.shape, cur.shape, torch.bfloat16, FILTERS[name], spec,
                             "prev" in port_params, ck.AUTO, SMS)
    got = _execute(sched, prev_t, cur_t, port_params, 2)
    want = ck.cell_reference(prev_t, cur_t, port_params, spec).float().numpy()
    err = np.abs(got.float().numpy() - want)
    assert np.all(err <= _bf16_ulp(want)), float(err.max())


def test_schedule_at_a_tuned_tile_is_the_same_function():
    _, spec = _specs("reduction")
    prev, cur, params = _inputs("reduction", 4, 8, seed=5, h=9, w=9)
    port_params = _port_params(params)
    outs = []
    for tile in (ck.AUTO, 16):
        sched = ck.cell_schedule(prev.shape, cur.shape, torch.float32, 4, spec, "prev" in port_params, tile, SMS)
        outs.append(_execute(sched, torch.from_numpy(prev), torch.from_numpy(cur), port_params, 2))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_a_call_fills_in_pointers_only(monkeypatch):
    """`_launch_schedule` makes one C call: the program packed once per
    signature and the call's pointers, each a buffer's or a prepared
    weight's address plus the slot's offset, in the kernels' order."""
    import ctypes

    from adanet_tpu_torch.ops import _build

    prev, cur, params, spec = _cpu_cell((6, 8, 4, "reduction", 9), dtype=torch.bfloat16)
    sched = ck.cell_schedule(prev.shape, cur.shape, cur.dtype, 4, spec, True, ck.AUTO, SMS)
    calls = []

    def cell_forward(program, n_steps, ptrs, failed, stream):
        calls.append((list(program), n_steps, list((ctypes.c_ulonglong * len(sched.ptr_slots)).from_address(ptrs)), stream))
        return 0

    monkeypatch.setattr(_build, "library", lambda name, function=None: cell_forward)
    monkeypatch.setattr(_build, "stream_handle", lambda t: 77)
    ptrs, _keep, grad = ck._bind_weights(sched, params)
    assert not grad
    before = ck.fused_cell.device_kernels
    out = ck._launch_schedule(sched, prev, cur, ptrs)
    assert ck.fused_cell.device_kernels - before == len(sched.steps)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == sched.out_shape
    ((program, n_steps, got, stream),) = calls
    assert n_steps == len(sched.steps) and stream == 77
    # The program: per step its kind, its plan's length and fields.
    at = 0
    for step in sched.steps:
        names = ck._FIELDS[step.kind]
        assert program[at:at + 2] == [ck._KINDS[step.kind], len(names)]
        assert program[at + 2:at + 2 + len(names)] == [step.fields[n] for n in names]
        at += 2 + len(names)
    assert at == len(program)
    # The pointers: the first step reads cur and writes its state slot;
    # every weight is its prepared tensor's address plus its offset.
    assert got[0] == cur.data_ptr()
    want = []
    for step in sched.steps:
        for path, layout, first in step.weights:
            leaf = params
            for key in path:
                leaf = leaf[key]
            want.append(ck.prepared_weight(leaf, layout).data_ptr() + 4 * first)
    weight_args = [got[i] for i, (base, _) in enumerate(sched.ptr_slots) if base >= len(ck._BUFFERS)]
    assert weight_args == want
    assert len(got) == sum({"conv1x1": 5, "sep_layer": 6, "pool": 3, "cast": 2}[s.kind] for s in sched.steps)
    # A refusal raises, naming the entry point.
    seen = []

    def check(code, what):
        seen.append(code)
        raise RuntimeError(what)

    monkeypatch.setattr(_build, "library", lambda name, function=None: lambda *args: 9)
    monkeypatch.setattr(_build, "check", check)
    with pytest.raises(RuntimeError, match="cell_forward, step"):
        ck._launch_schedule(sched, prev, cur, ptrs)
    assert seen == [9]


@pytest.mark.parametrize("filters,c_prev,c_cur", [(8, 6, 8), (6, 5, 7)])
def test_schedule_on_plain_stand_ins_at_odd_widths(filters, c_prev, c_cur):
    """A reduction cell whose first state is factorized-reduced (shifted
    path, half-F slots), at widths that take the kernels' element-load
    paths on the card (F = 6, odd C): the schedule still equals
    `cell_reference`."""
    spec = ck.CellSpec(
        operations=("separable_3x3_1", "max_pool_3x3", "none", "avg_pool_3x3"),
        hiddenstate_indices=(0, 1, 0, 1),
        used_hiddenstates=(0, 1, 0, 0),
        stride=2,
    )
    gen = torch.Generator().manual_seed(filters)
    params = ck.init_cell_params(gen, spec, c_prev, c_cur, filters, device="cpu")
    for path, leaf in ck._flatten(params):  # the factorized halves read offset affines
        if path[-1] in ("scale", "bias"):
            leaf.copy_(float(path[-1] == "scale") + 0.1 * torch.randn(leaf.shape, generator=gen))
    prev = torch.randn(3, 9, 9, c_prev, generator=gen)
    cur = torch.randn(3, 9, 9, c_cur, generator=gen)
    sched = ck.cell_schedule(prev.shape, cur.shape, torch.float32, filters, spec, "prev" in params, ck.AUTO, SMS)
    assert [s.fields["shift"] for s in sched.steps if s.kind == "conv1x1" and not s.fields["relu"]] == [0, 1]
    got = _execute(sched, prev, cur, params, 3)
    want = ck.cell_reference(prev, cur, params, spec)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
