"""The host side of the port's kernel launches, on the CPU.

K2's launch planner at every separable-conv shape of NASNet-A (6@768)
CIFAR and every serving bucket: the tiles cover the output exactly, the
block fits the card's shared memory and register tile, and the grid is
wide enough (one block per SM at bucket 32, 16 blocks at bucket 1 for the
8x8 shapes). The tuning lookup and K2's plan are memoised, misses
included, once per signature per process, and dropped by `clear_cache`,
`set_default_store` and `record`. A launch takes no lock and builds no
`torch.cuda.Stream` once the kernels are bound.
"""

import collections
import threading

import numpy as np
import pytest
import torch

from adanet_tpu_torch.ops import _build
from adanet_tpu_torch.ops import sepconv_kernels as sk
from adanet_tpu_torch.ops import tuning
from adanet_tpu_torch.store import ArtifactStore

H100_SMS = 132
BUCKETS = (1, 2, 4, 8, 16, 32)
# ((H, W, C), F, k, stride) -> K2 launches in one member forward.
FLAGSHIP_SHAPES = {
    ((32, 32, 32), 32, 3, 1): 34,
    ((32, 32, 32), 32, 5, 1): 23,
    ((32, 32, 96), 32, 3, 1): 2,
    ((32, 32, 96), 32, 5, 1): 1,
    ((32, 32, 64), 64, 5, 2): 2,
    ((32, 32, 64), 64, 7, 2): 2,
    ((16, 16, 64), 64, 3, 1): 38,
    ((16, 16, 64), 64, 5, 1): 26,
    ((16, 16, 64), 64, 7, 1): 2,
    ((16, 16, 128), 128, 5, 2): 2,
    ((16, 16, 128), 128, 7, 2): 2,
    ((8, 8, 128), 128, 3, 1): 38,
    ((8, 8, 128), 128, 5, 1): 26,
    ((8, 8, 128), 128, 7, 1): 2,
}


@pytest.fixture(autouse=True)
def _clean_tuning_state(monkeypatch):
    monkeypatch.delenv("ADANET_TUNE_STORE", raising=False)
    tuning.clear_cache()
    tuning.set_default_store(None)
    yield
    tuning.clear_cache()
    tuning.set_default_store(None)


def test_flagship_shapes_are_the_models():
    from adanet_tpu_torch.research.improve_nas import improve_nas

    builder = improve_nas.Builder(
        None,
        improve_nas.Hparams(use_pallas_sep_conv=True, compute_dtype=torch.bfloat16),
        seed=0,
        num_classes=10,
    )
    module = builder.build_subnetwork(10, input_shape=(32, 32, 3))
    shapes = collections.Counter(module.nasnet.sepconv_launch_shapes())
    assert dict(shapes) == FLAGSHIP_SHAPES


def _covers(n, tile, count):
    """`count` tiles of `tile` cover 0..n-1 once each: none empty."""
    return count * tile >= n > (count - 1) * tile


@pytest.mark.parametrize("shape", sorted(FLAGSHIP_SHAPES), ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_plan_covers_fits_and_fills_the_card(shape, dtype):
    (h, w, c), f, k, s = shape
    for b in BUCKETS:
        plan = sk.launch_plan((b, h, w, c), dtype, f, k, s, sms=H100_SMS)
        p = plan.fields
        ho, wo = -(-h // s), -(-w // s)
        assert plan.out_shape == (b, ho, wo, f)
        assert _covers(ho, p["th"], plan.tiles_h)
        assert _covers(wo, p["tw"], p["tiles_w"])
        assert _covers(f, p["tf"], plan.tiles_f)
        assert plan.grid == (plan.tiles_h * p["tiles_w"], b, plan.tiles_f)
        assert p["tw"] % sk.TILE_COLS == 0
        assert -(-p["th"] * p["tw"] // 16) * 16 * -(-p["tf"] // 8) * 8 <= sk.TILE_OUTPUTS
        assert p["smem"] <= sk.MAX_SHARED_BYTES
        assert sk.THREADS % p["cc"] == 0 and 8 <= p["cc"] <= max(8, 2 * c)
        # The staged rows and columns hold every tap of the tile.
        assert p["rh"] == (p["th"] - 1) * s + k and p["rw"] == (p["tw"] - 1) * s + k
        if b == 32:
            assert plan.blocks >= H100_SMS
        if b == 1 and h // s == 8:
            assert plan.blocks >= 16
    # The plan is the kernel's Plan struct, field for field.
    assert set(p) == set(sk.PLAN_FIELDS)
    assert p["is_bf16"] == int(dtype == torch.bfloat16)


def test_plan_at_a_tuned_tile_keeps_its_pixels():
    plan = sk.launch_plan((32, 32, 32, 32), torch.bfloat16, 32, 5, 1, tile_p=64)
    p = plan.fields
    assert plan.tile == (64, 32)
    assert (p["th"], p["tw"], p["tf"]) == (2, 32, 32)
    plan = sk.launch_plan((4, 8, 8, 8), torch.float32, 16, 3, 1, tile_p=16)
    assert plan.tile == (16, 16) and (plan.fields["th"], plan.fields["tw"]) == (2, 8)


class _SpyStore:
    """An empty store that counts its ref reads."""

    def __init__(self, root):
        self.inner = ArtifactStore(root)
        self.reads = 0

    def get_ref(self, kind, name):
        self.reads += 1
        return self.inner.get_ref(kind, name)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def test_lookup_memoises_misses_until_dropped(tmp_path):
    store = _SpyStore(str(tmp_path / "store"))
    tuning.set_default_store(store)
    spec = sk.tune_spec((32, 16, 16, 64), torch.bfloat16, 3, 64, 1)
    for _ in range(5):
        assert tuning.lookup("sepconv", spec, device="cpu") is None
    assert store.reads == 1
    other = dict(spec, stride=2)
    assert tuning.lookup("sepconv", other, device="cpu") is None
    assert store.reads == 2
    tuning.clear_cache()
    assert tuning.lookup("sepconv", spec, device="cpu") is None
    assert store.reads == 3
    tuning.set_default_store(store)
    assert tuning.lookup("sepconv", spec, device="cpu") is None
    assert store.reads == 4
    # A winner recorded in this process is launched at once.
    tuning.record(store.inner, "sepconv", other, {"tile_p": 32}, device="cpu")
    assert tuning.lookup("sepconv", other, device="cpu") == {"tile_p": 32}
    assert tuning.lookup("sepconv", spec, device="cpu") is None
    assert store.reads == 5


def _inputs(b, h, w, c, f, k, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32))
    dw = torch.from_numpy(rng.randn(c, 1, k, k).astype(np.float32))
    pw = torch.from_numpy(rng.randn(f, c, 1, 1).astype(np.float32))
    return x, dw, pw


def test_plan_and_lookup_run_once_per_signature(tmp_path, monkeypatch):
    """K2's wrapper plans, and so looks its tile up, once per signature
    per process; `clear_cache`, `set_default_store` and `record` drop
    the plans, and a tile recorded in this process is planned next."""
    monkeypatch.setattr(sk, "_sm_count", lambda device: H100_SMS)
    store = _SpyStore(str(tmp_path / "store"))
    tuning.set_default_store(store)
    x, dw, pw = _inputs(4, 8, 8, 16, 16, 3)
    x2, dw2, pw2 = _inputs(2, 8, 8, 16, 16, 3)
    plans = [sk.plan_for(x, dw, pw, 1) for _ in range(4)]
    assert all(plan is plans[0] for plan in plans)
    assert store.reads == 1
    assert sk.plan_for(x2, dw2, pw2, 1) is not plans[0]
    assert sk.plan_for(x, dw, pw, 2) is not plans[0]
    assert store.reads == 3
    assert plans[0].tile == (sk.AUTO, 16)

    tuning.clear_cache()
    assert sk.plan_for(x, dw, pw, 1) is not plans[0]
    assert store.reads == 4
    tuning.set_default_store(store)
    assert store.reads == 4 and not sk._PLANS
    sk.plan_for(x, dw, pw, 1)
    assert store.reads == 5
    spec = sk.tune_spec(x.shape, x.dtype, 3, 16, 1)
    tuning.record(store.inner, "sepconv", spec, {"tile_p": 16}, device=x.device)
    assert not sk._PLANS
    plan = sk.plan_for(x, dw, pw, 1)
    assert plan.tile == (16, 16)
    assert store.reads == 5  # the recorded winner is memoised


def test_plan_rejects_what_the_kernel_does_not_take(monkeypatch):
    monkeypatch.setattr(sk, "_sm_count", lambda device: H100_SMS)
    x, dw, pw = _inputs(1, 8, 8, 16, 16, 3)
    with pytest.raises(TypeError):
        sk.plan_for(x.double(), dw, pw, 1)
    with pytest.raises(ValueError, match="do not fit"):
        sk.plan_for(x, dw[:8], pw, 1)
    with pytest.raises(ValueError, match="do not fit"):
        sk.plan_for(x, dw, pw[:, :8], 1)
    assert not sk._PLANS


class _NoLock:
    def __enter__(self):
        raise AssertionError("library() took the lock")

    def __exit__(self, *exc):
        return False


def test_bound_functions_are_handed_out_without_the_lock(monkeypatch):
    sentinel = object()
    monkeypatch.setattr(_build, "_lock", _NoLock())
    monkeypatch.setitem(_build._ready, ("sepconv", None), sentinel)
    monkeypatch.setitem(_build._ready, ("cell", "cell_pool"), sentinel)
    assert _build.library("sepconv") is sentinel
    assert _build.library("cell", "cell_pool") is sentinel
    # Before the libraries are bound, the lock guards the first build.
    monkeypatch.setattr(_build, "_lock", threading.Lock())
    monkeypatch.setattr(_build, "build", lambda names=None: (_ for _ in ()).throw(RuntimeError("no nvcc")))
    monkeypatch.setattr(_build, "_functions", {})
    with pytest.raises(RuntimeError, match="no nvcc"):
        _build.library("combine")


def test_stream_handle_builds_no_stream_object(monkeypatch):
    def no_stream(*args, **kwargs):
        raise AssertionError("a torch.cuda.Stream was built")

    monkeypatch.setattr(torch.cuda, "current_stream", no_stream)
    monkeypatch.setattr(torch.cuda, "Stream", no_stream)
    seen = []
    monkeypatch.setattr(
        torch._C, "_cuda_getCurrentRawStream", lambda index: seen.append(index) or 1234, raising=False
    )
    t = torch.zeros(1)
    assert _build.stream_handle(t) == 1234
    assert seen == [t.get_device()]


def test_wrappers_take_the_stream_from_the_helper():
    """Every launch site gets its stream from `_build.stream_handle`."""
    import inspect

    from adanet_tpu_torch.ops import cell_kernels, ensemble_kernels

    for module in (_build, sk, ensemble_kernels, cell_kernels):
        source = inspect.getsource(module)
        assert "current_stream(" not in source, module.__name__
        assert ".cuda_stream" not in source, module.__name__
    assert "_build.stream_handle(" in inspect.getsource(sk._run)
    assert "_build.stream_handle(" in inspect.getsource(ensemble_kernels.fused_weighted_combine)
    assert "_build.stream_handle(" in inspect.getsource(cell_kernels._launch_schedule)
    assert "stream_handle(x)" in inspect.getsource(_build.copy_tensor)


def test_pointwise_weights_are_prepared_once_per_version():
    """K2 reads the pointwise weight transposed to [C, F] in x's dtype;
    the preparation is the plain layout, reused while the tensor is
    unchanged and redone after an in-place update."""
    rng = np.random.RandomState(3)
    pw = torch.from_numpy(rng.randn(12, 8, 1, 1).astype(np.float32))
    first = sk.pointwise_t(pw, torch.bfloat16)
    assert first.dtype == torch.bfloat16 and tuple(first.shape) == (8, 12)
    assert torch.equal(first, pw[:, :, 0, 0].t().to(torch.bfloat16))
    assert sk.pointwise_t(pw, torch.bfloat16) is first
    f32 = sk.pointwise_t(pw, torch.float32)
    assert f32.dtype == torch.float32 and torch.equal(f32, pw[:, :, 0, 0].t())
    with torch.no_grad():
        pw.mul_(2.0)
    again = sk.pointwise_t(pw, torch.bfloat16)
    assert again is not first
    assert torch.equal(again, pw[:, :, 0, 0].t().to(torch.bfloat16))
    # Another tensor with the same values is prepared for itself.
    other = pw.clone()
    assert sk.pointwise_t(other, torch.bfloat16) is not again
    # A tensor that dies takes its entry with it.
    key = (id(other), torch.bfloat16)
    assert key in sk._PREPARED
    del other
    assert key not in sk._PREPARED
    with torch.inference_mode():
        frozen = torch.ones(4, 2, 1, 1)
    assert torch.equal(sk.pointwise_t(frozen, torch.float32), torch.ones(2, 4))
