"""K2's gradient (fault C1): `fused_sep_conv` on the card goes through
`_FusedSepConv`, whose backward recomputes through `sep_conv_reference`,
as the JAX `_fused_bwd` takes `jax.vjp` of its reference.

The CUDA branch (`sepconv_kernels._on_card`) runs here with the launch
(`_run`) stubbed by the plain version, so that what the wrapper does
around the kernel is held on the CPU: a gradient reaches x, dw and pw
and equals autograd through the reference; under `no_grad` and
`inference_mode` it launches directly and makes no autograd node. The
reference's gradients are then held against `jax.vjp` of the JAX
`fused_sep_conv` (Pallas interpret mode) at atol 1e-5. On the card,
`chip_smoke.py` (`check_sepconv_grads`) holds K2's at its 14 shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adanet_tpu.ops import sepconv_kernels as jax_sk
from adanet_tpu_torch.ops import sepconv_kernels as sk
from adanet_tpu_torch.ops import tuning
from adanet_tpu_torch.utils import convert

CASES = [((2, 8, 8, 16), 12, 3, 1), ((2, 9, 9, 8), 16, 5, 2)]


@pytest.fixture
def stub_launch(monkeypatch):
    """The kernel's launch replaced by the plain version; returns the
    list of launches made."""
    monkeypatch.delenv("ADANET_TUNE_STORE", raising=False)
    tuning.clear_cache()
    tuning.set_default_store(None)
    launches = []

    def run(plan, x, dw, pw):
        launches.append(plan)
        assert not torch.is_grad_enabled()
        return sk.sep_conv_reference(x, dw, pw, plan.fields["S"])

    monkeypatch.setattr(sk, "_run", run)
    monkeypatch.setattr(sk, "_sm_count", lambda device: sk.H100_SMS)
    yield launches
    tuning.clear_cache()


def _inputs(shape, f, k, seed):
    rng = np.random.RandomState(seed)
    b, h, w, c = shape
    x = rng.randn(b, h, w, c).astype(np.float32)
    dw = (rng.randn(k, k, 1, c) * 0.3).astype(np.float32)
    pw = (rng.randn(1, 1, c, f) * 0.2).astype(np.float32)
    g = rng.randn(b, h, w, f).astype(np.float32)  # cut to the output size
    return x, dw, pw, g


def _torch_grads(fn, x, dw, pw, g, stride):
    inputs = [torch.from_numpy(x), torch.from_numpy(convert.conv_kernel(dw)), torch.from_numpy(convert.conv_kernel(pw))]
    inputs = [t.clone().requires_grad_(True) for t in inputs]
    out = fn(*inputs, stride)
    g = torch.from_numpy(g[:, : out.shape[1], : out.shape[2]].copy())
    return out, torch.autograd.grad(out, inputs, g)


@pytest.mark.parametrize("shape,f,k,stride", CASES)
def test_cuda_branch_differentiates_through_fused_sep_conv(stub_launch, shape, f, k, stride):
    x, dw, pw, g = _inputs(shape, f, k, seed=k + stride)
    out, got = _torch_grads(sk._on_card, x, dw, pw, g, stride)
    assert type(out.grad_fn).__name__ == "_FusedSepConvBackward"
    assert len(stub_launch) == 1
    want_out, want = _torch_grads(sk.sep_conv_reference, x, dw, pw, g, stride)
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    for got_g, want_g in zip(got, want):
        torch.testing.assert_close(got_g, want_g, rtol=0, atol=0)


@pytest.mark.parametrize("requires", ["x", "dw", "pw"])
def test_any_input_that_requires_grad_takes_the_function(stub_launch, requires):
    x, dw, pw, _ = _inputs((1, 6, 6, 8), 8, 3, seed=5)
    inputs = dict(x=torch.from_numpy(x), dw=torch.from_numpy(convert.conv_kernel(dw)),
                  pw=torch.from_numpy(convert.conv_kernel(pw)))
    inputs[requires].requires_grad_(True)
    out = sk._on_card(inputs["x"], inputs["dw"], inputs["pw"], 1)
    (grad,) = torch.autograd.grad(out.sum(), [inputs[requires]])
    assert grad.shape == inputs[requires].shape and torch.isfinite(grad).all()


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
def test_served_path_makes_no_autograd_node(stub_launch, mode):
    x, dw, pw, _ = _inputs((2, 8, 8, 16), 12, 3, seed=9)
    params = [torch.from_numpy(convert.conv_kernel(w)).requires_grad_(True) for w in (dw, pw)]
    with getattr(torch, mode)():
        out = sk._on_card(torch.from_numpy(x), *params, 1)
    assert out.grad_fn is None and not out.requires_grad
    assert len(stub_launch) == 1
    torch.testing.assert_close(out, sk.sep_conv_reference(torch.from_numpy(x), *params, 1).detach())


@pytest.mark.parametrize("shape,f,k,stride", CASES)
def test_gradients_match_jax_vjp(stub_launch, shape, f, k, stride):
    x, dw, pw, g = _inputs(shape, f, k, seed=10 * k + stride)
    out, got = _torch_grads(sk._on_card, x, dw, pw, g, stride)
    want_out, vjp = jax.vjp(
        lambda a, b, c: jax_sk.fused_sep_conv(a, b, c, stride, interpret=True),
        jnp.asarray(x), jnp.asarray(dw), jnp.asarray(pw),
    )
    gx, gdw, gpw = vjp(jnp.asarray(g[:, : out.shape[1], : out.shape[2]]))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(gx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), convert.conv_kernel(np.asarray(gdw)), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[2].numpy(), convert.conv_kernel(np.asarray(gpw)), atol=1e-5, rtol=0)
