"""The port's kernel wrappers on the CPU (their plain versions) against
the JAX package's kernels.

The JAX side runs its Pallas kernels as its own tests do on the CPU:
`fused_weighted_combine` off-TPU runs in interpret mode and
`fused_sep_conv(..., interpret=True)` runs the Pallas kernel in the
interpreter. Inputs come from numpy seeds.

Tolerances: K1 f32 atol 1e-6 (the same per-member f32 sums). K2 f32 atol
1e-5 (f32 convolution sums in other orders). K2 bf16 atol 2e-2 times the
output's largest magnitude: both sides compute in f32 from the same bf16
values and round once, but a sum that lands near a bf16 rounding
boundary can round either way (one bf16 ulp is 2^-8 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adanet_tpu.ops import ensemble_kernels as jax_ensemble
from adanet_tpu.ops import sepconv_kernels as jax_sepconv
from adanet_tpu_torch.ops import _build
from adanet_tpu_torch.ops import ensemble_kernels, sepconv_kernels
from adanet_tpu_torch.utils import convert


@pytest.mark.parametrize("vector", [False, True])
@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("n,b,c", [(2, 32, 10), (3, 515, 7)])
def test_combine_matches_jax(vector, use_bias, n, b, c):
    rng = np.random.RandomState(n * 1000 + b)
    logits = rng.randn(n, b, c).astype(np.float32)
    weights = rng.randn(*((n, c) if vector else (n,))).astype(np.float32)
    bias = rng.randn(c).astype(np.float32) if use_bias else None
    want = np.asarray(
        jax_ensemble.fused_weighted_combine(
            jnp.asarray(logits), jnp.asarray(weights), None if bias is None else jnp.asarray(bias)
        )
    )
    before = ensemble_kernels.fused_weighted_combine.launches
    got = ensemble_kernels.fused_weighted_combine(
        torch.from_numpy(logits),
        torch.from_numpy(weights),
        None if bias is None else torch.from_numpy(bias),
    )
    # CPU tensors take the plain version: no kernel launch is counted.
    assert ensemble_kernels.fused_weighted_combine.launches == before
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, c)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def _sepconv_inputs(b, h, w, c, f, k, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    dw = (rng.randn(k, k, 1, c) * 0.2).astype(np.float32)
    pw = (rng.randn(1, 1, c, f) * 0.2).astype(np.float32)
    return x, dw, pw


SEPCONV_CASES = [
    ((2, 8, 8, 16), 12, 3, 1),
    ((2, 8, 8, 16), 12, 3, 2),
    ((2, 9, 9, 8), 16, 5, 1),  # odd H/W: asymmetric SAME pads
    ((2, 9, 9, 8), 16, 5, 2),
    ((2, 8, 8, 8), 8, 7, 2),  # the reduction cell's 7x7
    ((1, 7, 10, 8), 8, 7, 1),  # odd H, even W
]


@pytest.mark.parametrize("shape,f,k,stride", SEPCONV_CASES)
def test_sep_conv_matches_jax_f32(shape, f, k, stride):
    x, dw, pw = _sepconv_inputs(*shape, f, k, seed=k * 10 + stride)
    want = np.asarray(
        jax_sepconv.fused_sep_conv(
            jnp.asarray(x), jnp.asarray(dw), jnp.asarray(pw), stride, interpret=True
        )
    )
    got = sepconv_kernels.fused_sep_conv(
        torch.from_numpy(x),
        torch.from_numpy(convert.conv_kernel(dw)),
        torch.from_numpy(convert.conv_kernel(pw)),
        stride,
    )
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape,f,k,stride", SEPCONV_CASES[:2] + SEPCONV_CASES[3:5])
def test_sep_conv_matches_jax_bf16(shape, f, k, stride):
    x, dw, pw = _sepconv_inputs(*shape, f, k, seed=k * 10 + stride + 1)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(
        jax_sepconv.fused_sep_conv(
            xb,
            jnp.asarray(dw, jnp.bfloat16),
            jnp.asarray(pw, jnp.bfloat16),
            stride,
            interpret=True,
        ).astype(jnp.float32)
    )
    got = sepconv_kernels.fused_sep_conv(
        torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(convert.conv_kernel(dw)),
        torch.from_numpy(convert.conv_kernel(pw)),
        stride,
    )
    assert got.dtype == torch.bfloat16
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2 * scale, rtol=0)


@pytest.mark.parametrize("size,kernel,stride", [(32, 3, 1), (32, 3, 2), (9, 5, 2), (8, 7, 2), (1, 3, 1)])
def test_same_pads_matches_jax(size, kernel, stride):
    assert sepconv_kernels.same_pads(size, kernel, stride) == jax_sepconv._same_pads(
        size, kernel, stride
    )


def test_tiles_fit_shared_memory():
    # The slice's widest case keeps whole rows of output channels.
    assert sepconv_kernels.tiles(128, 128, 7) == (32, 128)
    for c, f, k in [(128, 128, 7), (1024, 1024, 7), (4096, 64, 3)]:
        tp, tf = sepconv_kernels.tiles(c, f, k)
        assert 4 * (tp * c + c * (tf + 1) + k * k * c) <= sepconv_kernels.MAX_SHARED_BYTES
        assert tp >= 1 and tf >= 1


def test_copy_plain_version():
    x = torch.arange(8, dtype=torch.float32)
    before = _build.copy_tensor.launches
    y = _build.copy_tensor(x)
    assert torch.equal(x, y) and y.data_ptr() != x.data_ptr()
    assert _build.copy_tensor.launches == before


def test_kernel_sources_name_the_tpu_kernels_they_replace():
    import os

    for name, (source, functions) in _build.KERNELS.items():
        path = os.path.join(_build.CSRC_DIR, source)
        text = open(path).read()
        assert "Replaces: adanet_tpu/ops/" in text, source
        assert "Bound:" in text, source
        assert functions, source
        for fn_name, argtypes in functions.items():
            assert 'extern "C" int %s(' % fn_name in text, (source, fn_name)
            # One ctypes argtype per C parameter.
            signature = text.split('extern "C" int %s(' % fn_name)[1].split(")")[0]
            assert len(signature.split(",")) == len(argtypes), (source, fn_name)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
