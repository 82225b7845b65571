"""Parity of the port's NASNet-A (eval) with the JAX package's.

NASNet-A at num_cells=3 (one normal cell, then a reduction cell before
each of cells 1 and 2: calc_reduction_layers(3, 2) == [1, 2], so both
cell kinds run), 8 filters, 16x16x3 inputs. Parameters come from a numpy
seed into the JAX variable tree of a training-mode init (so the aux-head
parameters exist and must load; `torch_port_common`), are converted with
`utils.convert`, and both sides run eval.

Tolerances: f32 compute, atol 1e-4 on logits (the same arithmetic summed
in other orders). bf16 compute, atol 0.1 on logits of scale ~1: the JAX
CPU path of `use_pallas_sep_conv=True` is the XLA reference, which rounds
the depthwise result to bf16 before the pointwise product where the fused
kernel (and so the port) keeps it f32, and bf16 pools accumulate
differently, so the two differ by a few bf16 ulps per layer.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adanet_tpu.models import nasnet as jax_nasnet
from adanet_tpu_torch.models import nasnet as torch_nasnet
from adanet_tpu_torch.utils import convert
from torch_port_common import numpy_variables, variable_shapes

SMALL = dict(num_classes=10, num_cells=3, num_conv_filters=8)
SHAPE = (16, 16, 3)


@pytest.fixture(scope="module")
def jax_init():
    """Images, the JAX variable tree and variables with init statistics,
    shared by the file."""
    images = np.random.RandomState(0).randn(2, *SHAPE).astype(np.float32)
    cfg = jax_nasnet.NasNetConfig(**SMALL, compute_dtype=jnp.float32)
    shapes = variable_shapes(jax_nasnet.NasNetA(cfg), images)
    return images, shapes, numpy_variables(shapes, seed=1)


@functools.lru_cache(maxsize=None)
def _jax_apply(compute_dtype, fused):
    cfg = jax_nasnet.NasNetConfig(
        **SMALL, compute_dtype=compute_dtype, use_pallas_sep_conv=fused
    )
    return jax.jit(functools.partial(jax_nasnet.NasNetA(cfg).apply, training=False))


def _jax_logits(variables, images, compute_dtype, fused):
    logits, aux, pooled = _jax_apply(compute_dtype, fused)(variables, images)
    assert aux is None
    return np.asarray(logits), np.asarray(pooled)


def _torch_model(variables, compute_dtype, fused):
    cfg = torch_nasnet.NasNetConfig(
        **SMALL, compute_dtype=compute_dtype, use_pallas_sep_conv=fused
    )
    model = torch_nasnet.NasNetA(cfg, SHAPE)
    model.load_state_dict(convert.convert_variables(variables), strict=True)
    return model.eval()


def _torch_logits(variables, images, compute_dtype, fused):
    model = _torch_model(variables, compute_dtype, fused)
    with torch.inference_mode():
        logits, aux, pooled = model(torch.from_numpy(images))
    assert aux is None
    return logits.numpy(), pooled.numpy()


def test_structure_matches_flax_tree(jax_init):
    _, _, variables = jax_init
    model = _torch_model(variables, torch.float32, True)
    assert hasattr(model, "aux_head")
    assert model.reduction_cell_0.out_shape == (8, 8, 64)
    assert model.cell_2.out_shape == (4, 4, 192)
    n_flax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(
        {k: variables[k] for k in ("params", "batch_stats", "schedule")}))
    n_torch = sum(t.numel() for t in model.state_dict().values())
    assert n_flax == n_torch


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("trained_stats", [False, True])
def test_eval_logits_match_jax_f32(jax_init, fused, trained_stats):
    images, shapes, variables = jax_init
    if trained_stats:
        variables = numpy_variables(shapes, seed=3, trained_stats=True)
    want, want_pooled = _jax_logits(variables, images, jnp.float32, fused)
    got, got_pooled = _torch_logits(variables, images, torch.float32, fused)
    assert got.shape == want.shape == (2, 10)
    np.testing.assert_allclose(got_pooled, want_pooled, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_eval_logits_match_jax_bf16(jax_init):
    images, shapes, _ = jax_init
    variables = numpy_variables(shapes, seed=4, trained_stats=True)
    want, _ = _jax_logits(variables, images, jnp.bfloat16, True)
    got, _ = _torch_logits(variables, images, torch.bfloat16, True)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=0.1, rtol=0)


def test_init_parameters_from_generator_is_seeded():
    cfg = torch_nasnet.NasNetConfig(**SMALL, compute_dtype=torch.float32)
    models = []
    for _ in range(2):
        model = torch_nasnet.NasNetA(cfg, SHAPE)
        torch_nasnet.init_parameters(model, torch.Generator().manual_seed(7))
        models.append(model)
    w0 = models[0].cell_0.beginning_1x1.weight
    assert torch.equal(w0, models[1].cell_0.beginning_1x1.weight)
    # LeCun normal: variance 1 / fan_in.
    assert abs(float(w0.detach().std()) - (1.0 / w0.shape[1]) ** 0.5) < 0.1
