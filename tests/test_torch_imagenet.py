"""The port's NASNet-A with the ImageNet stem against the JAX package's.

- Structure: `conv0` (3 x 3, stride 2, VALID), `conv0_bn` and the two
  stride-2 stem cells `cell_stem_0` (no previous layer) and
  `cell_stem_1` (the factorized reduction of conv0's output at odd
  sizes, filters split `f // 2` and `f // 2 + f % 2`), no `stem_conv`;
  NASNet-A Mobile's shapes at 224 x 224; the stem cells counted in the
  drop-path depth schedule.
- The presets `cifar_config`, `mobile_imagenet_config` and
  `large_imagenet_config` equal the JAX presets field for field (the
  compute dtype mapped); an unknown stem raises `ValueError`.
- Parity at the JAX test's size (tests/test_imagenet_models.py: 2 x 64
  x 64 x 3, 3 cells, 8 filters, f32), parameters drawn in numpy into the
  JAX variable tree and carried across by `utils.convert`: the eval
  forward (logits and pooled, atol 1e-4), and a training forward
  (logits, every parameter's gradient within 1e-4 x max(1, max|ref|),
  the moved batch statistics within 1e-5); at 64 x 64 the map after
  cell 1 is 4 x 4, too small for the aux head, in both packages.
- K2's launch plan at every NASNet-A Mobile shape (channels 11 to 176,
  maps up to 111 x 111) at batches 1, 7 and 32 fits one block's shared
  memory, and gives at least one block per SM at batch 32.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adanet_tpu.models import nasnet as jax_nasnet
from adanet_tpu_torch import models as torch_models
from adanet_tpu_torch.models import nasnet as torch_nasnet
from adanet_tpu_torch.ops import sepconv_kernels as sk
from adanet_tpu_torch.utils import convert
from torch_port_common import numpy_variables, variable_shapes

SMALL = dict(num_classes=10, num_cells=3, num_conv_filters=8, drop_path_keep_prob=1.0,
             dense_dropout_keep_prob=1.0, stem_type="imagenet")
JAX_CONFIG = jax_nasnet.NasNetConfig(**SMALL, compute_dtype=jnp.float32)
SHAPE = (64, 64, 3)
MOBILE_SHAPE = (224, 224, 3)


@pytest.fixture(scope="module")
def inputs():
    """Images, and variables drawn into the JAX tree (trained
    statistics, count 1), shared by the file."""
    images = np.random.RandomState(0).randn(2, *SHAPE).astype(np.float32)
    shapes = variable_shapes(jax_nasnet.NasNetA(JAX_CONFIG), images)
    return images, numpy_variables(shapes, seed=3, trained_stats=True)


def _port(variables):
    model = torch_nasnet.NasNetA(torch_nasnet.NasNetConfig(**SMALL, compute_dtype=torch.float32), SHAPE)
    model.load_state_dict(convert.convert_variables(variables), strict=True)
    return model


def test_imagenet_stem_structure():
    model = torch_nasnet.NasNetA(torch_nasnet.mobile_imagenet_config(), MOBILE_SHAPE)
    names = {name for name, _ in model.named_children()}
    assert {"conv0", "conv0_bn", "cell_stem_0", "cell_stem_1"} <= names and "stem_conv" not in names
    assert (model.conv0.stride, model.conv0.padding) == (2, "VALID")
    assert model.cell_stem_0.prev_mode == "current"
    assert model.cell_stem_1.prev_mode == "factorized"
    reduce = model.cell_stem_1.reduce_prev
    assert reduce.path1_conv.weight.shape[:2] == (11, 32) and reduce.path2_conv.weight.shape[:2] == (11, 32)
    assert (model.cell_stem_0.filters, model.cell_stem_1.filters, model.cell_0.filters) == (11, 22, 44)
    assert model.cell_stem_0.out_shape == (56, 56, 44) and model.cell_stem_1.out_shape == (28, 28, 88)
    assert model.cell_11.out_shape == (7, 7, 1056) and model._aux_after == "cell_7"
    assert model._cells[:2] == ["cell_stem_0", "cell_stem_1"] and len(model._cells) == 16
    # Odd filters split 5 + 6 in the stem's factorized reduction.
    odd = torch_nasnet.NasNetA(torch_nasnet.mobile_imagenet_config(num_conv_filters=44 + 2), MOBILE_SHAPE)
    assert odd.cell_stem_0.filters == 11 and odd.cell_stem_1.filters == 23
    assert odd.cell_stem_1.reduce_prev.path1_conv.weight.shape[0] == 11
    assert odd.cell_stem_1.reduce_prev.path2_conv.weight.shape[0] == 12
    # The depth part of drop-path counts the stem cells: 3 cells, 2
    # reduction cells and 2 stem cells make 7, the last cell_2.
    large = torch_nasnet.NasNetA(torch_nasnet.large_imagenet_config(num_cells=3, num_conv_filters=8), SHAPE)
    assert large.cell_stem_0.depth_keep_prob == pytest.approx(1.0 - (1 / 7) * 0.3)
    assert large.cell_2.depth_keep_prob == pytest.approx(1.0 - (7 / 7) * 0.3)
    assert len(model.sepconv_launch_shapes()) == 160


@pytest.mark.parametrize("preset", ["cifar_config", "mobile_imagenet_config", "large_imagenet_config"])
def test_presets_match_jax(preset):
    got = getattr(torch_models, preset)(num_classes=7)
    want = getattr(jax_nasnet, preset)(num_classes=7)
    dtypes = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
    for field in dataclasses.fields(want):
        value = getattr(got, field.name)
        assert (dtypes[value] if field.name == "compute_dtype" else value) == getattr(want, field.name), field.name


def test_unknown_stem_raises():
    with pytest.raises(ValueError, match="stem_type"):
        torch_nasnet.NasNetA(torch_nasnet.NasNetConfig(stem_type="mobilenet"), (32, 32, 3))


def test_imagenet_eval_forward_matches_jax(inputs):
    images, variables = inputs
    want_logits, aux, want_pooled = jax.jit(
        functools.partial(jax_nasnet.NasNetA(JAX_CONFIG).apply, training=False))(variables, images)
    assert aux is None
    model = _port(variables).eval()
    with torch.inference_mode():
        logits, aux, pooled = model(torch.from_numpy(images))
    assert aux is None and logits.shape == (2, 10)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=1e-4, rtol=0)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled), atol=1e-4, rtol=0)


def test_imagenet_training_forward_and_gradient_match_jax(inputs):
    images, variables = inputs
    module = jax_nasnet.NasNetA(JAX_CONFIG)

    def loss_fn(params):
        (logits, aux, _), moved = module.apply(
            {**variables, "params": params}, images, training=True, mutable=["batch_stats", "schedule"]
        )
        assert aux is None
        return jnp.sum(logits ** 2), (logits, moved)

    (_, (want_logits, moved)), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    model = _port(variables)
    names, params = zip(*model.named_parameters())
    logits, aux, _ = model(torch.from_numpy(images), training=True)
    assert aux is None
    grads = torch.autograd.grad((logits ** 2).sum(), params)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), atol=1e-4, rtol=0)
    want = convert.convert_variables({"params": jax.tree_util.tree_map(np.asarray, want_grads)})
    assert sorted(want) == sorted(names)
    for name, g in zip(names, grads):
        ref = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-4 * max(1.0, float(np.abs(ref).max())), rtol=0,
                                   err_msg=name)
    stats = convert.convert_variables(jax.tree_util.tree_map(np.asarray, dict(moved)), ("batch_stats", "schedule"))
    buffers = dict(model.named_buffers())
    assert sorted(stats) == sorted(buffers)
    for name, value in stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), value.numpy(), atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("batch", [1, 7, 32])
def test_sepconv_plans_fit_at_mobile_shapes(batch):
    shapes = torch_nasnet.NasNetA(torch_nasnet.mobile_imagenet_config(), MOBILE_SHAPE).sepconv_launch_shapes()
    assert {c for (_, _, c), _, _, _ in shapes} >= {11, 22, 32, 44, 88, 176}
    for (h, w, c), f, k, s in sorted(set(shapes)):
        plan = sk.launch_plan((batch, h, w, c), torch.bfloat16, f, k, s)
        assert plan.fields["smem"] <= sk.MAX_SHARED_BYTES
        assert plan.out_shape == (batch, -(-h // s), -(-w // s), f)
        # The grid covers the output once.
        assert plan.tiles_h * plan.fields["th"] >= plan.out_shape[1]
        assert plan.fields["tiles_w"] * plan.fields["tw"] >= plan.out_shape[2]
        assert plan.tiles_f * plan.fields["tf"] >= f
        if batch == 32:
            assert plan.blocks >= sk.H100_SMS
