"""The port's fused NASNet-A cell (K3) on the CPU against the JAX package.

On the CPU the port's `fused_cell` runs its plain version,
`cell_reference`. The JAX side runs its Pallas kernel as its own tests
do on the CPU, `fused_cell(..., interpret=True)`, and its jitted
`cell_reference` (bit-identical to the interpret-mode kernel by the JAX
package's own oracle test). Inputs and parameters come from numpy seeds;
the parameters are drawn into the JAX `init_cell_params` tree and
carried across with `utils.convert.convert_cell_params`.

Tolerances: f32 rtol and atol 1e-5 (the same f32 arithmetic, sums in
other orders). bf16 inputs: one bf16 ulp of the expected output (both
sides compute in f32 from the same bf16 values and round once at the
output, so a sum near a rounding boundary may round either way).
Gradients rtol and atol 1e-5, against `jax.vjp` of the reference, which
is what the JAX custom VJP computes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adanet_tpu.ops import cell_kernels as jax_ck
from adanet_tpu_torch.ops import cell_kernels as ck
from adanet_tpu_torch.utils import convert

TINY_CELL = dict(
    operations=("separable_3x3_1", "none", "avg_pool_3x3", "max_pool_3x3"),
    hiddenstate_indices=(0, 1, 1, 0),
    used_hiddenstates=(1, 1, 0, 0),
    stride=1,
)
TINY_REDUCTION = dict(
    operations=("separable_3x3_1", "max_pool_3x3", "none", "avg_pool_3x3"),
    hiddenstate_indices=(0, 1, 0, 1),
    used_hiddenstates=(0, 1, 0, 0),
    stride=2,
)
NORMAL = dict(
    operations=jax_ck.NORMAL_CELL.operations,
    hiddenstate_indices=jax_ck.NORMAL_CELL.hiddenstate_indices,
    used_hiddenstates=jax_ck.NORMAL_CELL.used_hiddenstates,
    stride=1,
)
REDUCTION = dict(
    operations=jax_ck.REDUCTION_CELL.operations,
    hiddenstate_indices=jax_ck.REDUCTION_CELL.hiddenstate_indices,
    used_hiddenstates=jax_ck.REDUCTION_CELL.used_hiddenstates,
    stride=2,
)
SPECS = {"tiny": TINY_CELL, "tiny_reduction": TINY_REDUCTION, "normal": NORMAL, "reduction": REDUCTION}
FILTERS = {"tiny": 8, "tiny_reduction": 8, "normal": 4, "reduction": 4}


def _specs(name):
    return jax_ck.CellSpec(**SPECS[name]), ck.CellSpec(**SPECS[name])


def _inputs(name, c_prev, c_cur, seed, h=8, w=8, b=2):
    """prev, cur (numpy f32) and the JAX params tree with numpy leaves:
    weights ~ N(0, 1/fan_in), scales ~ 1 + N(0, 0.1^2), biases ~ N(0, 0.1^2)."""
    jspec, _ = _specs(name)
    filters = FILTERS[name]
    shapes = jax.eval_shape(
        functools.partial(
            jax_ck.init_cell_params, spec=jspec, prev_channels=c_prev, cur_channels=c_cur, filters=filters
        ),
        jax.random.PRNGKey(0),
    )
    rng = np.random.RandomState(seed)

    def leaf(path, spec):
        name = path[-1].key
        shape = spec.shape
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.randn(*shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1]))
        return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    prev = rng.randn(b, h, w, c_prev).astype(np.float32)
    cur = rng.randn(b, h, w, c_cur).astype(np.float32)
    return prev, cur, params


def _port_params(params):
    return convert.convert_cell_params(params)


def _jax_params(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def _jitted_reference(jspec):
    return jax.jit(functools.partial(jax_ck.cell_reference, spec=jspec))


# (spec, prev channels, cur channels): the prev projection is taken when
# prev's channel count differs from the cell's filters.
CASES = [
    ("tiny", 12, 8),
    ("tiny", 8, 6),
    ("tiny_reduction", 8, 8),
    ("tiny_reduction", 6, 8),
    ("normal", 6, 8),
    ("normal", 4, 6),
    ("reduction", 4, 8),
    ("reduction", 8, 4),
]


@pytest.mark.parametrize("name,c_prev,c_cur", CASES)
def test_cell_matches_jax_reference_f32(name, c_prev, c_cur):
    jspec, spec = _specs(name)
    prev, cur, params = _inputs(name, c_prev, c_cur, seed=c_prev * 10 + c_cur)
    want = np.asarray(_jitted_reference(jspec)(jnp.asarray(prev), jnp.asarray(cur), _jax_params(params)))
    port_params = _port_params(params)
    assert ("prev" in port_params) == (c_prev != FILTERS[name])
    before = ck.fused_cell.launches
    got = ck.fused_cell(torch.from_numpy(prev), torch.from_numpy(cur), port_params, spec)
    # CPU tensors take the plain version: no kernel launch is counted.
    assert ck.fused_cell.launches == before
    assert got.dtype == torch.float32
    assert tuple(got.shape) == ck.output_shape(spec, 2, 8, 8, FILTERS[name]) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["tiny", "tiny_reduction", "normal", "reduction"])
def test_cell_matches_jax_interpret_kernel_f32(name):
    """Against the Pallas kernel itself, run in interpret mode; odd 9x9
    inputs for the reduction specs reach the shifted factorized path's
    zero fill (TINY_REDUCTION) and the SAME halo of stride-2 pools."""
    jspec, spec = _specs(name)
    hw = 9 if "reduction" in name else 8
    prev, cur, params = _inputs(name, 6, 8, seed=7, h=hw, w=hw)
    want = np.asarray(
        jax_ck.fused_cell(jnp.asarray(prev), jnp.asarray(cur), _jax_params(params), jspec, interpret=True)
    )
    got = ck.fused_cell(torch.from_numpy(prev), torch.from_numpy(cur), _port_params(params), spec)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _bf16_ulp(x):
    """One bf16 ulp at each |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("name", ["tiny", "tiny_reduction", "normal", "reduction"])
def test_cell_matches_jax_bf16_within_one_ulp(name):
    jspec, spec = _specs(name)
    prev, cur, params = _inputs(name, 6, 8, seed=11)
    want = _jitted_reference(jspec)(
        jnp.asarray(prev, jnp.bfloat16), jnp.asarray(cur, jnp.bfloat16), _jax_params(params)
    )
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want, np.float32)
    got = ck.fused_cell(
        torch.from_numpy(prev).to(torch.bfloat16),
        torch.from_numpy(cur).to(torch.bfloat16),
        _port_params(params),
        spec,
    )
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert np.all(err <= _bf16_ulp(want)), float(err.max())


@pytest.mark.parametrize("name,c_prev", [("tiny", 12), ("tiny_reduction", 8)])
def test_cell_gradients_match_jax_vjp(name, c_prev):
    jspec, spec = _specs(name)
    hw = 9 if "reduction" in name else 8
    prev, cur, params = _inputs(name, c_prev, 8, seed=3, h=hw, w=hw)
    jparams = _jax_params(params)
    out_shape = jax_ck.output_shape(jspec, 2, hw, hw, FILTERS[name])
    cot = np.random.RandomState(5).randn(*out_shape).astype(np.float32)

    @jax.jit
    def jax_grads(p, c, par, g):
        _, vjp = jax.vjp(lambda a, b, q: jax_ck.cell_reference(a, b, q, jspec), p, c, par)
        return vjp(g)

    g_prev, g_cur, g_params = jax_grads(jnp.asarray(prev), jnp.asarray(cur), jparams, jnp.asarray(cot))

    t_prev = torch.from_numpy(prev).requires_grad_(True)
    t_cur = torch.from_numpy(cur).requires_grad_(True)
    t_params = _port_params(params)
    leaves = [leaf.requires_grad_(True) for _, leaf in ck._flatten(t_params)]
    out = ck.fused_cell(t_prev, t_cur, t_params, spec)
    grads = torch.autograd.grad(out, [t_prev, t_cur, *leaves], torch.from_numpy(cot))

    np.testing.assert_allclose(grads[0].numpy(), np.asarray(g_prev), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grads[1].numpy(), np.asarray(g_cur), rtol=1e-5, atol=1e-5)
    want = _port_params(jax.tree_util.tree_map(np.asarray, g_params))
    want_leaves = [leaf for _, leaf in ck._flatten(want)]
    assert len(want_leaves) == len(leaves)
    for (path, _), got, expected in zip(ck._flatten(t_params), grads[2:], want_leaves):
        np.testing.assert_allclose(
            got.numpy(), expected.numpy(), rtol=1e-5, atol=1e-5, err_msg=str(path)
        )


def test_convert_cell_params_layouts():
    _, _, params = _inputs("tiny_reduction", 6, 8, seed=1)
    port = convert.convert_cell_params(params)
    assert tuple(port["begin"]["w"].shape) == (8, 8)
    np.testing.assert_array_equal(port["prev"]["w"].numpy(), params["prev"]["w"].T)
    layer = port["blocks"][0]["left"]["layers"][0]
    jlayer = params["blocks"][0]["left"]["layers"][0]
    np.testing.assert_array_equal(layer["dw"].numpy()[:, 0], np.transpose(jlayer["dw"][:, :, 0, :], (2, 0, 1)))
    np.testing.assert_array_equal(layer["pw"].numpy()[:, :, 0, 0], jlayer["pw"][0, 0].T)
    red = port["reductions"]["0"]
    assert tuple(red["w1"].shape) == (4, 8) and tuple(red["w2"].shape) == (4, 8)
    np.testing.assert_array_equal(red["scale"].numpy(), params["reductions"]["0"]["scale"])
    assert isinstance(port["blocks"], tuple)


def test_init_cell_params_matches_jax_structure():
    for name in SPECS:
        jspec, spec = _specs(name)
        shapes = jax.eval_shape(
            functools.partial(
                jax_ck.init_cell_params, spec=jspec, prev_channels=6, cur_channels=8, filters=FILTERS[name]
            ),
            jax.random.PRNGKey(0),
        )
        want = _port_params(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes))
        got = ck.init_cell_params(torch.Generator().manual_seed(0), spec, 6, 8, FILTERS[name], device="cpu")
        assert [(p, tuple(t.shape)) for p, t in ck._flatten(got)] == [
            (p, tuple(t.shape)) for p, t in ck._flatten(want)
        ]
        for path, leaf in ck._flatten(got):
            if path[-1] in ("scale", "bias"):
                assert leaf.dtype == torch.float32


def test_cell_spec_validation():
    with pytest.raises(ValueError):
        ck.CellSpec(operations=("none",), hiddenstate_indices=(0,), used_hiddenstates=(1, 1, 0))
    with pytest.raises(ValueError):
        ck.CellSpec(operations=("none", "none"), hiddenstate_indices=(0, 1), used_hiddenstates=(1, 1))
    with pytest.raises(ValueError):
        ck.CellSpec(operations=("none", "none"), hiddenstate_indices=(0,), used_hiddenstates=(1, 1, 0))


def test_spatial_mismatch_and_unknown_op_raise():
    """Where the JAX wrapper falls back to its reference, the port raises."""
    _, spec = _specs("tiny")
    prev, cur, params = _inputs("tiny", 8, 8, seed=2)
    port_params = _port_params(params)
    with pytest.raises(ValueError, match="spatial"):
        ck.fused_cell(torch.from_numpy(prev[:, :4, :4]), torch.from_numpy(cur), port_params, spec)
    bad = ck.CellSpec(
        operations=("conv_3x3", "none", "avg_pool_3x3", "max_pool_3x3"),
        hiddenstate_indices=(0, 1, 1, 0),
        used_hiddenstates=(1, 1, 0, 0),
    )
    with pytest.raises(ValueError, match="Unsupported"):
        ck.fused_cell(torch.from_numpy(prev), torch.from_numpy(cur), port_params, bad)
