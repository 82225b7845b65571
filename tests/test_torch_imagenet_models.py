"""The port's ImageNet-class families (`models/resnet.py`,
`models/efficientnet.py`) against the JAX package's.

- Copies of the four structure tests of tests/test_imagenet_models.py
  (ResNet-50, the shallow ResNet's basic blocks, EfficientNet-B0, the
  scaling variants), built on the meta device (no memory, no compute):
  output shapes, and parameter counts equal to the Flax trees'.
- Forwards from the same variables (numpy, drawn into the Flax tree and
  carried across by `utils.convert`), f32 within 1e-5 x max(1, |value|):
  ResNet with basic and with bottleneck blocks and EfficientNet-B0
  (small inputs) in eval mode; in training mode, with the running
  statistics after the forward, the basic-block ResNet whole, a
  bottleneck block and MBConv blocks (stochastic depth from fed
  draws). A whole ResNet-50 or B0 in training mode moves under f32
  rounding by more than 1e-5 (JAX against itself, its variables moved
  by 1e-7), so it is held within 5 x that move.
- bf16 by the mean |diff| under 0.9 x JAX's own bf16-against-f32 gap at
  the same inputs (which the port's f32 forward fails): the ResNets'
  logits and an MBConv block's output.
- TF-SAME padding at the published shapes: the 7x7/s2 stem at 224, a
  v1.5 3x3/s2 at 56, a 5x5/s2 depthwise at 112.
- Under RUN_SLOW, a copy of test_resnet_and_efficientnet_search_lifecycle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adanet_tpu.models import efficientnet as jax_efficientnet
from adanet_tpu.models import resnet as jax_resnet

from adanet_tpu_torch.models import efficientnet, resnet
from adanet_tpu_torch.utils.convert import convert_efficientnet, convert_resnet

from torch_port_common import numpy_variables, one_torch_thread, variable_shapes

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)


def _flax_count(variables):
    return sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(variables["params"]))


def _port_count(module):
    return sum(p.numel() for p in module.parameters())


def test_resnet50_structure():
    """Full ResNet-50: output shapes and the canonical ~25.6M parameters,
    the Flax tree's count exactly."""
    with torch.device("meta"):
        module = resnet.ResNet(logits_dimension=1000, depth=50)
        out = module({"image": torch.empty(2, 224, 224, 3)}, training=False)
    assert out.logits.shape == (2, 1000)
    assert out.last_layer.shape == (2, 2048)
    params = _port_count(module)
    assert 25.0e6 < params < 26.5e6, params
    shapes = jax.eval_shape(lambda rng, x: jax_resnet.ResNet(logits_dimension=1000, depth=50).init(
        rng, x, training=False), jax.random.PRNGKey(0), jnp.zeros((2, 224, 224, 3), jnp.float32))
    assert params == _flax_count(shapes)


def test_resnet_shallow_uses_basic_blocks():
    with torch.device("meta"):
        module = resnet.ResNet(logits_dimension=10, depth=18, width=16, small_inputs=True)
        out = module({"image": torch.empty(2, 32, 32, 3)}, training=False)
    assert out.logits.shape == (2, 10)
    assert out.last_layer.shape == (2, 16 * 8)  # width * 2^3, no bottleneck
    assert isinstance(module.stage0_block0, resnet._BasicBlock)
    with pytest.raises(ValueError):
        resnet.ResNet(logits_dimension=10, depth=20)


def test_efficientnet_b0_structure():
    """Full EfficientNet-B0: ~5.3M parameters (the published figure), the
    Flax tree's count exactly, and the 1280-wide head."""
    with torch.device("meta"):
        module = efficientnet.EfficientNet(logits_dimension=1000, variant="b0")
        out = module({"image": torch.empty(2, 224, 224, 3)}, training=False)
    assert out.logits.shape == (2, 1000)
    assert out.last_layer.shape == (2, 1280)
    params = _port_count(module)
    assert 4.8e6 < params < 5.8e6, params
    shapes = jax.eval_shape(
        lambda rng, x: jax_efficientnet.EfficientNet(logits_dimension=1000, variant="b0").init(
            rng, x, training=False),
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, jnp.zeros((2, 224, 224, 3)))
    assert params == _flax_count(shapes)


def test_efficientnet_scaling_grows_params():
    def params_of(variant):
        with torch.device("meta"):
            module = efficientnet.EfficientNet(logits_dimension=10, variant=variant)
        shapes = jax.eval_shape(
            lambda rng, x: jax_efficientnet.EfficientNet(logits_dimension=10, variant=variant).init(
                rng, x, training=False),
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, jnp.zeros((1, 64, 64, 3)))
        assert _port_count(module) == _flax_count(shapes), variant
        return _port_count(module)

    counts = [params_of(v) for v in sorted(efficientnet.EFFICIENTNET_SCALING)]
    assert counts == sorted(counts) and len(set(counts)) == len(counts)
    with pytest.raises(ValueError):
        efficientnet.EfficientNet(logits_dimension=10, variant="b7")


@pytest.mark.parametrize("size,kernel,stride,pads", [(224, 7, 2, (2, 3)), (56, 3, 2, (0, 1)), (112, 5, 2, (1, 2)),
                                                     (32, 3, 1, (1, 1))])
def test_same_padding_at_published_shapes(size, kernel, stride, pads):
    from adanet_tpu_torch.ops.sepconv_kernels import same_pads

    assert same_pads(size, kernel, stride)[1:] == pads
    conv = resnet.Conv(2, 3, kernel, stride)
    torch.nn.init.normal_(conv.weight, generator=torch.Generator().manual_seed(0))
    x = np.random.RandomState(0).randn(1, size, size, 2).astype(np.float32)
    got = conv(torch.from_numpy(x).permute(0, 3, 1, 2), torch.float32).permute(0, 2, 3, 1)
    kernel_hwio = np.transpose(conv.weight.detach().numpy(), (2, 3, 1, 0))
    want = jax.lax.conv_general_dilated(x, kernel_hwio, (stride, stride), "SAME",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _families(dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    return {
        "resnet18": (lambda: jax_resnet.ResNet(logits_dimension=10, depth=18, width=8, small_inputs=True,
                                               compute_dtype=jdt),
                     lambda: resnet.ResNet(logits_dimension=10, depth=18, width=8, small_inputs=True,
                                           compute_dtype=tdt),
                     convert_resnet, 16),
        "resnet50": (lambda: jax_resnet.ResNet(logits_dimension=10, depth=50, width=4, compute_dtype=jdt),
                     lambda: resnet.ResNet(logits_dimension=10, depth=50, width=4, compute_dtype=tdt),
                     convert_resnet, 32),
        "efficientnet_b0": (lambda: jax_efficientnet.EfficientNet(logits_dimension=10, small_inputs=True,
                                                                  compute_dtype=jdt, drop_path_rate=0.5),
                            lambda: efficientnet.EfficientNet(logits_dimension=10, small_inputs=True,
                                                              compute_dtype=tdt, drop_path_rate=0.5),
                            convert_efficientnet, 16),
    }


def _drops(block):
    """Whether a training forward of an MBConv block draws its stochastic depth."""
    return block.residual and block.drop_rate > 0.0


class _Draws:
    """The same U[0, 1) draws for both packages' stochastic depth: the
    JAX module's `bernoulli(rng, keep, [B, 1, 1, 1])` and the port's
    `_uniform([B])`, block by block in order."""

    def __init__(self, batch, seed=0):
        self._rng = np.random.RandomState(seed)
        self._batch = batch
        self.jax, self.port = [], []

    def bernoulli(self, key, p, shape):
        u = self._rng.rand(self._batch).astype(np.float32)
        self.jax.append(u)
        return jnp.asarray(u).reshape(shape) < p

    def uniform(self, shape, generator, device):
        u = self.jax[len(self.port)]
        assert tuple(shape) == u.shape
        self.port.append(u)
        return torch.from_numpy(u).to(device)


def _run(family, dtype, training, seed=3, batch=4, monkeypatch=None):
    make_jax, make_port, convert, size = _families(dtype)[family]
    x = np.random.RandomState(seed).randn(batch, size, size, 3).astype(np.float32)
    shapes = variable_shapes(_families("float32")[family][0](), {"image": x})
    variables = numpy_variables(shapes, seed, trained_stats=True)
    rngs = {"dropout": jax.random.PRNGKey(0)}
    draws = _Draws(batch)
    if training and monkeypatch is not None:
        monkeypatch.setattr(jax_efficientnet.jax.random, "bernoulli", draws.bernoulli)
        monkeypatch.setattr(efficientnet, "_uniform", draws.uniform)
    if training:
        want, mutated = make_jax().apply(variables, {"image": x}, training=True, rngs=rngs,
                                         mutable=["batch_stats"])
    else:
        want, mutated = make_jax().apply(variables, {"image": x}, training=False), None
    module = make_port()
    module.load_state_dict(convert(variables))
    got = module({"image": torch.from_numpy(x)}, training=training)
    if training and monkeypatch is not None:
        monkeypatch.undo()
    return got, want, module, mutated, variables, x, draws


def _close(got, want, rel=1e-5, what=""):
    want = np.asarray(want)
    atol = rel * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=atol, err_msg=what)


def _assert_statistics(module, mutated, convert, rel=1e-5):
    """The port's running statistics after its training forward against the
    JAX forward's mutated `batch_stats`, each within rel x max(1, |value|)."""
    moved = convert(jax.tree_util.tree_map(np.asarray, {"batch_stats": mutated["batch_stats"]}))
    state = module.state_dict()
    assert set(moved) == {k for k in state if k.endswith((".mean", ".var"))}
    for key, value in moved.items():
        _close(state[key].numpy(), value.numpy(), rel, key)


@pytest.mark.parametrize("family,training", [("resnet18", False), ("resnet18", True), ("resnet50", False),
                                             ("efficientnet_b0", False)])
def test_f32_forward_and_statistics_match_jax(family, training, monkeypatch):
    """Eval mode for every family, training mode for the basic-block
    ResNet, at 1e-5. A whole bottleneck ResNet or EfficientNet in
    training mode, where every batch norm renormalises by its own
    batch, moves by more than that under f32 rounding alone
    (`test_deep_training_forward_within_jax_conditioning`); their blocks
    are held at 1e-5 in training mode below."""
    got, want, module, mutated, _, _, _ = _run(family, "float32", training, monkeypatch=monkeypatch)
    _close(got.logits.detach().numpy(), want.logits)
    _close(got.last_layer.detach().numpy(), want.last_layer)
    assert got.logits.dtype == torch.float32 and got.complexity == want.complexity
    if training:
        _assert_statistics(module, mutated, _families("float32")[family][2])


def _blocks(dtype):
    jdt = getattr(jnp, dtype)
    return {
        # A ResNet-50 stage's first block: projection, stride 2 on the 3x3.
        "bottleneck": (lambda: jax_resnet._Bottleneck(filters=8, stride=2, compute_dtype=jdt),
                       lambda: resnet._Bottleneck(16, 8, 2)),
        # An EfficientNet block with expansion, a 5x5 depthwise, squeeze-
        # excite and a residual that stochastic depth drops.
        "mbconv": (lambda: jax_efficientnet._MBConv(expand_ratio=6, filters=16, stride=1, kernel=5, drop_rate=0.5,
                                                    compute_dtype=jdt),
                   lambda: efficientnet._MBConv(16, 6, 16, 1, 5, 0.5)),
        # A stride-2 one (no residual).
        "mbconv_s2": (lambda: jax_efficientnet._MBConv(expand_ratio=6, filters=24, stride=2, kernel=3,
                                                       drop_rate=0.5, compute_dtype=jdt),
                      lambda: efficientnet._MBConv(16, 6, 24, 2, 3, 0.5)),
    }


def _run_block(block, dtype, training, monkeypatch, batch=8):
    from adanet_tpu_torch.utils.convert import convert_variables

    make_jax, make_port = _blocks(dtype)[block]
    x = np.random.RandomState(0).randn(batch, 16, 16, 16).astype(np.float32)
    shapes = jax.eval_shape(lambda r, v: _blocks("float32")[block][0]().init(r, v, training=True),
                            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, x)
    variables = numpy_variables(shapes, 1, trained_stats=True)
    draws = _Draws(batch)
    monkeypatch.setattr(jax_efficientnet.jax.random, "bernoulli", draws.bernoulli)
    monkeypatch.setattr(efficientnet, "_uniform", draws.uniform)
    want = make_jax().apply(variables, x, training=training, rngs={"dropout": jax.random.PRNGKey(0)},
                            mutable=["batch_stats"] if training else False)
    want, mutated = want if training else (want, None)
    module = make_port()
    module.load_state_dict(convert_variables(variables))
    got = module(torch.from_numpy(x).permute(0, 3, 1, 2), training, getattr(torch, dtype))
    monkeypatch.undo()
    return got.permute(0, 2, 3, 1).detach().float().numpy(), np.asarray(want, np.float32), module, mutated, draws


@pytest.mark.parametrize("block", ["bottleneck", "mbconv", "mbconv_s2"])
def test_training_blocks_match_jax(block, monkeypatch):
    """A bottleneck block and MBConv blocks in training mode, f32, from
    the same variables and (MBConv) the same stochastic-depth draws:
    output and running statistics within 1e-5 x max(1, |value|)."""
    from adanet_tpu_torch.utils.convert import convert_variables

    got, want, module, mutated, draws = _run_block(block, "float32", True, monkeypatch)
    _close(got, want)
    _assert_statistics(module, mutated, lambda v: convert_variables(v, collections=("batch_stats",)))
    assert len(draws.jax) == len(draws.port) == (1 if block == "mbconv" else 0)


@pytest.mark.parametrize("family", ["resnet50", "efficientnet_b0"])
def test_deep_training_forward_within_jax_conditioning(family, monkeypatch):
    """A whole bottleneck ResNet-50 and EfficientNet-B0 in training mode
    (f32, fed stochastic-depth draws): the port's logits and running
    statistics against JAX's within 5 x the largest move of JAX's own
    logits and statistics when its variables move by a relative 1e-7
    (seeds 5, 11, 17). That move exceeds 1e-5 of the logits for
    ResNet-50 (about 1.4e-4 at these inputs): the network's own
    conditioning, which no f32 implementation can beat."""
    got, want, module, mutated, variables, x, draws = _run(family, "float32", True, monkeypatch=monkeypatch)
    make_jax = _families("float32")[family][0]
    convert = _families("float32")[family][2]
    moved_logits, moved_stats = 0.0, 0.0
    for seed in (5, 11, 17):
        rng = np.random.RandomState(seed)
        moved = jax.tree_util.tree_map(lambda v: (v * (1.0 + 1e-7 * rng.randn(*v.shape))).astype(np.float32),
                                       variables)
        replay = iter(draws.jax)
        monkeypatch.setattr(jax_efficientnet.jax.random, "bernoulli",
                            lambda key, p, shape: jnp.asarray(next(replay)).reshape(shape) < p)
        out, stats = make_jax().apply(moved, {"image": x}, training=True, rngs={"dropout": jax.random.PRNGKey(0)},
                                      mutable=["batch_stats"])
        monkeypatch.undo()
        moved_logits = max(moved_logits, float(np.abs(np.asarray(out.logits) - np.asarray(want.logits)).max()))
        for a, b in zip(jax.tree_util.tree_leaves(stats), jax.tree_util.tree_leaves(mutated)):
            moved_stats = max(moved_stats, float(np.abs(np.asarray(a) - np.asarray(b)).max()))
    gap = float(np.abs(got.logits.detach().numpy() - np.asarray(want.logits)).max())
    assert 0.0 < gap <= 5.0 * moved_logits, (gap, moved_logits)
    want_stats = convert(jax.tree_util.tree_map(np.asarray, {"batch_stats": mutated["batch_stats"]}))
    state = module.state_dict()
    stats_gap = max(float((state[k] - v).abs().max()) for k, v in want_stats.items())
    assert stats_gap <= 5.0 * moved_stats, (stats_gap, moved_stats)
    if family == "efficientnet_b0":
        assert len(draws.jax) == len(draws.port) == sum(_drops(getattr(module, n)) for n in module.blocks) > 0


@pytest.mark.parametrize("family", ["resnet18", "resnet50"])
def test_bf16_forward_matches_jax(family):
    """bf16 by the mean |diff| of the logits: within 0.9 x JAX's own bf16
    against f32 gap at the same inputs, which the port's f32 forward
    fails."""
    got, want, _, _, variables, x, _ = _run(family, "bfloat16", training=False)
    want_logits = np.asarray(want.logits)
    f32 = _families("float32")[family][0]().apply(variables, {"image": x}, training=False)
    bound = 0.9 * float(np.abs(np.asarray(f32.logits) - want_logits).mean())
    gap = float(np.abs(got.logits.detach().numpy() - want_logits).mean())
    assert gap <= bound, (gap, bound)
    port_f32, _, _, _, _, _, _ = _run(family, "float32", training=False)
    assert float(np.abs(port_f32.logits.detach().numpy() - want_logits).mean()) > bound, \
        "an f32 forward passes the bf16 bound"
    assert got.logits.dtype == torch.float32


def test_bf16_mbconv_matches_jax(monkeypatch):
    """EfficientNet's bf16 held at its block, eval mode: at B0's pooled
    logits the bf16 effect (about 1.7e-4 mean at the f32 test's inputs)
    is no larger than the two backends' orders of bf16 rounding, so a
    whole-network bound cannot tell bf16 from f32 there. The block's
    output within 0.9 x JAX's own bf16 against f32 gap, which the
    port's f32 block fails."""
    got, want, _, _, _ = _run_block("mbconv", "bfloat16", False, monkeypatch)
    f32_jax = _run_block("mbconv", "float32", False, monkeypatch)[1]
    bound = 0.9 * float(np.abs(f32_jax - want).mean())
    assert float(np.abs(got - want).mean()) <= bound
    f32_port = _run_block("mbconv", "float32", False, monkeypatch)[0]
    assert float(np.abs(f32_port - want).mean()) > bound, "an f32 block passes the bf16 bound"


@pytest.mark.slow
def test_resnet_and_efficientnet_search_lifecycle(tmp_path):
    """Lifecycle smoke for the heavy families: the search runs end to end
    with finite metrics (copy of the JAX test, f32, adam 1e-3)."""
    from adanet_tpu_torch.core.estimator import Estimator
    from adanet_tpu_torch.core.heads import MultiClassHead
    from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
    from adanet_tpu_torch.examples.synthetic_digits import image_input_fn, make_dataset
    from adanet_tpu_torch.subnetwork.generator import SimpleGenerator

    def adam(named):
        return torch.optim.Adam([p for _, p in named], lr=1e-3)

    xtr, ytr = make_dataset(512, seed=7)
    xte, yte = make_dataset(256, seed=8)
    est = Estimator(
        head=MultiClassHead(n_classes=10),
        subnetwork_generator=SimpleGenerator([
            resnet.ResNetBuilder(depth=18, width=8, small_inputs=True, optimizer=adam, compute_dtype=torch.float32),
            efficientnet.EfficientNetBuilder(variant="b0", small_inputs=True, optimizer=adam,
                                             compute_dtype=torch.float32),
        ]),
        max_iteration_steps=20,
        max_iterations=1,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=lambda params: torch.optim.SGD(params, lr=0.01))],
        model_dir=str(tmp_path / "model"),
        log_every_steps=0,
        device="cpu",
    )

    # Grayscale -> 3 channels for the imagenet-style stems.
    def rgb_input(x, y):
        return image_input_fn(np.repeat(x, 3, axis=-1), y, batch_size=64)

    est.train(rgb_input(xtr, ytr), max_steps=10**6)
    metrics = est.evaluate(rgb_input(xte, yte))
    assert np.isfinite(metrics["average_loss"])
    assert np.isfinite(metrics["accuracy"])
