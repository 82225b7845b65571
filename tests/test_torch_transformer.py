"""The port's transformer family against the JAX package's, on the CPU.

Copies of tests/test_transformer.py's two tests on the port; the
converted JAX encoder against the port's (f32 logits within 1e-5 of
max(1, |logits|); bf16 within twice the JAX bf16 logits' own distance
from JAX f32 at these inputs); three SGD steps of the search with ring
attention over 8 shards against the JAX search on the 8-device mesh,
from the same numpy-drawn variables (losses rtol 2e-4); and the
long-context tutorial at a small size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from adanet_tpu.core.heads import MultiClassHead as JaxHead
from adanet_tpu.core.iteration import IterationBuilder as JaxIterationBuilder
from adanet_tpu.ensemble import ComplexityRegularizedEnsembler as JaxEnsembler
from adanet_tpu.ensemble import GrowStrategy as JaxGrow
from adanet_tpu.models import transformer as jax_transformer

from adanet_tpu_torch.core.heads import MultiClassHead
from adanet_tpu_torch.core.iteration import IterationBuilder
from adanet_tpu_torch.ensemble import ComplexityRegularizedEnsembler, GrowStrategy
from adanet_tpu_torch.models.transformer import TransformerBuilder, TransformerConfig
from adanet_tpu_torch.parallel import SequenceMesh
from adanet_tpu_torch.utils import convert
from torch_port_common import numpy_variables, variable_shapes, one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)

SIZES = dict(vocab_size=64, num_layers=1, num_heads=2, model_dim=16, mlp_dim=32, max_seq_len=64)


def _config(**kwargs):
    defaults = dict(SIZES, compute_dtype=torch.float32)
    defaults.update(kwargs)
    return TransformerConfig(**defaults)


def _jax_config(**kwargs):
    defaults = dict(SIZES, compute_dtype=jnp.float32)
    defaults.update(kwargs)
    return jax_transformer.TransformerConfig(**defaults)


def _batch(batch=4, seq=16, classes=3, seed=0):
    rng = np.random.RandomState(seed)
    return (
        {"tokens": rng.randint(0, 64, size=(batch, seq))},
        rng.randint(0, classes, size=(batch,)),
    )


def _sgd(params):
    return torch.optim.SGD(params, lr=0.01)


def _train(builder, batch, steps=4):
    factory = IterationBuilder(
        head=MultiClassHead(3),
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=_sgd)],
        ensemble_strategies=[GrowStrategy()],
        device="cpu",
    )
    it = factory.build_iteration(0, [builder], None, input_shape=batch[0]["tokens"].shape[1:])
    state = it.init_state(torch.Generator().manual_seed(0), batch)
    losses = []
    for _ in range(steps):
        state, metrics = it.train_step(state, batch)
        losses.append({k: float(v) for k, v in metrics.items()})
    return losses


def test_transformer_subnetwork_trains():
    builder = TransformerBuilder(_config(), optimizer=lambda p: torch.optim.Adam(p, lr=1e-3))
    metrics = _train(builder, _batch())[-1]
    name = "adanet_loss/t0_%s_grow_complexity_regularized" % builder.name
    assert np.isfinite(metrics[name])


def test_transformer_with_ring_attention_matches_full():
    """Sequence-parallel candidate == single-device candidate numerically."""
    batch = _batch(seq=16)
    b_full = TransformerBuilder(_config(), optimizer=_sgd)
    b_ring = TransformerBuilder(_config(sp_mesh=SequenceMesh(8)), optimizer=_sgd)
    m_full = _train(b_full, batch, steps=3)[-1]
    m_ring = _train(b_ring, batch, steps=3)[-1]
    k_full = "adanet_loss/t0_%s_grow_complexity_regularized" % b_full.name
    np.testing.assert_allclose(m_full[k_full], m_ring[k_full], rtol=2e-4)


def _variables(seed=3, seq=16):
    module = jax_transformer._TransformerSubnetworkModule(config=_jax_config(), logits_dimension=3)
    shapes = variable_shapes(module, {"tokens": np.zeros((1, seq), np.int32)})
    return numpy_variables(shapes, seed)


def _jax_logits(variables, tokens, dtype):
    module = jax_transformer._TransformerSubnetworkModule(config=_jax_config(compute_dtype=dtype),
                                                          logits_dimension=3)
    return np.asarray(module.apply(variables, {"tokens": tokens}, training=False).logits)


def _port_logits(variables, tokens, dtype):
    module = TransformerBuilder(_config(compute_dtype=dtype)).build_subnetwork(3)
    module.load_state_dict(convert.convert_transformer(variables), strict=True)
    with torch.no_grad():
        return module({"tokens": torch.from_numpy(tokens)}).logits.numpy()


def test_converted_encoder_matches_jax_f32():
    variables = _variables()
    tokens = _batch(batch=4, seq=16)[0]["tokens"]
    want = _jax_logits(variables, tokens, jnp.float32)
    got = _port_logits(variables, tokens, torch.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, float(np.abs(want).max())))


def test_converted_encoder_matches_jax_bf16():
    variables = _variables()
    tokens = _batch(batch=4, seq=16)[0]["tokens"]
    f32 = _jax_logits(variables, tokens, jnp.float32)
    want = _jax_logits(variables, tokens, jnp.bfloat16)
    got = _port_logits(variables, tokens, torch.bfloat16)
    bf16_distance = float(np.abs(want - f32).max())
    assert bf16_distance > 0
    assert float(np.abs(got - want).max()) <= 2 * bf16_distance
    assert float(np.abs(got - f32).max()) <= 2 * bf16_distance


def test_ring_search_losses_match_jax():
    """Three SGD steps of a one-candidate search with ring attention over
    8 shards (JAX: the 8-device CPU mesh), from the same variables."""
    batch = _batch(seq=16)
    flax = _variables(seq=16)
    jax_builder = jax_transformer.TransformerBuilder(
        _jax_config(sp_mesh=Mesh(np.asarray(jax.devices()), axis_names=("sp",))), optimizer=optax.sgd(0.01)
    )
    jax_builder.initial_variables = flax
    factory = JaxIterationBuilder(JaxHead(3), [JaxEnsembler(optimizer=optax.sgd(0.01))], [JaxGrow()])
    it = factory.build_iteration(0, [jax_builder], None)
    state = it.init_state(jax.random.PRNGKey(0), batch)
    want = []
    for _ in range(3):
        state, metrics = it.train_step(state, batch)
        want.append({k: float(v) for k, v in metrics.items()})
    builder = TransformerBuilder(_config(sp_mesh=SequenceMesh(8)), optimizer=_sgd)
    builder.initial_variables = convert.convert_transformer(flax)
    got = _train(builder, batch, steps=3)
    for step, (g, w) in enumerate(zip(got, want)):
        for key in ("adanet_loss/t0_%s_grow_complexity_regularized" % builder.name,
                    "subnetwork_loss/%s" % builder.name):
            assert key in w, sorted(w)
            np.testing.assert_allclose(g[key], w[key], rtol=2e-4, err_msg="step %d %s" % (step, key))


def test_encoder_refuses_sequences_past_max_seq_len():
    module = TransformerBuilder(_config(max_seq_len=8)).build_subnetwork(3)
    module.init_parameters(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="max_seq_len"):
        module({"tokens": torch.zeros(1, 16, dtype=torch.long)})


def test_adamw_default_matches_optax_adamw():
    """The builder's default optimizer is `optax.adamw(1e-3)`: three steps
    on the same parameter and gradients agree."""
    from adanet_tpu_torch.models.transformer import adamw

    rng = np.random.RandomState(0)
    p0 = rng.randn(5).astype(np.float32)
    grads = [rng.randn(5).astype(np.float32) for _ in range(3)]
    tx = optax.adamw(1e-3)
    params, opt = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    for g in grads:
        updates, opt = tx.update(jnp.asarray(g), opt, params)
        params = optax.apply_updates(params, updates)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    optimizer = adamw()([p])
    for g in grads:
        p.grad = torch.from_numpy(g)
        optimizer.step()
    # f32 rounding order: one ulp at these values.
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params), rtol=2e-7, atol=0)


def test_long_context_tutorial_small(capsys):
    from adanet_tpu_torch.examples.tutorials import long_context_ring_attention

    long_context_ring_attention.main(["--device", "cpu", "--seq_len", "64", "--batch_size", "8",
                                      "--max_steps", "6", "--iterations", "2", "--devices", "8"])
    out = capsys.readouterr().out
    assert "ring attention over 8 shards" in out
    assert "OK: long-context search with ring attention" in out


def test_ring_transformer_winner_exports(tmp_path):
    """A long-context search's winner (ring attention over 4 shards in
    its graph) exports; the program serves batches 1 and 7 bitwise the
    in-process predict and refuses another sequence length (the shape
    guard survives the export)."""
    from adanet_tpu_torch.core import export
    from adanet_tpu_torch.core.estimator import Estimator
    from adanet_tpu_torch.subnetwork.generator import SimpleGenerator

    rng = np.random.RandomState(1)
    tokens, labels = rng.randint(0, 64, (32, 16)), rng.randint(0, 2, 32)

    def input_fn():
        for start in range(0, 32, 8):
            yield {"tokens": tokens[start:start + 8]}, labels[start:start + 8]

    builders = [TransformerBuilder(_config(num_layers=n, sp_mesh=SequenceMesh(4))) for n in (1, 2)]
    est = Estimator(MultiClassHead(2), SimpleGenerator(builders), 4, max_iterations=2, device="cpu",
                    ensemblers=[ComplexityRegularizedEnsembler(optimizer=_sgd)], model_dir=str(tmp_path / "m"),
                    log_every_steps=0)
    est.train(input_fn)
    export_dir = est.export_saved_model(str(tmp_path / "export"), ({"tokens": tokens[:1]}, None))
    served = export.load_serving_program(export_dir, device="cpu")
    for rows in (tokens[:1], tokens[1:8]):
        want = next(iter(est.predict(lambda: iter([{"tokens": rows}]))))
        got = served({"tokens": rows})
        for key in want:
            assert torch.equal(got[key], want[key]), key
    with pytest.raises(Exception):
        served({"tokens": np.zeros((2, 32), np.int64)})
