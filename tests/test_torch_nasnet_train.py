"""The port's NASNet-A in training against the JAX package's.

- Batch norm's training branch against the JAX `_DebiasedBatchNorm` (the
  cases of tests/test_nasnet_bn.py): outputs and statistics after one
  and after 50 updates, the oracle's EMA over constant batches, the
  momentum cap at 0.9997, bf16 inputs with f32 statistics. f32 atol
  1e-5 x max(1, |ref|) (the same arithmetic, sums in other orders).
  In bf16 also the gradients: output within 2 bf16 ulps of each value,
  the input's gradient within one, scale's and bias's atol 1e-5 x
  max(1, max|ref|) (statistics or normalisation in bf16 fail it).
- Drop-path against the JAX `_drop_path` given the same U[0, 1) draws
  (exact in f32; bf16 to one ulp of its output), and each cell's keep
  probability at progress 0, 0.5 and 1 against the JAX formula; dense
  dropout against Flax `nn.Dropout` with the same draws (exact).
- One training forward and its gradient against the JAX package's
  `jax.value_and_grad`, recorded by `torch_nasnet_golden.py` (see there
  for the inputs and why it is recorded) at batch 4 and 32: logits, aux
  logits, pooled features, every parameter's gradient, the updated
  batch statistics, `count` and the schedule step. f32: atol 1e-4 x
  max(1, max|ref|) per tensor (sums in other orders through 5 cells;
  measured 3e-6 on the outputs, 2e-5 relative on the gradients). bf16
  at batch 4: the logits and pooled features within atol 0.1, as
  ROADMAP §C gives for the JAX CPU path's depthwise rounding (it rounds
  the depthwise result to bf16 where K2 and the port keep it f32); each
  output, and the whole gradient in norm, within twice the distance
  bf16 rounding puts between the JAX package's own bf16 and f32 results
  on these inputs (at batch 4 the batch norms amplify it: 26% of the
  gradient's norm, 0.083 on the aux logits, which pass two batch norms
  over 4 values a channel); the statistics atol 0.1 x max(1, max|ref|).
  bf16 at batch 32: the three outputs within atol 0.1, each parameter's
  gradient per tensor as the test states. bf16 rounding differences of
  this size hide faults of the same size (batch norm's statistics in
  bf16 pass them), which the batch-norm tests above hold.
- The same forward of a 2-cell NASNet-A in f32 against the JAX package
  run live, and the recorded inputs against the digest in the file.
- Remat: the same outputs, gradients, statistics, `count` and schedule
  step as without remat, with drop-path and dropout on (exact).
- The schedule collection and the statistics convert from the Flax tree
  and back.
- RUN_SLOW: the recorded JAX results are current.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adanet_tpu.models import nasnet as jax_nasnet
from adanet_tpu_torch.models import nasnet as torch_nasnet
from adanet_tpu_torch.utils import convert

import torch_nasnet_golden as golden
from torch_port_common import flax_tree, one_torch_thread, port_numpy_state, unflatten

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)


def _scaled_close(got, want, rtol_scale, what):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = rtol_scale * max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=what)


# ------------------------------------------------------------------ batch norm


def _jax_bn_steps(batches, init=None):
    bn = jax_nasnet._DebiasedBatchNorm()
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(batches[0]), True)
    if init is not None:
        variables = {**variables, "batch_stats": init}
    out = None
    for batch in batches:
        out, updates = bn.apply(variables, jnp.asarray(batch), True, mutable=["batch_stats"])
        variables = {**variables, "batch_stats": updates["batch_stats"]}
    evals = bn.apply(variables, jnp.asarray(batches[-1]), False)
    stats = {k: np.asarray(v) for k, v in variables["batch_stats"].items()}
    return np.asarray(out, np.float32), np.asarray(evals, np.float32), stats


def _torch_bn_steps(batches, init=None):
    feat = batches[0].shape[-1]
    bn = torch_nasnet._DebiasedBatchNorm(feat)
    if init is not None:
        bn.load_state_dict({"scale": bn.scale, "bias": bn.bias, **{k: torch.as_tensor(np.asarray(v))
                                                                   for k, v in init.items()}})
    out = None
    for batch in batches:
        train = torch_nasnet._Train(progress=torch.zeros(()), stats=[])
        out = bn(torch.as_tensor(np.asarray(batch, np.float32)).to(torch.as_tensor(batch).dtype), train)
        torch_nasnet._update_statistics(train.stats)
    with torch.no_grad():
        evals = bn(torch.as_tensor(batches[-1]))
    stats = {k: getattr(bn, k).numpy() for k in ("mean", "var", "count")}
    return out.detach().float().numpy(), evals.float().numpy(), stats


def _bn_case(name):
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "first_update":
        return [(5.0 + 2.0 * rng.randn(32, 4, 4, 3)).astype(np.float32)], None
    if name == "fifty_updates":
        return [(5.0 + 2.0 * rng.randn(16, 2, 2, 3)).astype(np.float32) for _ in range(50)], None
    if name == "oracle_constant_batches":
        return [np.full((8, 2, 2, 1), v, np.float32) for v in (1.0, 3.0, -2.0, 0.5, 4.0)], None
    if name == "momentum_cap":
        init = {"mean": rng.randn(3).astype(np.float32), "var": rng.uniform(0.5, 1.5, 3).astype(np.float32),
                "count": np.asarray(40000.0, np.float32)}
        return [rng.randn(4, 2, 2, 3).astype(np.float32) for _ in range(3)], init
    raise KeyError(name)


@pytest.mark.parametrize("name", ["first_update", "fifty_updates", "oracle_constant_batches", "momentum_cap"])
def test_batch_norm_training_matches_jax(name):
    batches, init = _bn_case(name)
    want_out, want_eval, want_stats = _jax_bn_steps(batches, init)
    got_out, got_eval, got_stats = _torch_bn_steps(batches, init)
    _scaled_close(got_out, want_out, 1e-5, "training output")
    _scaled_close(got_eval, want_eval, 1e-5, "eval output")
    for key in ("mean", "var", "count"):
        _scaled_close(got_stats[key], want_stats[key], 1e-5, key)
    assert float(got_stats["count"]) == float(want_stats["count"]) == (init or {"count": 0})["count"] + len(batches)


def test_batch_norm_momentum_schedule_and_first_update():
    """The first update replaces the statistics outright (momentum 0),
    and the momentum reaches 0.9997 at count 40000."""
    x = np.random.RandomState(0).randn(8, 2, 2, 3).astype(np.float32) * 2 + 5
    _, _, stats = _torch_bn_steps([x])
    np.testing.assert_allclose(stats["mean"], x.mean((0, 1, 2)), rtol=1e-6)
    np.testing.assert_allclose(stats["var"], x.var((0, 1, 2)), rtol=1e-5)
    counts = torch.tensor([0.0, 300.0, 40000.0])
    m = torch.clamp(counts / (counts + torch_nasnet.BN_WARMUP), max=torch_nasnet.BN_MOMENTUM)
    assert float(m[0]) == 0.0 and float(m[1]) < 0.97 and float(m[2]) == np.float32(0.9997)


def test_batch_norm_bf16_input_keeps_f32_statistics():
    x = np.random.RandomState(3).randn(8, 2, 2, 4).astype(np.float32)
    bn = torch_nasnet._DebiasedBatchNorm(4, out_dtype=torch.bfloat16)
    train = torch_nasnet._Train(progress=torch.zeros(()), stats=[])
    y = bn(torch.from_numpy(x).bfloat16(), train)
    torch_nasnet._update_statistics(train.stats)
    assert y.dtype == torch.bfloat16
    assert bn.mean.dtype == bn.var.dtype == torch.float32
    jbn = jax_nasnet._DebiasedBatchNorm(out_dtype=jnp.bfloat16)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.bfloat16), True)
    jy, updates = jbn.apply(variables, jnp.asarray(x, jnp.bfloat16), True, mutable=["batch_stats"])
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(updates["batch_stats"]["mean"]), atol=1e-5)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(updates["batch_stats"]["var"]), atol=1e-5)
    # One bf16 ulp of the output's scale.
    np.testing.assert_allclose(y.float().detach().numpy(), np.asarray(jy, np.float32), atol=2 ** -7 * 4, rtol=0)


def _bf16_ulp(values):
    """One bf16 ulp at each value (8 significant bits)."""
    exponent = np.floor(np.log2(np.maximum(np.abs(values), np.float32(2.0 ** -126))))
    return np.float32(2.0) ** (exponent - 7)


def test_batch_norm_bf16_training_gradient_matches_jax():
    """bf16 in and out, statistics and normalisation in f32, as the JAX
    module: the output within 2 bf16 ulps of each value, the input's
    gradient within one ulp, scale's and bias's within atol 1e-5 x
    max(1, max|ref|) (measured 2, 0 and 5.6e-7; statistics or normalisation
    taken in bf16 put the gradients 99-157 ulps and 5.7e-4 off, and the
    output 1e6 ulps of its smallest values)."""
    rng = np.random.RandomState(4)
    x = (2.0 * rng.randn(32, 3, 3, 16) + 1.0).astype(np.float32)
    cot = rng.randn(32, 3, 3, 16).astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(16)).astype(np.float32)
    bias = (0.1 * rng.randn(16)).astype(np.float32)
    jbn = jax_nasnet._DebiasedBatchNorm(out_dtype=jnp.bfloat16)
    xj = jnp.asarray(x, jnp.bfloat16)
    variables = jbn.init(jax.random.PRNGKey(0), xj, True)

    def loss(params, inputs):
        y, _ = jbn.apply({**variables, "params": params}, inputs, True, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * cot), y

    (_, want), (want_params, want_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, xj)
    bn = torch_nasnet._DebiasedBatchNorm(16, out_dtype=torch.bfloat16)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    y = bn(xt, torch_nasnet._Train(progress=torch.zeros(()), stats=[]))
    assert y.dtype == torch.bfloat16
    d_scale, d_bias, d_x = torch.autograd.grad((y.float() * torch.from_numpy(cot)).sum(), [bn.scale, bn.bias, xt])
    want, want_x = np.asarray(want, np.float32), np.asarray(want_x, np.float32)
    assert np.all(np.abs(y.detach().float().numpy() - want) <= 2 * _bf16_ulp(want))
    assert np.all(np.abs(d_x.float().numpy() - want_x) <= _bf16_ulp(want_x))
    for got, name in ((d_scale, "scale"), (d_bias, "bias")):
        _scaled_close(got.numpy(), np.asarray(want_params[name]), 1e-5, name)


# --------------------------------------------------------- drop-path, dropout


@pytest.mark.parametrize("keep_prob", [0.4, 0.6, 0.93])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_drop_path_matches_jax_given_the_same_draws(keep_prob, dtype):
    x = np.random.RandomState(1).randn(16, 3, 3, 5).astype(np.float32)
    key = jax.random.PRNGKey(7)
    keep = jnp.float32(keep_prob)
    want = jax_nasnet._drop_path(jnp.asarray(x, getattr(jnp, dtype)), keep, key)
    draws = np.array(jax.random.uniform(key, (16, 1, 1, 1), jnp.float32))
    got = torch_nasnet._drop_path(torch.from_numpy(x).to(getattr(torch, dtype)), torch.tensor(keep_prob),
                                  torch.from_numpy(draws.reshape(-1)))
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(want, np.float32)
    dropped = (want == 0).all(axis=(1, 2, 3))
    assert 0 < dropped.sum() < 16 or keep_prob > 0.9
    np.testing.assert_array_equal((got.float().numpy() == 0).all(axis=(1, 2, 3)), dropped)
    atol = 0.0 if dtype == "float32" else 2 ** -7 * float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


def test_drop_path_keep_prob_per_cell_at_each_progress():
    """cell_num and the depth- and progress-scaled keep probability of
    every cell, against the JAX module's formula (nasnet.py:372-381)."""
    cfg = torch_nasnet.NasNetConfig(num_cells=6, num_conv_filters=4, drop_path_keep_prob=0.6,
                                    compute_dtype=torch.float32)
    model = torch_nasnet.NasNetA(cfg, (8, 8, 3))
    total = cfg.num_cells + cfg.num_reduction_layers
    cells = [getattr(model, name) for name in model._cells]
    assert len(cells) == total
    for progress in (0.0, 0.5, 1.0):
        for cell_num, cell in enumerate(cells):
            layer_ratio = (cell_num + 1) / float(total)
            keep = 1.0 - layer_ratio * (1.0 - cfg.drop_path_keep_prob)
            want = 1.0 - jnp.float32(progress) * (1.0 - keep)
            got = cell.keep_prob(torch.tensor(progress))
            assert float(got) == float(want), (progress, cell_num)
        assert float(cells[-1].keep_prob(torch.tensor(progress))) == pytest.approx(1.0 - progress * 0.4, abs=1e-6)


def test_dense_dropout_matches_flax_given_the_same_draws(monkeypatch):
    import flax.linen as flax_nn

    x = np.random.RandomState(2).randn(6, 9).astype(np.float32)
    draws = np.random.RandomState(3).uniform(size=x.shape).astype(np.float32)
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p=0.5, shape=None: jnp.asarray(draws) < p)
    rate = 1.0 - 0.7
    want = flax_nn.Dropout(rate=rate, deterministic=False).apply({}, jnp.asarray(x),
                                                                   rngs={"dropout": jax.random.PRNGKey(0)})
    got = torch_nasnet._dropout(torch.from_numpy(x), 1.0 - rate, torch.from_numpy(draws))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------- forward and gradient vs JAX


def _replay(draws):
    """A stand-in for `nasnet._uniform` that hands out the recorded
    draws in order: a cell's [drop_paths, B] from its branches' [B, 1,
    1, 1] draws, dropout's [B, D] as it was drawn."""
    pending = list(draws)

    def uniform(shape, generator, device):
        shape = tuple(shape)
        if pending and pending[0].shape == shape:
            return torch.from_numpy(pending.pop(0))
        rows = [pending.pop(0).reshape(-1) for _ in range(shape[0])]
        assert all(r.shape == (shape[1],) for r in rows)
        return torch.from_numpy(np.stack(rows))

    uniform.pending = pending
    return uniform


def _port_forward(recorded, dtype_name, monkeypatch, batch=golden.BATCH, net=golden.FORWARD):
    """The port's training forward and gradient on a recorded case."""
    draws = [recorded[k] for k in sorted(k for k in recorded if k.startswith("draws/"))]
    images, c1, c2, state = golden.forward_inputs(batch, net)
    model = golden.forward_model(dtype_name, net)
    model.load_state_dict(convert.convert_variables(flax_tree(state)), strict=True)
    replay = _replay(draws)
    monkeypatch.setattr(torch_nasnet, "_uniform", replay)
    logits, aux, pooled = model(torch.from_numpy(images), training=True)
    value = torch.sum(logits * torch.from_numpy(c1)) + torch.sum(aux * torch.from_numpy(c2))
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(value, params)))
    assert not replay.pending
    return dict(value=value, logits=logits, aux_logits=aux, pooled=pooled), grads, model


def _recorded_grads(recorded):
    return {k: v.numpy() for k, v in convert.convert_variables(
        {"params": unflatten({k[len("grad/"):]: v for k, v in recorded.items() if k.startswith("grad/")})},
        ("params",)).items()}


def _check_buffers(recorded, model, tol):
    """The updated statistics, `count` and schedule step."""
    mutated = convert.convert_variables(
        unflatten({k[len("mutated/"):]: v for k, v in recorded.items() if k.startswith("mutated/")}),
        ("batch_stats", "schedule"),
    )
    state = model.state_dict()
    assert float(state["step"]) == golden.FORWARD_START_STEP + 1 == float(mutated["step"])
    for key, want in mutated.items():
        _scaled_close(state[key].numpy(), want.numpy(), tol, key)
    assert {float(v) for k, v in state.items() if k.endswith(".count")} == {2.0}


def _check_f32(recorded, outs, grads, model):
    """f32 against JAX: every output, gradient and buffer within atol
    1e-4 x max(1, max|ref|) per tensor."""
    for key in ("logits", "aux_logits", "pooled"):
        assert outs[key].dtype == torch.float32
        _scaled_close(outs[key].detach().numpy(), recorded[key], 1e-4, key)
    want_grads = _recorded_grads(recorded)
    assert sorted(want_grads) == sorted(grads)
    for name, grad in grads.items():
        _scaled_close(grad.numpy(), want_grads[name], 1e-4, "d " + name)
    _check_buffers(recorded, model, 1e-4)


@pytest.mark.parametrize("dtype_name", golden.DTYPES)
def test_training_forward_and_gradient_match_jax(dtype_name, monkeypatch):
    recorded = golden.load("forward/%s" % dtype_name)
    outs, grads, model = _port_forward(recorded, dtype_name, monkeypatch)
    if dtype_name == "float32":
        _check_f32(recorded, outs, grads, model)
        return
    # bf16: how far rounding moves the JAX package's own results (its
    # bf16 run against its f32 run on the same inputs and draws).
    jax_f32 = golden.load("forward/float32")
    for key in ("logits", "aux_logits", "pooled"):
        assert outs[key].dtype == torch.float32
        got = outs[key].detach().numpy()
        rounding = float(np.abs(recorded[key] - jax_f32[key]).max())
        assert float(np.abs(got - recorded[key]).max()) <= 2 * rounding, (key, rounding)
        if key != "aux_logits":
            np.testing.assert_allclose(got, recorded[key], atol=0.1, rtol=0, err_msg=key)
    want_grads = _recorded_grads(recorded)
    assert sorted(want_grads) == sorted(grads)
    names = sorted(grads)
    got = np.concatenate([grads[n].float().numpy().ravel() for n in names])
    want = np.concatenate([want_grads[n].ravel() for n in names])
    jax_f32_grads = _recorded_grads(jax_f32)
    rounding = np.linalg.norm(want - np.concatenate([jax_f32_grads[n].ravel() for n in names]))
    assert np.linalg.norm(got - want) <= 2 * rounding
    _check_buffers(recorded, model, 0.1)


@pytest.mark.parametrize("dtype_name", golden.DTYPES)
def test_training_forward_and_gradient_match_jax_at_batch_32(dtype_name, monkeypatch):
    """Batch 32, where the aux head's batch norms see 32 values a channel
    (4 at batch 4). f32 as at batch 4. bf16: logits, aux logits and
    pooled features within atol 0.1 of JAX's bf16 (ROADMAP §C's bound
    for the JAX CPU path's depthwise rounding; measured 0.026, 0.065,
    0.039). Each parameter's bf16 gradient g: |g - f| <= 4 x max(|j -
    f|, 0.01 |f|) in norm, where f and j are JAX's f32 and bf16
    gradients of that tensor, so the port's bf16 gradient is within four
    times the distance JAX's own bf16 gradient is from f32 (measured up
    to 3.07; |j - f| itself reaches 0.60 |f|, as batch norm's backward
    subtracts nearly equal terms)."""
    recorded = golden.load("forward_b32/%s" % dtype_name)
    outs, grads, model = _port_forward(recorded, dtype_name, monkeypatch, batch=golden.FORWARD_BATCHES["forward_b32"])
    if dtype_name == "float32":
        _check_f32(recorded, outs, grads, model)
        return
    for key in ("logits", "aux_logits", "pooled"):
        assert outs[key].dtype == torch.float32
        np.testing.assert_allclose(outs[key].detach().numpy(), recorded[key], atol=0.1, rtol=0, err_msg=key)
    want_grads = _recorded_grads(recorded)
    f32_grads = _recorded_grads(golden.load("forward_b32/float32"))
    assert sorted(want_grads) == sorted(grads)
    for name, grad in grads.items():
        f = f32_grads[name]
        port_gap = np.linalg.norm(grad.float().numpy() - f)
        jax_gap = max(np.linalg.norm(want_grads[name] - f), 0.01 * np.linalg.norm(f))
        assert port_gap <= 4 * jax_gap, (name, port_gap / jax_gap)
    _check_buffers(recorded, model, 0.1)


def test_training_forward_matches_live_jax(monkeypatch):
    """The JAX package run live (not recorded) on a 2-cell NASNet-A with
    the aux head, drop-path and dropout, f32, batch 4: the port's
    outputs, gradients and buffers as in the recorded f32 case."""
    recorded = golden.jax_forward("float32", golden.BATCH, golden.LIVE)
    outs, grads, model = _port_forward(recorded, "float32", monkeypatch, net=golden.LIVE)
    assert outs["aux_logits"] is not None
    _check_f32(recorded, outs, grads, model)


def test_golden_inputs_are_current():
    """The recorded results were recorded on the inputs the tests make
    now: inputs that change without a new recording fail here."""
    with np.load(golden.PATH) as data:
        np.testing.assert_array_equal(golden.inputs_digest(), data["inputs_sha256"])


# ----------------------------------------------------------------------- remat


def test_remat_keeps_outputs_gradients_and_buffers():
    cfg = dict(num_cells=3, num_conv_filters=4, drop_path_keep_prob=0.6, dense_dropout_keep_prob=0.8,
               total_training_steps=10, compute_dtype=torch.float32, use_pallas_sep_conv=True)
    images = torch.from_numpy(np.random.RandomState(0).randn(4, 10, 10, 3).astype(np.float32))
    results = []
    for remat in (False, True):
        model = torch_nasnet.NasNetA(torch_nasnet.NasNetConfig(**cfg, remat=remat), (10, 10, 3))
        model.load_state_dict({k: torch.from_numpy(v) for k, v in port_numpy_state(
            model.state_dict(), seed=5, trained_stats=True).items()})
        model.step.fill_(4.0)
        generator = torch.Generator().manual_seed(9)
        outs = []
        for _ in range(2):
            logits, aux, _ = model(images, training=True, generator=generator)
            loss = (logits ** 2).sum() + (aux ** 2).sum()
            names, params = zip(*model.named_parameters())
            grads = torch.autograd.grad(loss, params)
            outs.append((logits.detach(), aux.detach(), dict(zip(names, grads))))
        results.append((outs, {k: v.clone() for k, v in model.state_dict().items()}))
    (plain, plain_state), (rematted, remat_state) = results
    for (l0, a0, g0), (l1, a1, g1) in zip(plain, rematted):
        assert torch.equal(l0, l1) and torch.equal(a0, a1)
        assert sorted(g0) == sorted(g1)
        for name in g0:
            assert torch.equal(g0[name], g1[name]), name
    for key in plain_state:
        assert torch.equal(plain_state[key], remat_state[key]), key
    assert float(remat_state["step"]) == 6.0
    assert {float(v) for k, v in remat_state.items() if k.endswith(".count")} == {3.0}


def test_aux_head_in_training_only():
    cfg = torch_nasnet.NasNetConfig(num_cells=3, num_conv_filters=4, compute_dtype=torch.float32)
    model = torch_nasnet.NasNetA(cfg, (10, 10, 3))
    torch_nasnet.init_parameters(model, torch.Generator().manual_seed(0))
    images = torch.randn(2, 10, 10, 3)
    with torch.no_grad():
        _, aux, _ = model(images)
        assert aux is None
        _, aux, _ = model(images, training=True)
    assert aux.shape == (2, 10)
    small = torch_nasnet.NasNetA(cfg, (8, 8, 3))
    assert not hasattr(small, "aux_head")


# ------------------------------------------------------------------- convert


def test_schedule_and_statistics_convert_both_ways():
    model = golden.forward_model("float32")
    state = port_numpy_state(model.state_dict(), seed=3, trained_stats=True)
    state["step"] = np.asarray(7.0, np.float32)
    tree = flax_tree(state)
    assert sorted(tree) == ["batch_stats", "params", "schedule"]
    assert tree["schedule"]["step"].shape == ()
    back = convert.convert_variables(tree)
    assert sorted(back) == sorted(state)
    for key, value in state.items():
        np.testing.assert_array_equal(back[key].numpy(), value, err_msg=key)
    model.load_state_dict(back, strict=True)
    assert float(model.step) == 7.0
    only_params = convert.convert_variables(tree, ("params",))
    assert not any(k.endswith((".mean", ".var", ".count")) or k == "step" for k in only_params)


def test_recorded_forward_covers_every_drop_path():
    """The recorded draws: one [B, 1, 1, 1] per dropped branch of each
    cell, then dense dropout's [B, D]."""
    recorded = golden.load("forward/float32")
    draws = [recorded[k] for k in sorted(k for k in recorded if k.startswith("draws/"))]
    model = golden.forward_model("float32")
    branches = sum(getattr(model, name).drop_paths for name in model._cells)
    assert len(draws) == branches + 1
    assert all(d.shape == (golden.BATCH, 1, 1, 1) for d in draws[:-1])
    assert draws[-1].shape == (golden.BATCH, model.logits.weight.shape[1])


@pytest.mark.slow
def test_golden_file_is_current():
    """RUN_SLOW (about 10 minutes on the CPU): the JAX package, run again
    on the recorded inputs, gives the recorded results, to atol 1e-5 x
    max(1, max|ref|)."""
    fresh = golden.record()
    with np.load(golden.PATH) as data:
        assert sorted(data.files) == sorted(fresh)
        for key in data.files:
            _scaled_close(fresh[key], data[key], 1e-5, key)
