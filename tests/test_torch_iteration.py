"""The port's iteration engine against the JAX package's.

- `ComplexityRegularizedEnsembler.init_ensemble`: 1/N, zeros, bias, and
  warm start of kept members' weights and bias (equal values).
- `Iteration` trajectories: the simple_dnn search space of both packages
  from the same `initial_variables` (numpy, carried across by
  `utils.convert.convert_simple_dnn`), on the same batches, over 2
  iterations x 25 steps, with the fused combine off and on (JAX's K1 in
  Pallas interpret mode, the port's plain version) and with lambda, a
  bias and warm start: per-step losses and mixture weights within atol
  1e-4 x max(1, |value|), identical best candidate indices, and equal
  architecture JSON.
- A NaN batch: the candidate it reaches is quarantined as in JAX (dead
  flags, step counts, EMAs, selection).
- The zero-debiased EMA, tree utilities and batch utilities; a
  non-finite step leaves the parameters and the optimizer state as they
  were (the JAX step's `tree_where`).
- K1's prepared-weight memo under `torch.optim.Adam` (foreach and
  for-loop): a step's new weights are prepared afresh.
"""

import json
import zlib

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from adanet_tpu.core import candidate as jax_candidate
from adanet_tpu.core.heads import MultiClassHead as JaxHead
from adanet_tpu.core.iteration import IterationBuilder as JaxIterationBuilder
from adanet_tpu.ensemble import ComplexityRegularizedEnsembler as JaxEnsembler
from adanet_tpu.ensemble import GrowStrategy as JaxGrow
from adanet_tpu.examples import simple_dnn as jax_simple_dnn
from adanet_tpu.subnetwork import Builder as JaxBuilder
from adanet_tpu.subnetwork import Subnetwork as JaxSubnetwork
from adanet_tpu.utils import batches as jax_batches

from adanet_tpu_torch.core import candidate
from adanet_tpu_torch.core.heads import MultiClassHead
from adanet_tpu_torch.core.iteration import IterationBuilder
from adanet_tpu_torch.ensemble.strategy import GrowStrategy
from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
from adanet_tpu_torch.examples import simple_dnn
from adanet_tpu_torch.examples.synthetic_digits import input_fn, make_dataset
from adanet_tpu_torch.ops import ensemble_kernels as ek
from adanet_tpu_torch.ops import sepconv_kernels as sk
from adanet_tpu_torch.subnetwork.generator import Builder, Subnetwork
from adanet_tpu_torch.utils import batches, convert, trees

from adanet_tpu_torch.utils.convert import WithInitialVariables, simple_dnn_variables

from torch_port_common import one_torch_thread

STEPS = 25
FEATURES = 256
CLASSES = 10


_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)


def _close(got, want, what):
    got, want = float(got), float(want)
    assert abs(got - want) <= 1e-4 * max(1.0, abs(want)), "%s: %r vs %r" % (what, got, want)


# ------------------------------------------------------------ init_ensemble


def _members(rng, n, last=12):
    return [
        dict(last_layer=rng.randn(4, last).astype(np.float32), logits=rng.randn(4, CLASSES).astype(np.float32),
             complexity=1.0)
        for _ in range(n)
    ]


@pytest.mark.parametrize("kind", ["scalar", "vector", "matrix"])
@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("warm", [False, True])
def test_init_ensemble_matches_jax(kind, use_bias, warm):
    rng = np.random.RandomState(zlib.crc32(repr((kind, use_bias, warm)).encode()))
    members = _members(rng, 3)
    shape = {"scalar": (), "vector": (CLASSES,), "matrix": (12, CLASSES)}[kind]
    previous = None
    if warm:
        # Members 0 and 2 kept from the previous ensemble, 1 new.
        previous = {"weights": [np.asarray(rng.randn(*shape), np.float32), None,
                                np.asarray(rng.randn(*shape), np.float32)],
                    "bias": rng.randn(CLASSES).astype(np.float32)}
    kwargs = dict(mixture_weight_type=kind, use_bias=use_bias, warm_start_mixture_weights=warm)
    want = JaxEnsembler(**kwargs).init_ensemble(
        jax.random.PRNGKey(0), [JaxSubnetwork(**{k: jnp.asarray(v) if k != "complexity" else v for k, v in m.items()})
                                for m in members],
        previous_params=previous,
    )
    got = ComplexityRegularizedEnsembler(**kwargs).init_ensemble(
        torch.Generator().manual_seed(0),
        [Subnetwork(**{k: torch.from_numpy(v) if k != "complexity" else v for k, v in m.items()}) for m in members],
        previous_params=previous,
    )
    assert sorted(got) == sorted(want)
    assert len(got["weights"]) == len(want["weights"]) == 3
    for g, w in zip(got["weights"], want["weights"]):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if use_bias:
        np.testing.assert_array_equal(got["bias"].numpy(), np.asarray(want["bias"]))


def test_init_ensemble_initializer_and_default_optimizer():
    ensembler = ComplexityRegularizedEnsembler(mixture_weight_type="vector")
    members = [Subnetwork(last_layer=None, logits=torch.zeros(2, CLASSES))] * 4
    params = ensembler.init_ensemble(torch.Generator(), members)
    assert sorted(params) == ["weights"] and len(params["weights"]) == 4
    assert all(torch.equal(w, torch.full((CLASSES,), 0.25)) for w in params["weights"])
    assert ensembler.build_train_optimizer() is None
    assert ensembler.name == "complexity_regularized"


# ------------------------------------------------------- trajectory parity


def _adam_jax():
    return optax.adam(1e-3)


def _adam(params):
    return torch.optim.Adam(params, lr=1e-3, eps=1e-8)


CONFIGS = {
    "unfused": dict(fused=False),
    "fused": dict(fused=True),
    "fused_lambda_bias_warm_sgd": dict(fused=True, adanet_lambda=0.01, use_bias=True, warm=True, sgd=True),
}


def _packages(config):
    fused = config["fused"]
    kwargs = dict(
        adanet_lambda=config.get("adanet_lambda", 0.0),
        use_bias=config.get("use_bias", False),
        warm_start_mixture_weights=config.get("warm", False),
        use_fused_combine=fused,
    )
    if config.get("sgd"):
        jax_opt, opt = optax.sgd(0.05), (lambda params: torch.optim.SGD(params, lr=0.05))
    else:
        jax_opt, opt = _adam_jax(), _adam
    jax_side = dict(
        builder=JaxIterationBuilder(JaxHead(CLASSES), [JaxEnsembler(optimizer=jax_opt, **kwargs)], [JaxGrow()]),
        generator=WithInitialVariables(
            jax_simple_dnn.Generator(optimizer_fn=_adam_jax, layer_size=16, initial_num_layers=1, seed=0),
            FEATURES, CLASSES, convert=lambda v: v,
        ),
    )
    torch_side = dict(
        builder=IterationBuilder(MultiClassHead(CLASSES), [ComplexityRegularizedEnsembler(optimizer=opt, **kwargs)],
                                 [GrowStrategy()], device="cpu"),
        generator=WithInitialVariables(
            simple_dnn.Generator(optimizer_fn=_adam, layer_size=16, initial_num_layers=1, seed=0),
            FEATURES, CLASSES,
        ),
    )
    return jax_side, torch_side


def _batches(n, seed=7, batch_size=32):
    x, y = make_dataset(n * batch_size, seed=seed)
    return list(input_fn(x, y, batch_size)())


def _run(side, batches, is_jax, iterations=2, steps=STEPS):
    """Trains `iterations` x `steps` as the Estimator does; returns the
    per-step metrics and mixture weights, the best indices and the
    architectures' JSON."""
    trace, best, architectures = [], [], []
    previous = None
    for t in range(iterations):
        sample = batches[t * steps]
        builders = side["generator"].generate_candidates(previous, t, [], [])
        if is_jax:
            iteration = side["builder"].build_iteration(t, builders, previous)
            state = iteration.init_state(jax.random.PRNGKey(t), sample)
        else:
            iteration = side["builder"].build_iteration(t, builders, previous, input_shape=(FEATURES,))
            state = iteration.init_state(torch.Generator().manual_seed(t), sample)
        for s in range(steps):
            state, metrics = iteration.train_step(state, batches[t * steps + s])
            row = {k: float(v) for k, v in metrics.items()}
            for name, est in state.ensembles.items():
                for i, w in enumerate(est.params["weights"]):
                    row["weight/%s/%d" % (name, i)] = float(np.asarray(w.detach() if torch.is_tensor(w) else w))
            trace.append(row)
        index = iteration.best_candidate_index(state)
        best.append(index)
        name = iteration.ensemble_specs[index].name
        previous = iteration.freeze_candidate(state, name, sample)
        previous.architecture.add_replay_index(index)
        previous.architecture.set_global_step((t + 1) * steps)
        architectures.append(json.loads(previous.architecture.serialize()))
    return trace, best, architectures, previous


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_iteration_trajectory_matches_jax(config):
    jax_side, torch_side = _packages(CONFIGS[config])
    data = _batches(2 * STEPS)
    want_trace, want_best, want_arch, want_frozen = _run(jax_side, data, True)
    got_trace, got_best, got_arch, got_frozen = _run(torch_side, data, False)
    assert len(got_trace) == len(want_trace) == 2 * STEPS
    for step, (got, want) in enumerate(zip(got_trace, want_trace)):
        assert sorted(got) == sorted(want), step
        for key in want:
            _close(got[key], want[key], "step %d %s" % (step, key))
    assert got_best == want_best
    assert got_arch == want_arch
    assert got_frozen.name == want_frozen.name
    _close(got_frozen.final_ema, want_frozen.final_ema, "final EMA")
    want_params = want_frozen.ensembler_params
    got_params = got_frozen.ensembler_params
    assert sorted(got_params) == sorted(k for k in want_params if want_params[k] is not None)
    if "bias" in want_params:
        np.testing.assert_allclose(got_params["bias"].numpy(), np.asarray(want_params["bias"]), atol=1e-4)
    for g, w in zip(got_frozen.weighted_subnetworks, want_frozen.weighted_subnetworks):
        assert (g.subnetwork.iteration_number, g.subnetwork.name) == (w.subnetwork.iteration_number, w.subnetwork.name)
        assert g.subnetwork.shared == w.subnetwork.shared
        _close(g.subnetwork.complexity, w.subnetwork.complexity, "complexity")
        state = g.subnetwork.module.state_dict()
        for key, value in convert.convert_simple_dnn(jax.device_get(w.subnetwork.params)).items():
            np.testing.assert_allclose(state[key].numpy(), value.numpy(), atol=1e-4, rtol=1e-4, err_msg=key)


def test_eval_step_matches_jax():
    jax_side, torch_side = _packages(CONFIGS["fused"])
    data = _batches(STEPS + 1)
    results = []
    for side, is_jax in ((jax_side, True), (torch_side, False)):
        _, _, _, frozen = _run(side, data, is_jax, iterations=1)
        builders = side["generator"].generate_candidates(frozen, 1, [], [])
        if is_jax:
            iteration = side["builder"].build_iteration(1, builders, frozen)
            state = iteration.init_state(jax.random.PRNGKey(1), data[0])
        else:
            iteration = side["builder"].build_iteration(1, builders, frozen, input_shape=(FEATURES,))
            state = iteration.init_state(torch.Generator().manual_seed(1), data[0])
        results.append(iteration.eval_step(state, data[-1]))
    want, got = results
    assert sorted(got) == sorted(want)
    for name in want:
        assert sorted(got[name]) == sorted(want[name])
        for key in want[name]:
            _close(got[name][key], want[name][key], "%s %s" % (name, key))


# ------------------------------------------------------------------ NaN


class _JaxFragileModule(flax_nn.Module):
    logits_dimension: int

    @flax_nn.compact
    def __call__(self, features, training=False):
        x = jnp.asarray(features["x"], jnp.float32)
        logits = flax_nn.Dense(self.logits_dimension, name="logits")(x) + features["poison"][:, None]
        return JaxSubnetwork(last_layer=x, logits=logits, complexity=1.0)


class _JaxFragile(JaxBuilder):
    """A linear subnetwork that adds the batch's `poison` column to its
    logits: NaN there makes its loss NaN, and no other candidate's."""

    name = "fragile"

    def build_subnetwork(self, logits_dimension, previous_ensemble=None):
        return _JaxFragileModule(logits_dimension)

    def build_train_optimizer(self, previous_ensemble=None):
        return _adam_jax()


class _FragileModule(nn.Module):
    def __init__(self, input_dim, logits_dimension):
        super().__init__()
        self.logits = nn.Linear(input_dim, logits_dimension)

    def forward(self, features, training=False):
        x = features["x"]
        return Subnetwork(last_layer=x, logits=self.logits(x) + features["poison"][:, None], complexity=1.0)


class _Fragile(Builder):
    name = "fragile"

    def build_subnetwork(self, logits_dimension, previous_ensemble=None, *, input_shape):
        return _FragileModule(input_shape[0], logits_dimension)

    def build_train_optimizer(self, previous_ensemble=None):
        return lambda named_parameters: _adam([p for _, p in named_parameters])


def _poisoned_batches(n, at):
    """n batches whose `poison` column is 0, but NaN in one row of batch
    `at`."""
    data = _batches(n)
    for i, (features, _) in enumerate(data):
        features["poison"] = np.zeros(len(features["x"]), np.float32)
        if i == at:
            features["poison"][3] = np.nan
    return data


def test_nan_batch_quarantines_one_candidate_as_in_jax():
    data = _poisoned_batches(12, 5)
    runs = []
    for is_jax in (True, False):
        if is_jax:
            builders = [_JaxFragile(), jax_simple_dnn._DNNBuilder(_adam_jax, 16, 1, False, 0.0, 0)]
            factory = JaxIterationBuilder(JaxHead(CLASSES), [JaxEnsembler(optimizer=_adam_jax())], [JaxGrow()])
        else:
            builders = [_Fragile(), simple_dnn._DNNBuilder(_adam, 16, 1, False, 0.0, 0)]
            factory = IterationBuilder(MultiClassHead(CLASSES), [ComplexityRegularizedEnsembler(optimizer=_adam)],
                                       [GrowStrategy()], device="cpu")
        for builder, layers in zip(builders, (0, 1)):
            seed = zlib.crc32(builder.name.encode())
            flax = simple_dnn_variables(layers, 16, FEATURES, CLASSES, seed)
            builder.initial_variables = flax if is_jax else convert.convert_variables(flax, ("params",))
        if is_jax:
            iteration = factory.build_iteration(0, builders)
            state = iteration.init_state(jax.random.PRNGKey(0), data[0])
        else:
            iteration = factory.build_iteration(0, builders, input_shape=(FEATURES,))
            state = iteration.init_state(torch.Generator().manual_seed(0), data[0])
        losses = []
        for batch in data:
            state, metrics = iteration.train_step(state, batch)
            losses.append({k: float(v) for k, v in metrics.items()})
        subnetworks = {
            name: (int(st.step), bool(st.dead)) for name, st in state.subnetworks.items()
        }
        cands = {name: bool(c.dead) for name, c in state.candidates.items()}
        runs.append((losses, subnetworks, cands, iteration.ema_losses(state), iteration.best_candidate_index(state)))
    (want_losses, want_subs, want_cands, want_emas, want_best), (got_losses, got_subs, got_cands, got_emas, got_best) \
        = runs
    assert want_subs == got_subs == {"fragile": (5, True), "1_layer_dnn": (12, False)}
    assert want_cands == got_cands == {"t0_fragile_grow_complexity_regularized": True,
                                       "t0_1_layer_dnn_grow_complexity_regularized": False}
    assert got_best == want_best == 1
    assert sorted(got_emas) == sorted(want_emas)
    for name, value in want_emas.items():
        if np.isinf(value):
            assert np.isinf(got_emas[name])
        else:
            _close(got_emas[name], value, name)
    for step, (got, want) in enumerate(zip(got_losses, want_losses)):
        for key, value in want.items():
            if np.isfinite(value):
                _close(got[key], value, "step %d %s" % (step, key))
            else:
                assert not np.isfinite(got[key]), (step, key)


# ----------------------------------------------------- EMA, trees, batches


def test_candidate_ema_matches_jax():
    losses = [2.0, 1.5, 1.25, float("nan"), 1.0]
    want = jax_candidate.initial_candidate_state()
    got = candidate.initial_candidate_state()
    for loss in losses:
        want = jax_candidate.update_candidate_state(want, loss, 0.9)
        got = candidate.update_candidate_state(got, torch.tensor(loss), 0.9)
        w, g = float(jax_candidate.debiased_ema(want, 0.9)), float(candidate.debiased_ema(got, 0.9))
        assert (np.isinf(w) and np.isinf(g)) or abs(w - g) <= 1e-6 * abs(w)
        assert bool(got.dead) == bool(want.dead) and int(got.ema_count) == int(want.ema_count)
    seeded = candidate.initial_candidate_state(initial_ema=0.75, decay=0.9)
    np.testing.assert_allclose(float(candidate.debiased_ema(seeded, 0.9)), 0.75, rtol=1e-6)
    assert np.isinf(float(candidate.debiased_ema(candidate.initial_candidate_state(), 0.9)))


def test_tree_finite_and_where():
    """`tree_finite`, and the step's counterpart of the JAX `tree_where`:
    a step whose loss went NaN leaves that subnetwork's parameters and
    Adam state exactly as they were, while the other candidate steps."""
    tree = {"a": [torch.ones(3), torch.zeros(2, 2)], "b": torch.tensor(1), "c": None}
    assert bool(trees.tree_finite(tree))
    assert bool(trees.tree_finite({}))
    bad = {"a": [torch.ones(3), torch.tensor([0.0, float("inf")])]}
    assert not bool(trees.tree_finite(bad))
    assert not bool(trees.tree_finite([torch.tensor(float("nan"))]))

    data = _poisoned_batches(3, 2)
    builders = [_Fragile(), simple_dnn._DNNBuilder(_adam, 16, 1, False, 0.0, 0)]
    factory = IterationBuilder(MultiClassHead(CLASSES), [ComplexityRegularizedEnsembler(optimizer=_adam)],
                               [GrowStrategy()], device="cpu")
    iteration = factory.build_iteration(0, builders, input_shape=(FEATURES,))
    state = iteration.init_state(torch.Generator().manual_seed(0), data[0])

    def snapshot(name):
        st = state.subnetworks[name]
        opt = [{k: v.clone() if torch.is_tensor(v) else v for k, v in s.items()}
               for s in st.optimizer.state.values()]
        return {k: v.clone() for k, v in st.module.state_dict().items()}, opt

    for batch in data[:2]:
        state, _ = iteration.train_step(state, batch)
    before = {name: snapshot(name) for name in ("fragile", "1_layer_dnn")}
    state, metrics = iteration.train_step(state, data[2])
    assert not np.isfinite(float(metrics["subnetwork_loss/fragile"]))
    for name, kept in (("fragile", True), ("1_layer_dnn", False)):
        (params, opt), (params_after, opt_after) = before[name], snapshot(name)
        same = all(torch.equal(params[k], params_after[k]) for k in params) and all(
            torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])) for a, b in zip(opt, opt_after) for k in a)
        assert same == kept, name
    assert state.subnetworks["fragile"].dead and state.subnetworks["fragile"].step == 2


def test_batch_utilities_match_jax():
    rng = np.random.RandomState(0)
    batch = ({"x": rng.randn(5, 3).astype(np.float32), "w": rng.rand(5).astype(np.float32)},
             rng.randint(0, 3, 5).astype(np.int32))
    assert batches.batch_example_count(batch) == jax_batches.batch_example_count(batch) == 5
    assert batches.batch_example_count(batch) == jax_batches.batch_metric_weight(batch)
    moved = batches.to_device(batch, "cpu")
    assert isinstance(moved, tuple) and moved[0]["x"].dtype == torch.float32 and moved[1].dtype == torch.int32
    assert batches.feature_shape(batch[0]["x"]) == (3,)
    assert batches.feature_shape({"image": np.zeros((2, 4, 4, 1))}) == (4, 4, 1)
    with pytest.raises(ValueError):
        batches.feature_shape(batch[0])
    got, want = batches.WeightedMeanAccumulator(), jax_batches.WeightedMeanAccumulator()
    for metrics, n in (({"a": 1.0}, 3), ({"a": 4.0}, 1.5)):
        got.add(metrics, n)
        want.add(metrics, n)
    assert got.means() == want.means() and got.batches == want.batches == 2


# ------------------------------------------------------ K1's weight memo


@pytest.mark.parametrize("foreach", [False, True])
def test_prepared_weights_follow_adam_steps(foreach):
    """K1 reads member weights prepared once per version
    (`sepconv_kernels.prepare_all`). An optimizer step changes them in
    place; the next combine must prepare them again, not reuse the memo
    (on the card it would combine with last step's weights)."""
    weights = [nn.Parameter(torch.tensor(0.5)), nn.Parameter(torch.tensor(0.25))]
    optimizer = torch.optim.Adam(weights, lr=0.1, foreach=foreach)
    first = ek.prepared_weights(weights)
    made = sk.prepare.made
    assert ek.prepared_weights(weights) is first and sk.prepare.made == made  # the memo
    for step in range(3):
        for w in weights:
            w.grad = torch.tensor(1.0)
        optimizer.step()
        fresh = ek.prepared_weights(weights)
        assert fresh is not first and sk.prepare.made == made + step + 1
        torch.testing.assert_close(fresh, torch.stack([w.detach() for w in weights]))
        assert ek.prepared_weights(weights) is fresh
        first = fresh
    logits = [torch.ones(2, 3), torch.full((2, 3), 2.0)]
    with torch.no_grad():
        out = ek.fused_weighted_combine_members(logits, weights, None)
    torch.testing.assert_close(out, weights[0].detach() * logits[0] + weights[1].detach() * logits[1])


def test_initial_variables_must_fit_the_module():
    builder = simple_dnn._DNNBuilder(_adam, 16, 1, False, 0.0, 0)
    builder.initial_variables = convert.convert_simple_dnn(simple_dnn_variables(2, 16, FEATURES, CLASSES, 0))
    factory = IterationBuilder(MultiClassHead(CLASSES), [ComplexityRegularizedEnsembler()], [GrowStrategy()],
                               device="cpu")
    iteration = factory.build_iteration(0, [builder], input_shape=(FEATURES,))
    with pytest.raises(ValueError, match="initial_variables"):
        iteration.init_state(torch.Generator(), _batches(1)[0])


def test_dropout_draws_from_the_iteration_generator():
    """A dropout forward takes the iteration's generator: one seed, one
    trajectory; another seed, another (no global RNG involved)."""

    def losses(seed):
        builder = simple_dnn._DNNBuilder(_adam, 16, 2, False, 0.5, 0)
        factory = IterationBuilder(MultiClassHead(CLASSES), [ComplexityRegularizedEnsembler(optimizer=_adam)],
                                   [GrowStrategy()], device="cpu")
        iteration = factory.build_iteration(0, [builder], input_shape=(FEATURES,))
        assert iteration.subnetwork_specs[0].takes_generator
        state = iteration.init_state(torch.Generator().manual_seed(seed), data[0])
        out = []
        for batch in data:
            state, metrics = iteration.train_step(state, batch)
            out.append(float(metrics["subnetwork_loss/2_layer_dnn"]))
        return out

    data = _batches(4)
    torch.manual_seed(0)
    first = losses(1)
    torch.manual_seed(1)
    assert losses(1) == first
    assert losses(2) != first
    module = simple_dnn._SimpleDNN(FEATURES, CLASSES, 1, 64, 0.5)
    module.init_parameters(torch.Generator().manual_seed(0))
    x = {"x": torch.ones(8, FEATURES)}
    kept = module(x, training=True, generator=torch.Generator().manual_seed(0)).last_layer
    assert torch.equal(module(x, training=False).last_layer * 2.0 * (kept != 0), kept)
