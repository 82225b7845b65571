"""The port's ModelFlow (`experimental/`) against the JAX package's.

- Copies of the eleven tests of tests/test_experimental.py (reference:
  adanet/experimental/keras/model_search_test.py), on the CPU, with the
  MLP an `nn.Module` and the optimizers factories; `ParallelScheduler`
  runs three workers over a CPU pool.
- `Model.fit` and `WeightedEnsemble` against the JAX package's from the
  same variables (carried across by `utils.convert.convert_model`):
  losses within 1e-5 x max(1, |value|), and a trainer -> auto-ensemble
  search choosing the same best model in both packages.
- `Model`, `ParallelScheduler` and the port's `drain_callables` raise
  without CUDA unless the CPU is asked for, and a unit runs with its
  device pinned.
"""

import numpy as np
import pytest
import torch
from torch import nn

from adanet_tpu_torch.experimental import (
    AllStrategy,
    AutoEnsemblePhase,
    GrowStrategy,
    InMemoryStorage,
    InputPhase,
    MeanEnsemble,
    MeanEnsembler,
    Model,
    ModelContainer,
    ModelSearch,
    ParallelScheduler,
    RandomKStrategy,
    RepeatPhase,
    SequentialController,
    TrainerPhase,
    TunerPhase,
    WeightedEnsemble,
    WeightedEnsembler,
)

from torch_port_common import one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)

CPU = torch.device("cpu")


class _MLP(nn.Module):
    def __init__(self, hidden: int = 8, in_dim: int = 4):
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim, hidden)
        self.Dense_1 = nn.Linear(hidden, 1)

    def forward(self, features, training: bool = False):
        return self.Dense_1(torch.relu(self.Dense_0(features.float())))


def _mse(logits, labels):
    return torch.mean(torch.square(logits - labels.float()))


def _dataset(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(64, 4).astype(np.float32)
    y = (x.sum(axis=1, keepdims=True) + 0.1 * rng.randn(64, 1)).astype(np.float32)

    def data():
        for s in range(0, 64, 16):
            yield x[s:s + 16], y[s:s + 16]

    return data


def _sgd(lr):
    return lambda params: torch.optim.SGD(params, lr=lr)


def _model(hidden=8, lr=0.05, seed=0):
    return Model(_MLP(hidden), loss_fn=_mse, optimizer=_sgd(lr), seed=seed, device="cpu")


def test_storage_orders_by_score():
    storage = InMemoryStorage()
    storage.save_model(ModelContainer(2.0, "b", [2.0]))
    storage.save_model(ModelContainer(1.0, "a", [1.0]))
    storage.save_model(ModelContainer(3.0, "c", [3.0]))
    assert storage.get_best_models(2) == ["a", "b"]
    assert len(storage.get_models()) == 3


def test_model_fit_reduces_loss():
    model = _model()
    before = model.evaluate(_dataset()())
    model.fit(_dataset()(), epochs=10)
    after = model.evaluate(_dataset()())
    assert after[0] < before[0]


def test_model_search_trainer_then_ensemble():
    """ModelSearch pipeline: input -> train 2 models -> auto-ensemble
    (reference: model_search_test.py)."""
    phases = [
        InputPhase(_dataset(0), _dataset(1)),
        TrainerPhase([_model(8, seed=0), _model(16, seed=1)], epochs=5),
        AutoEnsemblePhase(
            ensemblers=[MeanEnsembler(_mse)],
            ensemble_strategies=[GrowStrategy(), AllStrategy()],
            num_candidates=2,
        ),
    ]
    search = ModelSearch(SequentialController(phases))
    search.run()
    best = list(search.get_best_models(1))
    assert len(best) == 1
    loss = best[0].evaluate(_dataset(1)())[0]
    assert np.isfinite(loss)


def test_tuner_phase_random_search():
    from adanet_tpu_torch.experimental import RandomSearchTuner

    built = []

    def build_model(hparams):
        built.append(dict(hparams))
        return _model(hidden=hparams["hidden"], seed=hparams["seed"])

    tuner = RandomSearchTuner(space={"hidden": [4, 8, 16], "seed": [0, 1, 2, 3]}, max_trials=3)
    phases = [
        InputPhase(_dataset(0), _dataset(1)),
        TunerPhase(build_model=build_model, tuner=tuner, epochs=2),
    ]
    search = ModelSearch(SequentialController(phases))
    search.run()
    assert len(list(search.get_best_models(3))) == 3
    assert len(built) == 3  # built lazily, once per trial
    # Every trial got its score reported back.
    assert all(score is not None for _, score in tuner.trials)
    assert tuner.best_trial()[1] == min(s for _, s in tuner.trials)


def test_tuner_phase_adaptive_mutation():
    """GreedyMutationTuner proposals depend on reported results: after
    the warmup, each trial mutates the best hyperparameters in exactly
    one dimension (the reference's oracle-driven adaptivity,
    keras_tuner_phase.py:29-71)."""
    from adanet_tpu_torch.experimental import GreedyMutationTuner

    tuner = GreedyMutationTuner(space={"hidden": [4, 8, 16], "lr": [0.1, 0.01]}, max_trials=6, warmup_trials=2,
                                seed=3)
    phases = [
        InputPhase(_dataset(0), _dataset(1)),
        TunerPhase(build_model=lambda hp: _model(hidden=hp["hidden"], seed=0), tuner=tuner, epochs=1),
    ]
    ModelSearch(SequentialController(phases)).run()
    trials = tuner.trials
    assert len(trials) == 6 and all(s is not None for _, s in trials)
    # Post-warmup proposals differ from the best-so-far in <= 1 dimension.
    for i in range(2, len(trials)):
        best_before = min((t for t in trials[:i]), key=lambda t: t[1])[0]
        diffs = sum(1 for key in best_before if trials[i][0][key] != best_before[key])
        assert diffs <= 1


def test_repeat_phase():
    phases = [
        InputPhase(_dataset(0), _dataset(1)),
        RepeatPhase([lambda: TrainerPhase([_model(8)], epochs=1)], repetitions=2),
    ]
    search = ModelSearch(SequentialController(phases))
    search.run()
    assert len(list(search.get_best_models(1))) == 1


def test_random_k_strategy():
    groups = RandomKStrategy(k=3, seed=1)(["a", "b"])
    assert len(groups) == 1
    assert len(groups[0]) == 3
    assert set(groups[0]) <= {"a", "b"}


def test_weighted_ensemble_initializes_as_mean_then_improves():
    """WeightedEnsemble (reference: keras/ensemble_model.py:60-87) starts
    exactly at the mean ensemble (1/k weights) and its trained combiner
    must not underperform the mean; submodels stay frozen."""
    submodels = [_model(8, seed=0), _model(16, seed=1)]
    for submodel in submodels:
        submodel.fit(_dataset(0), epochs=5)
        submodel.trainable = False

    mean = MeanEnsemble(submodels, _mse)
    weighted = WeightedEnsemble(submodels, _mse, optimizer=_sgd(0.05))
    # Before training: identical to the mean ensemble.
    np.testing.assert_allclose(weighted.evaluate(_dataset(1)())[0], mean.evaluate(_dataset(1)())[0], rtol=1e-5)

    before_train_loss = weighted.evaluate(_dataset(0)())[0]
    frozen_before = {k: v.clone() for k, v in submodels[0].module.state_dict().items()}
    weighted.fit(_dataset(0), epochs=10)
    # Combiner trained, submodels untouched.
    assert not np.allclose(weighted.mixture_weights.detach().numpy(), [0.5, 0.5])
    for key, value in submodels[0].module.state_dict().items():
        assert torch.equal(value, frozen_before[key]), key
    assert set(dict(weighted.module.named_parameters())) == {"mixture", "bias"}
    # Training the combiner improves (or at worst matches, within SGD
    # noise) its own starting loss — which IS the mean ensemble's.
    assert weighted.evaluate(_dataset(0)())[0] <= before_train_loss * 1.02


def test_weighted_ensemble_over_fresh_composite_submodel():
    """A WeightedEnsemble wrapping a never-fit MeanEnsemble materializes
    the inner model's parameters on first use, and evaluates the same
    twice."""
    inner = _model(8, seed=0)
    weighted = WeightedEnsemble([MeanEnsemble([inner], _mse)], _mse, optimizer=_sgd(0.05))
    first = weighted.evaluate(_dataset(1)())
    second = weighted.evaluate(_dataset(1)())
    np.testing.assert_allclose(first[0], second[0], rtol=1e-6)
    weighted.fit(_dataset(0), epochs=1)


def test_autoensemble_phase_with_weighted_ensembler():
    phases = [
        InputPhase(_dataset(0), _dataset(1)),
        TrainerPhase([_model(8, seed=0), _model(16, seed=1)], epochs=5),
        AutoEnsemblePhase(
            ensemblers=[MeanEnsembler(_mse), WeightedEnsembler(_mse, optimizer=_sgd(0.05))],
            ensemble_strategies=[AllStrategy()],
            num_candidates=2,
        ),
    ]
    search = ModelSearch(SequentialController(phases))
    search.run()
    best = list(search.get_best_models(2))
    assert len(best) == 2
    assert any(isinstance(m, WeightedEnsemble) for m in best)


def test_parallel_scheduler_matches_sequential():
    """The parallel scheduler must produce the same best models as the
    sequential one: barriers preserve phase chaining while units within
    a phase run concurrently (three workers over a CPU pool)."""

    def build_phases():
        return [
            InputPhase(_dataset(0), _dataset(1)),
            TrainerPhase([_model(4, seed=0), _model(8, seed=1), _model(16, seed=2)], epochs=3),
            AutoEnsemblePhase(
                ensemblers=[MeanEnsembler(_mse)],
                ensemble_strategies=[GrowStrategy(), AllStrategy()],
                num_candidates=3,
            ),
        ]

    sequential = ModelSearch(SequentialController(build_phases()))
    sequential.run()
    seq_best = list(sequential.get_best_models(1))[0]

    parallel = ModelSearch(SequentialController(build_phases()),
                           scheduler=ParallelScheduler(num_workers=3, devices=[CPU]))
    parallel.run()
    par_best = list(parallel.get_best_models(1))[0]

    np.testing.assert_allclose(seq_best.evaluate(_dataset(1)())[0], par_best.evaluate(_dataset(1)())[0], rtol=1e-5)


# ---------------------------------------------------------------- parity


def _jax_parts():
    import flax.linen as flax_nn
    import jax.numpy as jnp
    import optax

    from adanet_tpu.experimental import Model as JaxModel

    class JaxMLP(flax_nn.Module):
        hidden: int = 8

        @flax_nn.compact
        def __call__(self, features, training: bool = False):
            x = jnp.asarray(features, jnp.float32)
            x = flax_nn.relu(flax_nn.Dense(self.hidden)(x))
            return flax_nn.Dense(1)(x)

    def mse(logits, labels):
        return jnp.mean(jnp.square(logits - jnp.asarray(labels, jnp.float32)))

    def model(hidden, seed, lr=0.05):
        return JaxModel(JaxMLP(hidden), loss_fn=mse, optimizer=optax.sgd(lr), seed=seed)

    return model, mse, optax


def _pair(hidden, seed):
    """A JAX model initialised from its seed, and the port's model
    started from the same numbers."""
    import jax

    from adanet_tpu_torch.utils.convert import convert_model

    jax_model_fn, _, _ = _jax_parts()
    want = jax_model_fn(hidden, seed)
    want._ensure_initialized(next(_dataset(0)())[0])
    got = _model(hidden, seed=seed)
    convert_model(jax.tree_util.tree_map(np.asarray, dict(want.variables)), got)
    return got, want


def _close(got, want, rel=1e-5):
    for g, w in zip(got, want):
        assert abs(g - w) <= rel * max(1.0, abs(w)), (got, want)


def test_fit_and_weighted_ensemble_match_jax():
    from adanet_tpu.experimental import WeightedEnsemble as JaxWeighted

    _, jax_mse, optax = _jax_parts()
    pairs = [_pair(8, 0), _pair(16, 1)]
    for got, want in pairs:
        _close(got.evaluate(_dataset(1)()), want.evaluate(_dataset(1)()))
        got.fit(_dataset(0), epochs=5)
        want.fit(_dataset(0), epochs=5)
        _close(got.evaluate(_dataset(1)()), want.evaluate(_dataset(1)()))
        got.trainable = want.trainable = False
    got_weighted = WeightedEnsemble([g for g, _ in pairs], _mse, optimizer=_sgd(0.05))
    want_weighted = JaxWeighted([w for _, w in pairs], jax_mse, optimizer=optax.sgd(0.05))
    _close(got_weighted.evaluate(_dataset(1)()), want_weighted.evaluate(_dataset(1)()))
    got_weighted.fit(_dataset(0), epochs=10)
    want_weighted.fit(_dataset(0), epochs=10)
    _close(got_weighted.evaluate(_dataset(1)()), want_weighted.evaluate(_dataset(1)()))
    _close(got_weighted.mixture_weights.detach().tolist(), np.asarray(want_weighted.mixture_weights).tolist())


def test_search_chooses_the_jax_packages_best_model():
    from adanet_tpu import experimental as jax_experimental

    _, jax_mse, optax = _jax_parts()
    pairs = [_pair(4, 0), _pair(8, 1), _pair(16, 2)]

    def run(package, models, mse, ensemblers):
        search = package.ModelSearch(package.SequentialController([
            package.InputPhase(_dataset(0), _dataset(1)),
            package.TrainerPhase(models, epochs=3),
            package.AutoEnsemblePhase(ensemblers=ensemblers,
                                      ensemble_strategies=[package.GrowStrategy(), package.AllStrategy()],
                                      num_candidates=3),
        ]))
        search.run()
        best = list(search.get_best_models(3))
        return [type(m).__name__ for m in best], [m.evaluate(_dataset(1)())[0] for m in best]

    import adanet_tpu_torch.experimental as port

    got_names, got_losses = run(port, [g for g, _ in pairs], _mse,
                                [port.MeanEnsembler(_mse), port.WeightedEnsembler(_mse, optimizer=_sgd(0.05))])
    want_names, want_losses = run(jax_experimental, [w for _, w in pairs], jax_mse,
                                  [jax_experimental.MeanEnsembler(jax_mse),
                                   jax_experimental.WeightedEnsembler(jax_mse, optimizer=optax.sgd(0.05))])
    assert got_names == want_names
    _close(got_losses, want_losses)


def test_cuda_requests_without_cuda_raise(monkeypatch):
    from adanet_tpu_torch.distributed import scheduler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: Model(_MLP()), lambda: ParallelScheduler(),
                 lambda: scheduler.drain_callables([lambda: None], 1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_drain_pins_each_unit_to_its_device(monkeypatch):
    """A unit on a card runs under `torch.cuda.device(d)` of its worker's
    device; on the CPU under no pinning."""
    import contextlib

    from adanet_tpu_torch.distributed import scheduler

    pinned = []

    def cuda_device(device):
        pinned.append(torch.device(device))
        return contextlib.nullcontext()

    monkeypatch.setattr(torch.cuda, "device", cuda_device)
    seen = []
    scheduler.drain_callables([lambda: seen.append(1)] * 3, 1, devices=[torch.device("cuda", 1)])
    assert seen == [1, 1, 1] and pinned == [torch.device("cuda", 1)] * 3
    pinned.clear()
    scheduler.drain_callables([lambda: seen.append(1)], 1, devices=[CPU])
    assert pinned == [] and len(seen) == 4


def test_concurrent_inits_draw_each_models_own_numbers():
    """Stress: twelve workers initialise twelve models at once, with the
    interpreter switching threads every 10 us; each model's parameters
    equal its own seed's sequential init (the seeded global generator is
    taken one initialisation at a time)."""
    import sys

    from adanet_tpu_torch.distributed.scheduler import drain_callables

    models = [_model(16, seed=s) for s in range(12)]
    previous = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        failures = drain_callables([lambda m=m: m._ensure_initialized(None) for m in models], num_workers=12,
                                   devices=[CPU], on_error="isolate")
    finally:
        sys.setswitchinterval(previous)
    assert failures == {}
    for seed, model in enumerate(models):
        twin = _model(16, seed=seed)
        twin._ensure_initialized(None)
        for key, value in twin.module.state_dict().items():
            assert torch.equal(model.module.state_dict()[key], value), (seed, key)
