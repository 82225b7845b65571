"""The port's improve_nas workload against the JAX package's.

- Losses: label-smoothed cross entropy and the distillation loss against
  the JAX functions, and `build_subnetwork_loss` (aux head, NONE,
  ADAPTIVE, BORN_AGAIN) against the JAX builder's (atol 1e-6).
- Optimizers: `fn_with_name` (five rules x two schedules) against optax
  over 6 steps on the same parameters and gradients, past the cosine
  decay's end; `Builder.build_train_optimizer` against the JAX builder's
  optax chain on a tree of conv and Dense kernels, batch-norm scale and
  bias and a Dense bias, with a step under the clip norm and one over it,
  at weight decay 5e-4 and 0.5 (only kernels decayed). atol 1e-6 x
  max(1, |ref|): optax's f32 arithmetic in another order.
- Iteration trajectory: the port's `Iteration` with the improve_nas
  `Builder` against the JAX package's, recorded by
  `torch_nasnet_golden.py`: 2 iterations x 4 steps, for NONE, ADAPTIVE
  and BORN_AGAIN. Per-step losses and mixture weights within atol 1e-4
  x max(1, |value|), the same selection, and the trained subnetwork's
  batch statistics, counts and schedule step (atol 1e-4 x max(1,
  max|ref|)).
- NaN quarantine: a step with a non-finite loss leaves the parameters,
  the batch statistics, `count`, the schedule step and the optimizer's
  count (the cosine position) and slots as they were; the candidate is
  dead after it, as in the JAX step.
- Distillation teachers are combined once a step, on first read.
- Generators: `DynamicGenerator` grows +3 cells and +10 filters from the
  last frozen member (the JAX generator's builders); both refuse cells
  that are not a multiple of 3; the builder's report.
- The trainer CLI runs fake data on the CPU and prints its metrics; its
  flags and defaults are the JAX trainer's.
- RUN_SLOW: the torch copies of `test_nasnet_family_converges` and
  `test_nasnet_search_improves_ensemble` (tests/test_convergence.py), at
  their thresholds.
"""

import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adanet_tpu.core.iteration import TrainLossContext as JaxContext
from adanet_tpu.subnetwork import Subnetwork as JaxSubnetwork
from research.improve_nas.trainer import improve_nas as jax_improve_nas
from research.improve_nas.trainer import optimizer as jax_optimizer

from adanet_tpu_torch.core.heads import MultiClassHead
from adanet_tpu_torch.core.iteration import IterationBuilder, TrainLossContext
from adanet_tpu_torch.ensemble.strategy import GrowStrategy
from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
from adanet_tpu_torch.research.improve_nas import improve_nas, optimizer, trainer
from adanet_tpu_torch.subnetwork.generator import Subnetwork
from adanet_tpu_torch.utils import convert

import torch_nasnet_golden as golden
from torch_port_common import flatten, flax_tree, one_torch_thread, unflatten

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)

CLASSES = 10


def _close(got, want, what, scale=1e-4):
    got, want = float(got), float(want)
    assert abs(got - want) <= scale * max(1.0, abs(want)), "%s: %r vs %r" % (what, got, want)


# ---------------------------------------------------------------------- losses


def _logits(seed, n=8):
    return np.random.RandomState(seed).randn(n, CLASSES).astype(np.float32) * 2


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
def test_smoothed_cross_entropy_matches_jax(label_smoothing):
    logits, labels = _logits(0), np.random.RandomState(1).randint(0, CLASSES, 8).astype(np.int32)
    want = jax_improve_nas._smoothed_softmax_cross_entropy(jnp.asarray(logits), labels, label_smoothing)
    got = improve_nas._smoothed_softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                                      label_smoothing)
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)


def test_distillation_loss_matches_jax():
    student, teacher = _logits(2), _logits(3)
    want = jax_improve_nas._distillation_loss(jnp.asarray(student), jnp.asarray(teacher))
    got = improve_nas._distillation_loss(torch.from_numpy(student), torch.from_numpy(teacher))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)


@pytest.mark.parametrize("mode", ["none", "adaptive", "born_again"])
@pytest.mark.parametrize("aux", [False, True])
def test_build_subnetwork_loss_matches_jax(mode, aux):
    logits, aux_logits, ens, sub = _logits(4), _logits(5), _logits(6), _logits(7)
    labels = np.random.RandomState(8).randint(0, CLASSES, 8).astype(np.int32)
    hparams = dict(knowledge_distillation=mode, use_aux_head=True, label_smoothing=0.1, aux_head_weight=0.4)
    jax_builder = jax_improve_nas.Builder(None, jax_improve_nas.Hparams(
        **dict(hparams, knowledge_distillation=jax_improve_nas.KnowledgeDistillation(mode))))
    builder = improve_nas.Builder(None, improve_nas.Hparams(
        **dict(hparams, knowledge_distillation=improve_nas.KnowledgeDistillation(mode))))
    want = jax_builder.build_subnetwork_loss(
        JaxSubnetwork(last_layer=None, logits=jnp.asarray(logits),
                      extras={"aux_logits": jnp.asarray(aux_logits) if aux else None}),
        labels, None, JaxContext(jnp.asarray(ens), jnp.asarray(sub)),
    )
    got = builder.build_subnetwork_loss(
        Subnetwork(last_layer=None, logits=torch.from_numpy(logits),
                   extras={"aux_logits": torch.from_numpy(aux_logits) if aux else None}),
        torch.from_numpy(labels), None,
        types.SimpleNamespace(previous_ensemble_logits=torch.from_numpy(ens),
                              previous_subnetwork_logits=torch.from_numpy(sub)),
    )
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)
    none = builder.build_subnetwork_loss(
        Subnetwork(last_layer=None, logits=torch.from_numpy(logits), extras={}), torch.from_numpy(labels), None, None)
    assert float(none) == pytest.approx(float(improve_nas._smoothed_softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels), 0.1)))


# ------------------------------------------------------------------ optimizers


def _steps(seed, shapes, n, big=()):
    rng = np.random.RandomState(seed)
    return [{k: (rng.randn(*s) * (40.0 if i in big else 0.3)).astype(np.float32) for k, s in shapes.items()}
            for i in range(n)]


def _run_optax(tx, params, grads):
    state = tx.init(params)
    trace = []
    for g in grads:
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        trace.append(jax.tree_util.tree_map(np.asarray, params))
    return trace


def _run_port(opt, params, grads, to_port):
    trace = []
    for g in grads:
        for key, p in params.items():
            p.grad = torch.from_numpy(to_port(key, g))
        opt.step()
        opt.zero_grad(set_to_none=True)
        trace.append({k: p.detach().numpy().copy() for k, p in params.items()})
    return trace


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
@pytest.mark.parametrize("name", optimizer.RULES)
def test_fn_with_name_matches_optax(name, schedule):
    shapes = {"w": (3, 4), "b": (4,)}
    init = _steps(0, shapes, 1)[0]
    grads = _steps(1, shapes, 6)
    want = _run_optax(jax_optimizer.fn_with_name(name, schedule, cosine_decay_steps=4)(0.1),
                      {k: jnp.asarray(v) for k, v in init.items()}, [{k: jnp.asarray(v) for k, v in g.items()}
                                                                    for g in grads])
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    rule = optimizer.fn_with_name(name, schedule, cosine_decay_steps=4)(0.1)
    got = _run_port(optimizer.Chain(list(params.values()), rule, [False] * len(params)), params, grads, lambda key, g: g[key])
    for step, (g, w) in enumerate(zip(got, want)):
        for key in shapes:
            np.testing.assert_allclose(g[key], w[key], atol=1e-6 * max(1.0, float(np.abs(w[key]).max())),
                                       rtol=0, err_msg="%s %s step %d %s" % (name, schedule, step, key))


def test_fn_with_name_refuses_what_the_jax_one_refuses():
    for args in (("adamw",), ("sgd", "linear"), ("sgd", "cosine")):
        with pytest.raises(ValueError):
            jax_optimizer.fn_with_name(*args)
        with pytest.raises(ValueError):
            optimizer.fn_with_name(*args)


# Flax path -> (port name, Flax shape); kernels are transposed in `convert`.
_TREE = {
    "conv/kernel": ("conv.weight", (3, 3, 2, 4)),
    "bn/scale": ("bn.scale", (4,)),
    "bn/bias": ("bn.bias", (4,)),
    "logits/kernel": ("logits.weight", (4, CLASSES)),
    "logits/bias": ("logits.bias", (CLASSES,)),
}


def _to_port(key, value):
    return convert._leaf(tuple(key.split("/")), value)[1].copy()


@pytest.mark.parametrize("weight_decay", [5e-4, 0.5])
def test_build_train_optimizer_matches_the_jax_chain(weight_decay):
    shapes = {k: s for k, (_, s) in _TREE.items()}
    init = _steps(2, shapes, 1)[0]
    # Step 1 under the clip norm of 5, step 2 far over it.
    grads = _steps(3, shapes, 4, big=(1,))
    norms = [np.sqrt(sum(float((v ** 2).sum()) for v in g.values())) for g in grads]
    assert norms[0] < 5.0 < norms[1]
    kwargs = dict(clip_gradients=5.0, weight_decay=weight_decay, initial_learning_rate=0.05)
    jax_builder = jax_improve_nas.Builder(jax_optimizer.fn_with_name("momentum", "cosine", cosine_decay_steps=3),
                                          jax_improve_nas.Hparams(**kwargs))
    want = _run_optax(jax_builder.build_train_optimizer(), unflatten({k: jnp.asarray(v) for k, v in init.items()}),
                      [unflatten({k: jnp.asarray(v) for k, v in g.items()}) for g in grads])
    builder = improve_nas.Builder(optimizer.fn_with_name("momentum", "cosine", cosine_decay_steps=3),
                                  improve_nas.Hparams(**kwargs))
    params = {k: torch.nn.Parameter(torch.from_numpy(_to_port(k, v))) for k, v in init.items()}
    opt = builder.build_train_optimizer()([(_TREE[k][0], p) for k, p in params.items()])
    assert opt._decayed == [0, 3]  # conv and Dense kernels only
    got = _run_port(opt, params, grads, lambda key, g: _to_port(key, g[key]))
    for step, (g, w) in enumerate(zip(got, want)):
        w = {k: _to_port(k, v) for k, v in flatten(w).items()}
        for key in shapes:
            np.testing.assert_allclose(g[key], w[key], atol=1e-6 * max(1.0, float(np.abs(w[key]).max())),
                                       rtol=0, err_msg="step %d %s" % (step, key))
    assert opt.param_groups[0]["count"] == len(grads)


def test_untrainable_builder_refuses_to_build_an_optimizer():
    with pytest.raises(ValueError, match="optimizer_fn"):
        improve_nas.Builder(None, improve_nas.Hparams()).build_train_optimizer()


# ---------------------------------------------------- the iteration's trajectory


def _port_factory():
    def sgd(params):
        return torch.optim.SGD(params, lr=golden.MIXTURE_LR)

    ensembler = ComplexityRegularizedEnsembler(optimizer=sgd, adanet_lambda=golden.ADANET_LAMBDA,
                                               use_fused_combine=True)
    return IterationBuilder(MultiClassHead(CLASSES), [ensembler], [GrowStrategy()], device="cpu")


def _port_builder(mode, t):
    hparams = improve_nas.Hparams(**golden.TRAJECTORY_HPARAMS, compute_dtype=torch.float32,
                                  knowledge_distillation=improve_nas.KnowledgeDistillation(mode))
    builder = improve_nas.Builder(optimizer.fn_with_name("momentum", "cosine", cosine_decay_steps=golden.COSINE_STEPS),
                                  hparams, num_classes=CLASSES)
    builder.initial_variables = convert.convert_variables(flax_tree(golden.trajectory_state(t)))
    return builder


def _port_iteration(t, mode, previous, factory=None):
    factory = factory or _port_factory()
    batches = golden.trajectory_batches()
    builder = _port_builder(mode, t)
    iteration = factory.build_iteration(t, [builder], previous, input_shape=golden.SHAPE)
    state = iteration.init_state(torch.Generator().manual_seed(t), batches[t * golden.STEPS])
    rows = {}
    for s in range(golden.STEPS):
        state, metrics = iteration.train_step(state, batches[t * golden.STEPS + s])
        row = golden.trajectory_row(metrics, state.ensembles, lambda w: w.detach())
        rows.update({"%d/%s" % (t * golden.STEPS + s, k): v for k, v in row.items()})
    return iteration, state, rows


@functools.lru_cache(maxsize=None)
def _port_first_iteration():
    iteration, state, rows = _port_iteration(0, "none", None)
    best = iteration.best_candidate_index(state)
    rows["best/0"] = best
    frozen = iteration.freeze_candidate(state, iteration.ensemble_specs[best].name, golden.trajectory_batches()[0])
    final = {k: v.numpy() for k, v in state.subnetworks["NasNet_A_3_4"].module.state_dict().items()}
    return rows, frozen, final


def _final_stats(recorded, t):
    prefix = "final/%d/" % t
    return {k: v.numpy() for k, v in convert.convert_variables(
        unflatten({k[len(prefix):]: v for k, v in recorded.items() if k.startswith(prefix)}),
        ("batch_stats", "schedule")).items()}


@pytest.mark.parametrize("mode", golden.MODES)
def test_iteration_trajectory_matches_jax(mode):
    recorded = golden.load("trajectory/%s" % mode)
    first_rows, frozen, first_final = _port_first_iteration()
    iteration, state, rows = _port_iteration(1, mode, frozen)
    rows.update(first_rows)
    rows["best/1"] = iteration.best_candidate_index(state)
    want_rows = {k: v for k, v in recorded.items() if not k.startswith("final/")}
    assert sorted(rows) == sorted(want_rows)
    for key, want in want_rows.items():
        if key.startswith("best/"):
            assert rows[key] == int(want), key
        else:
            _close(rows[key], want, key)
    finals = (first_final, {k: v.numpy() for k, v in state.subnetworks["NasNet_A_3_4"].module.state_dict().items()})
    for t, final in enumerate(finals):
        want = _final_stats(recorded, t)
        assert float(want["nasnet.step"]) == golden.STEPS
        for key, value in want.items():
            scale = 1e-4 * max(1.0, float(np.abs(value).max()))
            np.testing.assert_allclose(final[key], value, atol=scale, rtol=0, err_msg="t%d %s" % (t, key))


def test_distillation_teachers_are_combined_once_on_first_read():
    calls = []

    class Ensembler:
        def build_ensemble(self, params, outs):
            calls.append(torch.is_grad_enabled())
            return types.SimpleNamespace(logits=sum(o.logits for o in outs) * params)

    outs = [types.SimpleNamespace(logits=torch.full((2, 3), float(i + 1))) for i in range(2)]
    context = TrainLossContext(Ensembler(), 0.5, outs)
    assert calls == [] and torch.equal(context.previous_subnetwork_logits, outs[-1].logits)
    assert torch.equal(context.previous_ensemble_logits, torch.full((2, 3), 1.5))
    assert torch.equal(context.previous_ensemble_logits, torch.full((2, 3), 1.5))
    assert calls == [False]


# ------------------------------------------------------------------ quarantine


def test_skipped_step_keeps_parameters_buffers_and_schedule():
    """A NaN batch makes the subnetwork's loss non-finite: its update is
    skipped and the forward's statistics, counts and schedule step are
    put back; the optimizer's count (the cosine position) and momentum
    are untouched; the candidate is dead after it."""
    hparams = dict(golden.TRAJECTORY_HPARAMS, drop_path_keep_prob=0.6)
    builder = improve_nas.Builder(optimizer.fn_with_name("momentum", "cosine", cosine_decay_steps=4),
                                  improve_nas.Hparams(**hparams, compute_dtype=torch.float32), num_classes=CLASSES)
    iteration = _port_factory().build_iteration(0, [builder], None, input_shape=golden.SHAPE)
    batches = golden.trajectory_batches()
    state = iteration.init_state(torch.Generator().manual_seed(0), batches[0])
    state, _ = iteration.train_step(state, batches[0])
    st = state.subnetworks[builder.name]

    def snapshot():
        module = {k: v.clone() for k, v in st.module.state_dict().items()}
        slots = [s["trace"].clone() for s in st.optimizer.state.values()]
        return module, slots, st.optimizer.param_groups[0]["count"]

    before = snapshot()
    assert float(before[0]["nasnet.step"]) == 1.0 and before[2] == 1
    features, labels = batches[1]
    poisoned = ({"image": np.where(np.arange(golden.BATCH)[:, None, None, None] == 0, np.nan,
                                   features["image"]).astype(np.float32)}, labels)
    state, metrics = iteration.train_step(state, poisoned)
    assert not np.isfinite(float(metrics["subnetwork_loss/%s" % builder.name]))
    after = snapshot()
    assert sorted(after[0]) == sorted(before[0])
    for key in before[0]:
        assert torch.equal(after[0][key], before[0][key]), key
    assert all(torch.equal(a, b) for a, b in zip(after[1], before[1]))
    assert after[2] == before[2] == 1
    assert st.dead and st.step == 1
    state, _ = iteration.train_step(state, batches[2])
    assert torch.equal(st.module.state_dict()["nasnet.step"], before[0]["nasnet.step"])
    assert st.optimizer.param_groups[0]["count"] == 1


# ------------------------------------------------------------------ generators


def _previous(num_cells, num_conv_filters):
    sub = types.SimpleNamespace(shared={"num_cells": num_cells, "num_conv_filters": num_conv_filters})
    return types.SimpleNamespace(weighted_subnetworks=[types.SimpleNamespace(subnetwork=sub)])


@pytest.mark.parametrize("previous", [None, (3, 8), (6, 14)])
def test_generators_match_jax(previous):
    prev = _previous(*previous) if previous else None
    for jax_cls, cls in ((jax_improve_nas.Generator, improve_nas.Generator),
                         (jax_improve_nas.DynamicGenerator, improve_nas.DynamicGenerator)):
        want = jax_cls(None, jax_improve_nas.Hparams(num_cells=3, num_conv_filters=8)).generate_candidates(
            prev, 1, [], [])
        got = cls(None, improve_nas.Hparams(num_cells=3, num_conv_filters=8)).generate_candidates(prev, 1, [], [])
        assert [b.name for b in got] == [b.name for b in want]
    if previous:
        cells, filters = previous
        got = improve_nas.DynamicGenerator(None, improve_nas.Hparams()).generate_candidates(prev, 1, [], [])
        assert [b.name for b in got] == ["NasNet_A_%d_%d" % (cells + 3, filters),
                                         "NasNet_A_%d_%d" % (cells, filters + 10)]


def test_generators_refuse_cells_not_a_multiple_of_three():
    for cls in (improve_nas.Generator, improve_nas.DynamicGenerator, jax_improve_nas.Generator,
                jax_improve_nas.DynamicGenerator):
        hparams_cls = jax_improve_nas.Hparams if cls.__module__.startswith("research") else improve_nas.Hparams
        with pytest.raises(ValueError, match="multiple of 3"):
            cls(None, hparams_cls(num_cells=4))


def test_builder_report_matches_jax():
    kd = "adaptive"
    want = jax_improve_nas.Builder(None, jax_improve_nas.Hparams(
        knowledge_distillation=jax_improve_nas.KnowledgeDistillation(kd))).build_subnetwork_report()
    got = improve_nas.Builder(None, improve_nas.Hparams(
        knowledge_distillation=improve_nas.KnowledgeDistillation(kd))).build_subnetwork_report()
    assert got.hparams == want.hparams and got.attributes == want.attributes


# --------------------------------------------------------------------- trainer


def test_trainer_runs_fake_data_on_the_cpu(tmp_path, capsys):
    argv = ["--dataset=fake", "--num_cells=3", "--num_conv_filters=4", "--boosting_iterations=2",
            "--train_steps=8", "--batch_size=16", "--device=cpu", "--model_dir", str(tmp_path)]
    assert trainer.main(argv) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["global_step"] == 8
    assert 0.0 <= metrics["accuracy"] <= 1.0 and np.isfinite(metrics["loss"])
    assert metrics["best_ensemble"].startswith("t1_NasNet_A_3_4")
    for t in (0, 1):
        assert os.path.exists(tmp_path / ("architecture-%d.json" % t))


def test_trainer_flags_are_the_jax_trainers():
    import sys

    from absl import flags as absl_flags

    # The JAX trainer defines its flags in absl's global registry when
    # imported, where they would collide with the same names defined by
    # other trainers that later tests in this process import; they are
    # read, then taken out again with the module.
    module = "research.improve_nas.trainer.trainer"
    try:
        from research.improve_nas.trainer import trainer as jax_trainer  # noqa: F401  (defines the flags)

        own = [flag.name for flag in absl_flags.FLAGS.flags_by_module_dict()[module]]
        defaults = {name: absl_flags.FLAGS[name].default for name in own}
    finally:
        for name in [flag.name for flag in absl_flags.FLAGS.flags_by_module_dict().get(module, [])]:
            delattr(absl_flags.FLAGS, name)
        sys.modules.pop(module, None)

    ours = vars(trainer.parse_args([]))
    assert ours.pop("device") == "cuda"
    # A temporary directory instead of a fixed one under /tmp.
    assert ours.pop("model_dir") == "" and defaults["model_dir"] == "/tmp/improve_nas"
    for name, value in ours.items():
        assert defaults[name] == value, name
    parsed = trainer.parse_args(["--noforce_grow", "--learn_mixture_weights", "--knowledge_distillation=adaptive"])
    assert parsed.force_grow is False and parsed.learn_mixture_weights is True
    assert trainer.parse_args(["--force_grow=false"]).force_grow is False
    # The CIFAR providers are wired in: without the archive, the error
    # names the missing files.
    with pytest.raises(FileNotFoundError, match="data_batch_1"):
        trainer.main(["--dataset=cifar10", "--data_dir=/nonexistent", "--device=cpu"])
    with pytest.raises(ValueError, match="Unknown dataset"):
        trainer.main(["--dataset=svhn", "--device=cpu"])


# ------------------------------------------------------------------ slow gates


def _digits_estimator(tmp_path, generator, steps, iterations):
    from adanet_tpu_torch.core.estimator import Estimator

    def adam(params):
        return torch.optim.Adam(params, lr=1e-3, eps=1e-8)

    return Estimator(
        head=MultiClassHead(CLASSES), subnetwork_generator=generator, max_iteration_steps=steps,
        max_iterations=iterations, ensemblers=[ComplexityRegularizedEnsembler(optimizer=adam)],
        model_dir=str(tmp_path / "model"), log_every_steps=0, device="cpu",
    )


def _gate_hparams():
    return improve_nas.Hparams(num_cells=3, num_conv_filters=8, use_aux_head=False, drop_path_keep_prob=1.0,
                               dense_dropout_keep_prob=1.0, clip_gradients=5.0, weight_decay=1e-4,
                               initial_learning_rate=1e-3)


@pytest.mark.slow
def test_nasnet_family_converges_on_the_port(tmp_path):
    from adanet_tpu_torch.examples.synthetic_digits import image_input_fn, make_dataset
    from adanet_tpu_torch.subnetwork.generator import SimpleGenerator

    xtr, ytr = make_dataset(8192, seed=7)
    xte, yte = make_dataset(2048, seed=8)
    builder = improve_nas.Builder(optimizer.fn_with_name("adam"), _gate_hparams(), seed=0)
    est = _digits_estimator(tmp_path, SimpleGenerator([builder]), 300, 1)
    est.train(image_input_fn(xtr, ytr), max_steps=10**6)
    metrics = est.evaluate(image_input_fn(xte, yte))
    assert metrics["accuracy"] >= 0.88, metrics
    assert metrics["accuracy"] > 0.76


@pytest.mark.slow
def test_nasnet_search_improves_ensemble_on_the_port(tmp_path):
    from adanet_tpu_torch.examples.synthetic_digits import image_input_fn, make_dataset

    xtr, ytr = make_dataset(8192, seed=7)
    xte, yte = make_dataset(2048, seed=8)
    steps = 250
    est = _digits_estimator(tmp_path, improve_nas.DynamicGenerator(optimizer.fn_with_name("adam"), _gate_hparams(),
                                                                   seed=0), steps, 2)
    est.train(image_input_fn(xtr, ytr), max_steps=steps)
    assert est.latest_iteration_number() == 1
    t0 = est.evaluate(image_input_fn(xte, yte))
    est.train(image_input_fn(xtr, ytr), max_steps=10**6)
    assert est.latest_iteration_number() == 2
    t1 = est.evaluate(image_input_fn(xte, yte))
    assert t1["accuracy"] > t0["accuracy"], (t0, t1)
    assert t1["accuracy"] > 0.76
