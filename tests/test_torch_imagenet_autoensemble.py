"""The port's ImageNet AutoEnsemble workload
(`research/imagenet_autoensemble/`) against the JAX package's.

- Copies of the three provider tests of tests/test_imagenet_pipeline.py
  (the folder provider on a tiny JPEG tree written with PIL, its missing-
  tree error, the synthetic provider), and the synthetic provider's
  batches equal to the JAX one's.
- A mirror of test_candidate_pool_full_size_structure: ResNet-50 +
  EfficientNet-B0 at 224 (on the meta device), parameter counts the
  published ones and the Flax modules' exactly.
- The trainer's flags and defaults are the JAX trainer's (read from its
  source: importing it would define absl flags that collide with the
  improve_nas trainer's); a tiny run on the CPU (32 x 32 images,
  ResNet-18 width 8 + B0) has finite metrics, under replication and
  under `--placement=round_robin` (a `RoundRobinStrategy` on the CPU,
  every file of the search written).
- The optimizers against optax over 10 steps at 1e-6: `optax.sgd(lr,
  momentum=0.9)` and `optax.rmsprop(lr, decay=0.9, eps=1e-3,
  initial_scale=1.0, momentum=0.9)`, each under `clip_by_global_norm`,
  and EfficientNetBuilder's default `optax.rmsprop(0.016, decay=0.9,
  momentum=0.9)`.
- Five training steps of each candidate (ResNet-50 at width 4 and B0,
  32 x 32, f32) under the trainer's recipes at their defaults, from
  Flax's own initialisation, against the JAX candidates within JAX's
  own spread under a 1e-7 move of its initial variables.
"""

import ast
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adanet_tpu_torch.research.imagenet_autoensemble import imagenet_data, trainer
from adanet_tpu_torch.research.improve_nas import optimizer

from test_imagenet_pipeline import _write_jpeg_archive
from torch_port_common import one_torch_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)


def test_imagenet_provider_parses_folder_archive(tmp_path):
    class_names = _write_jpeg_archive(str(tmp_path))
    provider = imagenet_data.Provider(str(tmp_path), batch_size=4, image_size=32, seed=3)
    assert provider.num_classes == 3
    assert provider.class_names == sorted(class_names)

    # Train: 12 images at batch 4 -> 3 batches, augmented + standardized.
    batches = list(provider.get_input_fn("train")())
    assert len(batches) == 3
    for features, labels in batches:
        assert features["image"].shape == (4, 32, 32, 3)
        assert features["image"].dtype == np.float32
        assert labels.shape == (4,)
        assert labels.min() >= 0 and labels.max() < 3

    # Eval: deterministic center-crop path off the val/ split.
    eval_a = list(provider.get_input_fn("val")())
    eval_b = list(provider.get_input_fn("val", shuffle=False)())
    assert len(eval_a) == 1  # 6 val images at batch 4: remainder dropped
    np.testing.assert_array_equal(eval_a[0][0]["image"], eval_b[0][0]["image"])

    # Train augmentation re-randomizes per epoch.
    fn = provider.get_input_fn("train")
    epoch0 = next(iter(fn()))[0]["image"]
    epoch1 = next(iter(fn()))[0]["image"]
    assert not np.array_equal(epoch0, epoch1)


def test_imagenet_provider_missing_tree_errors(tmp_path):
    with pytest.raises(FileNotFoundError, match="train"):
        imagenet_data.Provider(str(tmp_path))


def test_synthetic_provider_is_deterministic_and_learnable_shaped():
    p1 = imagenet_data.SyntheticProvider(num_classes=4, num_examples=64, batch_size=16, image_size=32, seed=9)
    p2 = imagenet_data.SyntheticProvider(num_classes=4, num_examples=64, batch_size=16, image_size=32, seed=9)
    a = next(iter(p1.get_input_fn("train")()))
    b = next(iter(p2.get_input_fn("train")()))
    np.testing.assert_array_equal(a[0]["image"], b[0]["image"])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[0]["image"].shape == (16, 32, 32, 3)
    # Class-conditional means are separated (the learnable signal).
    images, labels = p1._data["train"]
    means = np.stack([images[labels == c].mean(axis=(0, 1, 2)) for c in range(4)])
    assert np.abs(means[:, None, :] - means[None, :, :]).sum() > 0.5


def test_providers_match_jax(tmp_path):
    from research.imagenet_autoensemble import imagenet_data as jax_data

    got = imagenet_data.SyntheticProvider(num_classes=8, num_examples=48, batch_size=16, image_size=24, seed=5)
    want = jax_data.SyntheticProvider(num_classes=8, num_examples=48, batch_size=16, image_size=24, seed=5)
    _write_jpeg_archive(str(tmp_path))
    pairs = [(got, want), (imagenet_data.Provider(str(tmp_path), batch_size=4, image_size=32, seed=3),
                           jax_data.Provider(str(tmp_path), batch_size=4, image_size=32, seed=3))]
    for port, ref in pairs:
        for partition in ("train", "test" if port is got else "val"):
            for _ in range(2):
                g, w = list(port.get_input_fn(partition)()), list(ref.get_input_fn(partition)())
                assert len(g) == len(w) > 0
                for (gf, gl), (wf, wl) in zip(g, w):
                    np.testing.assert_array_equal(gf["image"], wf["image"])
                    np.testing.assert_array_equal(gl, wl)


def _jax_flag_defaults():
    """{name: default} of the JAX trainer's `flags.DEFINE_*` calls, from
    its source."""
    tree = ast.parse(open(os.path.join(REPO, "research", "imagenet_autoensemble", "trainer.py")).read())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr.startswith("DEFINE_")):
            out[node.args[0].value] = ast.literal_eval(node.args[1])
    return out


def test_trainer_flags_are_the_jax_trainers():
    defaults = _jax_flag_defaults()
    ours = vars(trainer.parse_args([]))
    assert ours.pop("device") == "cuda"
    # A temporary directory instead of a fixed one under /tmp.
    assert ours.pop("model_dir") == "" and defaults.pop("model_dir") == "/tmp/imagenet_autoensemble"
    assert ours == defaults
    assert trainer.parse_args(["--learn_mixture_weights"]).learn_mixture_weights is True


def test_candidate_pool_full_size_structure():
    """ResNet-50 + EfficientNet-B0 at 224: published parameter counts,
    and the Flax modules' exactly."""
    from adanet_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
    from adanet_tpu.models.resnet import ResNet as JaxResNet

    flags = trainer.parse_args(["--image_size=224"])
    with torch.device("meta"):
        pool = trainer.candidate_pool(flags, 1000, 224)
    assert set(pool) == {"resnet50", "efficientnet_b0"}
    counts = {name: sum(p.numel() for p in sub.module.parameters()) for name, sub in pool.items()}
    assert 25.0e6 < counts["resnet50"] < 26.5e6, counts
    assert 4.8e6 < counts["efficientnet_b0"] < 5.8e6, counts
    assert not pool["resnet50"].module.small_inputs
    for name, module in (("resnet50", JaxResNet(logits_dimension=1000, depth=50)),
                         ("efficientnet_b0", JaxEfficientNet(logits_dimension=1000))):
        shapes = jax.eval_shape(lambda r, x, m=module: m.init(r, x, training=False),
                                {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                                jnp.zeros((1, 224, 224, 3), jnp.float32))
        assert counts[name] == sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes["params"]))
    small = trainer.candidate_pool(trainer.parse_args(["--resnet_depth=18"]), 8, 32)
    assert set(small) == {"resnet18", "efficientnet_b0"} and small["resnet18"].module.small_inputs
    with pytest.raises(ValueError, match="Unknown candidate"):
        trainer.candidate_pool(trainer.parse_args(["--candidates=vgg"]), 8, 32)


def test_round_robin_runs_tiny_on_the_cpu(tmp_path, capsys):
    from adanet_tpu_torch.distributed import RoundRobinStrategy

    flags = trainer.parse_args(["--placement=round_robin", "--image_size=32", "--resnet_depth=18",
                                "--resnet_width=8", "--batch_size=8", "--device=cpu"])
    provider = imagenet_data.SyntheticProvider(num_classes=8, num_examples=32, batch_size=8, image_size=32)
    strategy = trainer.build_estimator(flags, provider, str(tmp_path / "m"))._placement_strategy
    assert isinstance(strategy, RoundRobinStrategy) and strategy.devices == [torch.device("cpu")]
    argv = ["--dataset=fake", "--image_size=32", "--resnet_depth=18", "--resnet_width=8", "--boosting_iterations=2",
            "--train_steps=4", "--batch_size=16", "--device=cpu", "--placement=round_robin",
            "--model_dir", str(tmp_path / "rr")]
    assert trainer.main(argv) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["global_step"] == 4
    assert np.isfinite(metrics["loss"]) and 0.0 <= metrics["accuracy"] <= 1.0
    # The ensemble group reads the members in eval mode, on batch-norm
    # running statistics two steps old, so either iteration's ensemble
    # may win here.
    assert metrics["best_ensemble"].startswith(("t0_", "t1_"))
    for name in ("architecture-0.json", "architecture-1.json", "frozen-0.pt", "frozen-1.pt", "checkpoint.json",
                 "replay.json", "candidate-metrics-1.json"):
        assert os.path.exists(tmp_path / "rr" / name), name


def test_trainer_runs_tiny_on_the_cpu(tmp_path, capsys):
    argv = ["--dataset=fake", "--image_size=32", "--resnet_depth=18", "--resnet_width=8", "--boosting_iterations=2",
            "--train_steps=4", "--batch_size=16", "--device=cpu", "--model_dir", str(tmp_path)]
    assert trainer.main(argv) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["global_step"] == 4
    assert np.isfinite(metrics["loss"]) and 0.0 <= metrics["accuracy"] <= 1.0
    assert metrics["best_ensemble"].startswith("t1_")
    for t in (0, 1):
        assert os.path.exists(tmp_path / ("architecture-%d.json" % t))


@pytest.mark.parametrize("recipe", ["sgd_momentum", "rmsprop_published", "rmsprop_builder_default"])
@pytest.mark.parametrize("clip", [0.0, 5.0])
def test_optimizers_match_optax(recipe, clip):
    rng = np.random.RandomState(0)
    shapes = [(8, 4), (4,), (3, 3, 2, 5)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    if recipe == "sgd_momentum":
        rule, want_tx = optimizer.Rule("momentum", optimizer.constant_schedule(0.1)), optax.sgd(0.1, momentum=0.9)
    elif recipe == "rmsprop_published":
        rule = optimizer.rmsprop(0.016, eps=1e-3, initial_scale=1.0, momentum=0.9)
        want_tx = optax.rmsprop(0.016, decay=0.9, eps=1e-3, initial_scale=1.0, momentum=0.9)
    else:
        rule, want_tx = optimizer.rmsprop(0.016, momentum=0.9), optax.rmsprop(0.016, decay=0.9, momentum=0.9)
    if clip > 0:
        want_tx = optax.chain(optax.clip_by_global_norm(clip), want_tx)
    got = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    chain = optimizer.Chain(got, rule, clip_norm=clip)
    want = [jnp.asarray(p) for p in params]
    state = want_tx.init(want)
    clipped = 0
    for step in range(10):
        # Gradient norms around the clip, on both sides of it.
        grads = [(rng.randn(*s) * (0.3 + step % 3)).astype(np.float32) for s in shapes]
        clipped += float(np.sqrt(sum(float((g * g).sum()) for g in grads))) >= 5.0
        for p, g in zip(got, grads):
            p.grad = torch.from_numpy(g)
        chain.step()
        updates, state = want_tx.update([jnp.asarray(g) for g in grads], state, want)
        want = optax.apply_updates(want, updates)
        for p, w in zip(got, want):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=0, atol=1e-6)
    assert clipped > 0 and int(chain.param_groups[0]["count"]) == 10


def _jax_candidate(family):
    """The JAX trainer's candidate (research/imagenet_autoensemble/
    trainer.py:111-166) at 32 x 32 (small inputs), f32, ResNet-50 at width
    4: its module and its optimizer under `clip_by_global_norm(5)`."""
    from adanet_tpu.models import efficientnet as jax_efficientnet
    from adanet_tpu.models import resnet as jax_resnet

    if family == "resnet50":
        module = jax_resnet.ResNet(logits_dimension=8, depth=50, width=4, small_inputs=True, compute_dtype=jnp.float32)
        tx = optax.sgd(0.1, momentum=0.9)
    else:
        module = jax_efficientnet.EfficientNet(logits_dimension=8, small_inputs=True, compute_dtype=jnp.float32)
        tx = optax.rmsprop(0.016, decay=0.9, eps=1e-3, initial_scale=1.0, momentum=0.9)
    return module, optax.chain(optax.clip_by_global_norm(5.0), tx)


@pytest.mark.parametrize("family", ["resnet50", "efficientnet_b0"])
def test_candidate_training_follows_jax(family, monkeypatch):
    """Five training steps of each candidate under the trainer's own
    recipe at its defaults (the port's `candidate_pool` optimizers:
    sgd 0.1 with momentum, and the published rmsprop, each clipped at 5),
    from Flax's own initialisation carried across by `utils.convert`, on
    the synthetic provider's batches of 8 (f32, EfficientNet's stochastic
    depth fed the same draws each step). Every step's loss within 5 x the
    largest move of JAX's own losses when its initial variables move by
    a relative 1e-7 (seeds 5, 11, 17): training-mode ResNet-50 at this
    learning rate and batch parts from itself by tenths of a unit of loss
    within three steps, so that move, not a fixed tolerance, bounds the
    port."""
    from adanet_tpu.models import efficientnet as jax_efficientnet

    from adanet_tpu_torch.models import efficientnet, resnet
    from adanet_tpu_torch.utils.convert import convert_efficientnet, convert_resnet

    steps, batch = 5, 8
    flags = trainer.parse_args(["--image_size=32", "--resnet_width=4"])
    pool = trainer.candidate_pool(flags, 8, 32)
    provider = imagenet_data.SyntheticProvider(num_classes=8, num_examples=steps * batch, batch_size=batch,
                                               image_size=32)
    batches = list(provider.get_input_fn("train")())
    jax_module, tx = _jax_candidate(family)
    if family == "resnet50":
        module = resnet.ResNet(logits_dimension=8, depth=50, width=4, small_inputs=True, compute_dtype=torch.float32)
        convert, factory = convert_resnet, pool["resnet50"].optimizer
    else:
        module = efficientnet.EfficientNet(logits_dimension=8, small_inputs=True, compute_dtype=torch.float32)
        convert, factory = convert_efficientnet, pool["efficientnet_b0"].optimizer
    keys = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    variables = jax.tree_util.tree_map(np.asarray, jax_module.init(keys, batches[0][0], training=True))

    # Stochastic depth: the JAX step is traced once, so its draws are
    # constants; the port takes the same ones, block by block, each step.
    rng = np.random.RandomState(0)
    draws, taken = [], []

    def bernoulli(key, p, shape):
        draws.append(rng.rand(shape[0]).astype(np.float32))
        return jnp.asarray(draws[-1]).reshape(shape) < p

    def uniform(shape, generator, device):
        taken.append(draws[len(taken) % len(draws)])
        return torch.from_numpy(taken[-1]).to(device)

    monkeypatch.setattr(jax_efficientnet.jax.random, "bernoulli", bernoulli)
    monkeypatch.setattr(efficientnet, "_uniform", uniform)

    def loss_fn(params, stats, x, y):
        out, mutated = jax_module.apply({"params": params, "batch_stats": stats}, {"image": x}, training=True,
                                        rngs={"dropout": jax.random.PRNGKey(2)}, mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(out.logits, y).mean(), mutated["batch_stats"]

    @jax.jit
    def step(params, stats, state, x, y):
        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, stats, x, y)
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), stats, state, loss

    def jax_losses(start):
        params, stats = start["params"], start["batch_stats"]
        state, losses = tx.init(params), []
        for features, labels in batches:
            params, stats, state, loss = step(params, stats, state, features["image"], labels)
            losses.append(float(loss))
        return np.array(losses)

    want = jax_losses(variables)
    moved = np.zeros(steps)
    for seed in (5, 11, 17):
        r = np.random.RandomState(seed)
        start = jax.tree_util.tree_map(lambda v: (v * (1.0 + 1e-7 * r.randn(*v.shape))).astype(np.float32), variables)
        moved = np.maximum(moved, np.abs(jax_losses(start) - want))

    module.load_state_dict(convert(variables))
    chain = factory(module.parameters())
    got = []
    for features, labels in batches:
        chain.zero_grad()
        logits = module({"image": torch.from_numpy(features["image"])}, training=True).logits
        loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels).long())
        loss.backward()
        chain.step()
        got.append(float(loss.detach()))
    gap = np.abs(np.array(got) - want)
    print("%s: JAX %s, port %s, |port - JAX| %s, JAX's own move %s" % (family, want, got, gap, moved))
    assert np.all(gap <= 5.0 * np.maximum(moved, 1e-6 * np.abs(want))), (gap, moved)
    assert len(taken) == steps * len(draws) and (family == "resnet50") == (not draws)
