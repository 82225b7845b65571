"""Rules of the PyTorch port that hold for every slice.

- No module of `adanet_tpu_torch/`, and not `chip_smoke.py`, imports jax,
  flax, optax or the JAX package (an AST scan, and an import of every
  module with those blocked).
- Each framework-free module the port copies stays in sync with its
  original: the same lines once import statements are dropped and the
  package name is mapped.
- A CUDA request without CUDA raises; nothing carries on on the CPU.
"""

import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "adanet_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "adanet_tpu"}

#: Port copy -> original, both relative to the repo root.
COPIES = {
    "adanet_tpu_torch/core/architecture.py": "adanet_tpu/core/architecture.py",
    "adanet_tpu_torch/observability/metrics.py": "adanet_tpu/observability/metrics.py",
    "adanet_tpu_torch/observability/spans.py": "adanet_tpu/observability/spans.py",
    "adanet_tpu_torch/observability/flightrec.py": "adanet_tpu/observability/flightrec.py",
    "adanet_tpu_torch/robustness/faults.py": "adanet_tpu/robustness/faults.py",
    "adanet_tpu_torch/serving/frontend.py": "adanet_tpu/serving/frontend.py",
    "adanet_tpu_torch/robustness/sched.py": "adanet_tpu/robustness/sched.py",
    "adanet_tpu_torch/robustness/retry.py": "adanet_tpu/robustness/retry.py",
    "adanet_tpu_torch/store/__init__.py": "adanet_tpu/store/__init__.py",
    "adanet_tpu_torch/store/blobstore.py": "adanet_tpu/store/blobstore.py",
    "adanet_tpu_torch/store/leases.py": "adanet_tpu/store/leases.py",
    "adanet_tpu_torch/store/gc.py": "adanet_tpu/store/gc.py",
    "adanet_tpu_torch/store/fsck.py": "adanet_tpu/store/fsck.py",
    "adanet_tpu_torch/store/keys.py": "adanet_tpu/store/keys.py",
    "adanet_tpu_torch/subnetwork/report.py": "adanet_tpu/subnetwork/report.py",
    "adanet_tpu_torch/core/summary.py": "adanet_tpu/core/summary.py",
    "adanet_tpu_torch/ensemble/ensembler.py": "adanet_tpu/ensemble/ensembler.py",
    "adanet_tpu_torch/ensemble/strategy.py": "adanet_tpu/ensemble/strategy.py",
    "adanet_tpu_torch/examples/synthetic_digits.py": "adanet_tpu/examples/synthetic_digits.py",
    "adanet_tpu_torch/research/improve_nas/fake_data.py": "research/improve_nas/trainer/fake_data.py",
    "adanet_tpu_torch/core/timer.py": "adanet_tpu/core/timer.py",
    "adanet_tpu_torch/core/report_accessor.py": "adanet_tpu/core/report_accessor.py",
    "adanet_tpu_torch/replay/__init__.py": "adanet_tpu/replay/__init__.py",
    # The twelfth slice: the CIFAR providers with native augmentation,
    # the ImageNet input pipeline and ModelFlow's storages.
    "adanet_tpu_torch/ops/native_augment.py": "adanet_tpu/ops/native_augment.py",
    "adanet_tpu_torch/research/improve_nas/image_processing.py": "research/improve_nas/trainer/image_processing.py",
    "adanet_tpu_torch/research/improve_nas/cifar10.py": "research/improve_nas/trainer/cifar10.py",
    "adanet_tpu_torch/research/improve_nas/cifar100.py": "research/improve_nas/trainer/cifar100.py",
    "adanet_tpu_torch/research/imagenet_autoensemble/imagenet_data.py":
        "research/imagenet_autoensemble/imagenet_data.py",
    "adanet_tpu_torch/experimental/storages.py": "adanet_tpu/experimental/storages.py",
    # The thirteenth slice: the collective deadlines and the heartbeat.
    "adanet_tpu_torch/robustness/watchdog.py": "adanet_tpu/robustness/watchdog.py",
    # The fifteenth slice: the serving cascade (calibration, per-row
    # clearance).
    "adanet_tpu_torch/serving/fleet/cascade.py": "adanet_tpu/serving/fleet/cascade.py",
    # The seventeenth slice: the fleet's wire protocol and front tier, and
    # the Chrome-trace export.
    "adanet_tpu_torch/serving/fleet/transport.py": "adanet_tpu/serving/fleet/transport.py",
    "adanet_tpu_torch/serving/fleet/balancer.py": "adanet_tpu/serving/fleet/balancer.py",
    "adanet_tpu_torch/observability/export.py": "adanet_tpu/observability/export.py",
    # The nineteenth slice: the fleet's graft planning.
    "adanet_tpu_torch/fleet/transfer.py": "adanet_tpu/fleet/transfer.py",
}

#: Top-level definitions a copy replaces on purpose ("__doc__": the
#: module docstring), left out of the comparison on both sides. The
#: JAX package's env fingerprint derives from jax's versions; the port's
#: from torch's, CUDA's and the card's. The JAX package's replay
#: docstring describes its store grafts, which the port has not yet.
REPLACED = {
    "adanet_tpu_torch/store/keys.py": ("__doc__", "_env_fp_cache", "env_fingerprint"),
    # The port's replay retrains replayed iterations (no store graft yet).
    "adanet_tpu_torch/replay/__init__.py": ("__doc__",),
    # The port builds its own copy of the source into ops/.build/.
    "adanet_tpu_torch/ops/native_augment.py": ("__doc__", "_SRC", "_SO", "_build"),
    # The docstring names the port's source and the card.
    "adanet_tpu_torch/research/improve_nas/image_processing.py": ("__doc__",),
    # The docstring names the port's transports (store waits, gloo, NCCL).
    "adanet_tpu_torch/robustness/watchdog.py": ("__doc__",),
    # The docstring names the port's cheap program file (`cascade.pt2`).
    "adanet_tpu_torch/serving/fleet/cascade.py": ("__doc__",),
}

#: Modules that later slices added; the import rules must reach them.
SLICE_MODULES = (
    "adanet_tpu_torch.ops.cell_kernels",
    "adanet_tpu_torch.ops.tuning",
    "adanet_tpu_torch.store.keys",
    "adanet_tpu_torch.store.blobstore",
    "adanet_tpu_torch.tools.autotune",
    "adanet_tpu_torch.core.candidate",
    "adanet_tpu_torch.core.checkpoint",
    "adanet_tpu_torch.core.estimator",
    "adanet_tpu_torch.core.iteration",
    "adanet_tpu_torch.core.summary",
    "adanet_tpu_torch.ensemble.ensembler",
    "adanet_tpu_torch.ensemble.strategy",
    "adanet_tpu_torch.examples.simple_dnn",
    "adanet_tpu_torch.examples.synthetic_digits",
    "adanet_tpu_torch.subnetwork.report",
    "adanet_tpu_torch.utils.batches",
    "adanet_tpu_torch.utils.trees",
    "adanet_tpu_torch.research.improve_nas.fake_data",
    "adanet_tpu_torch.research.improve_nas.optimizer",
    "adanet_tpu_torch.research.improve_nas.trainer",
    "adanet_tpu_torch.robustness.integrity",
    "adanet_tpu_torch.tools.ckpt_fsck",
    "adanet_tpu_torch.tools.payload_versions",
    "adanet_tpu_torch.core.tpu_estimator",
    "adanet_tpu_torch.utils.device_timing",
    "adanet_tpu_torch.utils.precision",
    "adanet_tpu_torch.utils.prefetch",
    "adanet_tpu_torch.core.evaluator",
    "adanet_tpu_torch.core.report_accessor",
    "adanet_tpu_torch.core.report_materializer",
    "adanet_tpu_torch.core.timer",
    "adanet_tpu_torch.ensemble.mean",
    "adanet_tpu_torch.replay",
    "adanet_tpu_torch.autoensemble.common",
    "adanet_tpu_torch.autoensemble.estimator",
    "adanet_tpu_torch.examples.simple_cnn",
    "adanet_tpu_torch.examples.tutorials.adanet_objective",
    "adanet_tpu_torch.examples.tutorials.boston_housing",
    "adanet_tpu_torch.examples.tutorials.cifar10_cnn",
    "adanet_tpu_torch.examples.tutorials.mnist_simple_dnn",
    "adanet_tpu_torch.examples.tutorials.transfer_learning",
    "adanet_tpu_torch.ops.native_augment",
    "adanet_tpu_torch.research.improve_nas.image_processing",
    "adanet_tpu_torch.research.improve_nas.cifar10",
    "adanet_tpu_torch.research.improve_nas.cifar100",
    "adanet_tpu_torch.models.resnet",
    "adanet_tpu_torch.models.efficientnet",
    "adanet_tpu_torch.research.imagenet_autoensemble.imagenet_data",
    "adanet_tpu_torch.research.imagenet_autoensemble.trainer",
    "adanet_tpu_torch.distributed.scheduler",
    "adanet_tpu_torch.experimental",
    "adanet_tpu_torch.experimental.storages",
    "adanet_tpu_torch.experimental.model",
    "adanet_tpu_torch.experimental.phases",
    "adanet_tpu_torch.robustness.watchdog",
    "adanet_tpu_torch.distributed.coordination",
    "adanet_tpu_torch.distributed.mesh",
    "adanet_tpu_torch.distributed.placement",
    "adanet_tpu_torch.distributed.executor",
    "adanet_tpu_torch.distributed.multihost",
    "adanet_tpu_torch.parallel",
    "adanet_tpu_torch.parallel.ring_attention",
    "adanet_tpu_torch.models.transformer",
    "adanet_tpu_torch.examples.tutorials.long_context_ring_attention",
    "adanet_tpu_torch.examples.tutorials.serving_example",
    "adanet_tpu_torch.serving.fleet",
    "adanet_tpu_torch.serving.fleet.cascade",
    "adanet_tpu_torch.serving.fleet.transport",
    "adanet_tpu_torch.serving.fleet.balancer",
    "adanet_tpu_torch.serving.fleet.flip_coordinator",
    "adanet_tpu_torch.serving.fleet.replica",
    "adanet_tpu_torch.observability.export",
    "adanet_tpu_torch.research.distill_to_serve",
    "adanet_tpu_torch.research.distill_to_serve.distill",
    "adanet_tpu_torch.tools.servectl",
    "adanet_tpu_torch.tools.trace_view",
    "adanet_tpu_torch.tools.profile_nasnet",
    "adanet_tpu_torch.fleet",
    "adanet_tpu_torch.fleet.trial",
    "adanet_tpu_torch.fleet.transfer",
    "adanet_tpu_torch.fleet.comparator",
    "adanet_tpu_torch.fleet.controller",
    "adanet_tpu_torch.tools.fleetctl",
)

#: Modules run as `python -m` entry points; each must print its usage
#: (`--help`) with jax blocked.
ENTRY_POINTS = (
    "adanet_tpu_torch.serving.fleet.replica",
    "adanet_tpu_torch.tools.servectl",
    "adanet_tpu_torch.tools.trace_view",
    "adanet_tpu_torch.tools.profile_nasnet",
    "adanet_tpu_torch.tools.ckpt_fsck",
    "adanet_tpu_torch.research.distill_to_serve.distill",
    "adanet_tpu_torch.tools.fleetctl",
)


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        paths += [os.path.join(root, f) for f in sorted(files) if f.endswith(".py")]
    return paths


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_imports_anywhere_in_the_port():
    sources = _port_sources()
    assert len(sources) > 20
    scanned = {os.path.relpath(path, REPO) for path in sources}
    for module in SLICE_MODULES:
        path = module.replace(".", "/")
        assert path + ".py" in scanned or path + "/__init__.py" in scanned, module
    bad = {
        os.path.relpath(path, REPO): sorted(set(_imported_roots(path)) & FORBIDDEN)
        for path in sources
    }
    assert not {k: v for k, v in bad.items() if v}


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in %r: sys.modules[name] = None\n"
        "import adanet_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(adanet_tpu_torch.__path__, 'adanet_tpu_torch.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in %r and sys.modules[m] is not None)\n"
        "assert not leaked, leaked\n"
        "missing = sorted(set(%r) - set(names))\n"
        "assert not missing, missing\n"
        "print(len(names))\n" % (sorted(FORBIDDEN), sorted(FORBIDDEN), list(SLICE_MODULES))
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


@pytest.mark.parametrize("module", ENTRY_POINTS)
def test_entry_points_run_with_jax_blocked(module):
    code = (
        "import sys, runpy\n"
        "for name in %r: sys.modules[name] = None\n"
        "sys.argv = [%r, '--help']\n"
        "try:\n"
        "    runpy.run_module(%r, run_name='__main__', alter_sys=True)\n"
        "except SystemExit:\n"
        "    pass\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in %r and sys.modules[m] is not None)\n"
        "assert not leaked, leaked\n"
        "print('ENTRY OK')\n" % (sorted(FORBIDDEN), module, module, sorted(FORBIDDEN))
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "ENTRY OK" in out.stdout, out.stderr[-2000:]
    assert "usage" in out.stdout.lower()


def _defined_name(node, index):
    if index == 0 and isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant):
        return "__doc__"
    if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
        return node.name
    targets = node.targets if isinstance(node, ast.Assign) else [getattr(node, "target", None)]
    names = [t.id for t in targets if isinstance(t, ast.Name)]
    return names[0] if len(names) == 1 else None


def _without_imports(path, rename, replaced=()):
    text = open(path).read()
    if rename:
        text = re.sub(r"\badanet_tpu\b", "adanet_tpu_torch", text)
    lines = text.splitlines()
    drop = set()
    tree = ast.parse(text)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            drop.update(range(node.lineno - 1, node.end_lineno))
    found = set()
    for index, node in enumerate(tree.body):
        name = _defined_name(node, index)
        if name in replaced:
            found.add(name)
            drop.update(range(node.lineno - 1, node.end_lineno))
    assert found == set(replaced), "%s lacks %s" % (path, set(replaced) - found)
    return [line for i, line in enumerate(lines) if i not in drop]


@pytest.mark.parametrize("copy,original", sorted(COPIES.items()))
def test_copied_modules_stay_in_sync(copy, original):
    replaced = REPLACED.get(copy, ())
    want = _without_imports(os.path.join(REPO, original), rename=True, replaced=replaced)
    got = _without_imports(os.path.join(REPO, copy), rename=False, replaced=replaced)
    assert got == want, "%s drifted from %s" % (copy, original)


def _class_without_imports(path, name):
    """`ast.dump` of the top-level class `name` of `path`, its import
    statements left out (as `COPIES` compares modules)."""
    for node in ast.parse(open(path).read(), path).body:
        if isinstance(node, ast.ClassDef) and node.name == name:
            for parent in ast.walk(node):
                for field in ("body", "orelse", "finalbody"):
                    block = getattr(parent, field, None)
                    if isinstance(block, list):
                        setattr(parent, field, [n for n in block if not isinstance(n, (ast.Import, ast.ImportFrom))])
            return ast.dump(node)
    raise AssertionError("no class %s in %s" % (name, path))


def test_file_kv_is_the_jax_class():
    """`FileKV` is jax-free in the JAX package and copied as it stands."""
    got = _class_without_imports(os.path.join(PORT, "distributed", "scheduler.py"), "FileKV")
    want = _class_without_imports(os.path.join(REPO, "adanet_tpu", "distributed", "scheduler.py"), "FileKV")
    assert got == want


def test_cuda_request_without_cuda_raises(monkeypatch, tmp_path):
    from adanet_tpu_torch import AutoEnsembleEstimator, AutoEnsembleSubestimator, resolve_device
    from adanet_tpu_torch.core import TPUEstimator, export
    from adanet_tpu_torch.core.estimator import Estimator
    from adanet_tpu_torch.core.evaluator import Evaluator
    from adanet_tpu_torch.core.heads import MultiClassHead, MultiHead, RegressionHead
    from adanet_tpu_torch.core.report_materializer import ReportMaterializer
    from adanet_tpu_torch.ensemble.mean import MeanEnsembler
    from adanet_tpu_torch.core.iteration import IterationBuilder
    from adanet_tpu_torch.ensemble.strategy import GrowStrategy
    from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
    from adanet_tpu_torch.examples import simple_dnn
    from adanet_tpu_torch.research.improve_nas import trainer
    from adanet_tpu_torch.serving import ModelPool
    from adanet_tpu_torch.utils.prefetch import DevicePrefetchIterator
    from adanet_tpu_torch import replay
    from adanet_tpu_torch.distributed.scheduler import drain_callables
    from adanet_tpu_torch.examples.tutorials import cifar10_cnn
    from adanet_tpu_torch.experimental import Model, ParallelScheduler
    from adanet_tpu_torch.research.imagenet_autoensemble import trainer as imagenet_trainer
    from adanet_tpu_torch.distributed import RoundRobinStrategy, coordination, data_parallel_mesh
    from adanet_tpu_torch.distributed import ElasticWorkQueueStrategy, MultiHostRoundRobinExecutor
    from adanet_tpu_torch.examples.tutorials import long_context_ring_attention, serving_example
    from adanet_tpu_torch.serving import publish_generation
    from adanet_tpu_torch.research.distill_to_serve import distill_student, teacher_from_generation
    from adanet_tpu_torch.serving.fleet import ReplicaConfig, ServingReplica
    from adanet_tpu_torch.serving.fleet import replica as replica_lib
    from adanet_tpu_torch.tools import profile_nasnet
    from adanet_tpu_torch.fleet import FleetController, TrialSpec
    from adanet_tpu_torch.tools import fleetctl

    # An iteration built on the CPU, before CUDA is hidden, for the
    # executors that place onto devices of their own.
    cpu_iteration = IterationBuilder(MultiClassHead(10), [ComplexityRegularizedEnsembler()], [GrowStrategy()],
                                     device="cpu").build_iteration(0, simple_dnn.Generator().generate_candidates(
                                         None, 0, [], []), None, input_shape=(4,))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    head, generator = MultiClassHead(10), simple_dnn.Generator()
    # The selection slice's arguments: an Evaluator, reports, retained
    # states and example weights, over mean and multi-head candidates.
    selection = dict(evaluator=Evaluator(lambda: iter(())), report_materializer=ReportMaterializer(lambda: iter(())),
                     weight_key="w", keep_candidate_states=True, ensemblers=[MeanEnsembler()])
    multi_head = MultiHead([RegressionHead(name="r"), MultiClassHead(3, name="c")])
    fleet_spec = tmp_path / "fleet_spec.json"
    fleet_spec.write_text('{"trials": [{"id": "t"}]}')
    for call in (
        lambda: resolve_device(),
        lambda: resolve_device("cuda:0"),
        lambda: ModelPool(str(tmp_path)),
        lambda: export.load_serving_program(str(tmp_path)),
        lambda: Estimator(head, generator, 10, model_dir=str(tmp_path)),
        lambda: TPUEstimator(head, generator, 10, model_dir=str(tmp_path), prefetch_buffer=2,
                             prefetch_to_device=True),
        lambda: DevicePrefetchIterator(iter([])),
        lambda: IterationBuilder(head, [ComplexityRegularizedEnsembler()], [GrowStrategy()]),
        lambda: Estimator(multi_head, generator, 10, model_dir=str(tmp_path), **selection),
        lambda: TPUEstimator(head, generator, 10, model_dir=str(tmp_path), **selection),
        lambda: IterationBuilder(multi_head, [MeanEnsembler()], [GrowStrategy()], weight_key="w"),
        lambda: trainer.main(["--num_cells=3", "--train_steps=2", "--boosting_iterations=1",
                              "--model_dir", str(tmp_path)]),
        # The eleventh slice: AutoEnsemble (bagged and frozen members) and
        # replay.
        lambda: AutoEnsembleEstimator(
            head, {"bagged": AutoEnsembleSubestimator(torch.nn.Linear(2, 10), train_input_fn=lambda: iter(())),
                   "frozen": AutoEnsembleSubestimator(torch.nn.Linear(2, 10), prediction_only=True)},
            10, model_dir=str(tmp_path)),
        lambda: Estimator(head, generator, 10, model_dir=str(tmp_path), replay_config=replay.Config([0])),
        # The twelfth slice: both trainers and the CIFAR tutorial on their
        # providers, ModelFlow's Model and ParallelScheduler, and the
        # work-queue drain's default pool.
        lambda: trainer.main(["--dataset=cifar10", "--data_dir", str(tmp_path), "--num_cells=3",
                              "--model_dir", str(tmp_path)]),
        lambda: trainer.main(["--dataset=cifar100", "--data_dir", str(tmp_path), "--num_cells=3",
                              "--model_dir", str(tmp_path)]),
        lambda: cifar10_cnn.main(["--data_dir", str(tmp_path), "--model_dir", str(tmp_path)]),
        lambda: imagenet_trainer.main(["--image_size=32", "--batch_size=8", "--model_dir", str(tmp_path)]),
        lambda: Model(torch.nn.Linear(2, 1)),
        lambda: ParallelScheduler(),
        lambda: drain_callables([lambda: None], 1),
        # The thirteenth slice: RoundRobin placement (the strategy and the
        # trainer's flag), the data-parallel group and the process group.
        lambda: RoundRobinStrategy(),
        lambda: data_parallel_mesh(),
        lambda: coordination.initialize(device="cuda"),
        lambda: coordination.initialize("localhost:1", 2, 0, device="cuda"),
        lambda: imagenet_trainer.main(["--image_size=32", "--batch_size=8", "--placement=round_robin",
                                       "--model_dir", str(tmp_path)]),
        # The fourteenth slice: the elastic strategy (and the Estimator
        # over it) and the multi-host executor's default placement.
        lambda: ElasticWorkQueueStrategy(),
        lambda: Estimator(head, generator, 10, model_dir=str(tmp_path),
                          placement_strategy=ElasticWorkQueueStrategy(window_steps=8, speculate_steps=8)),
        lambda: MultiHostRoundRobinExecutor(cpu_iteration),
        # The fifteenth slice: the export and publication of programs, the
        # serving Estimator and both tutorials.
        lambda: export.export_serving_program(str(tmp_path / "x"), lambda f: f, {"x": np.zeros((2, 2))}),
        lambda: export.load_serving_program(str(tmp_path), export.CASCADE_FILE),
        lambda: publish_generation(str(tmp_path), 0, lambda f: f, {"x": np.zeros((2, 2))}),
        lambda: Estimator(head, generator, 10, model_dir=str(tmp_path), export_serving=True),
        lambda: long_context_ring_attention.main(["--seq_len", "16", "--max_steps", "1"]),
        lambda: serving_example.main([]),
        # The seventeenth slice: a fleet replica (and its CLI), the
        # distillation, its teacher and the NASNet-A profile.
        lambda: ServingReplica(ReplicaConfig("r0", str(tmp_path / "fleet"), str(tmp_path))),
        lambda: replica_lib.main(["--fleet-dir", str(tmp_path / "fleet"), "--model-dir", str(tmp_path),
                                  "--replica-id", "r0"]),
        lambda: distill_student(lambda f: {"predictions": np.zeros((2, 3), np.float32)},
                                [{"x": np.zeros((2, 2), np.float32)}]),
        lambda: teacher_from_generation(str(tmp_path)),
        lambda: profile_nasnet.main(["--steps", "1"]),
        # The nineteenth slice: the fleet controller, a trial's Estimator
        # and fleetctl's launch.
        lambda: FleetController([TrialSpec("t", lambda: head, lambda: generator, "g", 4)], lambda: iter(()),
                                str(tmp_path / "fleet")),
        lambda: TrialSpec("t", lambda: head, lambda: generator, "g", 4).build_estimator(str(tmp_path), None, 1),
        lambda: fleetctl.main(["launch", str(tmp_path / "fleetctl"), "--spec", str(fleet_spec)]),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_chip_smoke_fails_without_cuda(tmp_path):
    """The script exits non-zero and prints no result without a card,
    and also when it stands alone without the package."""
    bare = tmp_path / "chip_smoke.py"
    bare.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((REPO, "chip_smoke.py"), (str(tmp_path), str(bare))):
        out = subprocess.run(
            [sys.executable, script], cwd=cwd, env=env, capture_output=True, text=True, timeout=120
        )
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
