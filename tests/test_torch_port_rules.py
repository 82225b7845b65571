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
}

#: Top-level definitions a copy replaces on purpose ("__doc__": the
#: module docstring), left out of the comparison on both sides. The
#: JAX package's env fingerprint derives from jax's versions; the port's
#: from torch's, CUDA's and the card's.
REPLACED = {
    "adanet_tpu_torch/store/keys.py": ("__doc__", "_env_fp_cache", "env_fingerprint"),
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
        assert module.replace(".", "/") + ".py" in scanned, module
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


def test_cuda_request_without_cuda_raises(monkeypatch, tmp_path):
    from adanet_tpu_torch import resolve_device
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

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    head, generator = MultiClassHead(10), simple_dnn.Generator()
    # The selection slice's arguments: an Evaluator, reports, retained
    # states and example weights, over mean and multi-head candidates.
    selection = dict(evaluator=Evaluator(lambda: iter(())), report_materializer=ReportMaterializer(lambda: iter(())),
                     weight_key="w", keep_candidate_states=True, ensemblers=[MeanEnsembler()])
    multi_head = MultiHead([RegressionHead(name="r"), MultiClassHead(3, name="c")])
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
