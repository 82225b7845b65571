"""Serving export: hermetic programs of any ensemble.

Port of adanet_tpu/core/export.py. The JAX package lowers the best
ensemble's whole prediction function (member forwards, the mixture
combine, the head's predictions) to StableHLO with the parameters baked
in, loadable with no framework, generator or model code. The port's
counterpart is `torch.export`:

- `export_serving_program(export_dir, predict_fn, sample_features)`
  traces `predict_fn` into an `ExportedProgram` (parameters inside, a
  symbolic `batch` on every feature's leading dimension) and writes it
  with `torch.export.save` to `serving.pt2`, beside
  `serving_signature.json` (the JAX signature's fields: `platforms`,
  `requested_platforms`, `multi_platform_fallback_reason`,
  `polymorphic_fallback_reason`, `inputs`, `outputs`);
- `load_serving_program(export_dir, filename=None, device="cuda")`
  loads it with `torch.export.load` (no pickle of user classes), moves
  the program to `device` and returns `fn(features) -> predictions`.

A loader needs no builder, generator or model code, but the kernels'
custom ops must be registered: K1 and K2 appear in the graph as
`adanet_tpu_torch::weighted_combine` and `adanet_tpu_torch::sep_conv`
(a `ctypes` launch cannot be traced), so the serving process imports
`adanet_tpu_torch.ops`, which this module does. The ops dispatch by
device: on a CUDA tensor they launch the hand-written kernels, on a CPU
tensor they run the plain versions.

A "platform" is a device type. A program is multi-platform when the
same file serves on `cuda` and on `cpu`: the loader retargets the
devices the graph names and moves the parameters. At export each
requested platform other than the exporting one is checked by running
the retargeted graph on fake tensors of that device (shapes, dtypes,
devices and every operator's meta function; no device needed). As in
the JAX package, a failed polymorphic export falls back to the sample's
concrete batch and a failed platform to the exporting one, and each
fallback is recorded in the signature and logged, never silent.
`torch.export` specializes sizes 0 and 1, so a one-row sample is
repeated to two rows before the trace.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

import adanet_tpu_torch.ops  # noqa: F401  (registers the kernels' custom ops)
from adanet_tpu_torch._device import resolve_device
from adanet_tpu_torch.core.frozen import FrozenEnsemble

_LOG = logging.getLogger("adanet_tpu_torch")

SERVING_FILE = "serving.pt2"
SIGNATURE_FILE = "serving_signature.json"
#: The cheap-member program of a cascade publication
#: (`serving.fleet.cascade`): same serialization, second file.
CASCADE_FILE = "cascade.pt2"
REQUIRED_SERVING_FILES = (SERVING_FILE, SIGNATURE_FILE)
DEFAULT_PLATFORMS = ("cuda", "cpu")


def _canonical(tree):
    """`tree` with every dict's keys in sorted order (the order the
    exported program's input spec was traced in)."""
    if isinstance(tree, dict):
        return {key: _canonical(tree[key]) for key in sorted(tree)}
    return tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {key: _map(fn, value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, value) for value in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for key in tree for leaf in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def _tensor(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _describe(tree, batch):
    """`{"shape": [...], "dtype": ...}` a leaf, the leading dimension
    "batch" when it is symbolic (`batch` None: concrete)."""

    def leaf(t):
        dims = [str(int(d)) for d in t.shape]
        if batch is not None and dims:
            dims[0] = "batch"
        return {"shape": dims, "dtype": _dtype_name(t.dtype)}

    return _map(leaf, tree)


class _Program(torch.nn.Module):
    """`predict_fn` as the module `torch.export` traces."""

    def __init__(self, predict_fn: Callable):
        super().__init__()
        self._predict_fn = predict_fn

    def forward(self, features):
        return self._predict_fn(features)


def frozen_predict_fn(frozen: FrozenEnsemble, ensembler, head) -> Callable:
    """`features -> head predictions` of a frozen ensemble (member
    forwards, the ensembler's combine, the head), its parameters closed
    over: a function to export."""

    def predict_fn(features):
        outs = frozen.member_outputs(features, training=False)
        return head.predictions(ensembler.build_ensemble(frozen.ensembler_params, outs).logits)

    return predict_fn


def _retarget(graph_module: torch.fx.GraphModule, device: torch.device, recompile: bool = True) -> list:
    """Every device the graph names (factory functions, copies) becomes
    `device`; returns what `_restore` needs to undo it. The module's code
    is generated again only when a device changed and `recompile` (an
    `fx.Interpreter` reads the nodes themselves)."""

    def swap(value):
        if isinstance(value, torch.device):
            return device
        if isinstance(value, (list, tuple)):
            return type(value)(swap(v) for v in value)
        if isinstance(value, dict):
            return {k: swap(v) for k, v in value.items()}
        return value

    undo = []
    for node in graph_module.graph.nodes:
        args, kwargs = swap(node.args), swap(node.kwargs)
        if args != node.args or kwargs != node.kwargs:
            undo.append((node, node.args, node.kwargs))
            node.args, node.kwargs = args, kwargs
    if undo and recompile:
        graph_module.recompile()
    return undo


def _restore(undo: list) -> None:
    for node, args, kwargs in undo:
        node.args, node.kwargs = args, kwargs


def _check_platform(program, platform: str, user_inputs: Sequence[torch.Tensor]) -> None:
    """Raises unless the program's graph, retargeted to `platform`, runs
    on fake tensors of that device (every input, parameter and constant
    faked there)."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    device = torch.device(platform)
    if device.type == "cuda":
        device = torch.device("cuda", 0)
    graph_module = program.graph_module
    mode = FakeTensorMode(allow_non_fake_inputs=False)

    def fake(t):
        return FakeTensor(mode, torch.empty(t.shape, dtype=t.dtype, device="meta"), device)

    state = dict(program.state_dict)
    state.update(program.constants)
    args = []
    users = iter(user_inputs)
    for spec in program.graph_signature.input_specs:
        if spec.kind.name == "USER_INPUT":
            args.append(fake(next(users)))
        elif spec.target in state:
            args.append(fake(state[spec.target]))
        else:
            raise ValueError("program input %s (%s) has no value" % (spec.arg.name, spec.kind.name))
    undo = _retarget(graph_module, device, recompile=False)
    try:
        with mode:
            torch.fx.Interpreter(graph_module).run(*args)
    finally:
        _restore(undo)


def export_serving_program(
    export_dir: str,
    predict_fn: Callable,
    sample_features: Any,
    polymorphic_batch: bool = True,
    platforms=DEFAULT_PLATFORMS,
    device=None,
) -> str:
    """Serializes `predict_fn(features) -> predictions` with its
    parameters inside; returns the program's path.

    `device` is where `predict_fn`'s parameters lie (the card by
    default): the sample runs there. With `polymorphic_batch` the
    leading dimension of every feature is the symbolic `batch`, so the
    served program takes any batch size. `platforms` are the device
    types the program must also serve on (the exporting one is always
    among them)."""
    dev = resolve_device(device)
    features = _canonical(_map(lambda x: _tensor(x, dev), sample_features))
    rows = int(_leaves(features)[0].shape[0])
    if rows < 2:
        # torch.export specializes sizes 0 and 1.
        features = _map(lambda t: t.repeat((2,) + (1,) * (t.dim() - 1)), features)
    target_platforms = None
    if platforms:
        target_platforms = list(platforms)
        if dev.type not in target_platforms:
            target_platforms.append(dev.type)
    program = _Program(predict_fn)
    polymorphic_fallback_reason = None
    exported = None
    attempts = [True, False] if polymorphic_batch else [False]
    last_error = None
    for polymorphic in attempts:
        dynamic = None
        if polymorphic:
            batch = torch.export.Dim("batch")
            dynamic = (_map(lambda t: {0: batch}, features),)
        try:
            with torch.no_grad():
                exported = torch.export.export(program, (features,), dynamic_shapes=dynamic)
            chosen_polymorphic = polymorphic
            break
        except Exception as exc:  # a specialized model falls back
            last_error = exc
            reason = "%s: %s" % (type(exc).__name__, exc)
            if polymorphic:
                polymorphic_fallback_reason = reason
            _LOG.info("Export attempt (polymorphic batch=%s) failed: %s", polymorphic, exc)
    if exported is None:
        raise ValueError(
            "Could not export the serving program for any configuration; last error: %s" % last_error
        ) from last_error
    if not chosen_polymorphic and polymorphic_batch:
        _LOG.warning("Polymorphic-batch export fell back to the concrete batch %d: %s",
                     int(_leaves(features)[0].shape[0]), polymorphic_fallback_reason)
    with torch.inference_mode(), _serving_precision():
        outputs = exported.module()(features)
    served = [dev.type]
    multi_platform_fallback_reason = None
    for platform in target_platforms or []:
        if platform == dev.type:
            continue
        try:
            _check_platform(exported, platform, _leaves(features))
            served.append(platform)
        except Exception as exc:
            if multi_platform_fallback_reason is None:
                multi_platform_fallback_reason = "%s (%s): %s" % (platform, type(exc).__name__, exc)
    if multi_platform_fallback_reason is not None:
        served = [dev.type]
        _LOG.warning("Multi-platform export for %s fell back to single-platform %s: %s",
                     target_platforms, served, multi_platform_fallback_reason)
    os.makedirs(export_dir, exist_ok=True)
    path = os.path.join(export_dir, SERVING_FILE)
    torch.export.save(exported, path)
    batch = "batch" if chosen_polymorphic else None
    signature = {
        "platforms": served,
        "requested_platforms": target_platforms,
        # None when the requested capability survived; otherwise the
        # first error that forced the degradation.
        "multi_platform_fallback_reason": multi_platform_fallback_reason,
        "polymorphic_fallback_reason": None if chosen_polymorphic else polymorphic_fallback_reason,
        "inputs": _describe(features, batch),
        "outputs": _describe(outputs, batch),
    }
    with open(os.path.join(export_dir, SIGNATURE_FILE), "w") as f:
        json.dump(signature, f, indent=2, sort_keys=True)
    return path


@contextlib.contextmanager
def _serving_precision():
    """TF32 off, as the Estimator's evaluate and predict run (a served
    program gives the same numbers as the in-process predict)."""
    from adanet_tpu_torch.ensemble.weighted import full_f32_matmul

    with full_f32_matmul():
        yield


def load_serving_program(export_dir: str, filename: Optional[str] = None, device="cuda") -> Callable:
    """Loads an exported program; returns `fn(features) -> predictions`
    (a dict of tensors on `device`; features numpy or tensors, any batch
    size when the export was polymorphic). Needs no builder, generator
    or model code. `filename` selects another program of the export
    (the cascade's, `CASCADE_FILE`). On a CUDA device the kernels'
    self-test (K0) runs first, the counterpart of the JAX package's
    lowering probe in front of its Pallas kernels."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from adanet_tpu_torch.ops import _build

        _build.self_test(dev)
    program = torch.export.load(os.path.join(export_dir, filename or SERVING_FILE))
    module = program.module()
    target = torch.device("cuda", dev.index or 0) if dev.type == "cuda" else dev
    _retarget(module, target)
    module.to(target)
    # Constants (tensors the predict function closed over) are plain
    # attributes of the loaded module; they move too, once, outside
    # inference mode, so that they keep a version counter for the
    # kernels' prepared-weight memo.
    for sub in module.modules():
        for name, value in list(vars(sub).items()):
            if torch.is_tensor(value) and not isinstance(value, torch.nn.Parameter):
                setattr(sub, name, value.to(target))

    def predict(features):
        features = _canonical(_map(lambda x: _tensor(x, target), features))
        with torch.inference_mode(), _serving_precision():
            return module(features)

    predict.module = module
    return predict


def serving_signature(export_dir: str) -> Dict[str, Any]:
    with open(os.path.join(export_dir, SIGNATURE_FILE)) as f:
        return json.load(f)
