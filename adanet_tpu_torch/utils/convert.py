"""Carries the JAX package's variables across into the port's state dicts.

The input is plain nested dicts of numpy arrays: a caller holding Flax
variables unfreezes the tree and `np.asarray`s its leaves first; this
module never imports flax. Layout changes happen here and nowhere else:

- convolution kernels, HWIO `[kh, kw, I, O]` -> `[O, I, kh, kw]`
  (depthwise `[k, k, 1, C]` -> `[C, 1, k, k]`, pointwise `[1, 1, C, F]`
  -> `[F, C, 1, 1]`);
- Dense kernels `[in, out]` -> `[out, in]`;
- batch-norm `scale`/`bias` parameters and `mean`/`var`/`count`
  statistics keep their names and shapes;
- the `schedule` collection's drop-path `step` becomes the buffer of the
  same name (`nasnet.step` in a NASNet subnetwork).

A Flax path `a/b/kernel` becomes the key `a.b.weight`; any other leaf
keeps its name. The port's modules carry the Flax names, so NASNet's
ImageNet stem (`conv0`, `conv0_bn`, `cell_stem_<i>` with its
`reduce_prev`) maps by path like every other layer. `convert_cell_params` carries the fused cell's parameter
tree (`adanet_tpu/ops/cell_kernels.py: init_cell_params`) across the
same way, keeping its structure, and `convert_simple_dnn` a simple_dnn
subnetwork's variables (a builder's `initial_variables` in the port).
`WithInitialVariables` starts every simple_dnn candidate of either
package from the same numbers, drawn in numpy (`simple_dnn_variables`).
`convert_simple_cnn` carries a `SimpleCNN`'s variables, and
`convert_module` the variables of any Flax module of Dense and Conv
layers onto a torch module of Linear and Conv2d layers (an
AutoEnsemble candidate's `initial_variables`, or an experimental
`Model`'s through `convert_model`). `convert_resnet` and
`convert_efficientnet` carry the ImageNet-class families' variables,
batch-norm `mean`/`var` into buffers.
"""

from __future__ import annotations

import re
import zlib
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def conv_kernel(kernel: np.ndarray) -> np.ndarray:
    """HWIO -> OIHW."""
    return np.ascontiguousarray(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def dense_kernel(kernel: np.ndarray) -> np.ndarray:
    """[in, out] -> [out, in]."""
    return np.ascontiguousarray(np.asarray(kernel).T)


def _flatten(tree: Mapping[str, Any], prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, np.asarray(value)


def _leaf(path, value: np.ndarray):
    name = path[-1]
    if name == "kernel":
        if value.ndim == 4:
            value = conv_kernel(value)
        elif value.ndim == 2:
            value = dense_kernel(value)
        else:
            raise ValueError("kernel %s of rank %d" % ("/".join(path), value.ndim))
        name = "weight"
    return ".".join(path[:-1] + (name,)), value


def convert_variables(
    variables: Mapping[str, Any],
    collections=("params", "batch_stats", "schedule"),
) -> Dict[str, torch.Tensor]:
    """Flax variables (`{"params": ..., "batch_stats": ..., "schedule":
    ...}` of a NASNet subnetwork) -> a `state_dict` for the port's module,
    in the same training state. Collections not named are left out."""
    out: Dict[str, torch.Tensor] = {}
    for collection in collections:
        tree = variables.get(collection)
        if tree is None:
            continue
        for path, value in _flatten(tree):
            key, value = _leaf(path, value)
            if key in out:
                raise ValueError("duplicate key %s" % key)
            out[key] = torch.from_numpy(np.array(value, copy=True))
    return out


def convert_ensembler_params(params: Mapping[str, Any]) -> Dict[str, Any]:
    """Ensembler params -> the same structure of f32 tensors. For a
    `ComplexityRegularizedEnsembler`, `{"weights": [...], "bias": ...}`
    (bias None when absent), each weight and the bias a dict by key for
    multi-head logits; a mean ensemble's `{}` stays `{}`. Weight shapes
    need no change: [] scalar, [C] vector, or [D, C] matrix
    (right-multiplying the last layer, as in JAX)."""
    if "weights" not in params:
        if params:
            raise ValueError("not ensembler params: %s" % sorted(params))
        return {}

    def tensor(value):
        if isinstance(value, Mapping):
            return {key: tensor(v) for key, v in value.items()}
        return torch.from_numpy(np.array(value, dtype=np.float32, copy=True))

    weights = [tensor(w) for w in params["weights"]]
    bias: Optional[Any] = None
    if params.get("bias") is not None:
        bias = tensor(params["bias"])
    return {"weights": weights, "bias": bias}


def convert_cell_params(params: Mapping[str, Any]) -> Dict[str, Any]:
    """The JAX `init_cell_params` tree (numpy leaves) -> the port's tree
    (`adanet_tpu_torch.ops.cell_kernels`), in the same structure:

    - depthwise `dw` `[k, k, 1, C]` -> `[C, 1, k, k]` and pointwise `pw`
      `[1, 1, C, F]` -> `[F, C, 1, 1]`;
    - 1x1 `w` `[C, F]` -> `[F, C]`, and the factorized reduction's
      `w1`/`w2` the same way;
    - `scale` and `bias` unchanged.

    Leaves keep their dtype (bfloat16 arrives as float32 from numpy and
    is the caller's to cast); tuples stay tuples.
    """

    def leaf(name, value):
        value = np.asarray(value)
        if name in ("dw", "pw"):
            value = conv_kernel(value)
        elif name in ("w", "w1", "w2"):
            value = dense_kernel(value)
        return torch.from_numpy(np.array(value, copy=True))

    def walk(node, name=None):
        if isinstance(node, Mapping):
            return {key: walk(value, key) for key, value in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(walk(item, name) for item in node)
        return leaf(name, node)

    return walk(params)


def convert_simple_dnn(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX simple_dnn subnetwork's variables (`{"params": {"dense_<i>":
    {"kernel", "bias"}, ..., "logits": {...}}}`, numpy leaves; a
    multi-head one has `logits_<head>` for each head) -> the
    `state_dict` of the port's `examples.simple_dnn._SimpleDNN`, whose
    layers carry the Flax names. Raises on any other leaf."""
    state = convert_variables(variables, collections=("params",))
    unknown = [key for key in state if not re.fullmatch(r"(dense_\d+|logits|logits_\w+)\.(weight|bias)", key)]
    if unknown:
        raise ValueError("not a simple_dnn subnetwork: %s" % unknown)
    return state


def simple_dnn_variables(num_layers, layer_size, input_dim, n_classes, seed):
    """Flax-layout variables (numpy) of a JAX simple_dnn subnetwork,
    `{"params": {"dense_<i>": {"kernel", "bias"}, ..., "logits": ...}}`
    (`logits_<head>` for each head, by sorted name, when `n_classes` is
    a dict), drawn from `seed`: kernels ~ N(0, 1/fan_in), biases ~ N(0,
    0.1^2)."""
    rng = np.random.RandomState(seed)
    params = {}

    def dense(name, width, out):
        params[name] = {
            "kernel": (rng.randn(width, out) / np.sqrt(width)).astype(np.float32),
            "bias": (0.1 * rng.randn(out)).astype(np.float32),
        }

    width = input_dim
    for i in range(num_layers):
        dense("dense_%d" % i, width, layer_size)
        width = layer_size
    if isinstance(n_classes, Mapping):
        for key, dim in sorted(n_classes.items()):
            dense("logits_%s" % key, width, dim)
    else:
        dense("logits", width, n_classes)
    return {"params": params}


class WithInitialVariables:
    """Wraps a simple_dnn `Generator` of either package: each builder it
    returns carries `initial_variables`, drawn per (iteration, builder
    name, `seed`) by `simple_dnn_variables` and passed through `convert`
    (`convert_simple_dnn` for the port's builders, the identity for the
    JAX package's), so both packages, or the card and the CPU, start
    every candidate from the same numbers."""

    def __init__(self, generator, input_dim, n_classes, convert=convert_simple_dnn, seed=0):
        self._generator = generator
        self._convert = convert
        self._input_dim = input_dim
        self._n_classes = n_classes
        self._seed = seed

    def generate_candidates(self, previous_ensemble, iteration_number, previous_ensemble_reports,
                            all_reports, config=None):
        builders = self._generator.generate_candidates(
            previous_ensemble, iteration_number, previous_ensemble_reports, all_reports, config
        )
        for builder in builders:
            seed = zlib.crc32(("%d/%s/%d" % (iteration_number, builder.name, self._seed)).encode())
            builder.initial_variables = self._convert(simple_dnn_variables(
                builder._num_layers, builder._layer_size, self._input_dim, self._n_classes, seed
            ))
        return builders


def convert_simple_cnn(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX `SimpleCNN`'s variables (`{"params": {"conv_<i>_a", "conv_<i>_b":
    {"kernel" HWIO, "bias"}, ..., "logits": {...}}}`, numpy leaves) -> the
    `state_dict` of the port's `examples.simple_cnn.SimpleCNN`. Raises on
    any other leaf."""
    state = convert_variables(variables, collections=("params",))
    unknown = [key for key in state if not re.fullmatch(r"(conv_\d+_[ab]|logits)\.(weight|bias)", key)]
    if unknown:
        raise ValueError("not a SimpleCNN subnetwork: %s" % unknown)
    return state


#: Flax's automatic layer names by the torch layer type they map to.
_AUTO_NAMES = {torch.nn.Linear: "Dense", torch.nn.Conv2d: "Conv"}


def convert_module(variables: Mapping[str, Any], module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The Flax variables of a user module (`{"params": tree}`, numpy
    leaves; a tree nested under `inner`, as an AutoEnsemble wrapper holds
    it, is unwrapped) -> the `state_dict` of the torch `module`.

    Each layer of `module` that holds parameters (Linear or Conv2d, in
    module order) takes the Flax layer of its own path (`conv1`,
    `block.dense`) when the tree has one, else the next automatic name of
    its type (`Dense_<i>`, `Conv_<i>`, counted in module order). Kernels
    change layout as in `convert_variables`; every Flax layer must be
    used once, and shapes must agree."""
    tree = variables.get("params", variables)
    if set(tree) == {"inner"}:
        tree = tree["inner"]
    flat = {".".join(path): value for path, value in _flatten(tree)}
    counters: Dict[str, int] = {}
    out: Dict[str, torch.Tensor] = {}
    used = set()
    for name, layer in module.named_modules():
        own = dict(layer.named_parameters(recurse=False))
        if not own:
            continue
        kind = next((auto for cls, auto in _AUTO_NAMES.items() if isinstance(layer, cls)), None)
        if kind is None:
            raise ValueError("cannot map layer %r of type %s" % (name, type(layer).__name__))
        source = name
        if not any(key.startswith(name + ".") for key in flat):
            source = "%s_%d" % (kind, counters.get(kind, 0))
            counters[kind] = counters.get(kind, 0) + 1
        for param_name, param in own.items():
            leaf = {"weight": "kernel"}.get(param_name, param_name)
            key = "%s.%s" % (source, leaf)
            if key not in flat:
                raise ValueError("no Flax leaf %s for %s.%s" % (key.replace(".", "/"), name, param_name))
            _, value = _leaf(tuple(key.split(".")), flat[key])
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError("%s: Flax %s against torch %s" % (key, value.shape, tuple(param.shape)))
            out["%s.%s" % (name, param_name) if name else param_name] = torch.from_numpy(np.array(value, copy=True))
            used.add(key)
    unused = sorted(set(flat) - used)
    if unused:
        raise ValueError("Flax leaves with no torch counterpart: %s" % unused)
    return out


def _convert_family(variables: Mapping[str, Any], pattern: str, what: str) -> Dict[str, torch.Tensor]:
    state = convert_variables(variables, collections=("params", "batch_stats"))
    unknown = [key for key in state if not re.fullmatch(pattern, key)]
    if unknown:
        raise ValueError("not a %s: %s" % (what, unknown))
    return state


def convert_resnet(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX `ResNet`'s variables (`{"params": {"stem", "stem_bn",
    "stage<s>_block<b>": {"conv<i>", "bn<i>", "proj", "proj_bn"}, "logits"},
    "batch_stats": {...}}`, numpy leaves) -> the `state_dict` of the port's
    `models.resnet.ResNet`: kernels in torch's layouts, batch-norm `scale`
    and `bias` parameters, `mean` and `var` buffers. Raises on any other
    leaf."""
    layer = r"(stem|stem_bn|logits|stage\d+_block\d+\.(conv\d|bn\d|proj|proj_bn))"
    return _convert_family(variables, layer + r"\.(weight|bias|scale|mean|var)", "ResNet")


def convert_efficientnet(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX `EfficientNet`'s variables (`{"params": {"stem", "stem_bn",
    "stage<s>_block<b>": {"expand", "expand_bn", "depthwise", "dw_bn",
    "se": {"Conv_0", "Conv_1"}, "project", "project_bn"}, "head", "head_bn",
    "logits"}, "batch_stats": {...}}`) -> the `state_dict` of the port's
    `models.efficientnet.EfficientNet`, as `convert_resnet` does."""
    block = r"stage\d+_block\d+\.(expand|expand_bn|depthwise|dw_bn|se\.Conv_[01]|project|project_bn)"
    layer = r"(stem|stem_bn|head|head_bn|logits|%s)" % block
    return _convert_family(variables, layer + r"\.(weight|bias|scale|mean|var)", "EfficientNet")


def convert_model(variables: Mapping[str, Any], model) -> None:
    """Loads a JAX experimental `Model`'s variables (`{"params": tree}`,
    numpy leaves) into the port's `experimental.Model` `model`, whose
    module holds Linear and Conv2d layers (`convert_module`), so that it
    trains on from those numbers instead of its own seeded init."""
    model.load_state_dict(convert_module(variables, model.module))
