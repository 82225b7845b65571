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
    """`ComplexityRegularizedEnsembler` params `{"weights": [...],
    "bias": ...}` -> the same structure of f32 tensors (bias None when
    absent). Weight shapes need no change: [] scalar, [C] vector, or
    [D, C] matrix (right-multiplying the last layer, as in JAX)."""
    weights = [
        torch.from_numpy(np.array(w, dtype=np.float32, copy=True))
        for w in params["weights"]
    ]
    bias: Optional[torch.Tensor] = None
    if params.get("bias") is not None:
        bias = torch.from_numpy(np.array(params["bias"], dtype=np.float32, copy=True))
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
    {"kernel", "bias"}, ..., "logits": {...}}}`, numpy leaves) -> the
    `state_dict` of the port's `examples.simple_dnn._SimpleDNN`, whose
    layers carry the Flax names. Raises on any other leaf."""
    state = convert_variables(variables, collections=("params",))
    unknown = [key for key in state if not re.fullmatch(r"(dense_\d+|logits)\.(weight|bias)", key)]
    if unknown:
        raise ValueError("not a simple_dnn subnetwork: %s" % unknown)
    return state


def simple_dnn_variables(num_layers, layer_size, input_dim, n_classes, seed):
    """Flax-layout variables (numpy) of a JAX simple_dnn subnetwork,
    `{"params": {"dense_<i>": {"kernel", "bias"}, ..., "logits": ...}}`,
    drawn from `seed`: kernels ~ N(0, 1/fan_in), biases ~ N(0, 0.1^2)."""
    rng = np.random.RandomState(seed)
    params = {}
    width = input_dim
    for name, out in [("dense_%d" % i, layer_size) for i in range(num_layers)] + [("logits", n_classes)]:
        params[name] = {
            "kernel": (rng.randn(width, out) / np.sqrt(width)).astype(np.float32),
            "bias": (0.1 * rng.randn(out)).astype(np.float32),
        }
        width = out
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
