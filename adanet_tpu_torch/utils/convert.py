"""Carries the JAX package's variables across into the port's state dicts.

The input is plain nested dicts of numpy arrays: a caller holding Flax
variables unfreezes the tree and `np.asarray`s its leaves first; this
module never imports flax. Layout changes happen here and nowhere else:

- convolution kernels, HWIO `[kh, kw, I, O]` -> `[O, I, kh, kw]`
  (depthwise `[k, k, 1, C]` -> `[C, 1, k, k]`, pointwise `[1, 1, C, F]`
  -> `[F, C, 1, 1]`);
- Dense kernels `[in, out]` -> `[out, in]`;
- batch-norm `scale`/`bias` parameters and `mean`/`var`/`count`
  statistics keep their names and shapes.

A Flax path `a/b/kernel` becomes the key `a.b.weight`; any other leaf
keeps its name. `convert_cell_params` carries the fused cell's parameter
tree (`adanet_tpu/ops/cell_kernels.py: init_cell_params`) across the
same way, keeping its structure.
"""

from __future__ import annotations

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
    collections=("params", "batch_stats"),
) -> Dict[str, torch.Tensor]:
    """Flax variables (e.g. `{"params": ..., "batch_stats": ...}` of a
    NASNet subnetwork) -> a `state_dict` for the port's module. Other
    collections (the drop-path `schedule`) are training state and are
    left out."""
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
