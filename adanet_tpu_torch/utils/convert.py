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
keeps its name.
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
