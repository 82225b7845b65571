"""Mixed-precision step policy: bf16 compute, f32 parameters and statistics.

Port of adanet_tpu/utils/precision.py. The rule the port follows, as the
JAX package does, is bf16 compute with f32 state: convolutions and
matrix products run in the compute dtype, while parameters, optimizer
state, batch-norm statistics, logits and losses stay float32. This
module is the batch side of that policy: the float features are cast to
the compute dtype once, at the train step's boundary
(`core/iteration.py` `step_compute_dtype`), so the first convolution
reads half the bytes and no layer casts them again.

Deliberately left as they are:

- labels and example weights, the losses' inputs;
- integer and bool features;
- anything already as narrow as the target or narrower (never widen).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from adanet_tpu_torch.utils.trees import tree_map

_NAMES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32,
          "float64": torch.float64}


def _cast_leaf(leaf, target: torch.dtype):
    if torch.is_tensor(leaf):
        if leaf.is_floating_point() and leaf.element_size() > target.itemsize:
            return leaf.to(target)
        return leaf
    if isinstance(leaf, np.ndarray) and leaf.dtype.kind == "f" and leaf.dtype.itemsize > target.itemsize:
        return torch.from_numpy(leaf).to(target)
    return leaf


def cast_floats(tree, dtype, preserve_keys: Sequence[str] = ()):
    """Casts the wide floating-point leaves of `tree` to `dtype`.

    Only leaves whose item size exceeds the target's are cast (tensors,
    and numpy arrays, which become tensors): integers, bools and
    already-narrow floats pass through. Top-level mapping keys named in
    `preserve_keys` (an example-weight column) are left alone.
    `dtype=None` is the identity."""
    if dtype is None:
        return tree
    target = resolve_dtype(dtype)

    def cast(leaf):
        return _cast_leaf(leaf, target)

    if isinstance(tree, Mapping) and preserve_keys:
        return {key: value if key in preserve_keys else tree_map(cast, value) for key, value in tree.items()}
    return tree_map(cast, tree)


def cast_batch(batch, dtype, preserve_keys: Sequence[str] = ()):
    """Casts a (features, labels) batch's float features to `dtype`;
    labels are never cast. A batch that is not a pair is cast as a
    features tree."""
    if dtype is None:
        return batch
    if isinstance(batch, tuple) and len(batch) == 2:
        features, labels = batch
        return (cast_floats(features, dtype, preserve_keys), labels)
    return cast_floats(batch, dtype, preserve_keys)


def resolve_dtype(dtype: Optional[Any]) -> Optional[torch.dtype]:
    """None stays None; a name ("bfloat16") or a torch or numpy dtype
    becomes a torch dtype. A target that is not floating point raises
    `ValueError` (a step cast to int would corrupt training silently)."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        resolved = dtype
    else:
        name = dtype if isinstance(dtype, str) else getattr(np.dtype(dtype), "name", str(dtype))
        resolved = _NAMES.get(str(name).replace("torch.", ""))
        if resolved is None:
            raise ValueError("step_compute_dtype must be a floating dtype, got %r" % (dtype,))
    if not resolved.is_floating_point:
        raise ValueError("step_compute_dtype must be a floating dtype, got %r" % (dtype,))
    return resolved
