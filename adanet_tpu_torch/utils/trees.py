"""Small tree utilities over dicts, lists and tuples of tensors.

Port of `tree_where` and `tree_finite` from adanet_tpu/utils/trees.py.
A tree is a tensor, or a dict, list or tuple of trees; other leaves
(numbers, None) are ignored by `tree_finite`. The train step keeps or
drops an update on the device with `tree_where` over flat copies of its
tensors (`core/iteration.py`), so that no step reads a flag on the host.
"""

from __future__ import annotations

import torch


def tree_leaves(tree):
    """The leaves of `tree` but None, dict entries in sorted key order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            yield from tree_leaves(item)
    elif tree is not None:
        yield tree


def tree_map(fn, tree):
    """`tree` with `fn` applied to every leaf, the structure kept."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, item) for item in tree)
    return fn(tree)


def tree_where(pred, on_true, on_false):
    """`torch.where(pred, a, b)` leaf by leaf over matching trees; `pred`
    is a 0-d bool tensor (on the leaves' device) and the result takes
    the structure of `on_true`."""
    if isinstance(on_true, dict):
        return {key: tree_where(pred, on_true[key], on_false[key]) for key in on_true}
    if isinstance(on_true, (list, tuple)):
        return type(on_true)(tree_where(pred, a, b) for a, b in zip(on_true, on_false, strict=True))
    return torch.where(pred, on_true, on_false)


def tree_finite(tree) -> torch.Tensor:
    """0-d bool tensor: True iff every floating leaf is entirely finite.

    Computed on the leaves' device without a host sync; an empty tree is
    finite (on the CPU).
    """
    flags = [
        torch.isfinite(leaf).all()
        for leaf in tree_leaves(tree)
        if torch.is_tensor(leaf) and leaf.is_floating_point()
    ]
    if not flags:
        return torch.ones((), dtype=torch.bool)
    return torch.stack(flags).all()

