"""Small tree utilities over dicts, lists and tuples of tensors.

Port of `tree_finite` from adanet_tpu/utils/trees.py (the step skips a
non-finite update on the host, so `tree_where` has no use yet). A tree
is a tensor, or a dict, list or tuple of trees; other leaves (numbers,
None) are ignored.
"""

from __future__ import annotations

import torch


def _leaves(tree):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            yield from _leaves(item)
    elif tree is not None:
        yield tree


def tree_finite(tree) -> torch.Tensor:
    """0-d bool tensor: True iff every floating leaf is entirely finite.

    Computed on the leaves' device without a host sync; an empty tree is
    finite (on the CPU).
    """
    flags = [
        torch.isfinite(leaf).all()
        for leaf in _leaves(tree)
        if torch.is_tensor(leaf) and leaf.is_floating_point()
    ]
    if not flags:
        return torch.ones((), dtype=torch.bool)
    return torch.stack(flags).all()

