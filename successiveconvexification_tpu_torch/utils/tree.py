"""Minimal tree utilities over NamedTuples, tuples, lists, dicts and tensors."""

from __future__ import annotations

import torch


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over trees of the same structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        # leaves in sorted key order, as JAX flattens a dict (the order of
        # tree_leaves and of checkpoint files); the result keeps tree's order
        out = {k: tree_map(fn, tree[k], *(r[k] for r in rest))
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(lambda a: out.append(a), tree)
    return out


def tree_where(mask: torch.Tensor, new, old):
    """Per-lane select: ``new`` where ``mask`` (B,) is True, else ``old``.

    ``torch.where``, never arithmetic, so a NaN in the unselected tree
    cannot leak into the result."""

    def one(n, o):
        m = mask.reshape(mask.shape + (1,) * (n.dim() - mask.dim()))
        return torch.where(m, n, o)

    return tree_map(one, new, old)
