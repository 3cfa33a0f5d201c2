"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

Leaves are visited in sorted-key order, the order ``jax.tree.leaves``
uses for dicts, so sums over leaves add in the same order as in the JAX
package. A leaf may be a DTensor (the sharded train state).
"""

from __future__ import annotations

import sys
from typing import Any, Callable


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (which must have the same keys)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def is_dtensor(leaf) -> bool:
    """Whether ``leaf`` is a DTensor. One exists only once its module is
    loaded, so a one-device step does not pay the second that loading
    ``torch.distributed.tensor`` takes."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(leaf, mod.DTensor)
