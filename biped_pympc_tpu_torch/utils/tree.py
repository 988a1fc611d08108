"""Trees of tensors: dataclasses, tuples and lists whose leaves are tensors
(or None), as the controller's state and the examples' carries are."""

from __future__ import annotations

import dataclasses

import torch


def leaves(tree, prefix: str = ""):
    """(path, tensor) of every tensor of a tree of dataclasses, tuples and
    lists, in order; None leaves are absent."""
    if tree is None:
        return
    if torch.is_tensor(tree):
        yield prefix, tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from leaves(getattr(tree, f.name), f"{prefix}.{f.name}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}[{i}]")
    else:
        raise TypeError(f"carry leaf {prefix} is a {type(tree).__name__}")


def tree_map(fn, tree):
    """The tree with `fn` applied to every tensor; the structure rebuilt, so
    a step may replace the leaves of the copy without touching `tree`."""
    if tree is None or torch.is_tensor(tree):
        return None if tree is None else fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    return type(tree)(tree_map(fn, v) for v in tree)
