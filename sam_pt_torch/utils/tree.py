"""A batch as the port passes it around: a tensor, or a dict of tensors that
share their leading axis (a frame embedding with parts, such as HQ-SAM's).
What the parts mean is the SAM model's and its predictor's to know."""
from __future__ import annotations

import torch


def tree_map(fn, *trees):
    """`fn` over the leaves: over tensors, or key by key over dicts of
    them. With several trees, `fn` takes one leaf of each."""
    if isinstance(trees[0], dict):
        return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def leading_size(tree) -> int:
    """The size of the leading axis that the leaves share."""
    leaf = next(iter(tree.values())) if isinstance(tree, dict) else tree
    return leaf.shape[0]


def pad_last(tree, n: int):
    """The leading axis padded to `n` with copies of the last item (None
    stays None)."""
    def pad(x):
        k = n - x.shape[0]
        return torch.cat([x, x[-1:].expand(k, *x.shape[1:])]) if k else x

    return None if tree is None else tree_map(pad, tree)
