"""`sam_pt_torch/utils/tree.py`: a batch that is a tensor or a dict of
tensors, mapped over, measured and padded the same way either form."""
import pytest
import torch

from sam_pt_torch.utils.tree import leading_size, pad_last, tree_map


def _batch(form):
    x = torch.arange(12.0).reshape(3, 4)
    return x if form == "tensor" else {"emb": x, "hq": x[:, :1] - 1}


def _leaves(tree):
    return list(tree.values()) if isinstance(tree, dict) else [tree]


@pytest.mark.parametrize("form", ["tensor", "dict"])
def test_pad_map_and_leading_size(form):
    tree = _batch(form)
    assert leading_size(tree) == 3

    padded = pad_last(tree, 5)
    assert leading_size(padded) == 5
    for got, leaf in zip(_leaves(padded), _leaves(tree)):
        assert torch.equal(got[:3], leaf)
        assert torch.equal(got[3:], leaf[-1:].expand(2, -1))
    assert pad_last(tree, 3) is tree or all(
        a is b for a, b in zip(_leaves(pad_last(tree, 3)), _leaves(tree)))
    assert pad_last(None, 5) is None

    doubled = tree_map(lambda a, b: a + b, tree, tree)
    assert type(doubled) is type(tree)
    for got, leaf in zip(_leaves(doubled), _leaves(tree)):
        assert torch.equal(got, 2 * leaf)
    cropped = tree_map(lambda a: a[:2], padded)
    assert leading_size(cropped) == 2
