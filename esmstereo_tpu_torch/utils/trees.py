"""Nested-container helpers, the reference's iteration utilities
(``utils/experiment.py:16-56``).

Counterpart of ``esmstereo_tpu/utils/trees.py``, whose functions map over
JAX pytrees: here the trees are dicts, lists and tuples of tensors, numpy
arrays or numbers, and ``None`` is an empty subtree. ``save_images`` is in
``utils.meters``.
"""

from __future__ import annotations

import numpy as np
import torch


def tree_map(fn, tree):
    """``fn`` applied to every leaf, the containers rebuilt."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def tensor2float(tree):
    """Every leaf -> python float (scalar leaves expected)."""
    return tree_map(float, tree)


def tensor2numpy(tree):
    """Every leaf -> numpy array (a tensor copied to the host)."""
    return tree_map(lambda x: x.detach().cpu().numpy()
                    if isinstance(x, torch.Tensor) else np.asarray(x), tree)


def check_allfloat(tree) -> None:
    """Raise ``TypeError`` unless every leaf is a python float."""
    for leaf in tree_leaves(tree):
        if not isinstance(leaf, float):
            raise TypeError(f"leaf of type {type(leaf).__name__}, not float")
