"""Trees in JAX's order: nested dicts, lists and tuples (named tuples too)
of leaves, walked as ``jax.tree`` walks them (dict keys sorted) and named
by JAX's ``keystr`` paths (``"['params']['embed']"``, ``"[0]"``,
``".field"``); ``None`` is an empty subtree.  The checkpoint layout and the
optimizer's leaf order (the order ``clip_by_global_norm`` sums in) both
come from here.

A leaf crosses numpy through :func:`leaf_numpy` and :func:`leaf_tensor`.
numpy has no ``bfloat16``: a bfloat16 leaf travels as its bits, a 2-byte
void array (:data:`BF16_BITS`), the form ``np.load`` gives the reference's
ml_dtypes leaves in; ``leaf_tensor`` also takes an ml_dtypes ``bfloat16``
array (as ``jax.device_get`` gives it).  Checkpoints and the models'
``params_from_numpy`` both read leaves through it."""
from __future__ import annotations

import numpy as np
import torch

# a bfloat16 leaf's bits (numpy has no bfloat16)
BF16_BITS = np.dtype("V2")


def leaf_numpy(leaf) -> np.ndarray:
    """A leaf as the numpy array a checkpoint stores: a tensor's values on
    the host, a bfloat16 tensor's bits as :data:`BF16_BITS`."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16_BITS)
        return t.numpy()
    return np.asarray(leaf)


def leaf_tensor(arr) -> torch.Tensor:
    """A CPU tensor of a numpy leaf (a restored one, :func:`leaf_numpy`'s,
    or any array-like): bfloat16's bits (:data:`BF16_BITS`, or an ml_dtypes
    ``bfloat16`` array) as a bfloat16 tensor, anything else as
    ``torch.from_numpy`` gives it (a read-only array, as a broadcast view,
    is copied first)."""
    arr = np.require(arr, requirements=["C", "W"])
    if arr.dtype == BF16_BITS or arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _is_named_tuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """(path segment, child) pairs of an inner node in JAX's order, or None
    for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if _is_named_tuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def leaves_with_path(tree, prefix: str = "") -> list:
    """(keystr path, leaf) pairs of ``tree`` in JAX's flatten order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [pair for seg, v in kids
            for pair in leaves_with_path(v, prefix + seg)]


def leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's flatten order."""
    return [v for _, v in leaves_with_path(tree)]


def unflatten(tree_like, values):
    """A tree of ``tree_like``'s structure (dicts with sorted keys, as JAX
    rebuilds them) holding the next items of the iterator ``values``."""
    if tree_like is None:
        return None
    kids = _children(tree_like)
    if kids is None:
        return next(values)
    if isinstance(tree_like, dict):
        return {k: unflatten(tree_like[k], values) for k in sorted(tree_like)}
    vals = [unflatten(v, values) for _, v in kids]
    if _is_named_tuple(tree_like):
        return type(tree_like)(*vals)
    return type(tree_like)(vals)


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees of ``rest``
    (each of ``tree``'s structure), as ``jax.tree.map``."""
    cols = [leaves(tree)] + [leaves(t) for t in rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees of different structure")
    return unflatten(tree, iter([fn(*xs) for xs in zip(*cols)]))
