"""Native checkpoint format: a flat .npz of the params pytree.

Replaces torch ``state_dict`` files for models trained with this engine; the torch
converter (convert.py) remains the bridge for reference-published .ckpt files.
"""

from __future__ import annotations

import numpy as np


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + str(k) + "/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + str(i) + "/")
    else:
        yield prefix[:-1], np.asarray(tree)


def save_params(path: str, params) -> None:
    flat = dict(_flatten(params))
    np.savez_compressed(path, **flat)


def load_params(path: str) -> dict:
    data = np.load(path)
    tree: dict = {}
    for key in data.files:
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[key]
    return _listify(tree)


def _listify(node):
    """Convert dicts whose keys are 0..n-1 ints back into lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    keys = list(out.keys())
    if keys and all(k.isdigit() for k in keys):
        idx = sorted(int(k) for k in keys)
        if idx == list(range(len(idx))):
            return [out[str(i)] for i in idx]
    return out
