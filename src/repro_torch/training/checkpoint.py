"""Tree checkpointing to a directory of .npy files + a structure index:
the reference's on-disk format (``repro.training.checkpoint``).

``index.json`` holds the step and, for each leaf, its path (``d:`` a
dict key, ``l:`` a list index, ``t:`` a tuple index, joined by ``/``),
its file ``leaf_i.npy`` and its dtype name.  numpy cannot store bf16 or
float8, so such a leaf is written as its bit pattern (``uint16`` /
``uint8``) under its own dtype name and viewed back through torch on
restore (no ``ml_dtypes``).  ``restore`` reads a directory the
reference's ``save`` wrote into the same tree, its leaves as CPU
tensors; the port's own trees (dicts of tensors keyed by parameter
name, an ``AdamWState`` tuple) go both ways alike."""
from __future__ import annotations

import json
import os
from typing import Any, List, Tuple

import numpy as np
import torch

# numpy cannot natively persist bf16/f8: store bit patterns + dtype name
_EXTENDED = {"bfloat16": (torch.bfloat16, np.uint16, torch.int16),
             "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, torch.uint8)}


def _flatten(tree, path="") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{path}/d:{k}")
        return out
    if isinstance(tree, (list, tuple)):
        tag = "l" if isinstance(tree, list) else "t"
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, f"{path}/{tag}:{i}")
        return out
    return [(path, tree)]


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the array written to disk and its dtype name."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach().cpu()
    name = str(t.dtype).removeprefix("torch.")
    if name in _EXTENDED:
        _, np_bits, torch_bits = _EXTENDED[name]
        return t.view(torch_bits).numpy().view(np_bits), name
    return t.numpy(), name


def _to_torch(arr: np.ndarray, name: str) -> torch.Tensor:
    if name in _EXTENDED:
        dt, _, torch_bits = _EXTENDED[name]
        bits = arr.view(np.int16) if torch_bits == torch.int16 else arr
        return torch.from_numpy(bits).view(dt)
    return torch.from_numpy(arr)


def save(path: str, tree: Any, step: int = 0) -> None:
    os.makedirs(path, exist_ok=True)
    leaves = _flatten(tree)
    index = {"step": step, "leaves": []}
    for i, (p, leaf) in enumerate(leaves):
        arr, dtype_name = _to_numpy(leaf)
        np.save(os.path.join(path, f"leaf_{i}.npy"), arr)
        index["leaves"].append({"path": p, "file": f"leaf_{i}.npy",
                                "dtype": dtype_name})
    with open(os.path.join(path, "index.json"), "w") as f:
        json.dump(index, f)


def restore(path: str) -> Tuple[Any, int]:
    """(tree, step): dicts, lists and tuples as saved, every leaf a CPU
    tensor of its saved dtype."""
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    tree: Any = None
    for ent in index["leaves"]:
        arr = _to_torch(np.load(os.path.join(path, ent["file"])),
                        ent["dtype"])
        tree = _insert(tree, ent["path"].strip("/").split("/"), arr)
    tree = _finalize(tree)
    return tree, index["step"]


def _insert(tree, parts, value):
    if not parts:
        return value
    tag, key = parts[0].split(":", 1)
    if tag == "d":
        tree = tree if isinstance(tree, dict) else {}
        tree[key] = _insert(tree.get(key), parts[1:], value)
        return tree
    # list/tuple: store as dict of ints + tag marker, finalize later
    tree = tree if isinstance(tree, dict) else {}
    tree["__seq__"] = tag
    tree[int(key)] = _insert(tree.get(int(key)), parts[1:], value)
    return tree


def _finalize(tree):
    if isinstance(tree, dict):
        if "__seq__" in tree:
            tag = tree.pop("__seq__")
            items = [_finalize(tree[i]) for i in sorted(tree)]
            return tuple(items) if tag == "t" else items
        return {k: _finalize(v) for k, v in tree.items()}
    return tree
