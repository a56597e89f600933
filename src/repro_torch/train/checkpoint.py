"""Checkpointing (port of `repro.train.checkpoint`) with atomic commits,
in the reference's on-disk layout:

    <dir>/step_<N>/
        manifest.json   (step, and each leaf's dtype and shape by path)
        arrays.npz      (the leaves, keyed by path with "/" -> "__")

A state is a tree of nested dicts (lists and tuples by index) of tensors;
a leaf's path joins its keys with "/".  Writes go to a tmp directory and
are renamed into place, so a crash mid-save never corrupts the latest
checkpoint; the oldest beyond `keep` are removed.  bf16 leaves are stored
as uint16 views (npz has no bfloat16).  `restore` reads into the
structure of a like-state, each leaf on `device` (else the like leaf's).
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch


def flatten(tree, prefix: str = "") -> dict:
    """{path: leaf} of a tree of dicts / lists / tuples, in tree order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for key, node in items:
        out.update(flatten(node, f"{prefix}/{key}" if prefix else str(key)))
    return out


def unflatten(like, leaves: dict, prefix: str = ""):
    """A tree shaped like `like` with each leaf taken from {path: leaf}."""
    if isinstance(like, dict):
        return {k: unflatten(v, leaves, f"{prefix}/{k}" if prefix else str(k))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(unflatten(v, leaves, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(like))
    return leaves[prefix]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def save(directory: str, step: int, tree, keep: int = 3) -> str:
    flat = flatten(tree)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrays, manifest = {}, {"step": step, "leaves": {}}
    for key, leaf in flat.items():
        t = leaf.detach().cpu()
        dtype = _dtype_name(t)
        arr = t.view(torch.int16).numpy().view(np.uint16) if dtype == "bfloat16" \
            else t.numpy()
        arrays[key.replace("/", "__")] = arr
        manifest["leaves"][key] = {"dtype": dtype, "shape": list(arr.shape)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int):
    steps = sorted(all_steps(directory))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)


def all_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_step(directory: str):
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: int, like_tree, device=None):
    """The checkpoint of `step` in the structure of `like_tree`: new
    tensors, each on `device`, else on its like leaf's device."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    arrays = np.load(os.path.join(path, "arrays.npz"))
    leaves = {}
    for key, like in flatten(like_tree).items():
        arr = arrays[key.replace("/", "__")]
        if manifest["leaves"][key]["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr.copy())
        leaves[key] = t.to(like.device if device is None else device)
    return unflatten(like_tree, leaves)
