"""Atomic checkpoints in the reference's on-disk format (the port of
``repro/train/checkpoint.py``).

Format: ``<dir>/step_<N:08d>/`` holding one ``leaf_<i:05d>.npy`` per leaf
and ``manifest.json`` (``step``, and ``leaves``: each leaf's ``path``,
``file``, ``dtype`` and ``shape``).  bf16 leaves are stored as their
uint16 bits with ``"dtype": "bfloat16"`` in the manifest, since numpy
has no such dtype.  A save writes ``step_<N>.tmp``
and renames it, so a crash mid-save never leaves a partial checkpoint
that :func:`latest_step` would pick.

The leaf order and path strings are the reference's ``_flatten``: dict keys
sorted at every level, a NamedTuple's fields in order as ``.<field>``, a
tuple's items by index, joined with ``/``.  A train state ``{"params",
"opt": AdamState, "step"}`` gives ``opt/.step``, ``opt/.mu/<key path>``,
``opt/.nu/...``, ``params/...``, then ``step``.  So a checkpoint saved by
either package restores in the other.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device



def _flatten(tree, prefix=()):
    """[(path tuple, leaf)] in the reference's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields for x in _flatten(getattr(tree, f), prefix + (f".{f}",))]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in _flatten(v, prefix + (str(i),))]
    return [(prefix, tree)]


def _to_numpy(v) -> tuple:
    """(array to store, logical dtype name)."""
    if torch.is_tensor(v):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:  # its bits, through int16
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(v)
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def save(ckpt_dir: str, state: Any) -> str:
    step = int(state.get("step", 0)) if isinstance(state, dict) else 0
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    manifest = {"step": step, "leaves": []}
    for i, (path, v) in enumerate(_flatten(state)):
        arr, dtype_name = _to_numpy(v)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({"path": "/".join(path), "file": fname,
                                   "dtype": dtype_name, "shape": list(arr.shape)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _rebuild(template, prefix, leaves: dict):
    """``template``'s structure with each leaf taken from ``leaves`` by its
    path."""
    if isinstance(template, dict):
        return {k: _rebuild(v, prefix + (str(k),), leaves) for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(getattr(template, f), prefix + (f".{f}",), leaves)
                                for f in template._fields))
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(v, prefix + (str(i),), leaves)
                              for i, v in enumerate(template))
    return leaves.pop("/".join(prefix))


def restore(ckpt_dir: str, step: Optional[int] = None, template: Any = None,
            device=None) -> Any:
    """Load a checkpoint onto ``device`` (the card unless the caller asks
    for the CPU).  With ``template`` (a tree of like structure; its leaves
    are not read, so tensors on the ``meta`` device do) the structure is
    rebuilt exactly, NamedTuples included; without it, nested dicts from the
    recorded paths, digit-keyed levels as tuples (as the reference's)."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = {leaf["path"]: _to_tensor(np.load(os.path.join(d, leaf["file"])),
                                       leaf["dtype"], dev)
              for leaf in manifest["leaves"]}

    if template is not None:
        state = _rebuild(template, (), leaves)
        if leaves:
            raise ValueError(f"checkpoint leaves not in the template: {sorted(leaves)}")
    else:
        state: Any = {}
        for path, t in leaves.items():
            keys = path.split("/")
            node = state
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = t
        state = _renest(state)
    if isinstance(state, dict) and "step" in state:
        state["step"] = int(state["step"])
    return state


def _renest(tree):
    """Digit-keyed dicts back into tuples (NamedTuple-ish states round-trip
    as plain tuples, as in the reference)."""
    if isinstance(tree, dict):
        if tree and all(isinstance(k, str) and k.isdigit() for k in tree):
            return tuple(_renest(tree[k]) for k in sorted(tree, key=int))
        return {k: _renest(v) for k, v in tree.items()}
    return tree
