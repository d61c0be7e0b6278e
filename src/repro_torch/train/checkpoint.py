"""Atomic checkpoints in the reference's on-disk format (the port of
``repro/train/checkpoint.py``).

Format: ``<dir>/step_<N:08d>/`` holding one ``leaf_<i:05d>.npy`` per leaf
and ``manifest.json`` (``step``, and ``leaves``: each leaf's ``path``,
``file``, ``dtype`` and ``shape``).  bf16 leaves are stored as their
uint16 bits with ``"dtype": "bfloat16"`` in the manifest, since numpy
has no such dtype.  A save writes ``step_<N>.tmp``
and renames it, so a crash mid-save never leaves a partial checkpoint
that :func:`latest_step` would pick.

Sharded states (every rank of the process group calls :func:`save` and
:func:`restore`, on a file system they share): no rank ever holds a whole
``DTensor`` leaf.  Rank 0 lays out each leaf's ``.npy`` file at its full
shape, then every rank writes its local block into it through a memory
map (of replicated blocks, only the copy at mesh coordinate 0 is
written), and rank 0 publishes the manifest.  :func:`restore` with
``shardings`` reads each rank's block of its target placements straight
from a memory map of the file and builds the ``DTensor`` from it, so the
target mesh may differ from the one the state was saved from (elastic
remesh).

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


def _is_dtensor(v) -> bool:
    return torch.is_tensor(v) and hasattr(v, "full_tensor")


def _block(shape, device_mesh, placements, coord) -> tuple:
    """The slices of a ``DTensor``'s global array that the rank at mesh
    coordinate ``coord`` holds: each ``Shard(d)``, in mesh order, cuts the
    current extent of ``d`` into chunks as ``torch.chunk`` does."""
    lo, size = [0] * len(shape), list(shape)
    for i, p in enumerate(placements):
        if p.is_partial():
            raise ValueError("a Partial DTensor has no block to save: reduce it first")
        if p.is_shard():
            d = p.dim
            chunk = -(-size[d] // device_mesh.size(i))
            start = min(coord[i] * chunk, size[d])
            lo[d] += start
            size[d] = min(chunk, size[d] - start)
    return tuple(slice(a, a + n) for a, n in zip(lo, size))


def _to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def save(ckpt_dir: str, state: Any) -> str:
    step = int(state.get("step", 0)) if isinstance(state, dict) else 0
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    flat = _flatten(state)
    if any(_is_dtensor(v) for _, v in flat):
        return _save_sharded(final, step, flat)
    return _write(final, step, [(path, _to_numpy(v)) for path, v in flat])


def _save_sharded(final: str, step: int, flat: list) -> str:
    import torch.distributed as dist

    tmp, lead = final + ".tmp", dist.get_rank() == 0
    files = [os.path.join(tmp, f"leaf_{i:05d}.npy") for i in range(len(flat))]
    if lead:
        _fresh(tmp)
        manifest = {"step": step, "leaves": []}
        for fname, (path, v) in zip(files, flat):
            if _is_dtensor(v):
                arr, dtype_name = _to_numpy(torch.empty(0, dtype=v.dtype))
                np.lib.format.open_memmap(fname, mode="w+", dtype=arr.dtype,
                                          shape=tuple(v.shape))
                shape = list(v.shape)
            else:
                arr, dtype_name = _to_numpy(v)
                np.save(fname, arr)
                shape = list(arr.shape)
            manifest["leaves"].append({"path": "/".join(path), "file": os.path.basename(fname),
                                       "dtype": dtype_name, "shape": shape})
    dist.barrier()
    for fname, (_, v) in zip(files, flat):
        if not _is_dtensor(v):
            continue
        dm, coord = v.device_mesh, v.device_mesh.get_coordinate()
        if any(c and not p.is_shard() for c, p in zip(coord, v.placements)):
            continue   # a replica of a block that the rank at coordinate 0 writes
        arr = np.load(fname, mmap_mode="r+")
        arr[_block(v.shape, dm, v.placements, coord)] = _to_numpy(v.to_local())[0]
        arr.flush()
        del arr
    dist.barrier()
    if lead:
        _publish(tmp, final, manifest)
    dist.barrier()
    return final


def _fresh(tmp: str):
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)


def _publish(tmp: str, final: str, manifest: dict) -> str:
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


def _write(final: str, step: int, leaves: list) -> str:
    tmp = final + ".tmp"
    _fresh(tmp)
    manifest = {"step": step, "leaves": []}
    for i, (path, (arr, dtype_name)) in enumerate(leaves):
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({"path": "/".join(path), "file": fname,
                                   "dtype": dtype_name, "shape": list(arr.shape)})
    return _publish(tmp, final, manifest)


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
            device=None, shardings: Any = None) -> Any:
    """Load a checkpoint onto ``device`` (the card unless the caller asks
    for the CPU).  With ``template`` (a tree of like structure; its leaves
    are not read, so tensors on the ``meta`` device do) the structure is
    rebuilt exactly, NamedTuples included; without it, nested dicts from the
    recorded paths, digit-keyed levels as tuples (as the reference's).

    With ``shardings`` (a tree like the state's of
    ``distributed.sharding.NamedSharding``, or None for a leaf to load onto
    ``device`` whole) each rank reads only its block of each leaf's
    placements, onto the device type of that sharding's mesh: elastic
    remesh, every rank of the mesh calling this."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    shard_of = {} if shardings is None else {"/".join(p): s for p, s in _flatten(shardings)}
    leaves = {leaf["path"]: _load(os.path.join(d, leaf["file"]), leaf["dtype"], dev,
                                  shard_of.get(leaf["path"]))
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


def _load(fname: str, dtype: str, device, sharding) -> torch.Tensor:
    """One leaf: whole onto ``device``, or with a ``NamedSharding`` this
    rank's block of it as a ``DTensor``."""
    if sharding is None:
        return _to_tensor(np.load(fname), dtype, device)
    from torch.distributed.tensor import DTensor

    dm, pl = sharding.mesh.device_mesh, sharding.placements
    if dm is None:
        raise ValueError("the mesh has no DeviceMesh: start a process group whose "
                         "world size is the mesh's size before making the mesh")
    arr = np.load(fname, mmap_mode="r")
    local = np.ascontiguousarray(arr[_block(arr.shape, dm, pl, dm.get_coordinate())])
    shape = torch.Size(arr.shape)
    return DTensor.from_local(_to_tensor(local, dtype, dm.device_type), dm, pl, run_check=False,
                              shape=shape, stride=torch.empty(shape, device="meta").stride())


def _renest(tree):
    """Digit-keyed dicts back into tuples (NamedTuple-ish states round-trip
    as plain tuples, as in the reference)."""
    if isinstance(tree, dict):
        if tree and all(isinstance(k, str) and k.isdigit() for k in tree):
            return tuple(_renest(tree[k]) for k in sorted(tree, key=int))
        return {k: _renest(v) for k, v in tree.items()}
    return tree
