"""Session state compared bit for bit, for the port's tests and
``chip_smoke.py``.  Imports neither JAX nor ``repro``, so the card tests
and the smoke run use it on a machine that has only PyTorch."""

import dataclasses

import torch


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, NaNs included."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(),
                                                                 b.nan_to_num())
    return torch.equal(a, b)


def tree_tensors(tree) -> list:
    """Every tensor a session (or any nesting of dataclasses, NamedTuples,
    dicts and lists) holds, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        items = [tree[k] for k in sorted(tree)]
    elif dataclasses.is_dataclass(tree):
        items = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, (tuple, list)):
        items = list(tree)
    else:
        return []
    return [t for x in items for t in tree_tensors(x)]


def same_session(a, b) -> bool:
    """Two port sessions hold the same state bit for bit: every tensor,
    the host clocks and counts, and the densify generator's state."""
    host = ("frame_idx", "kf_count", "kf_total", "last_kf_idx")
    if any(getattr(a, f) != getattr(b, f) for f in host):
        return False
    if (a.pstate is None) != (b.pstate is None):
        return False
    if a.pstate is not None and any(
            getattr(a.pstate, f) != getattr(b.pstate, f)
            for f in ("interval", "iters_left", "opt_steps")):
        return False
    ta, tb = tree_tensors(a), tree_tensors(b)
    return (len(ta) == len(tb) and all(same_bits(x, y) for x, y in zip(ta, tb))
            and torch.equal(a.rng.get_state(), b.rng.get_state()))
