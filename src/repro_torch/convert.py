"""Carry state across from the JAX package, given as numpy arrays.

Each function takes numpy arrays (or objects whose attributes are numpy
arrays, such as a ``jax.device_get`` of the reference's pytrees) and builds
the port's counterpart on ``device``: the card unless the caller asks for
the CPU (``device="cpu"``), as for the entry points.  With them a test
starts both packages from identical state.  This module imports no JAX: the
objects are read by attribute name only.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import gaussians as G
from repro_torch.core.camera import Intrinsics
from repro_torch.core.pruning import PruneState
from repro_torch.core.sorting import FragmentLists
from repro_torch.slam import datasets as D
from repro_torch.slam.engine import _Stage
from repro_torch.slam.map.paged import PageTable
from repro_torch.slam.metrics import DeviceWork
from repro_torch.slam.session import SLAMConfig, SlamSession, densify_picks
from repro_torch.train.optimizer import AdamState


def _t(x, device, dtype=None) -> torch.Tensor:
    # A copy: the source arrays may be read-only, and the port's session
    # writes its logs in place.
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def field_from_numpy(src, device=None) -> G.GaussianField:
    """A ``GaussianField`` from an object with numpy ``mu``, ``log_scale``,
    ``quat``, ``logit_o``, ``color`` and ``alive`` attributes."""
    dev = resolve_device(device)
    return G.GaussianField(**{f: _t(getattr(src, f), dev)
                              for f in G.PARAM_FIELDS + ("alive",)})


def adam_from_numpy(src, device=None) -> AdamState:
    """An ``AdamState`` from an object with ``step``, ``mu`` and ``nu``
    (the moments as dicts of numpy arrays)."""
    dev = resolve_device(device)
    return AdamState(step=_t(src.step, dev, torch.int32),
                     mu={k: _t(v, dev) for k, v in src.mu.items()},
                     nu={k: _t(v, dev) for k, v in src.nu.items()})


def dataset_from_numpy(src, device=None) -> D.SLAMDataset:
    """A dataset from an object with ``name``, ``intrinsics`` (fx, fy, cx,
    cy, width, height), ``frames`` (each with ``rgb``, ``depth``,
    ``w2c_gt``) and ``gt_field``."""
    dev = resolve_device(device)
    i = src.intrinsics
    intr = Intrinsics(float(i.fx), float(i.fy), float(i.cx), float(i.cy),
                      int(i.width), int(i.height))
    frames = [D.Frame(rgb=_t(f.rgb, dev, torch.float32),
                      depth=_t(f.depth, dev, torch.float32),
                      w2c_gt=np.asarray(f.w2c_gt, np.float32))
              for f in src.frames]
    return D.SLAMDataset(name=src.name, intrinsics=intr, frames=frames,
                         gt_field=field_from_numpy(src.gt_field, dev))


def _work_totals(src) -> list:
    """Counter totals of a reference work record: a hi/lo split record
    (``total = hi * 2**30 + lo``) or a flat one."""
    fields = DeviceWork._fields
    if hasattr(src, "hi"):
        return [int(getattr(src.hi, f)) * (1 << 30) + int(getattr(src.lo, f))
                for f in fields]
    return [int(getattr(src, f)) for f in fields]


def prune_state_from_numpy(src, device=None) -> PruneState:
    """A ``PruneState`` from an object with the reference's eleven leaves;
    the clocks (``interval``, ``iters_left``, ``opt_steps``) are () int32
    tensors, as there."""
    dev = resolve_device(device)
    dtypes = {"score": torch.float32, "grad_ema": torch.float32,
              "masked": torch.bool, "stable": torch.bool}
    return PruneState(**{f: _t(getattr(src, f), dev, dtypes.get(f, torch.int32))
                         for f in PruneState._fields})


def page_table_from_numpy(src, device=None) -> PageTable:
    """A ``PageTable`` from an object with numpy ``row2page``, ``lo``,
    ``hi`` and ``occupancy``."""
    dev = resolve_device(device)
    return PageTable(row2page=_t(src.row2page, dev, torch.int32),
                     lo=_t(src.lo, dev, torch.float32), hi=_t(src.hi, dev, torch.float32),
                     occupancy=_t(src.occupancy, dev, torch.int32))


def session_from_numpy(src, cfg: SLAMConfig, intr: Intrinsics, *,
                       device=None, seed: int = 0) -> SlamSession:
    """A session from every leaf of a reference session (numpy), its
    pruning state, parked churn baselines and page table included.

    The reference's densify PRNG key has no torch counterpart; the new
    session's pick table is drawn on a generator seeded with ``seed``
    (tests inject the reference's permutation instead)."""
    dev = resolve_device(device)
    rng = torch.Generator(device=dev)
    rng.manual_seed(seed)
    f = src.frags
    pstate = (prune_state_from_numpy(src.pstate, dev)
              if src.pstate is not None else None)
    return SlamSession(
        cfg=cfg, intr=intr, stages={1: _Stage(intr, cfg, dev)},
        g=field_from_numpy(src.g, dev),
        map_opt=adam_from_numpy(src.map_opt, dev),
        pstate=pstate,
        masked=_t(src.masked, dev, torch.bool),
        pose=_t(src.pose, dev, torch.float32),
        velocity=_t(src.velocity, dev, torch.float32),
        traj=_t(src.traj, dev, torch.float32),
        frame_idx=int(src.frame_idx),
        kf_rgb=_t(src.kf_rgb, dev, torch.float32),
        kf_depth=_t(src.kf_depth, dev, torch.float32),
        kf_w2c=_t(src.kf_w2c, dev, torch.float32),
        kf_count=_t(src.kf_count, dev, torch.int64),
        kf_total=_t(src.kf_total, dev, torch.int64),
        last_kf_idx=_t(src.last_kf_idx, dev, torch.int64),
        last_kf_rgb=_t(src.last_kf_rgb, dev, torch.float32),
        prev_rgb=_t(src.prev_rgb, dev, torch.float32),
        prev_depth=_t(src.prev_depth, dev, torch.float32),
        kf_psnr=_t(src.kf_psnr, dev, torch.float32),
        alive_log=_t(src.alive_log, dev, torch.int64),
        work=DeviceWork(*(torch.tensor(v, dtype=torch.int64, device=dev)
                          for v in _work_totals(src.work))),
        frags=FragmentLists(*(_t(x, dev, torch.int32) for x in f)),
        kf_picks=densify_picks(rng, intr, cfg, int(np.shape(src.traj)[0])), rng=rng,
        tile_baselines={int(k): _t(v, dev, torch.int32)
                        for k, v in src.tile_baselines.items()},
        page=(page_table_from_numpy(src.page, dev)
              if getattr(src, "page", None) is not None else None),
        last_kf_host=int(src.last_kf_idx) if cfg.keyframe.on_host else None,
    )


def _leaf(x, device) -> torch.Tensor:
    """A numpy leaf of the reference's LM trees as a tensor, bf16 bit for
    bit: JAX's bf16 arrives as ``ml_dtypes.bfloat16``, which
    ``torch.as_tensor`` refuses, so its bits cross as int16."""
    a = np.array(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    return _leaf(tree, device)


def lm_params_from_numpy(tree, device=None) -> dict:
    """The port's LM parameters from the reference's parameter tree (a dict
    of numpy arrays, as ``jax.device_get`` gives it): the same keys,
    shapes, dtypes and bits."""
    return _tree(tree, resolve_device(device))


def lm_cache_from_numpy(tree, device=None) -> dict:
    """A decode cache of the port from the reference's (``prefill``'s or
    ``pad_cache``'s, after ``jax.device_get``); ``len`` is a () int32
    tensor, as there."""
    out = _tree(tree, resolve_device(device))
    out["len"] = out["len"].to(torch.int32).reshape(())
    return out


def lm_adam_from_numpy(src, device=None) -> AdamState:
    """The reference's ``AdamState`` over an LM tree (``jax.device_get`` of
    it: ``step``, and ``mu`` / ``nu`` as nested dicts of numpy arrays) as
    the port's, bf16 moments bit for bit; ``step`` a () int32 tensor."""
    dev = resolve_device(device)
    return AdamState(step=_leaf(src.step, dev).to(torch.int32).reshape(()),
                     mu=_tree(src.mu, dev), nu=_tree(src.nu, dev))


def lm_train_state_from_numpy(state, device=None) -> dict:
    """A train state ``{"params", "opt": AdamState, "step"}`` of the
    reference's ``Trainer`` (after ``jax.device_get``) as the port's."""
    dev = resolve_device(device)
    return {"params": lm_params_from_numpy(state["params"], dev),
            "opt": lm_adam_from_numpy(state["opt"], dev),
            "step": int(state["step"])}
