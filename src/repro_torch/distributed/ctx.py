"""Activation-sharding context (the port of ``repro.distributed.ctx``).

The model code pins the layouts of its activations through this module
without threading mesh objects through every layer: the caller sets the
data-parallel, model and sequence axes before running the model, and
``constrain_batch`` / ``constrain_moe_dispatch`` then redistribute a
``DTensor`` activation to the placements the reference's
``with_sharding_constraint`` names.

They return their input itself, untouched, while the axes are unset, when
the batch dim is not divisible, or when the input is a plain tensor (one
card, or a rank's local shard): the model's outputs are then the same bit
for bit whether or not the context is set.

The axes are process state, as the reference's are: a caller that sets
them clears them (``set_dp_axes(None)``) when done.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.distributed.sharding import P, placements

_DP_AXES: Optional[Tuple[str, ...]] = None
_DP_SIZE: int = 1
_SEQ_AXIS: Optional[str] = None   # Megatron-style sequence parallelism
_SEQ_SIZE: int = 1
_MODEL_AXIS: Optional[str] = None
_MODEL_SIZE: int = 1


def set_dp_axes(axes: Optional[Tuple[str, ...]], size: int = 1):
    global _DP_AXES, _DP_SIZE
    _DP_AXES = tuple(axes) if axes else None
    _DP_SIZE = size


def set_model_axis(axis: Optional[str], size: int = 1):
    global _MODEL_AXIS, _MODEL_SIZE
    _MODEL_AXIS = axis
    _MODEL_SIZE = size


def set_seq_axis(axis: Optional[str], size: int = 1):
    """Enable sequence-parallel residual-stream sharding: layer-boundary
    activations (B, S, d) carry S on the TP axis."""
    global _SEQ_AXIS, _SEQ_SIZE
    _SEQ_AXIS = axis
    _SEQ_SIZE = size


def get_dp_axes():
    return _DP_AXES


def _constrain(x, spec: P):
    """``with_sharding_constraint(x, spec)``: a DTensor redistributed to the
    spec's placements on its own mesh; anything else as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(x.device_mesh.mesh_dim_names, spec))


def constrain_moe_dispatch(x: torch.Tensor) -> torch.Tensor:
    """Pin (B, E, C, d) dispatch tensors: batch on DP, experts on the TP
    axis (EP)."""
    if _DP_AXES is None or x.ndim != 4:
        return x
    if x.shape[0] % _DP_SIZE != 0:
        return x
    e_axis = _MODEL_AXIS if (_MODEL_AXIS and x.shape[1] % _MODEL_SIZE == 0) else None
    return _constrain(x, P(_DP_AXES, e_axis, None, None))


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """Pin dim 0 to DP (and dim 1 to the sequence axis when enabled)."""
    if _DP_AXES is None or x.ndim < 2:
        return x
    if x.shape[0] % _DP_SIZE != 0:
        return x
    seq = None
    if (_SEQ_AXIS is not None and x.ndim >= 3 and x.shape[1] % _SEQ_SIZE == 0
            and x.shape[1] >= _SEQ_SIZE):
        seq = _SEQ_AXIS
    return _constrain(x, P(_DP_AXES, seq, *([None] * (x.ndim - 2))))
