"""Device selection for the port's entry points.

The entry points (``session_init``, ``run_sequence``, ``render``,
``make_dataset``) run on the card unless the caller asks for the CPU.  A
request for the card on a machine without one raises: nothing carries on
on the CPU in its place.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none was "
            "found; pass device='cpu' to run the plain PyTorch versions")
    return dev


def check_on(t: torch.Tensor, dev: torch.device, what: str) -> None:
    """Raise if ``t`` does not live on ``dev``'s device type."""
    if t.device.type != dev.type:
        raise ValueError(f"{what} is on {t.device}, expected {dev}")


_CONSTANTS: dict = {}


def constant(value, dtype: torch.dtype, device) -> torch.Tensor:
    """A constant tensor of ``value`` (a number or a nested sequence), made
    once per (value, dtype, device) and shared by every caller, who must
    not write to it.  ``torch.tensor(value, device="cuda")`` copies from
    pageable host memory on every call, which a CUDA graph capture cannot
    record; a cached constant is made on the first, eager, call."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:  # "cuda" is cuda:<current>
        device = torch.device("cuda", torch.cuda.current_device())
    key = (repr(value), dtype, device)
    if key not in _CONSTANTS:
        _CONSTANTS[key] = torch.tensor(value, dtype=dtype, device=device)
    return _CONSTANTS[key]
