"""PyTorch/CUDA port of the RTGS 3DGS-SLAM reproduction.

``repro_torch`` mirrors ``repro``'s layout (``core``, ``kernels``, ``slam``,
``train``) so each module's counterpart is easy to find.  It imports
``torch`` and numpy only: nothing of JAX and nothing of the ``repro``
package.  The rasterizer's forward (K1) and backward (K2) are CUDA C++
kernels for Hopper (``csrc/``), built with ``nvcc`` at first use.

Precision is set here, once, for the whole package: float32 matrix
products and convolutions must not drop to TF32 on the card.  The
projection's small products (``core/projection.py``: the camera transform
and the ``J W Sigma W^T J^T`` covariance chain) feed conics whose
determinant is a difference of near-equal terms; TF32 keeps ~3 decimal
digits and would move splat footprints by whole pixels.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from repro_torch._device import resolve_device  # noqa: E402

__all__ = ["resolve_device"]
