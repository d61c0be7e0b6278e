"""End-to-end differentiable 3DGS rendering (counterpart of
``repro/core/render.py``).

``render`` composes projection (Step 1), fragment lists (Steps 1-2 and 2,
reusable across iterations), rasterization through the backend registry
(Step 3) and the background composite.  Autograd through it gives the
Rendering BP (the ``kernel`` backend's K2 + GMU) and the Preprocessing BP
(autograd of ``project``) including the camera-pose gradients.

``cam.w2c`` of shape (4, 4) renders one view; (B, 4, 4) renders B views,
projected and fragment-built one view at a time (the (T, N) membership of
a full-size view is ~0.8 GB), rasterized by ONE stacked kernel launch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch._device import check_on, constant, resolve_device
from repro_torch.core.camera import Camera
from repro_torch.core.gaussians import GaussianField
from repro_torch.core.projection import ProjectedGaussians, project
from repro_torch.core.raster_api import RasterInputs, RasterPlan
from repro_torch.core.sorting import (
    FragmentLists, build_fragment_lists, stack_fragment_lists,
)
from repro_torch.kernels import ops


class RenderOutput(NamedTuple):
    image: torch.Tensor    # (H, W, 3) composited color   [(B, ...) batched]
    depth: torch.Tensor    # (H, W) blended depth (alpha-premultiplied)
    alpha: torch.Tensor    # (H, W) coverage = 1 - final transmittance
    final_t: torch.Tensor  # (H, W)
    frags: FragmentLists
    proj: ProjectedGaussians


def _composite(color_pm, depth_pm, final_t, frags, proj, background):
    bg = constant(tuple(float(c) for c in background), torch.float32, color_pm.device)
    image = color_pm + final_t[..., None] * bg
    return RenderOutput(image=image, depth=depth_pm, alpha=1.0 - final_t,
                        final_t=final_t, frags=frags, proj=proj)


def render(g: GaussianField, cam: Camera, plan: RasterPlan,
           frags: Optional[FragmentLists] = None, *,
           background=(0.0, 0.0, 0.0), keep: Optional[torch.Tensor] = None,
           device=None) -> RenderOutput:
    """Render ``g`` from ``cam`` under ``plan``.

    Runs on the card unless ``device="cpu"``; the field and camera must
    already live there.  Pass cached ``frags`` (leading B when batched) to
    reuse fragment lists across iterations.  ``keep`` (an (N,) bool mask)
    goes to the fragment build when ``frags`` is None: rows outside it
    render nothing (sparse mapping passes ``~stable``)."""
    dev = resolve_device(device)
    check_on(g.mu, dev, "the Gaussian field")
    check_on(cam.w2c, dev, "the camera pose")
    if cam.w2c.ndim == 2:
        proj = project(g, cam)
        if frags is None:
            frags = build_fragment_lists(proj, plan.grid, plan.capacity, keep)
        out = ops.rasterize(RasterInputs.from_projection(proj, frags), plan)
        return _composite(*out, frags, proj, background)

    views = cam.w2c.shape[0]
    projs = [project(g, Camera(cam.intrinsics, cam.w2c[b])) for b in range(views)]
    if frags is None:
        frags = stack_fragment_lists([
            build_fragment_lists(p, plan.grid, plan.capacity, keep) for p in projs])
    proj = ProjectedGaussians(*(torch.stack(xs) for xs in zip(*projs)))
    out = ops.rasterize(RasterInputs.from_projection(proj, frags), plan)
    return _composite(*out, frags, proj, background)
