"""The port on a card: the CUDA kernels K1 and K2 against their plain
versions, the ``kernel`` backend against the ``ref`` backend, and the
default entry points.  Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false.

The file imports neither JAX nor ``repro``, so it runs on a machine that
has only PyTorch; there, skip the JAX fixtures of ``tests/conftest.py``::

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from _kernel_inputs import random_attrs
from repro_torch.core import gaussians as G
from repro_torch.core.camera import Camera, Intrinsics, look_at
from repro_torch.core.raster_api import RasterPlan
from repro_torch.core.render import render
from repro_torch.core.sorting import make_tile_grid
from repro_torch.kernels.tile_render import tile_render_fwd, tile_render_fwd_plain
from repro_torch.kernels.tile_render_bp import tile_render_bwd, tile_render_bwd_plain

pytestmark = pytest.mark.cuda

FWD_ATOL, FWD_RTOL, DEPTH_TOL = 2e-5, 1e-4, 1e-4


@pytest.fixture
def dev():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _grad_atol(ref: torch.Tensor) -> float:
    return max(3e-6, 3e-5 * float(ref.abs().max()))


def _attrs(seed, rows, cap, height, width, near_tile=False):
    a, c = random_attrs(seed, rows, cap, height, width, sparse=True,
                        near_tile=near_tile)
    return torch.as_tensor(a), torch.as_tensor(c)


def _close(got, want, atol, rtol=0.0):
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("hw,cap,chunk,views,near_tile", [
    ((32, 32), 32, 16, 1, False),
    ((48, 64), 64, 16, 3, False),
    ((64, 64), 128, 32, 1, False),
    ((480, 640), 256, 16, 1, False),
    ((480, 640), 256, 16, 2, True),   # saturated tiles: chunk skips
])
def test_cuda_kernels_match_plain(dev, hw, cap, chunk, views, near_tile):
    grid = make_tile_grid(*hw)
    tiles = grid.num_tiles
    attrs, count = _attrs(7, views * tiles, cap, *hw, near_tile=near_tile)
    a, c = attrs.to(dev), count.to(dev)
    kw = dict(chunk=chunk, tiles_per_view=tiles)
    got = tile_render_fwd(a, c, grid, **kw)
    want = tile_render_fwd_plain(a, c, grid, **kw)
    torch.cuda.synchronize()
    for name, g, w in zip(("color", "depth", "final_T", "stash"), got, want):
        tol = DEPTH_TOL if name == "depth" else FWD_ATOL
        rtol = DEPTH_TOL if name == "depth" else FWD_RTOL
        _close(g, w, tol, rtol)
    r = np.random.default_rng(8)
    cots = [torch.as_tensor(r.normal(size=s).astype(np.float32), device=dev)
            for s in ((views * tiles, 3, 256), (views * tiles, 256),
                      (views * tiles, 256))]
    gg = tile_render_bwd(a, c, got[3], *cots, grid, **kw)
    gw = tile_render_bwd_plain(a, c, got[3], *cots, grid, **kw)
    torch.cuda.synchronize()
    _close(gg, gw, _grad_atol(gw))


def test_cuda_wrappers_reject_non_contiguous_operands(dev):
    grid = make_tile_grid(32, 32)
    attrs, count = _attrs(3, grid.num_tiles, 32, 32, 32)
    a = attrs.to(dev).transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tile_render_fwd(a, count.to(dev), grid)


def _scene(dev):
    r = np.random.default_rng(0)
    pts = r.uniform(-1, 1, (200, 3)) * np.array([1.5, 1.0, 0.5]) + np.array([0, 0, 3.0])
    g = G.from_points(torch.as_tensor(pts, dtype=torch.float32, device=dev),
                      torch.as_tensor(r.uniform(0, 1, (200, 3)), dtype=torch.float32,
                                      device=dev),
                      capacity=256, scale=0.08, opacity=0.8)
    w2c = look_at(torch.zeros(3, device=dev), torch.tensor([0.0, 0.0, 3.0], device=dev),
                  torch.tensor([0.0, -1.0, 0.0], device=dev))
    return g, Camera(Intrinsics(80.0, 80.0, 32.0, 32.0, 64, 64), w2c)


def test_cuda_kernel_backend_matches_ref_backend(dev):
    """Images and the gradients of every Gaussian parameter: K1 + K2 + GMU
    against autograd through the plain tensor oracle, both on the card."""
    g, cam = _scene(dev)
    target = torch.rand((64, 64, 3), generator=torch.Generator().manual_seed(1)).to(dev)
    res = {}
    for backend in ("kernel", "ref"):
        params = {k: v.clone().requires_grad_(True) for k, v in G.params_of(g).items()}
        out = render(G.with_params(g, params), cam,
                     RasterPlan(grid=make_tile_grid(64, 64), backend=backend,
                                capacity=64))
        loss = ((out.image - target) ** 2).mean() + 0.1 * out.depth.mean()
        res[backend] = (out, torch.autograd.grad(loss, list(params.values())))
    _close(res["kernel"][0].image, res["ref"][0].image, FWD_ATOL, FWD_RTOL)
    _close(res["kernel"][0].depth, res["ref"][0].depth, DEPTH_TOL, DEPTH_TOL)
    for gk, gr in zip(res["kernel"][1], res["ref"][1]):
        _close(gk, gr, _grad_atol(gr))


def test_cuda_session_runs_through_the_kernels(dev):
    """The default entry points run on the card, and the SLAM session goes
    through K1 and K2, never through their plain versions."""
    from repro_torch.core.keyframes import KeyframePolicy
    from repro_torch.slam.datasets import make_dataset
    from repro_torch.slam.session import SLAMConfig, run_sequence

    ds = make_dataset("room0", num_frames=5, height=64, width=64,
                      num_gaussians=400, frag_capacity=48)
    assert ds.frames[0].rgb.device.type == "cuda"
    counts = (tile_render_fwd.launches, tile_render_bwd.launches,
              tile_render_fwd_plain.calls, tile_render_bwd_plain.calls)
    res = run_sequence(ds, SLAMConfig(iters_track=3, iters_map=4, capacity=1024,
                                      frag_capacity=48, map_window=2,
                                      keyframe=KeyframePolicy(interval=2)))
    after = (tile_render_fwd.launches, tile_render_bwd.launches,
             tile_render_fwd_plain.calls, tile_render_bwd_plain.calls)
    assert after[0] > counts[0] and after[1] > counts[1]
    assert after[2:] == counts[2:]
    assert np.isfinite(res.ate) and len(res.keyframe_psnr) == 3
    assert all(np.isfinite(p) for p in res.keyframe_psnr)
