"""The port's ``kernel_norb`` backend, the R&B Buffer ablation (the
reference's ``pallas_norb``): its forward keeps no stash and its backward
re-runs K1 to regenerate it.  K1 is deterministic, so it equals the
``kernel`` backend bit for bit (images and every gradient, 1 and 4 views);
against the reference's interpreted ``pallas_norb`` its gradients agree
within the backward tolerance max(3e-6, 3e-5 max|g|).  On the CPU K1 and
K2 run as their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_grads_close, jx, np_, th, tiny_cloud
from _torch_parity import first_cpu_exp_spent  # noqa: F401  (autouse fixture)
from _torch_parity import one_cpu_thread  # noqa: F401  (autouse fixture)
from repro.core import gaussians as JG
from repro.core import lie as jlie
from repro.core.camera import Camera as JCamera
from repro.core.camera import Intrinsics as JIntr
from repro.core.camera import look_at as jlook_at
from repro.core.raster_api import RasterPlan as JPlan
from repro.core.render import render as jrender
from repro.core.sorting import make_tile_grid as jgrid
from repro_torch.core import gaussians as TG
from repro_torch.core import lie as tlie
from repro_torch.core.camera import Camera as TCamera
from repro_torch.core.camera import Intrinsics as TIntr
from repro_torch.core.raster_api import RasterPlan as TPlan
from repro_torch.core.render import render as trender
from repro_torch.core.sorting import make_tile_grid as tgrid
from repro_torch.kernels import tile_render

HW, CAP = 64, 64
INTR = dict(fx=80.0, fy=80.0, cx=32.0, cy=32.0, width=HW, height=HW)
PARAMS = ("mu", "log_scale", "quat", "logit_o", "color")
XI0 = np.array([0.01, -0.01, 0.02, 0.01, -0.02, 0.01], np.float32)


def _inputs(views, seed=0):
    pts, cols, cap = tiny_cloud(seed)
    w2c = np.asarray(jlook_at(jnp.zeros(3), jnp.array([0.0, 0.0, 3.0]),
                              jnp.array([0.0, -1.0, 0.0])))
    r = np.random.default_rng(9)
    xis = [np.zeros(6, np.float32)] + [(r.normal(size=6) * 0.05).astype(np.float32)
                                       for _ in range((views or 1) - 1)]
    poses = np.stack([np.asarray(jlie.se3_exp(jx(x))) @ w2c for x in xis])
    poses = poses[0] if views is None else poses
    target = np.random.default_rng(3).uniform(size=(HW, HW, 3)).astype(np.float32)
    return pts, cols, cap, poses.astype(np.float32), target


def _port(backend, views):
    """Images and the gradients of every Gaussian parameter and the pose
    tangent under ``backend``; also K1's launches and plain calls."""
    pts, cols, cap, poses, target = _inputs(views)
    g = TG.from_points(th(pts), th(cols), capacity=cap, scale=0.08, opacity=0.8)
    params = {k: v.clone().requires_grad_(True) for k, v in TG.params_of(g).items()}
    xi = th(XI0, requires_grad=True)
    calls0 = tile_render.tile_render_fwd_plain.calls
    out = trender(TG.with_params(g, params),
                  TCamera(TIntr(**INTR), tlie.se3_exp(xi) @ th(poses)),
                  TPlan(grid=tgrid(HW, HW), backend=backend, capacity=CAP),
                  device="cpu")
    loss = (((out.image - th(target)) ** 2).mean() + 0.1 * out.depth.mean()
            + 0.05 * out.alpha.mean())
    grads = torch.autograd.grad(loss, [params[k] for k in PARAMS] + [xi])
    fwd_calls = tile_render.tile_render_fwd_plain.calls - calls0
    return (out.image, out.depth, out.alpha), grads, fwd_calls


@pytest.mark.parametrize("views", [None, 4])
def test_norb_equals_kernel_bitwise(views):
    img_k, g_k, calls_k = _port("kernel", views)
    img_n, g_n, calls_n = _port("kernel_norb", views)
    for a, b in zip(img_n, img_k):
        assert torch.equal(a, b)
    for name, a, b in zip(PARAMS + ("xi",), g_n, g_k):
        assert torch.equal(a, b), name
    # One stacked forward, and one more K1 run in the backward.
    assert (calls_k, calls_n) == (1, 2)


@pytest.mark.parametrize("views", [None, 3])
def test_norb_gradients_match_pallas_norb(views):
    pts, cols, cap, poses, target = _inputs(views)
    g_j = JG.from_points(jx(pts), jx(cols), capacity=cap, scale=0.08, opacity=0.8)
    plan = JPlan(grid=jgrid(HW, HW), backend="pallas_norb", capacity=CAP)

    def loss_j(params, xi):
        cam = JCamera(JIntr(**INTR), jlie.se3_exp(xi) @ jx(poses))
        out = jrender(JG.with_params(g_j, params), cam, plan)
        return (jnp.mean((out.image - jx(target)) ** 2) + 0.1 * jnp.mean(out.depth)
                + 0.05 * jnp.mean(out.alpha))

    gp_j, gxi_j = jax.grad(loss_j, argnums=(0, 1))(JG.params_of(g_j), jx(XI0))
    _, grads, _ = _port("kernel_norb", views)
    assert_grads_close([gp_j[k] for k in PARAMS] + [gxi_j], grads,
                       list(PARAMS) + ["xi"])
    assert all(np.isfinite(np_(g)).all() for g in grads)
