"""Parity of the port's rendering with ``repro``: single-view and batched
renders, and their gradients, through the port's ``kernel`` backend (K1
and K2 run as their plain versions on the CPU) against ``repro``'s ``ref``
backend and its interpreted ``pallas`` backend, on a ``tiny_scene``-sized
cloud (200 Gaussians, 64x64, K=64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    DEPTH_TOL, FWD_ATOL, FWD_RTOL, assert_grads_close, jx, np_, th, tiny_cloud,
)
from _torch_parity import first_cpu_exp_spent  # noqa: F401  (autouse fixture)
from _torch_parity import one_cpu_thread  # noqa: F401  (autouse fixture)
from repro.core import gaussians as JG
from repro.core import lie as jlie
from repro.core.camera import Camera as JCamera
from repro.core.camera import Intrinsics as JIntr
from repro.core.camera import look_at as jlook_at
from repro.core.projection import project as jproject
from repro.core.raster_api import RasterInputs as JInputs
from repro.core.raster_api import RasterPlan as JPlan
from repro.core.render import render as jrender
from repro.core.sorting import build_fragment_lists as jbuild
from repro.core.sorting import make_tile_grid as jgrid
from repro.kernels import ops as jops
from repro_torch.core import gaussians as TG
from repro_torch.core import lie as tlie
from repro_torch.core.camera import Camera as TCamera
from repro_torch.core.camera import Intrinsics as TIntr
from repro_torch.core.raster_api import RasterInputs as TInputs
from repro_torch.core.raster_api import RasterPlan as TPlan
from repro_torch.core.render import render as trender
from repro_torch.core.sorting import FragmentLists
from repro_torch.core.sorting import make_tile_grid as tgrid
from repro_torch.kernels import ops as tops

HW, CAP = 64, 64
INTR = dict(fx=80.0, fy=80.0, cx=32.0, cy=32.0, width=HW, height=HW)
PARAMS = ("mu", "log_scale", "quat", "logit_o", "color")
RASTER_LEAVES = ("mu2d", "conic", "color", "opacity", "depth")


def _scene(seed=0):
    pts, cols, cap = tiny_cloud(seed)
    g_j = JG.from_points(jx(pts), jx(cols), capacity=cap, scale=0.08, opacity=0.8)
    g_t = TG.from_points(th(pts), th(cols), capacity=cap, scale=0.08, opacity=0.8)
    w2c = np_(jlook_at(jnp.zeros(3), jnp.array([0.0, 0.0, 3.0]),
                       jnp.array([0.0, -1.0, 0.0])))
    return g_j, g_t, w2c


def _poses(w2c, views):
    """``views`` nearby poses (numpy), the first one ``w2c`` itself."""
    r = np.random.default_rng(9)
    xis = [np.zeros(6, np.float32)] + [
        (r.normal(size=6) * 0.05).astype(np.float32) for _ in range(views - 1)]
    return np.stack([np_(jlie.se3_exp(jx(x))) @ w2c for x in xis]).astype(np.float32)


def _target(seed=3):
    return np.random.default_rng(seed).uniform(size=(HW, HW, 3)).astype(np.float32)


def _loss(out_image, out_depth, out_alpha, target, mean):
    return (mean((out_image - target) ** 2) + 0.1 * mean(out_depth)
            + 0.05 * mean(out_alpha))


def _assert_images_close(o_t, o_j):
    for name, tol, rtol in (("image", FWD_ATOL, FWD_RTOL),
                            ("depth", DEPTH_TOL, DEPTH_TOL),
                            ("alpha", FWD_ATOL, FWD_RTOL)):
        np.testing.assert_allclose(np_(getattr(o_t, name)), np_(getattr(o_j, name)),
                                   atol=tol, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("views", [None, 3])
@pytest.mark.parametrize("jax_backend", ["ref", "pallas"])
def test_render_and_gradients_match(jax_backend, views):
    """Image, depth, alpha and the gradients of a loss w.r.t. every
    Gaussian parameter and the pose tangent (Step-4 and Step-5 BP)."""
    g_j, g_t, w2c = _scene()
    poses = w2c if views is None else _poses(w2c, views)
    target = _target()
    xi0 = np.array([0.01, -0.01, 0.02, 0.01, -0.02, 0.01], np.float32)
    jplan = JPlan(grid=jgrid(HW, HW), backend=jax_backend, capacity=CAP)
    tplan = TPlan(grid=tgrid(HW, HW), backend="kernel", capacity=CAP)

    def loss_j(params, xi):
        cam = JCamera(JIntr(**INTR), jlie.se3_exp(xi) @ jx(poses))
        out = jrender(JG.with_params(g_j, params), cam, jplan)
        return _loss(out.image, out.depth, out.alpha, jx(target), jnp.mean), out

    (l_j, out_j), (gp_j, gxi_j) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(JG.params_of(g_j), jx(xi0))

    params = {k: v.clone().requires_grad_(True) for k, v in TG.params_of(g_t).items()}
    xi = th(xi0, requires_grad=True)
    cam = TCamera(TIntr(**INTR), tlie.se3_exp(xi) @ th(poses))
    out_t = trender(TG.with_params(g_t, params), cam, tplan, device="cpu")
    l_t = _loss(out_t.image, out_t.depth, out_t.alpha, th(target), torch.mean)
    grads = torch.autograd.grad(l_t, [params[k] for k in PARAMS] + [xi])

    _assert_images_close(out_t, out_j)
    for name in ("idx", "count", "overflow", "total"):
        assert np.array_equal(np_(getattr(out_t.frags, name)),
                              np_(getattr(out_j.frags, name))), name
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), rtol=1e-5)
    assert_grads_close([gp_j[k] for k in PARAMS] + [gxi_j], grads,
                       list(PARAMS) + ["xi"])


def test_batched_render_is_bitwise_per_view():
    """One stacked raster call over B views equals B single-view renders
    bit for bit (the reference's own batched-render invariant,
    ``tests/test_raster_api.py``); gradients agree to float rounding."""
    _, g_t, w2c = _scene(1)
    poses = _poses(w2c, 3)
    plan = TPlan(grid=tgrid(HW, HW), backend="kernel", capacity=CAP)
    target = th(_target(4))

    def run(cams):
        params = {k: v.clone().requires_grad_(True)
                  for k, v in TG.params_of(g_t).items()}
        outs = [trender(TG.with_params(g_t, params), TCamera(TIntr(**INTR), c),
                        plan, device="cpu") for c in cams]
        loss = sum(_loss(o.image, o.depth, o.alpha, target, torch.sum) for o in outs)
        return outs, torch.autograd.grad(loss, [params[k] for k in PARAMS])

    (batched,), g_b = run([th(poses)])
    singles, g_s = run([th(p) for p in poses])
    for b, single in enumerate(singles):
        for name in ("image", "depth", "alpha"):
            assert torch.equal(getattr(batched, name)[b], getattr(single, name))
    for a, b in zip(g_b, g_s):
        # The summed loss adds the per-view gradients in one order on both
        # sides, but autograd accumulates the stacked views in another.
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("jax_backend", ["ref", "pallas"])
def test_rasterize_gradients_match(jax_backend):
    """``ops.rasterize`` on the same projected inputs and fragment lists:
    the kernel backend's K2 + GMU gradients w.r.t. the 2D attributes."""
    g_j, _, w2c = _scene(2)
    proj = jproject(g_j, JCamera(JIntr(**INTR), jx(w2c)))
    frags = jbuild(proj, jgrid(HW, HW), CAP)
    target = _target(5)
    leaves = [getattr(proj, k) for k in RASTER_LEAVES]

    def loss_j(*xs):
        img, dep, ft = jops.rasterize(
            JInputs(*xs, frags=frags),
            JPlan(grid=jgrid(HW, HW), backend=jax_backend, capacity=CAP))
        return _loss(img, dep, ft, jx(target), jnp.mean)

    g_j = jax.grad(loss_j, argnums=tuple(range(5)))(*leaves)
    xs = [th(np_(x), requires_grad=True) for x in leaves]
    f_t = FragmentLists(*(th(np_(x)) for x in frags))
    img, dep, ft = tops.rasterize(TInputs(*xs, frags=f_t),
                                  TPlan(grid=tgrid(HW, HW), capacity=CAP))
    g_t = torch.autograd.grad(_loss(img, dep, ft, th(target), torch.mean), xs)
    assert_grads_close(g_j, g_t, RASTER_LEAVES)


def test_kernel_backend_matches_port_ref_backend():
    """The port's two backends agree with each other: autograd through the
    plain tensor oracle is the reference gradient of K2 + GMU."""
    _, g_t, w2c = _scene(3)
    target = th(_target(6))
    res = {}
    for backend in ("ref", "kernel"):
        params = {k: v.clone().requires_grad_(True)
                  for k, v in TG.params_of(g_t).items()}
        out = trender(TG.with_params(g_t, params), TCamera(TIntr(**INTR), th(w2c)),
                      TPlan(grid=tgrid(HW, HW), backend=backend, capacity=CAP),
                      device="cpu")
        loss = _loss(out.image, out.depth, out.alpha, target, torch.mean)
        res[backend] = (out, torch.autograd.grad(loss, [params[k] for k in PARAMS]))
    _assert_images_close(res["kernel"][0], res["ref"][0])
    assert_grads_close(res["ref"][1], res["kernel"][1], PARAMS)
