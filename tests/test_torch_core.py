"""Parity of the port's core modules with ``repro``: lie, camera,
gaussians, projection, sorting and losses — forward values and gradients
(torch autograd against ``jax.grad``) on a ``tiny_scene``-sized cloud
(200 Gaussians, 64x64, K=64), fragment lists bit for bit.  Also the port's
rules: no JAX or ``repro`` import anywhere in it, and entry points that
refuse to run without a card unless told ``device="cpu"``.
"""

import ast
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_grads_close, jx, np_, th, tiny_cloud
from repro.core import gaussians as JG
from repro.core import lie as jlie
from repro.core import losses as jlosses
from repro.core import sorting as jsort
from repro.core.camera import Camera as JCamera
from repro.core.camera import Intrinsics as JIntr
from repro.core.camera import look_at as jlook_at
from repro.core.projection import project as jproject
from repro_torch.core import gaussians as TG
from repro_torch.core import lie as tlie
from repro_torch.core import losses as tlosses
from repro_torch.core import sorting as tsort
from repro_torch.core.camera import Camera as TCamera
from repro_torch.core.camera import Intrinsics as TIntr
from repro_torch.core.camera import look_at as tlook_at
from repro_torch.core.downsample import DownsampleConfig as TDownsample
from repro_torch.core.projection import project as tproject

REPO = pathlib.Path(__file__).resolve().parents[1]
INTR = dict(fx=80.0, fy=80.0, cx=32.0, cy=32.0, width=64, height=64)
EYE, TARGET, UP = np.zeros(3, np.float32), np.array([0, 0, 3.0], np.float32), \
    np.array([0, -1.0, 0], np.float32)


# ---------------------------------------------------------------------------
# lie
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [0.0, 1e-5, 0.05, 0.8])
def test_lie_forward_matches(scale):
    xi = (np.random.default_rng(1).normal(size=(5, 6)) * scale).astype(np.float32)
    T_j = jlie.se3_exp(jx(xi))
    T_t = tlie.se3_exp(th(xi))
    np.testing.assert_allclose(np_(T_t), np_(T_j), atol=2e-6)
    np.testing.assert_allclose(np_(tlie.se3_log(T_t)), np_(jlie.se3_log(T_j)),
                               atol=2e-5)
    np.testing.assert_allclose(np_(tlie.so3_exp(th(xi[:, 3:]))),
                               np_(jlie.so3_exp(jx(xi[:, 3:]))), atol=2e-6)
    np.testing.assert_allclose(np_(tlie.se3_inverse(T_t)),
                               np_(jlie.se3_inverse(T_j)), atol=2e-6)


@pytest.mark.parametrize("scale", [0.0, 0.3])
def test_lie_grad_matches_and_is_finite(scale):
    """Double-where: the gradient at theta=0 is exact and NaN-free."""
    r = np.random.default_rng(2)
    xi = (r.normal(size=6) * scale).astype(np.float32)
    wgt = r.normal(size=(4, 4)).astype(np.float32)
    g_j = jax.grad(lambda x: jnp.sum(jlie.se3_exp(x) * jx(wgt)))(jx(xi))
    x_t = th(xi, requires_grad=True)
    (g_t,) = torch.autograd.grad((tlie.se3_exp(x_t) * th(wgt)).sum(), [x_t])
    assert np.all(np.isfinite(np_(g_t)))
    np.testing.assert_allclose(np_(g_t), np_(g_j), atol=1e-5)
    R = np_(jlie.so3_exp(jx(r.normal(size=3).astype(np.float32) * scale)))
    gl_j = jax.grad(lambda m: jnp.sum(jlie.so3_log(m)))(jx(R))
    R_t = th(R, requires_grad=True)
    (gl_t,) = torch.autograd.grad(tlie.so3_log(R_t).sum(), [R_t])
    assert np.all(np.isfinite(np_(gl_t)))
    np.testing.assert_allclose(np_(gl_t), np_(gl_j), atol=1e-4)


# ---------------------------------------------------------------------------
# camera and gaussians
# ---------------------------------------------------------------------------


def test_camera_matches():
    w_j = jlook_at(jx(EYE), jx(TARGET), jx(UP))
    w_t = tlook_at(th(EYE), th(TARGET), th(UP))
    np.testing.assert_allclose(np_(w_t), np_(w_j), atol=1e-6)
    assert tuple(TIntr(**INTR).scaled(2)) == tuple(JIntr(**INTR).scaled(2))
    xi = np.array([0.01, -0.02, 0.03, 0.02, 0.01, -0.01], np.float32)
    np.testing.assert_allclose(
        np_(TCamera(TIntr(**INTR), w_t).perturbed(th(xi)).w2c),
        np_(JCamera(JIntr(**INTR), w_j).perturbed(jx(xi)).w2c), atol=1e-6)
    np.testing.assert_allclose(np_(TCamera(TIntr(**INTR), w_t).c2w),
                               np_(JCamera(JIntr(**INTR), w_j).c2w), atol=1e-6)


def _fields(seed=0):
    pts, cols, cap = tiny_cloud(seed)
    g_j = JG.from_points(jx(pts), jx(cols), capacity=cap, scale=0.08, opacity=0.8)
    g_t = TG.from_points(th(pts), th(cols), capacity=cap, scale=0.08, opacity=0.8)
    return g_j, g_t


def _assert_field_equal(g_t, g_j):
    # XLA's and PyTorch's float32 ``log`` may differ in the last bit (the
    # inverse-sigmoid colors), so floats agree to 1 ulp, not bitwise.
    for f in TG.PARAM_FIELDS + ("alive",):
        np.testing.assert_allclose(np_(getattr(g_t, f)), np_(getattr(g_j, f)),
                                   rtol=2.4e-7, atol=0.0, err_msg=f)


def test_gaussians_from_points_and_covariance():
    g_j, g_t = _fields()
    _assert_field_equal(g_t, g_j)
    np.testing.assert_allclose(np_(g_t.covariance()), np_(g_j.covariance()),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(np_(g_t.rgb()), np_(g_j.rgb()), atol=1e-7)
    _assert_field_equal(TG.empty(16), JG.empty(16))
    p_t = TG.params_of(g_t)
    assert set(p_t) == set(JG.params_of(g_j))
    assert TG.with_params(g_t, p_t).mu is g_t.mu


@pytest.mark.parametrize("seed,max_new", [(0, 7), (1, 40), (2, 500)])
def test_gaussians_insert_matches(seed, max_new):
    r = np.random.default_rng(seed)
    g_j, g_t = _fields(seed)
    dead = r.uniform(size=g_t.capacity) < 0.3
    g_j = g_j._replace(alive=jx(np_(g_j.alive) & ~dead))
    g_t = g_t.replace(alive=th(np_(g_t.alive) & ~dead))
    n_new = 60
    pts = r.normal(size=(n_new, 3)).astype(np.float32)
    cols = r.uniform(0.1, 0.9, (n_new, 3)).astype(np.float32)
    alive = r.uniform(size=n_new) < 0.7
    new_j = JG.from_points(jx(pts), jx(cols), capacity=n_new)._replace(alive=jx(alive))
    new_t = TG.from_points(th(pts), th(cols), capacity=n_new).replace(alive=th(alive))
    _assert_field_equal(TG.insert(g_t, new_t, max_new), JG.insert(g_j, new_j, max_new))


# ---------------------------------------------------------------------------
# projection (forward values and the Step-5 gradients)
# ---------------------------------------------------------------------------

PROJ_FIELDS = ("mu2d", "conic", "color", "opacity", "depth", "radius", "valid")


def _cams():
    w = np_(jlook_at(jx(EYE), jx(TARGET), jx(UP)))
    return JCamera(JIntr(**INTR), jx(w)), TCamera(TIntr(**INTR), th(w))


def test_projection_forward_matches():
    g_j, g_t = _fields()
    c_j, c_t = _cams()
    p_j, p_t = jproject(g_j, c_j), tproject(g_t, c_t)
    for name in PROJ_FIELDS:
        np.testing.assert_allclose(np_(getattr(p_t, name)),
                                   np_(getattr(p_j, name)), rtol=2e-5,
                                   atol=1e-5, err_msg=name)


def test_projection_grads_match_jax():
    """Gradients of a projection readout w.r.t. every Gaussian param and
    the pose tangent, torch autograd vs jax.grad."""
    g_j, g_t = _fields()
    c_j, c_t = _cams()
    r = np.random.default_rng(5)
    n = g_t.capacity
    w = {k: r.normal(size=s).astype(np.float32)
         for k, s in [("mu2d", (n, 2)), ("conic", (n, 3)), ("color", (n, 3)),
                      ("opacity", (n,)), ("depth", (n,))]}
    xi0 = np.array([0.01, -0.02, 0.02, 0.01, 0.02, -0.01], np.float32)

    def readout(p, wts, s):
        return sum(s(getattr(p, k) * wts[k]) for k in wts)

    def loss_j(params, xi):
        p = jproject(JG.with_params(g_j, params), c_j.perturbed(xi))
        return readout(p, {k: jx(v) for k, v in w.items()}, jnp.sum)

    gj_params, gj_xi = jax.grad(loss_j, argnums=(0, 1))(JG.params_of(g_j), jx(xi0))
    params_t = {k: v.clone().requires_grad_(True) for k, v in TG.params_of(g_t).items()}
    xi_t = th(xi0, requires_grad=True)
    p = tproject(TG.with_params(g_t, params_t), c_t.perturbed(xi_t))
    loss = readout(p, {k: th(v) for k, v in w.items()}, torch.sum)
    gt = torch.autograd.grad(loss, list(params_t.values()) + [xi_t])
    names = list(params_t)
    assert_grads_close([gj_params[k] for k in names] + [gj_xi], gt, names + ["xi"])


# ---------------------------------------------------------------------------
# sorting: bit-equal fragment lists
# ---------------------------------------------------------------------------


def _proj_to_torch(p_j):
    from repro_torch.core.projection import ProjectedGaussians
    return ProjectedGaussians(*(th(np_(x)) for x in p_j))


@pytest.mark.parametrize("cap", [8, 64])
def test_fragment_lists_bit_equal(cap):
    g_j, _ = _fields()
    c_j, _ = _cams()
    p_j = jproject(g_j, c_j)
    grid_j = jsort.make_tile_grid(64, 64)
    f_j = jsort.build_fragment_lists(p_j, grid_j, cap)
    f_t = tsort.build_fragment_lists(_proj_to_torch(p_j),
                                     tsort.make_tile_grid(64, 64), cap)
    for name in ("idx", "count", "overflow", "total"):
        a, b = np_(getattr(f_j, name)), np_(getattr(f_t, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    if cap == 8:
        assert int(f_t.overflow) > 0  # the drop path is exercised


def test_fragment_stack_and_slot_update_match():
    g_j, _ = _fields()
    c_j, _ = _cams()
    grid_j, grid_t = jsort.make_tile_grid(64, 64), tsort.make_tile_grid(64, 64)
    lists_j, lists_t = [], []
    for dx in (0.0, 0.2, -0.3):
        w = c_j.w2c.at[0, 3].add(dx)
        p_j = jproject(g_j, JCamera(c_j.intrinsics, w))
        lists_j.append(jsort.build_fragment_lists(p_j, grid_j, 32))
        lists_t.append(tsort.build_fragment_lists(_proj_to_torch(p_j), grid_t, 32))
    s_j = jsort.stack_fragment_lists(lists_j[:2])
    s_t = tsort.stack_fragment_lists(lists_t[:2])
    u_j = jsort.update_fragment_slot(s_j, 1, lists_j[2])
    # The mapping phase's stride rebuild writes the fresh slot in place.
    u_t = tsort.stack_fragment_lists(lists_t[:2])
    for x, f in zip(u_t, lists_t[2]):
        x[1] = f
    for a, b in zip(list(s_j) + list(u_j), list(s_t) + list(u_t)):
        assert np.array_equal(np_(a), np_(b))
    assert np.array_equal(np_(s_t.idx[1]), np_(lists_t[1].idx))  # copy, not alias


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def test_losses_match():
    r = np.random.default_rng(7)
    h = w = 32
    args = [r.uniform(size=(h, w, 3)), r.uniform(0, 3, (h, w)), r.uniform(size=(h, w)),
            r.uniform(size=(h, w, 3)), r.uniform(0, 3, (h, w)) * (r.uniform(size=(h, w)) > 0.2)]
    args = [a.astype(np.float32) for a in args]
    l_j, g_j = jax.value_and_grad(
        lambda *a: jlosses.slam_loss(*a, lambda_pho=0.8), argnums=(0, 1, 2))(
            *[jx(a) for a in args])
    ts = [th(a, requires_grad=i < 3) for i, a in enumerate(args)]
    l_t = tlosses.slam_loss(*ts, lambda_pho=0.8)
    g_t = torch.autograd.grad(l_t, ts[:3])
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), rtol=1e-6)
    assert_grads_close(g_j, g_t, ["rgb", "depth", "alpha"])
    np.testing.assert_allclose(float(tlosses.psnr(ts[0], ts[3]).detach()),
                               float(jlosses.psnr(jx(args[0]), jx(args[3]))),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# metrics, keyframes, downsampling
# ---------------------------------------------------------------------------


def test_trajectory_and_image_metrics_match():
    from repro.slam import metrics as jm
    from repro_torch.slam import metrics as tm
    r = np.random.default_rng(11)
    gt = [np_(jlie.se3_exp(jx((r.normal(size=6) * 0.3).astype(np.float32))))
          for _ in range(7)]
    est = [np_(jlie.se3_exp(jx((r.normal(size=6) * 0.01).astype(np.float32)))) @ p
           for p in gt]
    assert tm.ate_rmse(est, gt) == jm.ate_rmse(est, gt)
    src, dst = r.normal(size=(9, 3)), r.normal(size=(9, 3))
    for a, b in zip(tm.align_umeyama(src, dst), jm.align_umeyama(src, dst)):
        assert np.array_equal(a, b)
    img_a, img_b = r.uniform(size=(8, 8, 3)), r.uniform(size=(8, 8, 3))
    assert tm.psnr_np(img_a, img_b) == jm.psnr_np(img_a, img_b)


def test_work_counters_accumulate_like_the_reference():
    """int64 counters give the totals of the reference's hi/lo split."""
    from repro.slam import metrics as jm
    from repro_torch.slam import metrics as tm
    steps = [(2_000_000_000, 4096, 131072), (7, 0, 3), (1_500_000_000, 307200, 9)]
    wide, w_t = jm.wide_work_zero(), tm.device_work_zero()
    for frags, px, alive in steps:
        w_j = jm.device_work_add(jm.device_work_zero(), frags, px, alive)
        wide = jm.wide_work_add(wide, w_j)
        w_t = tm.device_work_merge(w_t, tm.device_work_add(
            tm.device_work_zero(), frags, px, alive))
    totals = dict(zip(tm.DeviceWork._fields, (int(x) for x in w_t)))
    assert totals == jm.wide_work_totals(jax.device_get(wide))


def test_monogs_keyframes_and_factor_one_downsampling_match():
    """MonoGS keyframes and factor-1 downsampling (the identity) against the
    reference; the other policies and factors 2 and 4, which raised before
    they were ported, are held in ``test_torch_algos.py`` and
    ``test_torch_downsample.py``."""
    from repro.core import downsample as jds
    from repro.core.keyframes import KeyframePolicy as JP
    from repro_torch.core import downsample as tds
    from repro_torch.core.keyframes import KeyframePolicy as TP
    eye = np.eye(4, dtype=np.float32)
    for idx, since in [(0, 0), (3, 3), (8, 8), (9, 1), (17, 9)]:
        assert TP(interval=8).is_keyframe(idx, since) == JP(interval=8).is_keyframe(
            idx, since, eye, eye, None, None)
    assert TP(kind="gsslam").is_keyframe(3, 3, cur_pose=th(eye), last_kf_pose=th(eye)) \
        == JP(kind="gsslam").is_keyframe(3, 3, eye, eye, None, None)
    img = np.random.default_rng(0).uniform(size=(16, 16, 3)).astype(np.float32)
    assert np.array_equal(np_(tds.downsample_image(th(img), 1)),
                          np_(jds.downsample_image(jx(img), 1)))
    assert np.array_equal(np_(tds.downsample_depth(th(img[..., 0]), 1)),
                          np_(jds.downsample_depth(jx(img[..., 0]), 1)))
    assert tuple(tds.DownsampleConfig()) == tuple(jds.DownsampleConfig())
    np.testing.assert_allclose(np_(tds.downsample_image(th(img), 2)),
                               np_(jds.downsample_image(jx(img), 2)), rtol=1e-6)


# ---------------------------------------------------------------------------
# the port's rules
# ---------------------------------------------------------------------------


def _port_files():
    return sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests" / "_kernel_inputs.py",
        REPO / "tests" / "_session_state.py",
        *sorted((REPO / "tools").glob("*.py"))]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_port_imports_no_jax_and_no_repro(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            top = m.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {m}"


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    """With no CUDA device the default entry points raise; they never carry
    on on the CPU by themselves."""
    from repro_torch.core.raster_api import RasterPlan
    from repro_torch.core.render import render
    from repro_torch.slam.datasets import make_dataset
    from repro_torch.slam.session import SLAMConfig, run_sequence, session_init

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, g_t = _fields()
    _, c_t = _cams()
    plan = RasterPlan(grid=tsort.make_tile_grid(64, 64), capacity=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        render(g_t, c_t, plan)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_dataset("room0", num_frames=2, height=32, width=32, num_gaussians=64)
    ds = make_dataset("room0", num_frames=2, height=32, width=32,
                      num_gaussians=64, frag_capacity=16, device="cpu")
    cfg = SLAMConfig(capacity=256, frag_capacity=16, iters_track=1, iters_map=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        session_init(ds, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_sequence(ds, cfg)
    out = render(g_t, c_t, plan, device="cpu")
    assert out.image.shape == (64, 64, 3)


@pytest.mark.parametrize("which", ["field", "adam", "dataset", "session"])
def test_carry_across_needs_a_card_unless_told_cpu(monkeypatch, which):
    """``convert.*_from_numpy`` resolve their device as the entry points do:
    with no CUDA device and no ``device`` they raise and name the CPU
    option; with ``device="cpu"`` they build on the CPU."""
    from types import SimpleNamespace

    from repro_torch import convert

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g_np = jax.device_get(_fields()[0])
    moments = {f: np.asarray(getattr(g_np, f)) for f in TG.PARAM_FIELDS}
    calls = {
        "field": lambda **kw: convert.field_from_numpy(g_np, **kw),
        "adam": lambda **kw: convert.adam_from_numpy(
            SimpleNamespace(step=np.int32(3), mu=moments, nu=moments), **kw),
        "dataset": lambda **kw: convert.dataset_from_numpy(SimpleNamespace(), **kw),
        "session": lambda **kw: convert.session_from_numpy(
            SimpleNamespace(), None, TIntr(**INTR), **kw),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[which]()
    if which == "field":
        assert calls[which](device="cpu").mu.device.type == "cpu"
    elif which == "adam":
        assert calls[which](device="cpu").step.device.type == "cpu"


@pytest.mark.parametrize("field,value,error,match", [
    ("sparse_opt", True, ValueError, "sparse_opt=True requires cfg.prune"),
    ("paged", object(), NotImplementedError, "paged"),
    ("sched_bucket", 2, NotImplementedError, "sched_bucket")],
    ids=["sparse_opt-True", "paged-value1", "sched_bucket-2"])
def test_unported_config_fields_raise(field, value, error, match):
    """Unported fields raise when the config is made; ``sparse_opt``
    without ``prune`` raises the reference's ``ValueError`` when a stage is
    built from it (the stability bit rides the pruning state)."""
    from repro_torch.slam.engine import _Stage
    from repro_torch.slam.session import SLAMConfig
    with pytest.raises(error, match=match):
        _Stage(TIntr(**INTR), SLAMConfig(**{field: value}), torch.device("cpu"))


@pytest.mark.parametrize("field,value", [
    ("base_algo", "gsslam"), ("base_algo", "photoslam"), ("base_algo", "splatam"),
    ("prune", "PruneConfig"), ("downsample", TDownsample(enabled=True)),
    ("backend", "kernel_norb"), ("sparse_opt", True), ("scene", "desk0"),
    ("scene", "stairs0"), ("scene", "corridor0")])
def test_ported_config_fields_run_a_session(field, value):
    """Each field the port once refused, and each scene it once refused,
    now runs two frames on the CPU."""
    from repro_torch.core.keyframes import KeyframePolicy
    from repro_torch.core.pruning import PruneConfig
    from repro_torch.slam.datasets import make_dataset
    from repro_torch.slam.session import SLAMConfig, run_sequence
    kw = {field: PruneConfig(k0=2) if value == "PruneConfig" else value}
    if field == "base_algo":
        kw["keyframe"] = KeyframePolicy(kind=value)
    if field == "sparse_opt":
        kw.update(prune=PruneConfig(k0=2, stable_rel=1.0, stable_age=1),
                  keyframe=KeyframePolicy(interval=2))
    scene = kw.pop("scene", "room0")
    ds = make_dataset(scene, num_frames=3, height=64, width=64,
                      num_gaussians=200, frag_capacity=32, device="cpu")
    res = run_sequence(ds, SLAMConfig(iters_track=2, iters_map=2, capacity=512,
                                      frag_capacity=32, map_window=2, **kw),
                       device="cpu")
    assert np.isfinite(res.ate) and len(res.est_w2c) == 3
    if field == "sparse_opt":   # frame 2's mapping left stable rows out
        assert res.work.skipped_fragments > 0


@pytest.mark.parametrize("where,args", [("checkout", []), ("alone", []),
                                        ("checkout", ["kernels"])])
def test_chip_smoke_refuses_without_card_checkout_or_known_args(tmp_path, where, args):
    """No CUDA device here, a directory holding only the script, or an
    argument other than ``profile``: a non-zero exit and no result line."""
    script = REPO / "chip_smoke.py"
    if where == "alone":
        script = tmp_path / "chip_smoke.py"
        script.write_text((REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    run = subprocess.run([sys.executable, str(script), *args], cwd=script.parent,
                         env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode != 0
    assert '"ok"' not in run.stdout

