"""A keyframe's mapping work as one segment (``session._keyframe_segment``,
one CUDA graph replay on the card) on the CPU: each fixed-shape function
it runs against the reference, and a fused keyframe against
``fused=False``.

* ``_median_linear`` against ``jnp.nanmedian`` over a masked pick with no,
  one, an odd and an even count of valid entries, bit for bit;
* ``gaussians.insert`` against ``repro.core.gaussians.insert`` with more
  dead slots than newcomers, fewer, and none, bit for bit;
* ``_push_ring`` with its fill a () tensor against the reference's for
  fills 0 to W + 1, bit for bit;
* ``_densify_core`` against the reference's with the reference's own
  permutation: the same rows become alive and the same count is dropped,
  the parameters within ``test_torch_session.py``'s 1e-6 (the two invert
  the pose through different solvers); with no valid depth, nothing is
  written;
* one fused keyframe on the CPU (the keyframe segment through the
  runner's static buffers) equals ``fused=False`` bit for bit on
  ``kernel``, ``schedule`` and with sparse mapping: the session, the
  densify generator's state included, and the step's results; the fused
  keyframe's mapping counts 1 dispatch and no sync.

Inputs are drawn with numpy from a seed; the sessions run on the
reference's 64x64 room0, carried across with ``dataset_from_numpy``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _session_state import same_bits, same_session
from repro.core import gaussians as JG
from repro.core.camera import Intrinsics as JIntr
from repro.slam import session as jsession
from repro.slam.datasets import make_dataset as jmake_dataset
from repro_torch import convert
from repro_torch.core import gaussians as TG
from repro_torch.core.camera import Intrinsics as TIntr
from repro_torch.core.keyframes import KeyframePolicy
from repro_torch.core.pruning import PruneConfig
from repro_torch.slam import session as tsession
from repro_torch.slam.graphs import EngineStats

SEED = 0
BASE = dict(iters_track=3, iters_map=8, capacity=1024, frag_capacity=48,
            map_window=2, map_rebuild_stride=3)
PATHS = {
    "kernel": {},
    "schedule": dict(backend="schedule"),
    # Stability settles inside frame 1's tracking, so frame 2's keyframe
    # maps with stable rows frozen.
    "sparse": dict(backend="schedule", sparse_opt=True,
                   prune=PruneConfig(k0=2, step_frac=0.1, stable_ema_beta=0.6,
                                     stable_rel=4.0, stable_age=1, stable_warmup=2)),
}


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """The sessions here are thousands of tiny CPU ops, which a pool of
    intra-op threads only slows; fused and eager run under the same
    setting."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jx(a):
    return jnp.asarray(np.asarray(a))


def th(a):
    return torch.as_tensor(np.array(a))


def np_(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("n_valid", [0, 1, 5, 8])
def test_median_linear_matches_nanmedian(n_valid):
    r = np.random.default_rng(n_valid)
    x = r.uniform(0.5, 4.0, 12).astype(np.float32)
    valid = np.zeros(12, bool)
    valid[r.choice(12, n_valid, replace=False)] = True
    want = np.asarray(jnp.nanmedian(jnp.where(jx(valid), jx(x), jnp.nan)))
    got = np_(tsession._median_linear(th(x), th(valid)))
    assert got.dtype == want.dtype and np.array_equal(got, want, equal_nan=True)


def _field_arrays(r, n, alive):
    return dict(mu=r.normal(size=(n, 3)).astype(np.float32),
                log_scale=r.normal(size=(n, 3)).astype(np.float32),
                quat=r.normal(size=(n, 4)).astype(np.float32),
                logit_o=r.normal(size=n).astype(np.float32),
                color=r.normal(size=(n, 3)).astype(np.float32), alive=alive)


@pytest.mark.parametrize("dead_share", [0.6, 0.1, 0.0])
def test_insert_matches_the_reference(dead_share):
    """64 slots, 40 newcomers of which ~70% alive, at most 30 taken: more
    dead slots than takers, fewer, and none."""
    r = np.random.default_rng(int(dead_share * 10))
    g = _field_arrays(r, 64, r.uniform(size=64) >= dead_share)
    new = _field_arrays(r, 40, r.uniform(size=40) < 0.7)
    want = JG.insert(JG.GaussianField(**{k: jx(v) for k, v in g.items()}),
                     JG.GaussianField(**{k: jx(v) for k, v in new.items()}), 30)
    got = TG.insert(TG.GaussianField(**{k: th(v) for k, v in g.items()}),
                    TG.GaussianField(**{k: th(v) for k, v in new.items()}), 30)
    for f in TG.PARAM_FIELDS + ("alive",):
        assert np.array_equal(np_(getattr(got, f)), np.asarray(getattr(want, f))), f
    n_dead = int((~g["alive"]).sum())
    assert int(got.alive.sum()) - int(g["alive"].sum()) == min(
        n_dead, int(new["alive"].sum()), 30)


@pytest.mark.parametrize("count", range(5))
def test_push_ring_with_a_device_fill_matches(count):
    """A ring of W = 3 slots, filled 0 to W + 1 deep."""
    r = np.random.default_rng(count)
    buf = r.normal(size=(3, 4, 5)).astype(np.float32)
    row = r.normal(size=(4, 5)).astype(np.float32)
    want = jsession._push_ring(jx(buf), jx(row), jnp.asarray(count))
    got = tsession._push_ring(th(buf), th(row), torch.tensor(count))
    assert np.array_equal(np_(got), np.asarray(want))


@pytest.fixture(scope="module")
def scene():
    ds_j = jmake_dataset("room0", num_frames=3, height=64, width=64,
                         num_gaussians=400, frag_capacity=48)
    return ds_j, convert.dataset_from_numpy(ds_j, device="cpu")


@pytest.mark.parametrize("depth_valid", [True, False])
def test_densify_core_matches_the_reference(scene, depth_valid):
    ds_j, _ = scene
    cfg_j = jsession.SLAMConfig(backend="ref", **BASE)
    cfg_t = tsession.SLAMConfig(**BASE)
    r = np.random.default_rng(SEED)
    g = jax.device_get(jsession._seed_map(ds_j, cfg_j))
    alive = np.asarray(g.alive) & (r.uniform(size=cfg_j.capacity) < 0.9)
    g = g._replace(alive=alive)
    frame = ds_j.frames[2]
    depth = np.asarray(frame.depth) * depth_valid
    rendered = np.clip(frame.rgb + r.normal(scale=0.1, size=frame.rgb.shape),
                       0, 1).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), 2)
    perm = th(np.array(jax.random.permutation(key, 2 * cfg_t.densify_per_kf)))
    g_j, drop_j = jsession._densify_core(
        JG.GaussianField(*map(jx, g)), jx(frame.rgb), jx(depth), jx(rendered),
        jx(frame.w2c_gt), ds_j.intrinsics, cfg_j, key)
    g_t, drop_t = tsession._densify_core(
        convert.field_from_numpy(g, device="cpu"), th(frame.rgb), th(depth),
        th(rendered), th(frame.w2c_gt), TIntr(*JIntr(*ds_j.intrinsics)), cfg_t, None,
        perm=perm)
    assert int(drop_t) == int(drop_j)
    assert np.array_equal(np_(g_t.alive), np.asarray(g_j.alive))
    for f in TG.PARAM_FIELDS:
        np.testing.assert_allclose(np_(getattr(g_t, f)), np.asarray(getattr(g_j, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    if not depth_valid:
        assert np.array_equal(np_(g_t.alive), alive)
        for f in TG.PARAM_FIELDS:
            assert np.array_equal(np_(getattr(g_t, f)), np.asarray(getattr(g, f))), f


def _keyframe_run(ds, path, fused):
    """Init, a tracking-only frame 1 and a keyframe at frame 2 (densify
    pick drawn on the session's generator); the session and the
    keyframe's result and counts."""
    cfg = tsession.SLAMConfig(keyframe=KeyframePolicy(interval=2), fused=fused,
                              **BASE, **PATHS[path])
    sess = tsession.session_init(ds, cfg, seed=SEED, device="cpu")
    sess, _ = tsession.session_step(sess, ds.frames[1])
    stats = EngineStats()
    sess, res = tsession.session_step(sess, ds.frames[2], stats=stats)
    assert res.is_kf
    return sess, res, stats


@pytest.mark.parametrize("path", list(PATHS))
def test_fused_keyframe_equals_eager_bit_for_bit(scene, path):
    _, ds = scene
    s_f, r_f, c_f = _keyframe_run(ds, path, True)
    s_e, r_e, c_e = _keyframe_run(ds, path, False)
    assert same_session(s_f, s_e)
    for name in ("pose", "alive", "psnr", "track_losses", "map_losses", "fired"):
        assert same_bits(getattr(r_f, name), getattr(r_e, name)), name
    assert all(same_bits(a, b) for a, b in zip(r_f.work, r_e.work))
    assert bool(torch.isfinite(r_f.psnr)) and int(r_f.work.frag_build_rows) > 0
    st = s_f.stage
    sparse = path == "sparse"
    # Fused, tracking (with pruning, its boundaries inside) and mapping are
    # one run each; eager, each stands for its calls.
    assert c_f.replays == 0 and (c_f.dispatches, c_f.syncs) == (2, 0)
    k = s_f.cfg.iters_track
    if sparse:
        assert int(s_f.pstate.stable.sum()) > 0
        # Eager pruning: the build and schedule, the K iterations, each
        # fired boundary's rebuild, interval_update and schedule, and one
        # read per iteration for the boundary check.
        track = 2 + k + 3 * int(r_e.fired.sum())
        assert c_e.syncs == k
    else:
        track = k
        assert c_e.syncs == 0
    assert c_e.dispatches == track + 3 + st._map_dispatches(sparse)
