"""Parity of the port's §4.1 pruning (``repro_torch.core.pruning``) with
``repro.core.pruning`` on identical inputs.

The inputs are numpy draws from a seed; every case runs the same sequence
of calls on both sides.  Integer and bool leaves (masks, ``interval``,
``iters_left``, ``removed``, ``prev_tile_count``, ``age``, ``stable``) must
be equal, the clocks as () int32 tensors; float leaves (``score``, ``grad_ema``) agree within 1e-6
relative.  The cases mirror ``tests/test_pruning_downsample.py``, plus
selections where most scores tie at 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jx, np_, th
from _torch_parity import one_cpu_thread  # noqa: F401  (autouse fixture)
from repro.core import gaussians as JG
from repro.core import pruning as jp
from repro_torch import convert
from repro_torch.core import gaussians as TG
from repro_torch.core import pruning as tp
from repro_torch.core.sorting import FragmentLists

FLOATS = ("score", "grad_ema")
CLOCKS = ("interval", "iters_left", "opt_steps")


def _fields(alive):
    alive = np.asarray(alive, bool)
    n = alive.size
    return (JG.empty(n)._replace(alive=jx(alive)),
            TG.empty(n).replace(alive=th(alive)))


def _grads(r, n, zero_frac=0.0):
    """Param gradients (numpy) for ``n`` rows; a ``zero_frac`` share of
    rows get exactly zero gradients (no fragment in the view)."""
    g = {"mu": r.normal(size=(n, 3)), "log_scale": r.normal(size=(n, 3)),
         "quat": r.normal(size=(n, 4)), "logit_o": r.normal(size=(n,)),
         "color": r.normal(size=(n, 3))}
    zero = r.uniform(size=n) < zero_frac
    return {k: np.where(zero.reshape((-1,) + (1,) * (v.ndim - 1)), 0.0, v
                        ).astype(np.float32) for k, v in g.items()}


def _both(grads):
    return {k: jx(v) for k, v in grads.items()}, {k: th(v) for k, v in grads.items()}


def assert_state_equal(t, j):
    j = jax.device_get(j)
    for f in tp.PruneState._fields:
        got, want = getattr(t, f), getattr(j, f)
        if f in CLOCKS:
            assert got.dtype == torch.int32 and got.shape == (), f
            assert int(got) == int(want), f
        elif f in FLOATS:
            np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-6,
                                       atol=1e-30, err_msg=f)
        else:
            assert np.array_equal(np_(got), np.asarray(want)), f


def _start(alive, tiles, cfg_kw, **state_kw):
    g_j, g_t = _fields(alive)
    jcfg, tcfg = jp.PruneConfig(**cfg_kw), tp.PruneConfig(**cfg_kw)
    s_j = jp.init_state(g_j, tiles, jcfg)._replace(
        **{k: jx(v) for k, v in state_kw.items()})
    s_t = tp.init_state(g_t, tiles, tcfg)._replace(
        **{k: th(v) for k, v in state_kw.items()})
    assert_state_equal(s_t, s_j)
    return (g_j, s_j, jcfg), (g_t, s_t, tcfg)


def test_config_defaults_match():
    assert tuple(tp.PruneConfig()) == tuple(jp.PruneConfig())
    assert tp.PruneState._fields == jp.PruneState._fields


def test_importance_scores_eq7():
    r = np.random.default_rng(0)
    gj, gt = _both(_grads(r, 64))
    cfg = dict(lam=0.8)
    np.testing.assert_allclose(np_(tp.importance_scores(gt, tp.PruneConfig(**cfg))),
                               np.asarray(jp.importance_scores(gj, jp.PruneConfig(**cfg))),
                               rtol=1e-6)


@pytest.mark.parametrize("zero_frac", [0.0, 0.5, 0.9])
@pytest.mark.parametrize("with_alive", [True, False])
def test_accumulate_matches(zero_frac, with_alive):
    """Eight accumulations (EMA, age and the stability bit with ``alive``);
    one dead row in eight."""
    r = np.random.default_rng(int(zero_frac * 10) + 7 * with_alive)
    n = 96
    alive = r.uniform(size=n) > 0.125
    cfg = dict(stable_age=3, stable_ema_beta=0.5)
    (g_j, s_j, jcfg), (g_t, s_t, tcfg) = _start(alive, 4, cfg)
    for _ in range(8):
        gj, gt = _both(_grads(r, n, zero_frac) if r.uniform() < 0.5 else
                       {k: v * 1e-3 for k, v in _grads(r, n, zero_frac).items()})
        s_j = jp.accumulate(s_j, gj, jcfg, alive=g_j.alive if with_alive else None)
        s_t = tp.accumulate(s_t, gt, tcfg, alive=g_t.alive if with_alive else None)
        assert_state_equal(s_t, s_j)


def test_accumulate_stability_rule_and_warmup():
    """``test_pruning_downsample.py``'s stability cases on both sides: raw
    scores (beta 0), a warm-up of 5 calls, a loud iteration that thaws."""
    alive = [True, True, True, False]
    cfg = dict(stable_ema_beta=0.0, stable_rel=0.5, stable_age=2,
               stable_thresh=0.0, stable_warmup=5)
    (g_j, s_j, jcfg), (g_t, s_t, tcfg) = _start(alive, 4, cfg)

    def grads(scores):
        s = np.asarray(scores, np.float32)
        z = np.zeros_like(s)
        return _both({"mu": np.stack([s, z, z], -1),
                      "log_scale": np.zeros((4, 3), np.float32),
                      "quat": np.zeros((4, 4), np.float32)})

    seq = [[0.1, 10.0, 0.1, 0.0]] * 6 + [[10.0, 10.0, 0.1, 0.0]]
    for scores in seq:
        gj, gt = grads(scores)
        s_j = jp.accumulate(s_j, gj, jcfg, alive=g_j.alive)
        s_t = tp.accumulate(s_t, gt, tcfg, alive=g_t.alive)
        assert_state_equal(s_t, s_j)
    assert np_(s_t.stable).tolist() == [False, False, True, False]


def _boundaries(alive, scores_seq, tile_counts, cfg_kw, prev=None):
    """Run ``interval_update`` over ``scores_seq`` on both sides, checking
    the state, the field's alive mask and ``did`` after each boundary."""
    state_kw = {} if prev is None else {"prev_tile_count": np.asarray(prev, np.int32)}
    (g_j, s_j, jcfg), (g_t, s_t, tcfg) = _start(alive, len(tile_counts[0]),
                                                 cfg_kw, **state_kw)
    for scores, counts in zip(scores_seq, tile_counts):
        s_j = s_j._replace(score=jx(np.asarray(scores, np.float32)))
        s_t = s_t._replace(score=th(np.asarray(scores, np.float32)))
        counts = np.asarray(counts, np.int32)
        s_j, g_j, did_j = jp.interval_update(s_j, g_j, jx(counts), jcfg)
        s_t, g_t, did_t = tp.interval_update(s_t, g_t, th(counts), tcfg)
        assert_state_equal(s_t, s_j)
        assert np.array_equal(np_(g_t.alive), np.asarray(g_j.alive))
        assert bool(did_t) == bool(did_j)
    return s_t


def test_masking_selects_lowest_scores():
    n = 32
    s = _boundaries(np.ones(n, bool), [np.arange(n) + 1.0], [np.zeros(4)],
                    dict(step_frac=0.25, k0=2))
    assert np_(s.masked).tolist() == [True] * 8 + [False] * 24


def test_mask_then_permanent_removal():
    n = 16
    s = _boundaries(np.ones(n, bool), [np.arange(n, dtype=np.float32)] * 2,
                    [np.zeros(4)] * 2, dict(step_frac=0.5, k0=2, max_ratio=0.9))
    assert int(s.removed) == 8


@pytest.mark.parametrize("seed", [0, 1])
def test_prune_cap_respected(seed):
    n = 40
    r = np.random.default_rng(seed)
    s = _boundaries(np.ones(n, bool), [r.uniform(size=n) for _ in range(10)],
                    [np.zeros(4)] * 10, dict(step_frac=0.5, max_ratio=0.5, k0=1))
    assert float(tp.prune_ratio(s)) <= 0.5 + 1e-6


@pytest.mark.parametrize("counts,k_next", [([20, 0, 10, 10], 4), ([10, 10, 10, 11], 16)])
def test_interval_adapts_to_churn(counts, k_next):
    s = _boundaries(np.ones(8, bool), [np.zeros(8)], [counts], dict(k0=8),
                    prev=[10, 10, 10, 10])
    assert int(s.interval) == int(s.iters_left) == k_next


@pytest.mark.parametrize("zero_frac", [0.5, 0.9, 1.0])
def test_selection_with_ties_at_zero(zero_frac):
    """Most alive rows score exactly 0 (no fragment in the tracked view);
    the stable sort masks the lowest-index ones, as ``jnp.argsort`` does.
    Dead rows never count; three boundaries with churn in both
    directions and the -1 sentinel."""
    r = np.random.default_rng(int(zero_frac * 100))
    n = 300
    alive = r.uniform(size=n) > 0.2

    def scores():
        s = r.uniform(size=n).astype(np.float32)
        return np.where(r.uniform(size=n) < zero_frac, 0.0, s)

    counts = [r.integers(0, 50, 16) for _ in range(3)]
    s = _boundaries(alive, [scores() for _ in range(3)], counts,
                    dict(step_frac=0.08, k0=4), prev=np.full(16, -1))
    assert int(s.removed) > 0


def test_retile_matches_and_parks_baselines():
    """Factor switches 16 -> 4 -> 1 -> 16 tiles: parked baselines restored,
    unseen grids get the -1 sentinel, the (N,) leaves untouched."""
    r = np.random.default_rng(3)
    n = 32
    (g_j, s_j, _), (g_t, s_t, _) = _start(
        np.ones(n, bool), 16, {},
        prev_tile_count=r.integers(0, 9, 16).astype(np.int32),
        grad_ema=r.uniform(size=n).astype(np.float32),
        age=r.integers(0, 5, n).astype(np.int32),
        stable=r.uniform(size=n) < 0.3)
    b_j, b_t = {}, {}
    for tiles in (4, 1, 16, 4):
        s_j = jp.retile_state(s_j, tiles, b_j)
        s_t = tp.retile_state(s_t, tiles, b_t)
        assert_state_equal(s_t, s_j)
        assert sorted(b_t) == sorted(b_j)
        for k in b_j:
            assert np.array_equal(np_(b_t[k]), np.asarray(b_j[k]))
    assert tp.retile_state(s_t, 4) is s_t
    assert np_(tp.retile_state(s_t, 9).prev_tile_count).tolist() == [-1] * 9


@pytest.mark.parametrize("iters_left", [2, 0])
def test_cond_interval_update_matches(iters_left):
    """Off a boundary everything passes through; on one the lists are
    rebuilt by ``build_fn`` and ``interval_update`` runs.  The port writes
    the state, ``alive`` and the lists in place and returns ``fired`` as
    a () bool tensor."""
    r = np.random.default_rng(iters_left)
    n, tiles = 24, 4
    (g_j, s_j, jcfg), (g_t, s_t, tcfg) = _start(
        np.ones(n, bool), tiles, dict(k0=2, step_frac=0.25),
        score=r.uniform(size=n).astype(np.float32))
    s_j, s_t = s_j._replace(iters_left=jnp.asarray(iters_left, jnp.int32)), \
        s_t._replace(iters_left=th(np.int32(iters_left)))
    fresh = (r.integers(-1, n, (tiles, 8)).astype(np.int32),
             r.integers(0, 8, tiles).astype(np.int32), np.int32(0), np.int32(11))
    cur = tuple(np.zeros_like(x) for x in fresh)
    out_j = jp.cond_interval_update(
        s_j, g_j, FragmentLists(*map(jx, cur)), lambda gg, mm: FragmentLists(*map(jx, fresh)),
        jcfg)
    frags_t = FragmentLists(*map(th, cur))
    fired_t = tp.cond_interval_update(
        s_t, g_t, frags_t, lambda gg, mm: FragmentLists(*map(th, fresh)), tcfg)
    assert_state_equal(s_t, out_j[0])
    assert np.array_equal(np_(g_t.alive), np.asarray(out_j[1].alive))
    for a, b in zip(frags_t, out_j[2]):
        assert np.array_equal(np_(a), np.asarray(b))
    assert fired_t.dtype == torch.bool and fired_t.shape == ()
    assert bool(fired_t) == bool(out_j[3]) == (iters_left == 0)


def test_masks_and_ratio_match():
    r = np.random.default_rng(5)
    n = 20
    (g_j, s_j, _), (g_t, s_t, _) = _start(
        np.ones(n, bool), 4, {}, masked=r.uniform(size=n) < 0.4,
        removed=np.int32(7))
    assert np.array_equal(np_(tp.effective_opacity_mask(g_t, s_t)),
                          np.asarray(jp.effective_opacity_mask(g_j, s_j)))
    assert float(tp.prune_ratio(s_t)) == float(jp.prune_ratio(s_j))


def test_prune_state_round_trip():
    """``convert.prune_state_from_numpy`` carries all eleven leaves of a
    reference state across (clocks as () int32 tensors) and back unchanged."""
    r = np.random.default_rng(6)
    n = 40
    g_j, _ = _fields(r.uniform(size=n) > 0.1)
    s_j = jp.init_state(g_j, 16, jp.PruneConfig(k0=3))._replace(
        score=jx(r.uniform(size=n).astype(np.float32)),
        masked=jx(r.uniform(size=n) < 0.2),
        interval=jnp.asarray(6, jnp.int32), iters_left=jnp.asarray(2, jnp.int32),
        prev_tile_count=jx(r.integers(-1, 30, 16).astype(np.int32)),
        removed=jnp.asarray(5, jnp.int32),
        grad_ema=jx(r.uniform(size=n).astype(np.float32)),
        age=jx(r.integers(0, 9, n).astype(np.int32)),
        stable=jx(r.uniform(size=n) < 0.5), opt_steps=jnp.asarray(13, jnp.int32))
    s_t = convert.prune_state_from_numpy(jax.device_get(s_j), device="cpu")
    assert_state_equal(s_t, s_j)
    assert all(getattr(s_t, f).dtype == torch.int32 and getattr(s_t, f).shape == ()
               for f in CLOCKS)
    assert s_t.masked.dtype == torch.bool and s_t.age.dtype == torch.int32
