"""§4.1's pruning boundary on the device, on the CPU: the RTGS tracking
phase as one segment run (``engine._Stage._track_segment`` with
``prune``), whose boundaries run under ``when`` inside the segment
(conditional segments, ``PhaseRunner.run(conditional=True)``), so a fused
RTGS tracking phase counts one dispatch and reads nothing back.

* the port's fused tracking phase against the reference's
  ``_Stage._track_scan_prune`` from one shared state, on ``kernel`` and
  ``schedule``: a frame with two boundaries (``k0=2`` over 4 iterations)
  and one with none;
* fused equals eager bit for bit, solo and at S=2 (one row firing, one
  not), and each row its solo run;
* paged with every page in view equals flat bit for bit;
* a skipped conditional body leaves every buffer as it was, and one that
  runs writes them in place, in all three runner modes.

Inputs: the reference's room0 at 48x64 (``make_dataset``, carried across
with ``dataset_from_numpy``), its seeded map, tracked from frame 0's pose
against frame 1; the toy segment's inputs drawn with numpy from a seed.
On the card, ``tests/test_torch_cuda.py`` holds the conditional nodes
inside a segment.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _session_state import same_bits, tree_tensors
from _shared_runs import shared
from _torch_parity import np_, th
from repro.core import lie as jlie
from repro.core import pruning as jp
from repro.core.keyframes import KeyframePolicy as JPolicy
from repro.core.pruning import PruneConfig as JPrune
from repro.slam import engine as jengine
from repro.slam import metrics as jmetrics
from repro.slam import session as jsession
from repro.slam.datasets import make_dataset as jmake_dataset
from repro_torch import convert
from repro_torch.core import lie as tlie
from repro_torch.core.keyframes import KeyframePolicy as TPolicy
from repro_torch.core.pruning import PruneConfig as TPrune
from repro_torch.slam import engine as tengine
from repro_torch.slam import metrics as tmetrics
from repro_torch.slam import session as tsession
from repro_torch.slam.graphs import PhaseRunner
from repro_torch.slam.map import paged as tpaged

CFG = dict(iters_track=4, iters_map=4, capacity=1024, frag_capacity=48, map_window=2)
PRUNE = dict(k0=2, step_frac=0.08)
# ``iters_left`` at the frame's start -> the boundaries its 4 iterations
# fire: 2 fires at iterations 2 and 4 (the first boundary's baseline is
# the all-zero initial count, so the churn is high and K stays 2), 5 never.
LEFT = {2: [False, True, False, True], 5: [False] * 4}
CLOCKS = ("interval", "iters_left", "opt_steps")


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Tiny CPU ops run faster on one intra-op thread beside the test
    run's other workers; every mode runs under the same setting."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref(request, tmp_path_factory):
    return shared(request, tmp_path_factory, "torch_prune_device_ref", _ref_runs)


def _ref_runs():
    """The reference's tracking phase with pruning from its seeded map, at
    each start of ``LEFT``: the caller's build at the base pose, then
    ``_Stage.track_scan_prune`` (one ``lax.scan``)."""
    ds = jmake_dataset("room0", num_frames=2, height=48, width=64,
                       num_gaussians=400, frag_capacity=48)
    cfg = jsession.SLAMConfig(backend="ref", keyframe=JPolicy(interval=2), scan_unroll=1,
                              prune=JPrune(**PRUNE), **CFG)
    g = jsession._seed_map(ds, cfg)
    st = jengine._Stage(ds.intrinsics, cfg, 1)
    base = jnp.asarray(ds.frames[0].w2c_gt)
    f1 = ds.frames[1]
    out = {"ds": convert.dataset_from_numpy(ds, device="cpu"), "g": jax.device_get(g),
           "base": np.asarray(base), "runs": {}}
    for left in LEFT:
        ps = jp.init_state(g, st.grid.num_tiles, cfg.prune)._replace(
            interval=jnp.asarray(left, jnp.int32), iters_left=jnp.asarray(left, jnp.int32))
        start = jax.device_get(ps)
        frags = st.build(g, ps.masked, base)
        xi, g_out, ps_out, work, losses, fired = st.track_scan_prune(
            jax.tree_util.tree_map(jnp.copy, g), ps, base, jnp.asarray(f1.rgb),
            jnp.asarray(f1.depth), frags, jmetrics.device_work_zero())
        out["runs"][left] = jax.device_get(dict(
            start=start, pose=jlie.se3_exp(xi) @ base, alive=g_out.alive, pstate=ps_out,
            work=work, fired=fired))
    return out


@pytest.fixture(scope="module")
def port(ref):
    return dict(ds=ref["ds"], g=convert.field_from_numpy(ref["g"], device="cpu"),
                base=th(ref["base"]))


def _state(ref, left):
    return convert.prune_state_from_numpy(ref["runs"][left]["start"], device="cpu")


def _stage(port, **kw):
    cfg = tsession.SLAMConfig(keyframe=TPolicy(interval=2), prune=TPrune(**PRUNE),
                              **{**CFG, **kw})
    return tengine._Stage(port["ds"].intrinsics, cfg, torch.device("cpu"))


def _row(port, ps):
    f1 = port["ds"].frames[1]
    return (port["g"], ps.masked, ps, port["base"], f1.rgb, f1.depth,
            tmetrics.device_work_zero("cpu"))


def _same_rows(a, b) -> bool:
    """Two rows of ``_track_rows`` bit for bit (``view_idx`` aside)."""
    ta = tree_tensors([x for i, x in enumerate(a) if i != 4])
    tb = tree_tensors([x for i, x in enumerate(b) if i != 4])
    return len(ta) == len(tb) and all(same_bits(x, y) for x, y in zip(ta, tb))


@pytest.mark.parametrize("left", sorted(LEFT))
@pytest.mark.parametrize("backend", ["kernel", "schedule"])
def test_one_segment_tracking_matches_the_reference(ref, port, backend, left):
    """The port's fused tracking phase (one segment run, every boundary
    inside it) against the reference's ``_track_scan_prune``: the pose
    within 1e-4 per entry (``test_torch_rtgs_session.py``'s one-step
    bound), ``fired``, the clock, ``removed``, the masked and alive counts,
    ``prev_tile_count`` and every work counter exactly."""
    st = _stage(port, backend=backend)
    xi, g, ps, work, losses, fired = st._track_scan_prune(
        *[x for i, x in enumerate(_row(port, _state(ref, left))) if i != 1])
    want = ref["runs"][left]
    assert np_(fired).tolist() == np.asarray(want["fired"]).tolist() == LEFT[left]
    pose = tlie.se3_exp(xi) @ port["base"]
    np.testing.assert_allclose(np_(pose), want["pose"], atol=1e-4)
    for f in CLOCKS:
        got = getattr(ps, f)
        assert got.dtype == torch.int32 and got.shape == ()
        assert int(got) == int(getattr(want["pstate"], f)), f
    assert int(ps.removed) == int(want["pstate"].removed)
    assert (int(ps.removed) > 0) == (left == 2)
    assert int(ps.masked.sum()) == int(np.asarray(want["pstate"].masked).sum())
    assert (int(ps.masked.sum()) > 0) == (left == 2)
    assert np.array_equal(np_(ps.prev_tile_count), np.asarray(want["pstate"].prev_tile_count))
    assert int(g.alive.sum()) == int(np.asarray(want["alive"]).sum())
    for f, v in zip(want["work"]._fields, want["work"]):
        assert int(getattr(work, f)) == int(v), f
    assert losses.shape == (CFG["iters_track"],)
    assert (st.runner.stats.dispatches, st.runner.stats.syncs) == (1, 0)


@pytest.mark.parametrize("backend", ["kernel", "schedule"])
def test_fused_equals_eager_solo_and_two_rows(ref, port, backend):
    """Fused and eager (``fused=False``) tracking phases agree bit for bit,
    solo and as one S=2 run whose rows fire two boundaries and none; each
    row equals its solo run.  Fused, a run is one dispatch and no sync;
    eager, the build (and schedule), the K iterations and per fired
    boundary a rebuild, ``interval_update`` (and a schedule), with one
    read per iteration for the boundary check."""
    fused, eager = _stage(port, backend=backend), _stage(port, backend=backend, fused=False)
    sched, k = backend == "schedule", CFG["iters_track"]
    solo = {}
    for left in LEFT:
        before = dataclasses.replace(eager.runner.stats)
        a = fused._track_rows([_row(port, _state(ref, left))])[0]
        b = eager._track_rows([_row(port, _state(ref, left))])[0]
        assert _same_rows(a, b), left
        n = sum(LEFT[left])
        counts = eager.runner.stats.since(before)
        assert (counts.dispatches, counts.syncs) == (1 + sched + k + n * (2 + sched), k)
        solo[left] = a
    assert (fused.runner.stats.dispatches, fused.runner.stats.syncs) == (2, 0)
    rows = [_row(port, _state(ref, left)) for left in sorted(LEFT)]
    before = dataclasses.replace(fused.runner.stats)
    both = fused._track_rows(rows)
    counts = fused.runner.stats.since(before)
    assert (counts.dispatches, counts.syncs) == (1, 0)
    assert all(_same_rows(r, solo[left]) for r, left in zip(both, sorted(LEFT)))
    assert all(_same_rows(r, e) for r, e in zip(both, eager._track_rows(rows)))


def test_paged_with_every_page_in_view_equals_flat(ref, port):
    """With all 8 pages of 128 rows in view the working set is the whole
    pool in order, so the paged phase (cull, gather, build, iterations,
    boundaries, scatter-back) equals the flat one bit for bit."""
    flat = _stage(port)
    paged = _stage(port, paged=tpaged.PagedConfig(128, 8))
    page = tpaged.build_page_table(port["g"], paged.cfg.paged)
    ring = port["base"][None].repeat(CFG["map_window"], 1, 1)
    for left in LEFT:
        a = flat._track_rows([_row(port, _state(ref, left))])[0]
        b = paged._track_rows([_row(port, _state(ref, left))], [(page, ring)])[0]
        assert torch.equal(b[4], torch.arange(CFG["capacity"]))
        assert _same_rows(a, b), left


def test_a_skipped_boundary_leaves_the_state(ref, port):
    """A frame whose boundary never fires returns the map's alive mask,
    the mask-pruned set, the churn baseline, ``removed`` and ``interval``
    as they came in; only the scores, the stability leaves and the two
    counting clocks move."""
    start = _state(ref, 5)
    _, g, ps, _, _, fired = _stage(port)._track_scan_prune(
        *[x for i, x in enumerate(_row(port, start)) if i != 1])
    assert not bool(fired.any())
    assert torch.equal(g.alive, port["g"].alive)
    for f in ("masked", "prev_tile_count", "removed", "interval", "initial_alive"):
        assert same_bits(getattr(ps, f), getattr(start, f)), f
    assert int(ps.iters_left) == 5 - CFG["iters_track"]
    assert int(ps.opt_steps) == CFG["iters_track"]
    assert not torch.equal(ps.score, start.score)


def _toy_segment(n):
    """``n`` iterations over a state buffer ``x``: each doubles it, then
    under ``when(flag_i)`` a body adds ``y`` in place and counts itself."""
    def fn(t, when):
        x, runs = t["x"].clone(), torch.zeros((), dtype=torch.int64)
        for i in range(n):
            x.copy_(x * 2.0)

            def body():
                x.add_(t["y"])
                runs.add_(1)

            when(t["flags"][i], body)
        return {"x": x, "runs": runs}
    return fn


@pytest.mark.parametrize("fused", [True, False])
def test_conditional_body_inside_a_segment(fused):
    """A conditional body inside a segment's loop, skipped and run: the
    result equals the same loop written out on the host with the body
    where its flag holds, and a skipped body leaves the buffer as the
    previous iteration left it.  Fused (on the CPU) a run is one dispatch
    and no sync; eager, one read per ``when``."""
    r = np.random.default_rng(23)
    x0, y = r.normal(size=5).astype(np.float32), r.normal(size=5).astype(np.float32)
    runner = PhaseRunner("cpu", fused=fused)
    for flags in ([False] * 3, [True, False, True], [True] * 3):
        inputs = {"x": th(x0), "y": th(y), "flags": torch.tensor(flags)}
        before = dataclasses.replace(runner.stats)
        _, (out,) = runner.run("toy", _toy_segment(3), inputs, conditional=True)
        counts = runner.stats.since(before)
        want = x0.copy()
        for f in flags:
            want = want * np.float32(2.0)
            if f:
                want = want + y
        assert np.array_equal(np_(out["x"]), want), flags
        assert int(out["runs"]) == sum(flags)
        assert (counts.dispatches, counts.syncs) == ((1, 0) if fused else
                                                     (1 + sum(flags), 3))
        assert np.array_equal(np_(inputs["x"]), x0)     # the inputs stay as given
