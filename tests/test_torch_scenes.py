"""Parity of the port's scenes with ``repro``'s: the trajectories of all six
registered scenes, and the point clouds of ``desk0``, ``stairs0`` and
``corridor0`` surface by surface.

The port draws its points with numpy and the reference with
``jax.random``, so no point can be equal.  What involves no draw is held
equal: the trajectories (within float32 rounding) and each surface's share
of the points (exactly).  Each surface's per-axis extents are held within a
tolerance that follows from how it is drawn: 2% of the span + 4 cm for a
uniform draw (the extremes of a few hundred uniform draws sit within ~1% of
the bounds; stairs0 and corridor0 add 8 mm of normal noise, ~3 cm at its
extremes), and 2 sigma + 4 cm along an axis drawn from a normal of scale
sigma (the extremes of a few hundred normal draws vary by ~0.5 sigma).
"""

import zlib

import jax
import numpy as np
import pytest
import torch

from _torch_parity import one_cpu_thread  # noqa: F401  (autouse fixture)
from repro.slam import datasets as jdatasets
from repro_torch.slam import datasets as tdatasets

N = 4096
NEW_SCENES = ("desk0", "stairs0", "corridor0")


def _surfaces(name: str, n: int):
    """[(surface, rows, per-axis normal scale or None)] in the order both
    packages concatenate them, from the reference recipe's counts."""
    if name == "desk0":
        clutter = n - 2 * (n // 8)
        per = clutter // 3
        return [("wall", n // 8, None), ("floor", n // 8, None),
                ("blob 0", clutter - 2 * per, 0.18), ("blob 1", per, 0.16),
                ("blob 2", per, 0.14)]
    if name == "stairs0":
        n_steps = n - n // 8
        w = np.array([(6 - k) ** 2 for k in range(6)], np.float64)
        counts = np.floor(n_steps * w / w.sum()).astype(int)
        counts[0] += n_steps - int(counts.sum())
        return ([(f"step {k}", int(c), None) for k, c in enumerate(counts)]
                + [("landing wall", n // 8, None)])
    assert name == "corridor0"
    pillars = n - 3 * (n // 4)
    per = pillars // 6
    return ([("floor", n // 4, None), ("left wall", n // 4, None),
             ("right wall", n // 4, None)]
            + [(f"pillar {i}", pillars - 5 * per if i == 0 else per,
                np.array([0.12, 0.45, 0.12])) for i in range(6)])


def _clouds(name: str, seed: int = 0):
    salt = seed + zlib.crc32(name.encode()) % 1000
    pj, cj = jdatasets._surface_points(jax.random.PRNGKey(salt), name, N)
    pt, ct = tdatasets._surface_points(np.random.default_rng(salt), name, N)
    return (np.asarray(pj), np.asarray(cj)), (pt, ct)


def test_registry_is_the_reference_registry():
    assert tdatasets.SCENES == jdatasets.SCENES
    with pytest.raises(ValueError, match="registered scenes"):
        tdatasets.make_dataset("attic0", device="cpu")


@pytest.mark.parametrize("name", jdatasets.SCENES)
def test_trajectories_match(name):
    """Every pose of every scene within float32 rounding of the
    reference's (both build look-at matrices in float32)."""
    want = jdatasets._trajectory(name, 12)
    got = tdatasets._trajectory(name, 12)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=2e-6)


@pytest.mark.parametrize("name", NEW_SCENES)
def test_surface_shares_and_extents_match(name):
    (pj, cj), (pt, ct) = _clouds(name)
    assert pt.shape == pj.shape == (N, 3) and ct.shape == cj.shape == (N, 3)
    assert pt.dtype == ct.dtype == np.float32
    assert np.isfinite(pt).all() and (ct >= 0.02).all() and (ct <= 0.98).all()
    start = 0
    surfaces = _surfaces(name, N)
    assert sum(rows for _, rows, _ in surfaces) == N
    for surface, rows, sigma in surfaces:
        sj, st = pj[start:start + rows], pt[start:start + rows]
        start += rows
        span = sj.max(0) - sj.min(0)
        tol = (0.02 * span + 0.04 if sigma is None
               else 2.0 * np.broadcast_to(sigma, (3,)) + 0.04)
        for which, a, b in (("min", st.min(0), sj.min(0)), ("max", st.max(0), sj.max(0))):
            assert (np.abs(a - b) <= tol).all(), (
                f"{name} {surface} {which} {a} vs the reference's {b} (tol {tol})")


@pytest.mark.parametrize("name", NEW_SCENES)
def test_make_dataset_builds_each_new_scene_on_the_cpu(name):
    """Three frames on the CPU, at the reference's poses.  The first frame
    (the whole scene ahead of the camera) is held to the reference's own
    first frame in two statistics of the draws: the share of pixels with
    valid depth and the mean colour, each within 0.05 (measured: up to
    0.028 and 0.021; later frames of corridor0 sit among a few pillar
    points, whose draws differ)."""
    ds = tdatasets.make_dataset(name, num_frames=3, height=48, width=64,
                                num_gaussians=800, frag_capacity=48, device="cpu")
    assert ds.name == name and ds.num_frames == 3
    assert int(ds.gt_field.alive.sum()) == 800
    for f, pose in zip(ds.frames, tdatasets._trajectory(name, 3)):
        assert f.rgb.shape == (48, 64, 3) and f.depth.shape == (48, 64)
        assert f.rgb.device.type == "cpu"
        assert bool(torch.isfinite(f.rgb).all() and torch.isfinite(f.depth).all())
        assert np.array_equal(f.w2c_gt, pose)
    ref = jdatasets.make_dataset(name, num_frames=3, height=48, width=64,
                                 num_gaussians=800, frag_capacity=48).frames[0]
    got = ds.frames[0]
    valid = float((got.depth > 0).double().mean())
    assert valid == pytest.approx(float((ref.depth > 0).mean()), abs=0.05)
    np.testing.assert_allclose(got.rgb.mean(dim=(0, 1)).numpy(),
                               np.asarray(ref.rgb).mean(axis=(0, 1)), atol=0.05)


def test_desk_tile_loads_are_more_skewed_than_the_room():
    """desk0 exists for its skewed per-tile loads (the WSU's workload): the
    tile-load tail ratio (max / mean fragments per tile) of its first view
    exceeds room0's."""
    from repro_torch.core.camera import Camera
    from repro_torch.core.projection import project
    from repro_torch.core.sorting import build_fragment_lists, make_tile_grid

    ratio = {}
    for name in ("room0", "desk0"):
        ds = tdatasets.make_dataset(name, num_frames=1, height=96, width=128,
                                    num_gaussians=N, frag_capacity=4096,
                                    device="cpu")
        proj = project(ds.gt_field, Camera(ds.intrinsics, torch.as_tensor(
            ds.frames[0].w2c_gt)))
        count = build_fragment_lists(proj, make_tile_grid(96, 128), 4096).count
        ratio[name] = float(count.max()) / float(count.double().mean())
    assert ratio["desk0"] > ratio["room0"], ratio


def test_registered_scenes_match_the_reference():
    """The scene registry ``bench_sessions`` and ``bench_serve`` list."""
    assert tdatasets.registered_scenes() == jdatasets.registered_scenes()
    assert tdatasets.registered_scenes() is tdatasets.SCENES
