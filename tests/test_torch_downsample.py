"""Parity of the port's §4.2 dynamic downsampling
(``repro_torch.core.downsample``) with ``repro.core.downsample``: the
area-ratio schedule and its side factors for d = 1..12 (keyframe or not),
and image and depth pooling at factors 1, 2 and 4 with invalid depth."""

import numpy as np
import pytest

from _torch_parity import jx, np_, th
from _torch_parity import one_cpu_thread  # noqa: F401  (autouse fixture)
from repro.core import downsample as jds
from repro_torch.core import downsample as tds

CONFIGS = [dict(), dict(m=1.5), dict(m=3.0), dict(enabled=False)]


@pytest.mark.parametrize("cfg", CONFIGS)
def test_schedule_matches(cfg):
    cj, ct = jds.DownsampleConfig(**cfg), tds.DownsampleConfig(**cfg)
    assert tuple(ct) == tuple(cj)
    for d in range(1, 13):
        assert tds.area_ratio(d, ct) == jds.area_ratio(d, cj)
        for kf in (False, True):
            assert tds.side_factor(d, kf, ct) == jds.side_factor(d, kf, cj)


def test_default_schedule_factors():
    """m = 2: 1/16 of the area at d = 1, 1/8 at d = 2, 1/4 from d = 3."""
    assert [tds.side_factor(d, False) for d in range(1, 8)] == [4, 2, 2, 2, 2, 2, 2]
    assert tds.side_factor(8, True) == 1


@pytest.mark.parametrize("factor", [1, 2, 4])
@pytest.mark.parametrize("channels", [None, 3])
def test_image_pooling_matches(factor, channels):
    r = np.random.default_rng(factor)
    shape = (32, 48) + (() if channels is None else (channels,))
    img = r.uniform(size=shape).astype(np.float32)
    got = np_(tds.downsample_image(th(img), factor))
    want = np.asarray(jds.downsample_image(jx(img), factor))
    assert got.shape == want.shape == (32 // factor, 48 // factor) + shape[2:]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("factor", [1, 2, 4])
@pytest.mark.parametrize("invalid", [0.0, 0.5, 1.0])
def test_depth_pooling_ignores_invalid(factor, invalid):
    """Pixels <= 0 (zeros and negatives) are left out of each block's mean;
    a block with none valid pools to 0, never NaN."""
    r = np.random.default_rng(int(invalid * 10) + factor)
    depth = r.uniform(0.5, 4.0, size=(32, 48)).astype(np.float32)
    bad = r.uniform(size=depth.shape) < invalid
    depth[bad] = np.where(r.uniform(size=bad.sum()) < 0.5, 0.0, -1.0)
    depth[:factor, :factor] = 0.0          # one wholly invalid block
    got = np_(tds.downsample_depth(th(depth), factor))
    want = np.asarray(jds.downsample_depth(jx(depth), factor))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if factor > 1:
        assert got[0, 0] == 0.0


def test_pooling_rejects_a_ragged_frame():
    with pytest.raises(ValueError):
        tds.downsample_image(th(np.zeros((30, 32), np.float32)), 4)
