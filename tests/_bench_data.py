"""The reference PagedMap bench's corridor0 dataset as a numpy file, so the
port's smoke run on the card (which has no JAX) runs the bench's config on
the bench's own inputs (``benchmarks/bench_paged.py:124-126``: 24 frames,
48x64, 4096 ground-truth Gaussians, ``frag_capacity=256``).

Regenerate with ``PYTHONPATH=src python tests/_bench_data.py``;
``tests/test_torch_paged_session.py`` checks the file against the
reference's ``make_dataset``.
"""

import pathlib

import numpy as np

PATH = pathlib.Path(__file__).resolve().parent / "data" / "corridor0_48x64_24.npz"
KW = dict(num_frames=24, height=48, width=64, num_gaussians=4096, frag_capacity=256)


def reference_arrays() -> dict:
    """The reference's dataset as numpy arrays (imports the JAX package)."""
    from repro.slam.datasets import make_dataset
    ds = make_dataset("corridor0", **KW)
    g = ds.gt_field
    i = ds.intrinsics
    return dict(
        intrinsics=np.asarray([i.fx, i.fy, i.cx, i.cy, i.width, i.height], np.float64),
        rgb=np.stack([np.asarray(f.rgb, np.float32) for f in ds.frames]),
        depth=np.stack([np.asarray(f.depth, np.float32) for f in ds.frames]),
        w2c=np.stack([np.asarray(f.w2c_gt, np.float32) for f in ds.frames]),
        **{f"gt_{k}": np.asarray(getattr(g, k))
           for k in ("mu", "log_scale", "quat", "logit_o", "color", "alive")})


if __name__ == "__main__":
    PATH.parent.mkdir(exist_ok=True)
    np.savez_compressed(PATH, **reference_arrays())
    print(f"wrote {PATH} ({PATH.stat().st_size} bytes)")
