"""Shared helpers of the ``test_torch_*`` parity tests: tolerances, numpy
inputs made from a seed, and numpy <-> JAX / torch conversion.  The kernels'
packed inputs come from ``_kernel_inputs`` (numpy only).

The tolerances start from the reference's own kernel tests
(``tests/test_kernels.py``): forward atol 2e-5 / rtol 1e-4 on color, final
T and the stash and 1e-4 on depth; backward atol max(3e-6, 3e-5 max|g|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

FWD_ATOL, FWD_RTOL, DEPTH_TOL = 2e-5, 1e-4, 1e-4


@pytest.fixture(scope="module", autouse=True)
def first_cpu_exp_spent():
    """Spend a process's first CPU ``torch.exp`` before a module's forward
    tolerances are checked.  Once, in a full run, a forward parity case of
    the plain scheduled kernels failed by ~1.5e-4 (relative), and the first
    ``torch.exp`` of a fresh process was seen off every later call's on the
    same input; the cause is not known and later probes did not reproduce
    it (ROADMAP, Queue 3).  Modules whose plain-kernel forward outputs are
    held to the reference's tolerances import this fixture."""
    torch.exp(torch.linspace(-40.0, 0.0, 20480))


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread for a module's torch work.  The tier-1 command
    runs six pytest-xdist workers; at torch's default of one thread per
    core each worker's parallel ops contend with the others' (five port
    files took 215 s at the default and 123 s at one thread, six workers on
    eight cores).  Modules import this fixture to take it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def grad_atol(ref_grad) -> float:
    return max(3e-6, 3e-5 * float(np.max(np.abs(np.asarray(ref_grad)))))


def np_(x) -> np.ndarray:
    """numpy copy of a JAX array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def jx(a):
    return jnp.asarray(np.asarray(a))


def th(a, dtype=None, requires_grad=False):
    t = torch.as_tensor(np.array(a), dtype=dtype)
    return t.requires_grad_(True) if requires_grad else t


def assert_grads_close(ref_grads, port_grads, names):
    for a, b, name in zip(ref_grads, port_grads, names):
        np.testing.assert_allclose(np_(b), np_(a), atol=grad_atol(a),
                                   err_msg=f"gradient of {name}")


def tiny_cloud(seed=0, n=200, extra=56):
    """``tiny_scene``-sized cloud (numpy): points, colors, capacity."""
    r = np.random.default_rng(seed)
    pts = r.uniform(-1, 1, (n, 3)) * np.array([1.5, 1.0, 0.5]) + np.array([0.0, 0.0, 3.0])
    cols = r.uniform(0, 1, (n, 3))
    return pts.astype(np.float32), cols.astype(np.float32), n + extra
