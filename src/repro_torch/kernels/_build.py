"""Build and load the CUDA kernels in ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``build/repro_torch/`` at the
root of the checkout and loaded with ``ctypes``; the library's file name
carries a hash of its source, so an edited source is rebuilt.  Nothing
here runs at import time, and nothing falls back: a failed build raises.

``build_all`` starts one ``nvcc`` per source at once and waits for all of
them; the ``-Xptxas -v`` report of each build (registers, shared memory,
spills) is kept in :data:`PTXAS_REPORT`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("tile_render", "tile_render_bp", "gmu", "graph_cond")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # No fused multiply-add contraction: the kernels keep the rounding of
    # the reference's separate multiplies and adds, so the transmittance
    # and termination decisions match the plain versions.
    "-fmad=false",
    "-Xptxas", "-v",
)

PTXAS_REPORT: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names=SOURCES, force: bool = False) -> None:
    """Compile every missing library (every one with ``force``), one
    ``nvcc`` per source, all started at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {n: _start(n) for n in names
               if force or not _lib_path(n).exists()}
    failed = []
    for name, (proc, tmp, out) in started.items():
        log, _ = proc.communicate()
        PTXAS_REPORT[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    if name not in _LIBS:
        if not _lib_path(name).exists():
            build_all((name,))
        _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return _LIBS[name]
