"""Three-term roofline of one counted step on the card (the port of
``repro.analysis.roofline``).

    compute    = counted FLOPs  / (chips * peak FLOP/s)
    memory     = counted bytes  / (chips * HBM bandwidth)
    collective = coll_bytes     / (chips * link bandwidth)

The constants are one NVIDIA H100 SXM's (NVIDIA's data sheet, dense rates,
at its full 700 W power limit; a card set below it runs slower under
load): 989 TFLOP/s bf16, 3.35 TB/s HBM3, 450 GB/s of NVLink 4 per
direction.

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` of a
compiled step (``from_compiled``), which has no PyTorch counterpart; it
also counts a scanned layer stack's body once, not once per layer.  Here
:func:`count_step` runs the step once and counts what this rank ran, as
``hlo_counter`` counts one device's partitioned program: FLOPs with
``torch.utils.flop_counter.FlopCounterMode`` (matrix products and
convolutions, each GEMM's 2·m·n·k; elementwise work is not counted), bytes
as the sum over every aten op of its tensor operands' and results' sizes
(what XLA's "bytes accessed" sums per HLO op; views move nothing and are
skipped), and collective bytes from ``analysis/census.py``.  A DTensor op
counts as the ops DTensor runs on this rank's local shards.  Work that
``torch.utils.checkpoint`` recomputes in the backward runs again and is
counted again, so ``flops_ratio`` = MODEL_FLOPS / counted FLOPs shows
remat's cost.  MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) for
training, 2*N*D otherwise.
"""

from __future__ import annotations

import dataclasses
import json

from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis import census
from repro_torch.configs.base import ArchConfig, ShapeSpec

PEAK_FLOPS = 989e12      # bf16 dense, H100 SXM 80GB HBM3 at 700 W
HBM_BW = 3.35e12         # bytes/s, H100 SXM 80GB HBM3 at 700 W
LINK_BW = 450e9          # bytes/s per direction, NVLink 4 (H100 SXM, 700 W)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float          # the counted FLOPs of the step
    hlo_bytes: float          # the counted bytes of the step
    collective_bytes: float
    model_flops: float
    per_device_hbm_bytes: float

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / (self.chips * LINK_BW)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — how much of the computed work is useful."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / bound step time (the score)."""
        t_useful = self.model_flops / (self.chips * PEAK_FLOPS)
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        return t_useful / t_bound if t_bound else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops, "hlo_flops": self.hlo_flops,
            "flops_ratio": self.flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "per_device_hbm_gb": self.per_device_hbm_bytes / 1e9,
        }


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """6*N*D for training, 2*N*D per generated/processed token otherwise."""
    n = cfg.active_param_count()
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * tokens


def peak_share(flops: float, seconds: float) -> float:
    """``flops`` done in ``seconds`` as a share of one card's bf16 peak:
    with MODEL_FLOPS the model-FLOP utilization, with counted FLOPs the
    share of the peak the step's products ran at."""
    return flops / (seconds * PEAK_FLOPS)


def count_step(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and count this rank's work:
    {"flops", "bytes", "collective_bytes", "collectives" (``census.
    collective_stats``), "transcendentals", "out"}.  A training step's backward runs inside
    ``fn`` and is counted with it, checkpoint recomputation included.  On
    one card, or a mesh of one rank, no collective runs and
    ``collective_bytes`` is 0."""
    # the census above the FLOP counter: it steps aside for a DTensor op,
    # so neither sees one, only the local ops DTensor runs
    with FlopCounterMode(display=False) as fc, census.Census() as cs:
        out = fn(*args, **kwargs)
    return {"flops": float(fc.get_total_flops()), "bytes": float(cs.bytes),
            "collective_bytes": float(census.total_collective_bytes(cs)),
            "collectives": census.collective_stats(cs),
            "transcendentals": float(cs.transcendentals), "out": out}


def from_counts(cfg: ArchConfig, shape: ShapeSpec, mesh_name: str, chips: int,
                counts: dict, peak_bytes: float) -> Roofline:
    """A :class:`Roofline` from :func:`count_step`'s counts of one rank and
    the step's peak device memory: the step's totals are ``chips`` times one
    rank's, as the reference's dry run scales its per-device counts.  On one
    card the collective bytes are 0 and the collective term never bounds."""
    return Roofline(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_flops=counts["flops"] * chips, hlo_bytes=counts["bytes"] * chips,
        collective_bytes=counts.get("collective_bytes", 0.0) * chips,
        model_flops=model_flops(cfg, shape),
        per_device_hbm_bytes=float(peak_bytes),
    )


def save_rows(rows, path: str):
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)
