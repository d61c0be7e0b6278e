"""The 3D Gaussian scene representation (counterpart of
``repro/core/gaussians.py``).

``GaussianField`` is a fixed-capacity structure of tensors; SLAM adds and
removes Gaussians by toggling the ``alive`` mask, exactly as the reference
does, so every shape stays put for the whole session.
"""

from __future__ import annotations

import dataclasses

import torch

PARAM_FIELDS = ("mu", "log_scale", "quat", "logit_o", "color")


@dataclasses.dataclass
class GaussianField:
    mu: torch.Tensor         # (N, 3) float32
    log_scale: torch.Tensor  # (N, 3) float32
    quat: torch.Tensor       # (N, 4) float32
    logit_o: torch.Tensor    # (N,) float32
    color: torch.Tensor      # (N, 3) float32 (pre-sigmoid)
    alive: torch.Tensor      # (N,) bool

    @property
    def capacity(self) -> int:
        return self.mu.shape[0]

    def replace(self, **kw) -> "GaussianField":
        return dataclasses.replace(self, **kw)

    def num_alive(self) -> torch.Tensor:
        return self.alive.sum()

    def opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.logit_o)

    def rgb(self) -> torch.Tensor:
        return torch.sigmoid(self.color)

    def scales(self) -> torch.Tensor:
        return torch.exp(self.log_scale)

    def rotations(self) -> torch.Tensor:
        """Unit quaternions -> (N,3,3) rotation matrices."""
        q = self.quat / (torch.linalg.norm(self.quat, dim=-1, keepdim=True) + 1e-9)
        w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
        return torch.stack(
            [
                torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
                torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
                torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
            ],
            dim=-2,
        )

    def covariance(self) -> torch.Tensor:
        """3D covariance Sigma = R S S^T R^T, (N,3,3)."""
        RS = self.rotations() * self.scales()[:, None, :]
        return RS @ RS.transpose(-1, -2)


def params_of(g: GaussianField) -> dict:
    """The trainable float leaves (everything but ``alive``)."""
    return {f: getattr(g, f) for f in PARAM_FIELDS}


def with_params(g: GaussianField, params: dict) -> GaussianField:
    return g.replace(**params)


def empty(capacity: int, device="cpu") -> GaussianField:
    f32 = dict(dtype=torch.float32, device=device)
    quat = torch.zeros((capacity, 4), **f32)
    quat[:, 0] = 1.0
    return GaussianField(
        mu=torch.zeros((capacity, 3), **f32),
        log_scale=torch.full((capacity, 3), -10.0, **f32),
        quat=quat,
        logit_o=torch.full((capacity,), -10.0, **f32),
        color=torch.zeros((capacity, 3), **f32),
        alive=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )


def from_points(points: torch.Tensor, colors: torch.Tensor, capacity: int,
                scale: float = 0.05, opacity: float = 0.7) -> GaussianField:
    """Seed a field from a point cloud (e.g. back-projected depth)."""
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"{n} points exceed capacity {capacity}")
    g = empty(capacity, device=points.device)
    c = torch.clamp(colors, 1e-4, 1 - 1e-4)
    g.mu[:n] = points
    # float32 logs, as the reference takes them
    g.log_scale[:n] = torch.log(torch.tensor(scale, dtype=torch.float32))
    g.logit_o[:n] = torch.log(torch.tensor(opacity / (1 - opacity),
                                           dtype=torch.float32))
    g.color[:n] = torch.log(c / (1 - c))
    g.alive[:n] = True
    return g


def insert(g: GaussianField, new: GaussianField, max_new: int) -> GaussianField:
    """Insert up to ``max_new`` alive entries of ``new`` into dead slots of
    ``g``: the lowest-index dead slots take the lowest-index alive entries.

    As in the reference, every invalid source is parked at a dump slot and
    dropped: the scatter writes into a ``capacity + 1`` buffer whose last
    slot is cut off.  No valid index is written twice, and nothing is read
    back to the host, so a CUDA graph can capture it."""
    dead = ~g.alive
    dead_rank = torch.cumsum(dead.to(torch.int32), 0, dtype=torch.int32) - 1
    src_rank = torch.cumsum(new.alive.to(torch.int32), 0, dtype=torch.int32) - 1
    take = torch.where(dead & (dead_rank < max_new), dead_rank,
                       torch.full_like(dead_rank, -1))
    valid_src = new.alive & (src_rank < min(max_new, g.capacity))
    dest = torch.where(valid_src, src_rank,
                       torch.full_like(src_rank, g.capacity)).long()
    src_idx_for_rank = torch.full((g.capacity + 1,), -1, dtype=torch.int64,
                                  device=g.mu.device)
    src_idx_for_rank.scatter_(0, dest, torch.arange(new.capacity, device=g.mu.device))
    src_idx_for_rank = src_idx_for_rank[:g.capacity]
    src_for_slot = torch.where(
        take >= 0, src_idx_for_rank[take.clamp(0, g.capacity - 1).long()],
        torch.full_like(src_idx_for_rank, -1))
    use = src_for_slot >= 0
    sf = src_for_slot.clamp(0, new.capacity - 1)

    def mix(dst, src):
        return torch.where(use.reshape((-1,) + (1,) * (dst.ndim - 1)), src[sf], dst)

    return GaussianField(
        mu=mix(g.mu, new.mu),
        log_scale=mix(g.log_scale, new.log_scale),
        quat=mix(g.quat, new.quat),
        logit_o=mix(g.logit_o, new.logit_o),
        color=mix(g.color, new.color),
        alive=g.alive | use,
    )
