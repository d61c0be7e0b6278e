"""Keyframe selection policies of the base algorithms (counterpart of
``repro/core/keyframes.py``).

Each base algorithm keeps its own policy (§6.1):
  * MonoGS      — a fixed frame interval;
  * GS-SLAM     — scene change by pose distance (translation / rotation);
  * Photo-SLAM  — photometric change against the last keyframe;
  * SplaTAM     — every frame.

MonoGS's and SplaTAM's decisions are host ``bool``s of the frame counts
(:meth:`KeyframePolicy.host_decision`).  GS-SLAM's and Photo-SLAM's compare
device values (a pose, an image difference): :meth:`KeyframePolicy.device_decision`
is a () bool tensor, which the session computes inside its keyframe graph,
ahead of the conditional node it gates, so nothing is read back
(``slam/session.py``).  :meth:`KeyframePolicy.is_keyframe` reads it for a
host caller (the §4.2 factor choice on host frames).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import lie

KINDS = ("monogs", "gsslam", "photoslam", "splatam")


@dataclasses.dataclass
class KeyframePolicy:
    kind: str = "monogs"        # monogs | gsslam | photoslam | splatam
    interval: int = 8           # monogs fixed interval
    trans_thresh: float = 0.25  # gsslam: meters
    rot_thresh: float = 0.25    # gsslam: radians
    pho_thresh: float = 0.10    # photoslam: RMSE threshold

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown keyframe policy {self.kind!r}; "
                             f"known: {', '.join(KINDS)}")

    @property
    def on_host(self) -> bool:
        """Whether the frame counts alone decide (MonoGS, SplaTAM)."""
        return self.kind in ("monogs", "splatam")

    def is_keyframe(self, frame_idx: int, frames_since_kf: int,
                    cur_pose=None, last_kf_pose=None, cur_rgb=None,
                    last_kf_rgb=None) -> bool:
        """GS-SLAM needs both poses ((4, 4) w2c) and Photo-SLAM both images;
        the other policies read only the frame counts."""
        decision = self.host_decision(frame_idx, frames_since_kf)
        if decision is None and (self.kind == "gsslam" or last_kf_rgb is not None):
            decision = self.device_decision(cur_pose, last_kf_pose, cur_rgb, last_kf_rgb)
        return decision is None or bool(decision)

    def host_decision(self, frame_idx: int, frames_since_kf) -> bool | None:
        """The decision where the frame counts make it (frame 0, MonoGS,
        SplaTAM); ``None`` where the device decides (GS-SLAM, Photo-SLAM),
        which needs no ``frames_since_kf``."""
        if frame_idx == 0 or self.kind == "splatam":
            return True
        if self.kind == "monogs":
            return frames_since_kf >= self.interval
        return None

    def device_decision(self, cur_pose=None, last_kf_pose=None, cur_rgb=None,
                        last_kf_rgb=None) -> torch.Tensor:
        """GS-SLAM's or Photo-SLAM's decision as a () bool tensor on the
        inputs' device, read by nothing: GS-SLAM's from the pose distance,
        Photo-SLAM's from the RMSE against the last keyframe's image."""
        if self.kind == "gsslam":
            rel = lie.se3_log(torch.as_tensor(cur_pose)
                              @ lie.se3_inverse(torch.as_tensor(last_kf_pose)))
            return ((torch.linalg.vector_norm(rel[:3]) > self.trans_thresh)
                    | (torch.linalg.vector_norm(rel[3:]) > self.rot_thresh))
        diff = torch.as_tensor(cur_rgb) - torch.as_tensor(last_kf_rgb)
        return torch.sqrt(torch.mean(diff * diff)) > self.pho_thresh
