"""Keyframe selection policies of the base algorithms (counterpart of
``repro/core/keyframes.py``).

Each base algorithm keeps its own policy (§6.1):
  * MonoGS      — a fixed frame interval;
  * GS-SLAM     — scene change by pose distance (translation / rotation);
  * Photo-SLAM  — photometric change against the last keyframe;
  * SplaTAM     — every frame.

The decisions are host ``bool``s.  GS-SLAM's and Photo-SLAM's read device
values (a pose, an image difference), which costs one sync each.
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

    def is_keyframe(self, frame_idx: int, frames_since_kf: int,
                    cur_pose=None, last_kf_pose=None, cur_rgb=None,
                    last_kf_rgb=None) -> bool:
        """GS-SLAM needs both poses ((4, 4) w2c) and Photo-SLAM both images;
        the other policies read only the frame counts."""
        return bool(self.keyframe_test(frame_idx, frames_since_kf, cur_pose,
                                       last_kf_pose, cur_rgb, last_kf_rgb))

    def keyframe_test(self, frame_idx: int, frames_since_kf: int,
                      cur_pose=None, last_kf_pose=None, cur_rgb=None,
                      last_kf_rgb=None):
        """:meth:`is_keyframe`'s decision before it is read: a host
        ``bool``, or for GS-SLAM and Photo-SLAM a () bool tensor on the
        device, so that a caller can read the decisions of many sessions
        at once."""
        if frame_idx == 0 or self.kind == "splatam":
            return True
        if self.kind == "monogs":
            return frames_since_kf >= self.interval
        if self.kind == "gsslam":
            rel = lie.se3_log(torch.as_tensor(cur_pose)
                              @ lie.se3_inverse(torch.as_tensor(last_kf_pose)))
            return ((torch.linalg.vector_norm(rel[:3]) > self.trans_thresh)
                    | (torch.linalg.vector_norm(rel[3:]) > self.rot_thresh))
        if last_kf_rgb is None:
            return True
        diff = torch.as_tensor(cur_rgb) - torch.as_tensor(last_kf_rgb)
        return torch.sqrt(torch.mean(diff * diff)) > self.pho_thresh


def read_decisions(tests) -> list:
    """Host bools of :meth:`KeyframePolicy.keyframe_test` results, with
    every device decision among them read in one transfer."""
    on_dev = [t for t in tests if isinstance(t, torch.Tensor)]
    read = iter(torch.stack(on_dev).tolist() if on_dev else [])
    return [bool(next(read)) if isinstance(t, torch.Tensor) else bool(t)
            for t in tests]
