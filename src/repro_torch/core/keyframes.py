"""Keyframe selection policy (counterpart of ``repro/core/keyframes.py``).

The port runs the MonoGS fixed-interval policy.  The other kinds exist as
values of ``kind`` but are not ported yet; the session rejects them.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class KeyframePolicy:
    kind: str = "monogs"        # monogs | gsslam | photoslam | splatam
    interval: int = 8           # monogs fixed interval
    trans_thresh: float = 0.25  # gsslam: meters
    rot_thresh: float = 0.25    # gsslam: radians
    pho_thresh: float = 0.10    # photoslam: RMSE threshold

    def is_keyframe(self, frame_idx: int, frames_since_kf: int) -> bool:
        if self.kind != "monogs":
            raise NotImplementedError(
                f"keyframe policy {self.kind!r} is not ported yet")
        return frame_idx == 0 or frames_since_kf >= self.interval
