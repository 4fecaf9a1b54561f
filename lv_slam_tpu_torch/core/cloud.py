"""Fixed-capacity point cloud container (port of `lv_slam_tpu.core.cloud`).

A cloud is a `(cap, 3)` float32 position tensor, a `(cap,)` float32
intensity tensor and a `(cap,)` bool mask. Invalid lanes carry the far-away
`SENTINEL` position, as in the reference, so voxel keys of masked lanes
fall outside every grid extent.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

SENTINEL = 1.0e6


class PointCloud(NamedTuple):
    """Padded point cloud: positions `(cap,3)`, intensity `(cap,)`, mask `(cap,)`."""

    xyz: torch.Tensor
    intensity: torch.Tensor
    mask: torch.Tensor

    @classmethod
    def from_numpy(cls, points, cap: int, device="cuda", intensity=None) -> "PointCloud":
        """Build from a host `(n, 3)` or `(n, 4)` array, padding/truncating to
        cap, on the card unless the caller asks for another device."""
        points = np.asarray(points, dtype=np.float32)
        if points.ndim != 2:
            raise ValueError(f"points must be (n,3|4), got {points.shape}")
        if points.shape[1] >= 4 and intensity is None:
            intensity = points[:, 3]
        xyz_np = points[:, :3]
        n = min(xyz_np.shape[0], cap)
        xyz = np.full((cap, 3), SENTINEL, dtype=np.float32)
        inten = np.zeros((cap,), dtype=np.float32)
        mask = np.zeros((cap,), dtype=bool)
        xyz[:n] = xyz_np[:n]
        if intensity is not None:
            inten[:n] = np.asarray(intensity, dtype=np.float32)[:n]
        mask[:n] = np.isfinite(xyz_np[:n]).all(axis=1)
        xyz[:n][~mask[:n]] = SENTINEL
        return cls(
            torch.from_numpy(xyz).to(device),
            torch.from_numpy(inten).to(device),
            torch.from_numpy(mask).to(device),
        )

    @property
    def cap(self) -> int:
        return self.xyz.shape[0]

    def to(self, device) -> "PointCloud":
        return PointCloud(self.xyz.to(device), self.intensity.to(device), self.mask.to(device))

    def transformed(self, transform: torch.Tensor) -> "PointCloud":
        """The cloud moved by a (4,4) transform, invalid lanes at the sentinel."""
        from lv_slam_tpu_torch.core import se3

        xyz = se3.transform_points_fma(transform, self.xyz)
        return PointCloud(torch.where(self.mask[:, None], xyz, SENTINEL), self.intensity, self.mask)

    def masked_xyz(self) -> torch.Tensor:
        """Positions with invalid lanes pinned to the sentinel."""
        return torch.where(self.mask[:, None], self.xyz, SENTINEL)

    def compact(self, out_cap: Optional[int] = None) -> "PointCloud":
        """Stable-move valid lanes to the front and keep the first `out_cap`
        lanes (the reference's slice: the result has min(cap, out_cap) lanes)."""
        out_cap = out_cap or self.cap
        idx = torch.argsort((~self.mask).to(torch.uint8), stable=True)[:out_cap]
        mask = self.mask[idx]
        xyz = torch.where(mask[:, None], self.xyz[idx], SENTINEL)
        return PointCloud(xyz, self.intensity[idx], mask)
