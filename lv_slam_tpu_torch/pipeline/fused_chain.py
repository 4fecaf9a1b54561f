"""The dlo -> LFA chain: NDT odometry and feature mapping in one scan loop
(port of `lv_slam_tpu.pipeline.fused_chain`).

Each scan step is the odometry step (`odometry/fused.make_fused_step`), then
the LFA step (`lfa/fused.make_lfa_fused`) on the RAW scan, seeded by that
scan's odometry pose. Scan 0 builds the keyframe map and the feature maps at
the identity. Chunked runs thread `ChainState` through `init_state` /
`return_state` and equal the unchunked run.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from lv_slam_tpu_torch.config import LfaConfig, OdometryConfig, PrefilterConfig
from lv_slam_tpu_torch.core.cloud import PointCloud
from lv_slam_tpu_torch.lfa.fused import LfaFusedState, make_lfa_fused, own_tables
from lv_slam_tpu_torch.odometry.fused import (
    FusedState,
    _prefilter_mid,
    _stride_active,
    make_fused_step,
)


class ChainState(NamedTuple):
    odo: FusedState
    lfa: LfaFusedState


def run_sequence_chain(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    stamps: torch.Tensor,
    odo_cfg: OdometryConfig,
    pf_cfg: PrefilterConfig,
    lfa_cfg: LfaConfig,
    crop_radius: Optional[float] = None,
    init_state: Optional[ChainState] = None,
    return_state: bool = False,
    inten: Optional[torch.Tensor] = None,
    return_filtered: bool = False,
    device="cuda",
):
    """(N,cap,3), (N,cap), (N,) -> ((N,4,4) odom, (N,4,4) refined[, filtered]).

    The inputs move to `device` (the card unless the caller asks for the
    CPU); `init_state` must already lie there. `return_filtered` adds each
    scan's `/filtered_points` product as in `run_sequence_fused`;
    `return_state` adds the final `ChainState`."""
    dev = torch.device(device)
    xyz, mask, stamps = xyz.to(dev), mask.to(dev), stamps.to(dev)
    inten = torch.zeros(xyz.shape[:2], dtype=torch.float32, device=dev) if inten is None else inten.to(dev)
    odo_init, odo_step = make_fused_step(odo_cfg, pf_cfg, return_filtered)
    lfa_init, lfa_step = make_lfa_fused(lfa_cfg, True, crop_radius)

    odoms, refined, filt = [], [], []
    start = 0
    if init_state is None:
        cloud0 = PointCloud(xyz[0], inten[0], mask[0])
        eye = torch.eye(4, dtype=torch.float32, device=dev)
        odo_s, lfa_s = odo_init(cloud0, stamps[0]), lfa_init(xyz[0], mask[0], eye)
        odoms.append(eye)
        refined.append(eye)
        if return_filtered:
            mid0 = _prefilter_mid(
                cloud0, pf_cfg,
                stride_consumer=_stride_active(
                    odo_cfg.subsample_method, odo_cfg.scan_matching_cap, cloud0.cap
                ),
            )
            filt.append((mid0.xyz.T, mid0.intensity, mid0.mask))
        start = 1
    else:
        odo_s, lfa_s = init_state.odo, own_tables(init_state.lfa)
    for i in range(start, xyz.shape[0]):
        odo_s, out = odo_step(odo_s, PointCloud(xyz[i], inten[i], mask[i]), stamps[i])
        lfa_s, pose = lfa_step(lfa_s, xyz[i], mask[i], out[0])
        odoms.append(out[0])
        refined.append(pose)
        if return_filtered:
            filt.append(out[3])

    result = (torch.stack(odoms), torch.stack(refined))
    if return_filtered:
        result = result + (tuple(torch.stack(col) for col in zip(*filt)),)
    return (result, ChainState(odo_s, lfa_s)) if return_state else result
