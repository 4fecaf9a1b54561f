"""Many sequences at once (port of `lv_slam_tpu.parallel.fleet`).

The reference runs S independent sequences as one SPMD program sharded over
its mesh's "batch" axis, each shard running the unmodified per-sequence
program (the fused odometry's `lax.scan`, optionally the fused LFA
refinement) over its local sequences one after another. Here a lane is the
port's own per-sequence run (`run_sequence_fused`, then `run_sequence_lfa`
fed its odometry, over `make_fused_step` / `make_lfa_fused` unchanged), so a
lane equals the single-sequence run bit for bit.

Without a mesh, or with a "batch" axis of one, every lane runs one after
another on the one device: the reference's shard body and `bench.py`'s
one-chip fleet. With a longer "batch" axis each rank runs its contiguous
block of lanes and the poses are all-gathered over the axis, so every rank
returns the whole (S, N, 4, 4), as JAX's global array holds it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from lv_slam_tpu_torch.config import LfaConfig, OdometryConfig, PrefilterConfig
from lv_slam_tpu_torch.lfa.fused import run_sequence_lfa
from lv_slam_tpu_torch.odometry.fused import run_sequence_fused
from lv_slam_tpu_torch.parallel.mesh import axis_block, gather_batch


def run_fleet_odometry(
    mesh: Optional[DeviceMesh],
    xyz: torch.Tensor,      # (S, N, cap, 3) S sequences of N scans
    mask: torch.Tensor,     # (S, N, cap)
    stamps: torch.Tensor,   # (S, N)
    cfg: OdometryConfig,
    lfa_cfg: Optional[LfaConfig] = None,
    prefilter_cfg: Optional[PrefilterConfig] = None,
    device="cuda",
) -> torch.Tensor:
    """-> (S, N, 4, 4) poses on `device`. Lane s runs the fused odometry on
    sequence s (scan 0 builds the first keyframe at the identity, zero
    intensity) and, with `lfa_cfg`, the fused LFA refinement fed those poses
    (scan 0 keeps its odometry pose); each rank runs its block of lanes."""
    lanes = axis_block(mesh, "batch", xyz.shape[0], "run_fleet_odometry")
    outs = []
    for i in range(lanes.start, lanes.stop):
        poses = run_sequence_fused(xyz[i], mask[i], stamps[i], cfg, prefilter_cfg, device=device)
        if lfa_cfg is not None:
            poses = run_sequence_lfa(xyz[i], mask[i], lfa_cfg, odom_poses=poses, device=device)
        outs.append(poses)
    return gather_batch(mesh, torch.stack(outs))


def shard_sequences(mesh: Optional[DeviceMesh], tensor: torch.Tensor) -> torch.Tensor:
    """This rank's block of the (S, ...) lanes, as the fleet splits them."""
    return tensor[axis_block(mesh, "batch", tensor.shape[0], "shard_sequences")]
