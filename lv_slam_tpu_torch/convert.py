"""The odometry state carried across from the JAX reference and back.

This system has no weights; the state a run carries (the keyframe hash map,
the poses and the stamps) plays their role. It crosses as a flat dict of
numpy arrays, keyed by the `FusedState` field names, with the key map's
fields under `key_map.`: a run can start in one implementation and go on in
the other. The JAX side fetches its `FusedState` (whose key map is a
`HashVoxelMap`) with `np.asarray` on each leaf; nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from lv_slam_tpu_torch.odometry.fused import FusedState
from lv_slam_tpu_torch.ops.ndt_hash import HashVoxelMap

_POSES = ("key_pose", "tf_s2k", "pre_tf_s2k", "guess")


def fused_state_from_numpy(leaves: Dict[str, np.ndarray], device) -> FusedState:
    def f32(name):
        return torch.from_numpy(np.array(leaves[name], dtype=np.float32, order="C")).to(device)

    key_map = HashVoxelMap(
        table=f32("key_map.table"),
        origin_cell=torch.from_numpy(
            np.array(leaves["key_map.origin_cell"], dtype=np.int32, order="C")
        ).to(device),
        resolution=float(leaves["key_map.resolution"]),
        extent=int(leaves["key_map.extent"]),
        n_dropped=torch.tensor(int(leaves["key_map.n_dropped"]), dtype=torch.int32).to(device),
    )
    return FusedState(
        key_map=key_map,
        **{name: f32(name) for name in _POSES},
        keyframe_stamp=f32("keyframe_stamp").reshape(()),
        scan_idx=int(leaves["scan_idx"]),
    )


def fused_state_to_numpy(state: FusedState) -> Dict[str, np.ndarray]:
    km = state.key_map
    out = {
        "key_map.table": km.table.cpu().numpy(),
        "key_map.origin_cell": km.origin_cell.cpu().numpy(),
        "key_map.resolution": np.float32(km.resolution),
        "key_map.extent": np.int64(km.extent),
        "key_map.n_dropped": km.n_dropped.cpu().numpy(),
        "keyframe_stamp": state.keyframe_stamp.cpu().numpy(),
        "scan_idx": np.int32(state.scan_idx),
    }
    out.update({name: getattr(state, name).cpu().numpy() for name in _POSES})
    return out
