"""The states carried across from the JAX reference and back: the odometry,
LFA and chain states, the pose graph and the backend's keyframes.

This system has no weights; the state a run carries (the keyframe hash map,
the LFA world maps, the poses and the stamps) plays their role. It crosses
as a flat dict of numpy arrays, keyed by the state's field names, with a
nested structure's fields under `<field>.`: a run can start in one
implementation and go on in the other. The JAX side fetches its state with
`np.asarray` on each leaf; nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from lv_slam_tpu_torch.core.cloud import PointCloud
from lv_slam_tpu_torch.graph.keyframe import KeyFrame
from lv_slam_tpu_torch.graph.pose_graph import PoseGraph, to_device
from lv_slam_tpu_torch.lfa.fused import LfaFusedState
from lv_slam_tpu_torch.odometry.fused import FusedState
from lv_slam_tpu_torch.ops.knn import CellTable, KnnGrid
from lv_slam_tpu_torch.ops.ndt_hash import HashVoxelMap
from lv_slam_tpu_torch.pipeline.fused_chain import ChainState

_POSES = ("key_pose", "tf_s2k", "pre_tf_s2k", "guess")
_LFA_POSES = ("odom_pose", "last_rel", "map_pose", "last_odom")
_LFA_GRIDS = ("prev_edge_grid", "prev_surf_grid")


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


def lfa_state_from_numpy(leaves: Dict[str, np.ndarray], device) -> LfaFusedState:
    """The LFA state from leaves keyed by its fields: tables as
    `edge_table.table` ((B, S*4) float32) and `edge_table.cell_size`, the
    previous scan's grids (standalone LFA) as `prev_edge_grid.keys` (int32),
    `.xyz`, `.origin_cell` (int32) and `.cell_size`. Without grid leaves the
    grids are None, as on the external-odometry path."""

    def arr(name, dtype):
        return torch.from_numpy(np.array(leaves[name], dtype=dtype, order="C")).to(device)

    def table(name):
        return CellTable(table=arr(f"{name}.table", np.float32),
                         cell_size=float(np.float32(leaves[f"{name}.cell_size"])))

    def grid(name):
        if f"{name}.keys" not in leaves:
            return None
        return KnnGrid(keys=arr(f"{name}.keys", np.int32), xyz=arr(f"{name}.xyz", np.float32),
                       origin_cell=arr(f"{name}.origin_cell", np.int32),
                       cell_size=float(np.float32(leaves[f"{name}.cell_size"])))

    return LfaFusedState(
        **{name: arr(name, np.float32) for name in _LFA_POSES},
        edge_table=table("edge_table"),
        surf_table=table("surf_table"),
        scan_idx=int(leaves["scan_idx"]),
        crop_center=arr("crop_center", np.float32),
        **{name: grid(name) for name in _LFA_GRIDS},
    )


def lfa_state_to_numpy(state: LfaFusedState) -> Dict[str, np.ndarray]:
    out = {name: getattr(state, name).cpu().numpy() for name in _LFA_POSES}
    for name in ("edge_table", "surf_table"):
        tab = getattr(state, name)
        out[f"{name}.table"] = tab.table.cpu().numpy()
        out[f"{name}.cell_size"] = np.float32(tab.cell_size)
    out["scan_idx"] = np.int32(state.scan_idx)
    out["crop_center"] = state.crop_center.cpu().numpy()
    for name in _LFA_GRIDS:
        grid = getattr(state, name)
        if grid is not None:
            for field in ("keys", "xyz", "origin_cell"):
                out[f"{name}.{field}"] = getattr(grid, field).cpu().numpy()
            out[f"{name}.cell_size"] = np.float32(grid.cell_size)
    return out


def chain_state_from_numpy(leaves: Dict[str, np.ndarray], device) -> ChainState:
    """The chain's state from leaves keyed `odo.<FusedState leaf>` and
    `lfa.<LfaFusedState leaf>` (as `lfa_state_from_numpy` reads them). The
    external-odometry path never reads the reference's `prev_edge_grid` /
    `prev_surf_grid`, so their leaves may be left out."""

    def sub(prefix):
        n = len(prefix) + 1
        return {k[n:]: v for k, v in leaves.items() if k.startswith(prefix + ".")}

    return ChainState(
        odo=fused_state_from_numpy(sub("odo"), device),
        lfa=lfa_state_from_numpy(sub("lfa"), device),
    )


def chain_state_to_numpy(state: ChainState) -> Dict[str, np.ndarray]:
    out = {f"odo.{k}": v for k, v in fused_state_to_numpy(state.odo).items()}
    out.update({f"lfa.{k}": v for k, v in lfa_state_to_numpy(state.lfa).items()})
    return out


def pose_graph_from_numpy(graph, device) -> PoseGraph:
    """The port's PoseGraph, as tensors on `device`, from the reference's
    (its `empty_graph` arrays are host numpy; a dict of its fields works too)."""
    leaves = graph if isinstance(graph, dict) else graph._asdict()
    return to_device(PoseGraph(**{name: np.asarray(leaves[name]) for name in PoseGraph._fields}), device)


def pose_graph_to_numpy(graph: PoseGraph) -> Dict[str, np.ndarray]:
    """The graph's fields as host numpy arrays, keyed by field name."""
    return {name: np.asarray(a.cpu().numpy() if isinstance(a, torch.Tensor) else a)
            for name, a in graph._asdict().items()}


def keyframe_from_numpy(kf, device) -> KeyFrame:
    """The port's KeyFrame from the reference's (or any object with its
    fields): host fields (descriptors and keypoints too) copied, the cloud's
    arrays moved to `device`."""
    xyz, inten, mask = (np.asarray(a) for a in (kf.cloud.xyz, kf.cloud.intensity, kf.cloud.mask))
    cloud = PointCloud(*(torch.from_numpy(np.array(a, order="C")).to(device) for a in (xyz, inten, mask)))
    desc, kpts = getattr(kf, "descriptor", None), getattr(kf, "keypoints", None)
    return KeyFrame(
        stamp=float(kf.stamp), seq=int(kf.seq), odom=np.array(kf.odom, np.float64),
        accum_distance=float(kf.accum_distance), cloud=cloud,
        descriptor=None if desc is None else np.array(desc, np.uint8),
        keypoints=None if kpts is None else np.array(kpts, np.int32), node_id=int(kf.node_id),
        estimate=None if kf.estimate is None else np.array(kf.estimate, np.float64),
    )
