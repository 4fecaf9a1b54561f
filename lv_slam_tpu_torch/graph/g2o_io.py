"""g2o text-format graph serialization + robust-kernel sidecar (a copy of
`lv_slam_tpu.graph.g2o_io` over the port's host-side `PoseGraph`; the files
are the reference's, so either package reads the other's).

Round-trips the reference's checkpoint format (`GraphSLAM::save/load`,
`graph_slam.cpp:333-363`). The reference registers nine custom types with the
g2o factory (`graph_slam.cpp:31-40`) so its text dump carries every factor;
we write the same tags (including the reference's `EDGE_PLANE_PAERPENDICULAR`
registration typo) with each edge's measurement followed by the
upper-triangular information matrix, exactly the per-type `write()` layouts
in `include/g2o/*.hpp`:

- `VERTEX_SE3:QUAT id tx ty tz qx qy qz qw`
- `VERTEX_PLANE id nx ny nz d` — plane vertices; their file ids live at
  `PLANE_ID_OFFSET + plane_index` (g2o allocates plane ids from the shared
  vertex counter; a fixed offset keeps our two index spaces separable).
- `FIX id` for gauge-fixed vertices (anchor nodes, the floor plane).
- `EDGE_SE3:QUAT i j  t q  info(6x6 upper)`
- `EDGE_SE3_PLANE i p  coeffs(4)  info(3x3 upper)`
- `EDGE_SE3_PRIORXY i  m(2)  info(2x2 upper)`   (`edge_se3_priorxy.hpp`)
- `EDGE_SE3_PRIORXYZ i  m(3)  info(3x3 upper)`  (`edge_se3_priorxyz.hpp`)
- `EDGE_SE3_PRIORVEC i  m(6)  info(3x3 upper)`  (`edge_se3_priorvec.hpp`)
- `EDGE_SE3_PRIORQUAT i qw qx qy qz  info(3x3 upper)`
- `EDGE_SE3_PRIORPLANE i coeffs(4) info(4x4 upper)` — our legacy unary floor
  prior; no reference analog (the reference expresses floors only through
  the shared plane vertex), kept so older graphs round-trip.
- `EDGE_PLANE_PRIOR_NORMAL p  m(3)  info(3x3 upper)`
- `EDGE_PLANE_PRIOR_DISTANCE p  d  info(1)`
- `EDGE_PLANE_PARALLEL p q  m(3)  info(3x3 upper)`
- `EDGE_PLANE_PAERPENDICULAR p q  m(3)  info(1)`
- `EDGE_PLANE_IDENTITY p q  m(4)  info(4x4 upper)`

The `.kernels` sidecar mirrors `robust_kernel_io.cpp:21-49` (per robust
edge: `<n_vertices> <id...> <type> <delta>`; only Huber is recognized).
Like the reference, kernels re-attach by vertex-id match on reload.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from lv_slam_tpu_torch.graph import pose_graph as pg

# file ids for plane vertices = PLANE_ID_OFFSET + plane slot index
PLANE_ID_OFFSET = 1_000_000

# unary prior p_type -> (tag, measurement dim, info dim)
_PRIOR_TAGS = {
    pg.PRIOR_XYZ: ("EDGE_SE3_PRIORXYZ", 3, 3),
    pg.PRIOR_XY: ("EDGE_SE3_PRIORXY", 2, 2),
    pg.PRIOR_QUAT: ("EDGE_SE3_PRIORQUAT", 4, 3),
    pg.PRIOR_VEC: ("EDGE_SE3_PRIORVEC", 6, 3),
    pg.PRIOR_PLANE: ("EDGE_SE3_PRIORPLANE", 4, 4),
}
_PRIOR_BY_TAG = {tag: (ptype, mdim, idim) for ptype, (tag, mdim, idim) in _PRIOR_TAGS.items()}

# plane-edge q_type -> (tag, is_binary, measurement dim, info dim)
_PLANE_TAGS = {
    pg.PLANE_IDENTITY: ("EDGE_PLANE_IDENTITY", True, 4, 4),
    pg.PLANE_PARALLEL: ("EDGE_PLANE_PARALLEL", True, 3, 3),
    pg.PLANE_PERPENDICULAR: ("EDGE_PLANE_PAERPENDICULAR", True, 3, 1),
    pg.PLANE_PRIOR_NORMAL: ("EDGE_PLANE_PRIOR_NORMAL", False, 3, 3),
    pg.PLANE_PRIOR_DISTANCE: ("EDGE_PLANE_PRIOR_DISTANCE", False, 1, 1),
}
_PLANE_BY_TAG = {
    tag: (qtype, binary, mdim, idim)
    for qtype, (tag, binary, mdim, idim) in _PLANE_TAGS.items()
}


def _quat_from_matrix_np(m: np.ndarray) -> np.ndarray:
    """(w,x,y,z), w>=0 — numpy mirror of core.se3.quat_from_matrix."""
    tr = np.trace(m)
    cands = np.array(
        [
            [1 + tr, m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]],
            [m[2, 1] - m[1, 2], 1 + m[0, 0] - m[1, 1] - m[2, 2], m[0, 1] + m[1, 0], m[0, 2] + m[2, 0]],
            [m[0, 2] - m[2, 0], m[0, 1] + m[1, 0], 1 - m[0, 0] + m[1, 1] - m[2, 2], m[1, 2] + m[2, 1]],
            [m[1, 0] - m[0, 1], m[0, 2] + m[2, 0], m[1, 2] + m[2, 1], 1 - m[0, 0] - m[1, 1] + m[2, 2]],
        ]
    )
    mags = np.array([1 + tr, 1 + m[0, 0] - m[1, 1] - m[2, 2], 1 - m[0, 0] + m[1, 1] - m[2, 2], 1 - m[0, 0] - m[1, 1] + m[2, 2]])
    q = cands[int(np.argmax(mags))]
    q = q / np.linalg.norm(q)
    return q if q[0] >= 0 else -q


def _matrix_from_quat_np(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _fmt(vals) -> str:
    return " ".join(f"{v:.9g}" for v in np.asarray(vals, np.float64).reshape(-1))


def _upper(info: np.ndarray, d: int) -> str:
    return _fmt(np.asarray(info, np.float64)[:d, :d][np.triu_indices(d)])


def _read_upper(parts, pos: int, d: int) -> Tuple[np.ndarray, int]:
    n = d * (d + 1) // 2
    vals = np.array([float(v) for v in parts[pos : pos + n]])
    info = np.zeros((d, d))
    info[np.triu_indices(d)] = vals
    info = info + np.triu(info, 1).T
    return info, pos + n


def save_graph(path: str, graph: pg.PoseGraph) -> None:
    """Write graph.g2o (+ <path>.kernels sidecar) covering every factor type."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    poses = np.asarray(graph.poses, np.float64)
    kernel_lines = []

    with open(path, "w") as f:
        for idx in np.nonzero(np.asarray(graph.node_valid))[0]:
            t = poses[idx][:3, 3]
            q = _quat_from_matrix_np(poses[idx][:3, :3])
            f.write(
                f"VERTEX_SE3:QUAT {idx} {_fmt(t)} "
                f"{q[1]:.9g} {q[2]:.9g} {q[3]:.9g} {q[0]:.9g}\n"
            )
        for idx in np.nonzero(np.asarray(graph.plane_valid))[0]:
            f.write(f"VERTEX_PLANE {PLANE_ID_OFFSET + idx} {_fmt(graph.planes[idx])}\n")
        f.write("FIX 0\n")
        for idx in np.nonzero(np.asarray(graph.node_valid) & np.asarray(graph.node_fixed))[0]:
            if idx != 0:
                f.write(f"FIX {idx}\n")
        for idx in np.nonzero(np.asarray(graph.plane_valid) & np.asarray(graph.plane_fixed))[0]:
            f.write(f"FIX {PLANE_ID_OFFSET + idx}\n")

        e_huber = np.asarray(graph.e_huber)
        for idx in np.nonzero(np.asarray(graph.e_valid))[0]:
            meas = np.asarray(graph.e_meas[idx], np.float64)
            t = meas[:3, 3]
            q = _quat_from_matrix_np(meas[:3, :3])
            i, j = int(graph.e_i[idx]), int(graph.e_j[idx])
            f.write(
                f"EDGE_SE3:QUAT {i} {j} {_fmt(t)} "
                f"{q[1]:.9g} {q[2]:.9g} {q[3]:.9g} {q[0]:.9g} "
                f"{_upper(graph.e_info[idx], 6)}\n"
            )
            if e_huber[idx] > 0:
                kernel_lines.append(f"2 {i} {j} Huber {e_huber[idx]:.9g}")

        p_huber = np.asarray(graph.p_huber)
        for idx in np.nonzero(np.asarray(graph.p_valid))[0]:
            ptype = int(graph.p_type[idx])
            tag, mdim, idim = _PRIOR_TAGS[ptype]
            node = int(graph.p_node[idx])
            f.write(
                f"{tag} {node} {_fmt(graph.p_meas[idx][:mdim])} "
                f"{_upper(graph.p_info[idx], idim)}\n"
            )
            if p_huber[idx] > 0:
                kernel_lines.append(f"1 {node} Huber {p_huber[idx]:.9g}")

        sp_huber = np.asarray(graph.sp_huber)
        for idx in np.nonzero(np.asarray(graph.sp_valid))[0]:
            i = int(graph.sp_i[idx])
            p = PLANE_ID_OFFSET + int(graph.sp_plane[idx])
            f.write(
                f"EDGE_SE3_PLANE {i} {p} {_fmt(graph.sp_meas[idx])} "
                f"{_upper(graph.sp_info[idx], 3)}\n"
            )
            if sp_huber[idx] > 0:
                kernel_lines.append(f"2 {i} {p} Huber {sp_huber[idx]:.9g}")

        q_huber = np.asarray(graph.q_huber)
        for idx in np.nonzero(np.asarray(graph.q_valid))[0]:
            qtype = int(graph.q_type[idx])
            tag, binary, mdim, idim = _PLANE_TAGS[qtype]
            pi = PLANE_ID_OFFSET + int(graph.q_i[idx])
            ids = f"{pi} {PLANE_ID_OFFSET + int(graph.q_j[idx])}" if binary else f"{pi}"
            f.write(
                f"{tag} {ids} {_fmt(graph.q_meas[idx][:mdim])} "
                f"{_upper(graph.q_info[idx], idim)}\n"
            )
            if q_huber[idx] > 0:
                nv = 2 if binary else 1
                kernel_lines.append(f"{nv} {ids} Huber {q_huber[idx]:.9g}")

    with open(path + ".kernels", "w") as f:
        for line in kernel_lines:
            f.write(line + "\n")


def load_graph(
    path: str,
    node_cap: int = 1024,
    edge_cap: int = 4096,
    prior_cap: int = 256,
    plane_cap: int = 8,
    sp_cap: int = 64,
    q_cap: int = 16,
) -> pg.PoseGraph:
    """Rebuild a PoseGraph from graph.g2o (+ optional .kernels sidecar)."""
    graph = pg.empty_graph(node_cap, edge_cap, prior_cap, plane_cap, sp_cap, q_cap)
    kernels: Dict[Tuple[int, ...], float] = {}
    kpath = path + ".kernels"
    if os.path.exists(kpath):
        with open(kpath) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 4 and parts[-2] == "Huber":
                    nv = int(parts[0])
                    ids = tuple(int(v) for v in parts[1 : 1 + nv])
                    kernels[ids] = float(parts[-1])

    def _huber(*ids: int) -> float:
        return kernels.get(tuple(ids), 0.0)

    e_slot = p_slot = sp_slot = q_slot = 0
    fixes = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "VERTEX_SE3:QUAT":
                idx = int(parts[1])
                t = np.array([float(v) for v in parts[2:5]])
                qx, qy, qz, qw = (float(v) for v in parts[5:9])
                pose = np.eye(4)
                pose[:3, :3] = _matrix_from_quat_np(np.array([qw, qx, qy, qz]))
                pose[:3, 3] = t
                graph = pg.add_node(graph, idx, pose)
            elif tag == "VERTEX_PLANE":
                idx = int(parts[1]) - PLANE_ID_OFFSET
                coeffs = np.array([float(v) for v in parts[2:6]])
                graph = pg.add_plane_node(graph, idx, coeffs)
            elif tag == "FIX":
                fixes.append(int(parts[1]))
            elif tag == "EDGE_SE3:QUAT":
                i, j = int(parts[1]), int(parts[2])
                t = np.array([float(v) for v in parts[3:6]])
                qx, qy, qz, qw = (float(v) for v in parts[6:10])
                meas = np.eye(4)
                meas[:3, :3] = _matrix_from_quat_np(np.array([qw, qx, qy, qz]))
                meas[:3, 3] = t
                info, _ = _read_upper(parts, 10, 6)
                graph = pg.add_se3_edge(graph, e_slot, i, j, meas, info, _huber(i, j))
                e_slot += 1
            elif tag == "EDGE_SE3_PLANE":
                i = int(parts[1])
                p = int(parts[2]) - PLANE_ID_OFFSET
                coeffs = np.array([float(v) for v in parts[3:7]])
                info, _ = _read_upper(parts, 7, 3)
                graph = pg.add_se3_plane_edge(
                    graph, sp_slot, i, p, coeffs, info,
                    _huber(i, int(parts[2])),
                )
                sp_slot += 1
            elif tag in _PRIOR_BY_TAG:
                ptype, mdim, idim = _PRIOR_BY_TAG[tag]
                node = int(parts[1])
                meas = np.array([float(v) for v in parts[2 : 2 + mdim]])
                info, _ = _read_upper(parts, 2 + mdim, idim)
                graph = pg.add_prior(graph, p_slot, node, ptype, meas, info, _huber(node))
                p_slot += 1
            elif tag in _PLANE_BY_TAG:
                qtype, binary, mdim, idim = _PLANE_BY_TAG[tag]
                pi = int(parts[1]) - PLANE_ID_OFFSET
                if binary:
                    pj = int(parts[2]) - PLANE_ID_OFFSET
                    pos = 3
                    hub = _huber(int(parts[1]), int(parts[2]))
                else:
                    pj = pi
                    pos = 2
                    hub = _huber(int(parts[1]))
                meas = np.array([float(v) for v in parts[pos : pos + mdim]])
                info, _ = _read_upper(parts, pos + mdim, idim)
                graph = pg.add_plane_edge(graph, q_slot, pi, pj, qtype, meas, info, hub)
                q_slot += 1

    for fid in fixes:
        if fid >= PLANE_ID_OFFSET:
            graph.plane_fixed[fid - PLANE_ID_OFFSET] = True
        elif fid != 0:
            graph = pg.set_node_fixed(graph, fid)
    return graph
