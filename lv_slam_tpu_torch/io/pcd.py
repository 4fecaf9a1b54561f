"""Minimal PCD (Point Cloud Data) reader/writer (a copy of
`lv_slam_tpu.io.pcd`, which the port does not import).

The reference persists keyframe clouds and exported maps as PCD via PCL
(`keyframe.cpp:86-91`, `global_graph_nodelet.cpp:1063`). Supports the fields
we produce (x y z [intensity]), binary and ascii, little-endian float32.
"""

from __future__ import annotations

import os

import numpy as np

_HEADER = """# .PCD v0.7 - Point Cloud Data file format
VERSION 0.7
FIELDS {fields}
SIZE {sizes}
TYPE {types}
COUNT {counts}
WIDTH {width}
HEIGHT 1
VIEWPOINT 0 0 0 1 0 0 0
POINTS {width}
DATA {data}
"""


def write_pcd(path: str, points: np.ndarray, binary: bool = True) -> None:
    """points: (N,3) or (N,4) [x y z intensity]."""
    points = np.asarray(points, np.float32)
    n, d = points.shape
    assert d in (3, 4), points.shape
    fields = "x y z" + (" intensity" if d == 4 else "")
    header = _HEADER.format(
        fields=fields,
        sizes=" ".join(["4"] * d),
        types=" ".join(["F"] * d),
        counts=" ".join(["1"] * d),
        width=n,
        data="binary" if binary else "ascii",
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(points.tobytes())
        else:
            np.savetxt(f, points, fmt="%.6f")


def read_pcd(path: str) -> np.ndarray:
    """Returns (N,F) float32 for float32 fields."""
    with open(path, "rb") as f:
        lines = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            lines.append(line)
            if line.startswith("DATA"):
                break
        meta = {}
        for line in lines:
            parts = line.split()
            if parts and parts[0] in ("FIELDS", "SIZE", "TYPE", "COUNT", "WIDTH", "POINTS", "DATA"):
                meta[parts[0]] = parts[1:]
        n = int(meta["POINTS"][0])
        d = len(meta["FIELDS"])
        if meta["DATA"][0] == "binary":
            buf = f.read(n * d * 4)
            return np.frombuffer(buf, dtype=np.float32).reshape(n, d).copy()
        return np.loadtxt(f, dtype=np.float32).reshape(n, d)
