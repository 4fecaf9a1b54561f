"""Hashed cell tables: the LFA world maps (port of the cell-table part of
`lv_slam_tpu.ops.knn`).

A `CellTable` stores the first S points of each 2 m cell directly in a
hashed (B, S*4) table of [x, y, z, valid] slots, so a query batch reads the
8 cells around each query with one row gather (`candidates_cell`). The maps
grow by one bounded feature batch per scan (`insert_cell_table_`: dedup-first
at the mapping resolution, the map wins; a full bucket drops the overflow)
and shrink by a radius crop (`crop_cell_table_`), which frees slots. Both
update the table in place: the caller owns the table it passes.

- `insert_cell_table_` is kernel 9a (`csrc/cell_table.cu`) on CUDA tensors
  and `insert_cell_table_ref_` on CPU tensors; both sort with the same two
  stable `torch.sort` passes, and the tables agree slot for slot.
- `crop_cell_table_` is kernel 9b (same file) on CUDA tensors and
  `crop_cell_table_ref_` on CPU tensors. It can gate itself on the LFA's
  `crop_interval` without a host read.

The sorted-grid k-NN (`build_grid`, `knn`) and `build_cell_table` /
`knn_cell` serve only standalone LFA and are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from lv_slam_tpu_torch.kernels._build import F32, I32, PTR, Kernel, check_cuda, check_dtype, ptr
from lv_slam_tpu_torch.ops.linalg3 import _div
from lv_slam_tpu_torch.ops.prefilter import _pack_yz, _unpack_yz, cell_coords, inv_resolution

_H1, _H2, _H3 = 73856093, 19349669, 83492791  # classic spatial-hash primes
_U32 = 0xFFFFFFFF
_BIG = 1 << 30

INSERT_KERNEL = Kernel(
    "insert_cell_table",
    source="lv_slam_tpu_torch/csrc/cell_table.cu",
    replaces="lv_slam_tpu/ops/knn.py:139",
    entries={
        "lvs_insert_keys": [PTR, PTR, I32, I32, F32, F32, PTR, PTR],
        "lvs_insert_rows": [PTR, PTR, PTR, PTR, I32, I32, I32, F32, PTR, PTR, PTR],
    },
)
CROP_KERNEL = Kernel(
    "crop_cell_table",
    source="lv_slam_tpu_torch/csrc/cell_table.cu",
    replaces="lv_slam_tpu/ops/knn.py:218",
    entries={"lvs_crop_cell_table": [PTR, I32, PTR, PTR, F32, F32, PTR]},
)


class CellTable(NamedTuple):
    table: torch.Tensor  # (B, S*4): S slots of [x, y, z, valid]
    cell_size: float

    @property
    def slots(self) -> int:
        return self.table.shape[1] // 4


def _bucket(coords: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """((c0*H1) ^ (c1*H2) ^ (c2*H3)) as uint32, mod B, as int64: the low 32
    bits of the int64 products are those of the reference's wrapping int32
    products."""
    c = coords.to(torch.int64)
    h = ((c[..., 0] * _H1) ^ (c[..., 1] * _H2) ^ (c[..., 2] * _H3)) & _U32
    return h % n_buckets


def empty_cell_table(n_buckets: int, slots: int, cell_size: float, device) -> CellTable:
    """All-invalid table (valid flags 0) for incremental insertion."""
    table = torch.zeros((n_buckets, slots * 4), dtype=torch.float32, device=device)
    return CellTable(table=table, cell_size=float(np.float32(cell_size)))


def cell_table_points(table: CellTable) -> Tuple[torch.Tensor, torch.Tensor]:
    """All stored points as a flat ((B*S,3), (B*S,)) padded point set."""
    rows = table.table.reshape(-1, 4)
    return rows[:, :3], rows[:, 3] > 0.5


def _insert_keys_ref(xyz, mask, n_buckets, resolution, cell_size):
    """(khi, vyz): khi = bucket * 2^32 + vx + 2^31 orders rows by (bucket,
    vx); masked rows take bucket B and vx 2^30. The cell divides truly by
    the cell size (a carried value in the reference's scan step); the voxel
    multiplies by the reciprocal resolution (a compiled-in constant)."""
    vox = cell_coords(xyz, resolution)
    cell = torch.floor(_div(xyz, cell_size)).to(torch.int32)
    b = torch.where(mask, _bucket(cell, n_buckets), n_buckets)
    vx = torch.where(mask, vox[:, 0], _BIG).to(torch.int64)
    khi = b * (1 << 32) + (vx + (1 << 31))
    return khi, _pack_yz(vox[:, 1], vox[:, 2])


def _insert_order(khi: torch.Tensor, vyz: torch.Tensor):
    """The reference's stable sort on (bucket, vx, vyz): two stable passes,
    the least significant key first. Returns (sorted khi, permutation)."""
    _, o1 = torch.sort(vyz, stable=True)
    skhi, o2 = torch.sort(khi[o1], stable=True)
    return skhi, o1[o2]


def insert_cell_table_(
    table: CellTable, xyz: torch.Tensor, mask: torch.Tensor, resolution: float
) -> None:
    """Dedup-first insertion of a point batch, IN PLACE. Kernel 9a on CUDA,
    the plain version on CPU."""
    if xyz.device.type == "cpu":
        insert_cell_table_ref_(table, xyz, mask, resolution)
        return
    n_buckets, s, n = table.table.shape[0], table.slots, xyz.shape[0]
    xyz, mask = xyz.contiguous(), mask.contiguous()
    check_cuda("insert_cell_table", table.table, xyz, mask)
    check_dtype("insert_cell_table", xyz, torch.float32, (n, 3))
    check_dtype("insert_cell_table", mask, torch.bool, (n,))
    check_dtype("insert_cell_table", table.table, torch.float32, (n_buckets, s * 4))
    dev = xyz.device
    khi = torch.empty((n,), dtype=torch.int64, device=dev)
    vyz = torch.empty((n,), dtype=torch.int32, device=dev)
    inv_res = inv_resolution(resolution)
    INSERT_KERNEL.call(
        "lvs_insert_keys", ptr(xyz), ptr(mask), n, n_buckets, inv_res, table.cell_size,
        ptr(khi), ptr(vyz),
    )
    skhi, order = _insert_order(khi, vyz)
    keep = torch.empty((n,), dtype=torch.int32, device=dev)
    free = torch.empty((n,), dtype=torch.int32, device=dev)
    INSERT_KERNEL.call(
        "lvs_insert_rows", ptr(skhi), ptr(order), ptr(vyz), ptr(xyz), n, n_buckets, s, inv_res,
        ptr(keep), ptr(free), ptr(table.table),
    )
    INSERT_KERNEL.launches += 1


def insert_cell_table_ref_(
    table: CellTable, xyz: torch.Tensor, mask: torch.Tensor, resolution: float
) -> None:
    """Plain PyTorch version of `insert_cell_table_`, line for line with the
    reference (exclusive cumsum rebased at bucket-run starts for the rank,
    the rank-th free slot of the bucket row)."""
    n_buckets, s, n = table.table.shape[0], table.slots, xyz.shape[0]
    khi, vyz = _insert_keys_ref(xyz, mask, n_buckets, resolution, table.cell_size)
    skhi, order = _insert_order(khi, vyz)
    sb = skhi >> 32
    svx = (skhi & _U32) - (1 << 31)
    svyz = vyz[order]
    svy, svz = _unpack_yz(svyz)
    sxyz = xyz[order]
    smask = sb < n_buckets
    new_b = torch.ones((n,), dtype=torch.bool, device=xyz.device)
    new_b[1:] = sb[1:] != sb[:-1]
    first_in_vox = new_b.clone()
    first_in_vox[1:] |= (svx[1:] != svx[:-1]) | (svyz[1:] != svyz[:-1])

    rows = table.table[torch.where(smask, sb, 0)].reshape(n, s, 4)
    occ_valid = rows[..., 3] > 0.5
    occ_vox = cell_coords(rows[..., :3].reshape(-1, 3), resolution).reshape(n, s, 3)
    pv = torch.stack([svx.to(torch.int32), svy, svz], dim=1)
    dup_map = torch.any(occ_valid & torch.all(occ_vox == pv[:, None, :], dim=-1), dim=-1)
    keep = smask & first_in_vox & ~dup_map

    ki = keep.to(torch.int64)
    ek = torch.cumsum(ki, 0) - ki
    base = torch.cummax(torch.where(new_b, ek, -1), 0).values
    rank = ek - base
    free = ~occ_valid
    cumfree = torch.cumsum(free.to(torch.int64), dim=1)
    hit = free & (cumfree == rank[:, None] + 1)
    pos = torch.argmax(hit.to(torch.int32), dim=1)
    ok = keep & torch.any(hit, dim=1)  # kept rows of one bucket get distinct slots
    new_rows = torch.cat([sxyz, torch.ones_like(sxyz[:, :1])], dim=1)
    table.table.view(n_buckets * s, 4)[(sb * s + pos)[ok]] = new_rows[ok]


def crop_cell_table_(
    table: CellTable,
    center: torch.Tensor,
    radius: float,
    last_center: Optional[torch.Tensor] = None,
    interval: float = 0.0,
) -> torch.Tensor:
    """Invalidate, IN PLACE, the slots beyond `radius` of `center`. With
    `last_center`, only when `center` has moved more than `interval` from it
    (decided on the device). Returns the center of the last crop: `center`,
    or `last_center` when the gate stayed closed. Kernel 9b on CUDA, the
    plain version on CPU."""
    if table.table.device.type == "cpu":
        return crop_cell_table_ref_(table, center, radius, last_center, interval)
    center = center.contiguous()
    tensors = (table.table, center) + ((last_center,) if last_center is not None else ())
    check_cuda("crop_cell_table", *tensors)
    check_dtype("crop_cell_table", center, torch.float32, (3,))
    out = torch.empty((3,), dtype=torch.float32, device=center.device)
    CROP_KERNEL.call(
        "lvs_crop_cell_table", ptr(table.table), table.table.numel() // 4, ptr(center),
        ptr(last_center) if last_center is not None else None, _sq(interval), _sq(radius), ptr(out),
    )
    CROP_KERNEL.launches += 1
    return out


def _sq(x: float) -> float:
    """float32(x) ** 2, as the reference squares its float32 constants."""
    return float(np.float32(x) * np.float32(x))


def crop_cell_table_ref_(
    table: CellTable,
    center: torch.Tensor,
    radius: float,
    last_center: Optional[torch.Tensor] = None,
    interval: float = 0.0,
) -> torch.Tensor:
    """Plain PyTorch version of `crop_cell_table_` (no host read either)."""
    rows = table.table.view(table.table.shape[0], table.slots, 4)
    d = rows[..., :3] - center
    sq = d * d
    valid = (rows[..., 3] > 0.5) & (sq[..., 0] + sq[..., 1] + sq[..., 2] < _sq(radius))
    new = valid.to(torch.float32)
    if last_center is None:
        rows[..., 3] = new
        return center
    m = center - last_center
    m = m * m
    go = m[0] + m[1] + m[2] > _sq(interval)
    rows[..., 3] = torch.where(go, new, rows[..., 3])
    return torch.where(go, center, last_center)


def candidates_cell(table: CellTable, queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw candidate set per query: (points (Q,8*S,3), valid (Q,8*S)) from the
    8 cells around each query, duplicate probe buckets dropped (the later
    probe of two that share a bucket). The plain form of kernel 10's probe."""
    n_buckets, s, q = table.table.shape[0], table.slots, queries.shape[0]
    cs = table.cell_size
    base = torch.floor(_div(queries - float(np.float32(cs / 2.0)), cs)).to(torch.int32)
    # the 2x2x2 block's offsets (i, j, k), i outermost: bits of 0..7
    p = torch.arange(8, dtype=torch.int32, device=queries.device)
    off = torch.stack([p >> 2, (p >> 1) & 1, p & 1], dim=1)
    b = _bucket(base[:, None, :] + off[None], n_buckets)  # (Q,8)
    earlier = torch.tril(torch.ones((8, 8), dtype=torch.bool, device=queries.device), diagonal=-1)
    dup = torch.any((b[:, :, None] == b[:, None, :]) & earlier, dim=-1)
    cand = table.table[b].reshape(q, 8, s, 4)
    ok = (cand[..., 3] > 0.5) & ~dup[:, :, None]
    return cand[..., :3].reshape(q, 8 * s, 3), ok.reshape(q, 8 * s)
