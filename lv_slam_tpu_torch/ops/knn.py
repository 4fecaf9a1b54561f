"""Grid-bucketed k-nearest neighbours and hashed cell tables (port of
`lv_slam_tpu.ops.knn`).

The sorted grid (`KnnGrid`) serves standalone LFA's scan-to-scan odometry:
the previous scan's less-sharp / less-flat features bucketed into 2 m cells
and sorted by flat cell key, so a query finds each of its 27 neighbouring
cells by binary search and takes the first `slots_per_cell` points of each
as candidates (`knn`; the 2-point lines and 3-point planes of
`lfa/registration.py` run on the same search).

- `build_grid` is kernel 9g (`csrc/knn_grid.cu`) on CUDA tensors and
  `build_grid_ref` on CPU tensors: cell keys, the per-axis minimum origin
  over valid lanes, a stable sort of the keys, a gather. On the card one C
  call: kernel 14's flat-key front end, the repo's key sort
  (`csrc/key_sort.cuh`), one pass that writes the sorted lanes and, after
  them in lane order, the masked and out-of-extent ones.
- `knn` is kernel 9k (same file) on CUDA tensors and `knn_ref` on CPU
  tensors: the k nearest of the 27 x 8 candidates, ties to the lower
  candidate index, as `lax.top_k` orders them; a warp a query (a lane a
  neighbour cell) below 16384 queries, a thread a query from there on
  (GICP's batches), the keys staged in shared memory.

A `CellTable` stores the first S points of each 2 m cell directly in a
hashed (B, S*4) table of [x, y, z, valid] slots, so a query batch reads the
8 cells around each query with one row gather (`candidates_cell`). The
device-resident LFA's maps grow by one bounded feature batch per scan
(`insert_cell_table_`: dedup-first at the mapping resolution, the map wins;
a full bucket drops the overflow) and shrink by a radius crop
(`crop_cell_table_`), which frees slots. Both update the table in place:
the caller owns the table it passes. The host mapping instead rebuilds its
tables from its map buffers every scan (`build_cell_table`).

- `insert_cell_table_` is kernel 9a (`csrc/cell_table.cu`) on CUDA tensors
  and `insert_cell_table_ref_` on CPU tensors; the tables agree slot for
  slot. A batch of at most `INSERT_BLOCK_ROWS` rows (the flagship's 4096
  edge and 8064 surf rows) is one launch of one thread-block cluster that
  sorts in registers and shared memory on the keys of `insert_sort_keys`;
  a larger one sorts with the twin's two stable `torch.sort` passes
  between two kernels.
- `crop_cell_table_` is kernel 9b (same file) on CUDA tensors and
  `crop_cell_table_ref_` on CPU tensors. It can gate itself on the LFA's
  `crop_interval` without a host read. `crop_cell_tables_` crops the LFA
  step's two tables in one launch on the same gate.
- `build_cell_table` is kernel 9c (same file) on CUDA tensors and
  `build_cell_table_ref` on CPU tensors: bucket keys, a stable sort, each
  bucket run's first S rows written to their slots. On the card one C call:
  the keys and per-bucket counts, the repo's key sort in as many digit
  passes as B - 1 has (`table_passes`), one pass that writes every slot
  once.
- `knn_cell` (the k nearest of the 8-cell probe, duplicate probe buckets
  dropped) is kernel 9n (same file) on CUDA tensors and `knn_cell_ref` on
  CPU tensors; `lax.top_k`'s order, ties and misses included. Neither
  package's LFA calls it (its fits take every candidate within 1 m).

Rounding: a cell coordinate of a build is `floor(x * (1/cell))`, as XLA
compiles the reference's division by a constant; a query's is a true
division by the grid's carried cell size (both exact for the 2 m cell),
each with `ops/cells`' flushes of subnormal coordinates and quotients.
Squared distances are the fma chain XLA makes of the reference's
`jnp.sum(d ** 2, -1)` on the CPU (`ops.linalg3.dot3_fma`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from lv_slam_tpu_torch.kernels._build import (
    F32, I32, MAX_SORT_LANES, PTR, Kernel, check_cuda, check_dtype, ptr, scratch_bytes,
)
from lv_slam_tpu_torch.ops.linalg3 import dot3_fma, sqrt32
from lv_slam_tpu_torch.ops.cells import cell_coords, floor_cells_div, inv_resolution
from lv_slam_tpu_torch.ops.prefilter import _pack_yz, _unpack_yz

_H1, _H2, _H3 = 73856093, 19349669, 83492791  # classic spatial-hash primes
_U32 = 0xFFFFFFFF
_BIG = 1 << 30
_EXTENT = 1024        # cells per axis of a KnnGrid: 1024^3 flat keys fit int32
_KEY_MAX = 2**31 - 1  # key of masked lanes and of cells out of the extent
MAX_K = 8             # neighbours a `knn` query may ask for

GRID_KERNEL = Kernel(
    "build_grid",
    source="lv_slam_tpu_torch/csrc/knn_grid.cu",
    replaces="lv_slam_tpu/ops/knn.py:39",
    # xyz, mask, n, 1/cell, scratch, its bytes -> keys, xyz in key order, origin
    entries={"lvs_knn_grid": [PTR, PTR, I32, F32, PTR, ctypes.c_longlong, PTR, PTR, PTR]},
)
KNN_KERNEL = Kernel(
    "knn",
    source="lv_slam_tpu_torch/csrc/knn_grid.cu",
    replaces="lv_slam_tpu/ops/knn.py:280",
    entries={
        # keys, xyz, n, origin, cell, queries, q, k, slots -> dists, points, valid
        "lvs_knn": [PTR, PTR, I32, PTR, F32, PTR, I32, I32, I32, PTR, PTR, PTR],
        # keys, xyz, n, origin, cell, queries, mask, q -> mu, v, valid
        "lvs_lines_from_2nn": [PTR, PTR, I32, PTR, F32, PTR, PTR, I32, PTR, PTR, PTR],
        # keys, xyz, n, origin, cell, queries, mask, q -> n, d, valid
        "lvs_planes_from_3nn": [PTR, PTR, I32, PTR, F32, PTR, PTR, I32, PTR, PTR, PTR],
    },
)
BUILD_TABLE_KERNEL = Kernel(
    "build_cell_table",
    source="lv_slam_tpu_torch/csrc/cell_table.cu",
    replaces="lv_slam_tpu/ops/knn.py:93",
    # xyz, mask, n, buckets, slots, 1/cell, digit passes, scratch, its bytes -> table
    entries={"lvs_build_cell_table": [PTR, PTR, I32, I32, I32, F32, I32, PTR, ctypes.c_longlong, PTR]},
)

INSERT_KERNEL = Kernel(
    "insert_cell_table",
    source="lv_slam_tpu_torch/csrc/cell_table.cu",
    replaces="lv_slam_tpu/ops/knn.py:139",
    entries={
        # xyz, mask, n, buckets, slots, 1/res, cell -> table (in place): one cluster, n <= INSERT_BLOCK_ROWS
        "lvs_insert_cell_table": [PTR, PTR, I32, I32, I32, F32, F32, PTR],
        # larger batches: keys, torch.sort glue, keep + place
        "lvs_insert_keys": [PTR, PTR, I32, I32, F32, F32, PTR, PTR],
        "lvs_insert_rows": [PTR, PTR, PTR, PTR, I32, I32, I32, F32, PTR, PTR, PTR],
    },
)
INSERT_BLOCK_ROWS = 8192  # the one-launch insert's batch cap: 8 blocks x 1024 rows (csrc/cell_table.cu kInsMaxRows)
KNN_CELL_KERNEL = Kernel(
    "knn_cell",
    source="lv_slam_tpu_torch/csrc/cell_table.cu",
    replaces="lv_slam_tpu/ops/knn.py:264",
    # table, buckets, slots, cell, queries, q, k -> dists, points, valid
    entries={"lvs_knn_cell": [PTR, I32, I32, F32, PTR, I32, I32, PTR, PTR, PTR]},
)
CROP_KERNEL = Kernel(
    "crop_cell_table",
    source="lv_slam_tpu_torch/csrc/cell_table.cu",
    replaces="lv_slam_tpu/ops/knn.py:218",
    # table a, its slots, table b (or null), its slots, center, last center (or null), interval^2, radius^2
    # -> center of the last crop
    entries={"lvs_crop_cell_tables": [PTR, I32, PTR, I32, PTR, PTR, F32, F32, PTR]},
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
    cell = floor_cells_div(xyz, cell_size).to(torch.int32)
    b = torch.where(mask, _bucket(cell, n_buckets), n_buckets)
    vx = torch.where(mask, vox[:, 0], _BIG).to(torch.int64)
    khi = b * (1 << 32) + (vx + (1 << 31))
    return khi, _pack_yz(vox[:, 1], vox[:, 2])


def _bit_length(lo: int, hi: int) -> int:
    """Bits of hi - lo; 0 for an empty range (hi < lo)."""
    return (hi - lo).bit_length() if hi >= lo else 0


def _range(x: torch.Tensor, sel: torch.Tensor) -> Tuple[int, int]:
    """(min, max) of x over sel; (2^31 - 1, -2^31) when sel is empty."""
    if not bool(sel.any()):
        return 2**31 - 1, -(2**31)
    return int(x[sel].min()), int(x[sel].max())


def insert_sort_keys(
    xyz: torch.Tensor, mask: torch.Tensor, n_buckets: int, resolution: float, cell_size: float
) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """(hi, lo, narrow): int64 words per row whose lexicographic order is
    the reference's sort on (bucket, vx, vyz) with the row index last, the
    order of `_insert_order`. Kernel 9a's one-launch sort (`insert_cluster`
    in `csrc/cell_table.cu`) builds the same keys. Narrow (`lo` all 0): the
    fields offset by the batch's minima and packed into 63 bits, bucket,
    vx, cy, cz, row from the top, where cy and cz are `_pack_yz`'s clamped
    halves of vyz; the offsets are taken over all rows for the bucket, over
    valid rows for vx, cy and cz, and over masked rows for theirs (masked
    rows all sit in bucket B with vx 2^30, so only cy, cz and the row order
    them, and valid rows never compare with them below the bucket). Wide,
    when those widths pass 63 bits: hi = bucket * 2^32 + vx + 2^31, lo =
    vyz * 2^32 + row."""
    n = xyz.shape[0]
    khi, vyz = _insert_keys_ref(xyz, mask, n_buckets, resolution, cell_size)
    row = torch.arange(n, dtype=torch.int64, device=xyz.device)
    b, vx = khi >> 32, (khi & _U32) - (1 << 31)
    cy, cz = vyz.to(torch.int64) >> 15, vyz.to(torch.int64) & ((1 << 15) - 1)
    valid = b < n_buckets
    every = torch.ones_like(valid)
    (b0, b1), (x0, x1) = _range(b, every), _range(vx, valid)
    (y0, y1), (z0, z1) = _range(cy, valid), _range(cz, valid)
    (my0, my1), (mz0, mz1) = _range(cy, ~valid), _range(cz, ~valid)
    wx = _bit_length(x0, x1)
    wy = max(_bit_length(y0, y1), _bit_length(my0, my1))
    wz = max(_bit_length(z0, z1), _bit_length(mz0, mz1))
    wi = max(n - 1, 0).bit_length()
    if _bit_length(b0, b1) + wx + wy + wz + wi > 63:
        return khi, vyz.to(torch.int64) * (1 << 32) + row, False
    key = b - b0
    key = key * (1 << wx) + torch.where(valid, vx - x0, 0)
    key = key * (1 << wy) + cy - torch.where(valid, y0, my0)
    key = key * (1 << wz) + cz - torch.where(valid, z0, mz0)
    return key * (1 << wi) + row, torch.zeros_like(key), True


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
    inv_res = inv_resolution(resolution)
    if n <= INSERT_BLOCK_ROWS:  # host-known: one launch, nothing else
        INSERT_KERNEL.call(
            "lvs_insert_cell_table", ptr(xyz), ptr(mask), n, n_buckets, s, inv_res, table.cell_size,
            ptr(table.table),
        )
        INSERT_KERNEL.launches += 1
        return
    dev = xyz.device
    khi = torch.empty((n,), dtype=torch.int64, device=dev)
    vyz = torch.empty((n,), dtype=torch.int32, device=dev)
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
    return _crop((table,), center, radius, last_center, interval)


def crop_cell_tables_(
    edge: CellTable,
    surf: CellTable,
    center: torch.Tensor,
    radius: float,
    last_center: Optional[torch.Tensor] = None,
    interval: float = 0.0,
) -> torch.Tensor:
    """`crop_cell_table_` of both LFA tables on one gate, in one kernel 9b
    launch on CUDA; the plain version on CPU. Returns the center of the last
    crop."""
    if edge.table.device.type == "cpu":
        return crop_cell_tables_ref_(edge, surf, center, radius, last_center, interval)
    return _crop((edge, surf), center, radius, last_center, interval)


def _crop(tables, center, radius, last_center, interval) -> torch.Tensor:
    """Kernel 9b's launch over one or two tables."""
    center = center.contiguous()
    tensors = tuple(t.table for t in tables) + (center,) + ((last_center,) if last_center is not None else ())
    check_cuda("crop_cell_table", *tensors)
    check_dtype("crop_cell_table", center, torch.float32, (3,))
    for t in tables:
        if t.table.dtype != torch.float32 or t.table.data_ptr() % 16:
            raise ValueError("crop_cell_table: expected 16-byte aligned float32 tables")
    out = torch.empty((3,), dtype=torch.float32, device=center.device)
    a, b = tables if len(tables) == 2 else (tables[0], None)
    CROP_KERNEL.call(
        "lvs_crop_cell_tables", ptr(a.table), a.table.numel() // 4, ptr(b.table) if b is not None else None,
        b.table.numel() // 4 if b is not None else 0, ptr(center),
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


def crop_cell_tables_ref_(
    edge: CellTable,
    surf: CellTable,
    center: torch.Tensor,
    radius: float,
    last_center: Optional[torch.Tensor] = None,
    interval: float = 0.0,
) -> torch.Tensor:
    """Plain PyTorch version of `crop_cell_tables_`: the two single-table
    crops on the same (center, last_center) gate."""
    out = crop_cell_table_ref_(edge, center, radius, last_center, interval)
    crop_cell_table_ref_(surf, center, radius, last_center, interval)
    return out


def probe_buckets(table: CellTable, queries: torch.Tensor) -> torch.Tensor:
    """The buckets (Q,8) of the 2x2x2 cells around each query, offsets (i,
    j, k) with i outermost, as int64."""
    cs = table.cell_size
    base = floor_cells_div(queries - float(np.float32(cs / 2.0)), cs).to(torch.int32)
    p = torch.arange(8, dtype=torch.int32, device=queries.device)
    off = torch.stack([p >> 2, (p >> 1) & 1, p & 1], dim=1)
    return _bucket(base[:, None, :] + off[None], table.table.shape[0])


def candidates_cell(table: CellTable, queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw candidate set per query: (points (Q,8*S,3), valid (Q,8*S)) from the
    8 cells around each query, duplicate probe buckets dropped (the later
    probe of two that share a bucket). The plain form of kernel 10's probe."""
    s, q = table.slots, queries.shape[0]
    b = probe_buckets(table, queries)
    earlier = torch.tril(torch.ones((8, 8), dtype=torch.bool, device=queries.device), diagonal=-1)
    dup = torch.any((b[:, :, None] == b[:, None, :]) & earlier, dim=-1)
    cand = table.table[b].reshape(q, 8, s, 4)
    ok = (cand[..., 3] > 0.5) & ~dup[:, :, None]
    return cand[..., :3].reshape(q, 8 * s, 3), ok.reshape(q, 8 * s)


def _top_k(queries: torch.Tensor, cand: torch.Tensor, hit: torch.Tensor, k: int):
    """(dists (Q,k), points (Q,k,3), valid (Q,k)): the k best candidates by
    squared distance, misses at +inf; a stable ascending sort is
    `lax.top_k`'s order of -d2 (ties and misses to the lower index)."""
    d = queries[:, None, :] - cand
    d2 = torch.where(hit, dot3_fma(d, d), torch.inf)
    d2, top = torch.sort(d2, dim=1, stable=True)
    dists = sqrt32(torch.clamp(d2[:, :k], min=0.0))
    points = torch.gather(cand, 1, top[:, :k, None].expand(-1, -1, 3))
    return dists, points, torch.isfinite(dists)


def knn_cell_ref(table: CellTable, queries: torch.Tensor, k: int):
    """Plain PyTorch version of `knn_cell`."""
    cand, ok = candidates_cell(table, queries)
    return _top_k(queries, cand, ok, k)


def knn_cell(table: CellTable, queries: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """For each query (Q,3): (dists (Q,k), points (Q,k,3), valid (Q,k)), the
    k nearest of the 8-cell probe's candidates (duplicate probe buckets
    dropped), complete within cell_size/2; a query with fewer than k valid
    candidates returns its lowest-index invalid ones after them, at +inf.
    Kernel 9n on CUDA, the plain version on CPU."""
    if not 1 <= k <= 8 * table.slots:
        raise ValueError(f"knn_cell: k must be in [1, {8 * table.slots}], got {k}")
    if queries.device.type == "cpu":
        return knn_cell_ref(table, queries, k)
    q, n_buckets, s = queries.shape[0], table.table.shape[0], table.slots
    queries = queries.contiguous()
    check_cuda("knn_cell", table.table, queries)
    check_dtype("knn_cell", table.table, torch.float32, (n_buckets, s * 4))
    check_dtype("knn_cell", queries, torch.float32, (q, 3))
    dev = queries.device
    dists = torch.empty((q, k), dtype=torch.float32, device=dev)
    points = torch.empty((q, k, 3), dtype=torch.float32, device=dev)
    valid = torch.empty((q, k), dtype=torch.bool, device=dev)
    KNN_CELL_KERNEL.call("lvs_knn_cell", ptr(table.table), n_buckets, s, table.cell_size, ptr(queries), q, k,
                         ptr(dists), ptr(points), ptr(valid))
    KNN_CELL_KERNEL.launches += 1
    return dists, points, valid


def _default_buckets(n: int) -> int:
    """The reference's default table size: ~2N buckets, in [2^12, 2^18]."""
    return 1 << max(12, min(18, (2 * n - 1).bit_length()))


def _table_keys_ref(xyz: torch.Tensor, mask: torch.Tensor, cell_size: float, n_buckets: int) -> torch.Tensor:
    """int32 bucket of each row's cell; B for masked rows."""
    return torch.where(mask, _bucket(cell_coords(xyz, cell_size), n_buckets), n_buckets).to(torch.int32)


def build_cell_table_ref(
    xyz: torch.Tensor, mask: torch.Tensor, cell_size: float, n_buckets: Optional[int] = None, slots: int = 8
) -> CellTable:
    """Plain PyTorch version of `build_cell_table`, line for line with the
    reference: stable bucket sort, each row's rank in its bucket run, one
    scatter of the rows ranked below `slots`."""
    n = xyz.shape[0]
    n_buckets = n_buckets or _default_buckets(n)
    sb, order = torch.sort(_table_keys_ref(xyz, mask, cell_size, n_buckets), stable=True)
    idx = torch.arange(n, device=xyz.device)
    new_seg = torch.ones((n,), dtype=torch.bool, device=xyz.device)
    new_seg[1:] = sb[1:] != sb[:-1]
    rank = idx - torch.cummax(torch.where(new_seg, idx, 0), dim=0).values
    ok = mask[order] & (rank < slots) & (sb < n_buckets)
    rows = torch.cat([xyz[order], torch.ones_like(xyz[:, :1])], dim=1)
    table = torch.zeros((n_buckets * slots, 4), dtype=torch.float32, device=xyz.device)
    table[(sb.to(torch.int64) * slots + rank)[ok]] = rows[ok]  # the targets are distinct
    return CellTable(table=table.view(n_buckets, slots * 4), cell_size=float(np.float32(cell_size)))


def table_passes(n_buckets: int) -> int:
    """Digit passes of kernel 9c's key sort: the 8-bit digits of the largest
    bucket, B - 1 (at least one)."""
    if n_buckets < 1:
        raise ValueError(f"build_cell_table: n_buckets must be at least 1, got {n_buckets}")
    return max(1, -(-(n_buckets - 1).bit_length() // 8))


def build_cell_table(
    xyz: torch.Tensor, mask: torch.Tensor, cell_size: float, n_buckets: Optional[int] = None, slots: int = 8
) -> CellTable:
    """xyz (N,3), mask (N,) -> a hashed (B, S*4) table holding the first
    `slots` points of each bucket in input order. `n_buckets` defaults to
    ~2N. Kernel 9c on CUDA (one C call: the bucket keys and counts, the
    repo's key sort, one pass over the table), the plain version on CPU."""
    if xyz.device.type == "cpu":
        return build_cell_table_ref(xyz, mask, cell_size, n_buckets, slots)
    n = xyz.shape[0]
    n_buckets = n_buckets or _default_buckets(n)
    if n > MAX_SORT_LANES:
        raise ValueError(f"build_cell_table: {n} rows exceed the key sort's {MAX_SORT_LANES}")
    if slots < 1:
        raise ValueError(f"build_cell_table: slots must be at least 1, got {slots}")
    passes = table_passes(n_buckets)
    xyz, mask = xyz.contiguous(), mask.contiguous()
    check_cuda("build_cell_table", xyz, mask)
    check_dtype("build_cell_table", xyz, torch.float32, (n, 3))
    check_dtype("build_cell_table", mask, torch.bool, (n,))
    dev = xyz.device
    scratch = torch.empty((scratch_bytes("lvs_cell_table_scratch_bytes", n, n_buckets),), dtype=torch.uint8,
                          device=dev)
    table = torch.empty((n_buckets, slots * 4), dtype=torch.float32, device=dev)
    BUILD_TABLE_KERNEL.call(
        "lvs_build_cell_table", ptr(xyz), ptr(mask), n, n_buckets, slots, inv_resolution(cell_size), passes,
        ptr(scratch), scratch.numel(), ptr(table),
    )
    BUILD_TABLE_KERNEL.launches += 1
    return CellTable(table=table, cell_size=float(np.float32(cell_size)))


# ---------------------------------------------------------------- sorted grid


class KnnGrid(NamedTuple):
    keys: torch.Tensor         # (N,) int32 ascending flat cell keys (pad: INT32_MAX)
    xyz: torch.Tensor          # (N, 3) points sorted by key
    origin_cell: torch.Tensor  # (3,) int32
    cell_size: float


def _grid_keys_ref(xyz: torch.Tensor, mask: torch.Tensor, cell_size: float):
    """(int32 flat keys, INT32_MAX for masked lanes and out of the extent;
    int32 origin: the per-axis minimum cell over valid lanes, 0 without one)."""
    coords = cell_coords(xyz, cell_size).to(torch.int64)
    origin = torch.where(mask[:, None], coords, _BIG).amin(dim=0)
    origin = torch.where(origin == _BIG, 0, origin)
    rel = coords - origin
    e = _EXTENT
    ok = torch.all((rel >= 0) & (rel < e), dim=1) & mask
    flat = (rel[:, 0] * e + rel[:, 1]) * e + rel[:, 2]
    return torch.where(ok, flat, _KEY_MAX).to(torch.int32), origin.to(torch.int32)


def build_grid_ref(xyz: torch.Tensor, mask: torch.Tensor, cell_size: float) -> KnnGrid:
    """Plain PyTorch version of `build_grid`."""
    keys, origin = _grid_keys_ref(xyz, mask, cell_size)
    skeys, order = torch.sort(keys, stable=True)
    return KnnGrid(keys=skeys, xyz=xyz[order], origin_cell=origin, cell_size=float(np.float32(cell_size)))


def build_grid(xyz: torch.Tensor, mask: torch.Tensor, cell_size: float) -> KnnGrid:
    """xyz (N,3), mask (N,) -> the points sorted by cell key; equal keys keep
    input order, masked and out-of-extent lanes follow in lane order. Kernel
    9g on CUDA (one C call: the keys, the repo's key sort, one output pass),
    the plain version on CPU."""
    if xyz.device.type == "cpu":
        return build_grid_ref(xyz, mask, cell_size)
    n = xyz.shape[0]
    if n > MAX_SORT_LANES:
        raise ValueError(f"build_grid: {n} lanes exceed the key sort's {MAX_SORT_LANES}")
    xyz, mask = xyz.contiguous(), mask.contiguous()
    check_cuda("build_grid", xyz, mask)
    check_dtype("build_grid", xyz, torch.float32, (n, 3))
    check_dtype("build_grid", mask, torch.bool, (n,))
    dev = xyz.device
    scratch = torch.empty((scratch_bytes("lvs_knn_grid_scratch_bytes", n),), dtype=torch.uint8, device=dev)
    keys = torch.empty((n,), dtype=torch.int32, device=dev)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    origin = torch.empty((3,), dtype=torch.int32, device=dev)
    GRID_KERNEL.call(
        "lvs_knn_grid", ptr(xyz), ptr(mask), n, inv_resolution(cell_size), ptr(scratch), scratch.numel(), ptr(keys),
        ptr(out), ptr(origin),
    )
    GRID_KERNEL.launches += 1
    return KnnGrid(keys=keys, xyz=out, origin_cell=origin, cell_size=float(np.float32(cell_size)))


def _off27(device) -> torch.Tensor:
    """The 27 neighbour offsets (i, j, k), i outermost: the reference's `_OFF27`."""
    p = torch.arange(27, dtype=torch.int64, device=device)
    return torch.stack([p // 9, (p // 3) % 3, p % 3], dim=1) - 1


def knn_candidates(grid: KnnGrid, queries: torch.Tensor, slots_per_cell: int = 8):
    """(points (Q, 27*S, 3), hit (Q, 27*S)): the first S rows at or after each
    neighbour cell's binary-search start, the index clamped to the last row,
    in the reference's order (cell-major, `_OFF27` order). A candidate hits
    when its row holds that cell; cells out of the extent never hit."""
    e = _EXTENT
    coords = floor_cells_div(queries, grid.cell_size).to(torch.int32).to(torch.int64)
    rel = coords[:, None, :] - grid.origin_cell.to(torch.int64) + _off27(queries.device)
    in_extent = torch.all((rel >= 0) & (rel < e), dim=-1)
    flat = (rel[..., 0] * e + rel[..., 1]) * e + rel[..., 2]
    cell_key = torch.where(in_extent, flat, _KEY_MAX).to(torch.int32)
    start = torch.searchsorted(grid.keys, cell_key)  # side "left"
    slot = torch.arange(slots_per_cell, device=queries.device)
    idx = torch.clamp(start[..., None] + slot, max=grid.keys.shape[0] - 1)
    hit = (grid.keys[idx] == cell_key[..., None]) & in_extent[..., None]
    q = queries.shape[0]
    return grid.xyz[idx].reshape(q, -1, 3), hit.reshape(q, -1)


def knn_ref(
    grid: KnnGrid, queries: torch.Tensor, k: int, slots_per_cell: int = 8
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `knn`."""
    cand, hit = knn_candidates(grid, queries, slots_per_cell)
    return _top_k(queries, cand, hit, k)


def check_grid(name: str, grid: KnnGrid, *tensors: torch.Tensor) -> None:
    """The grid and the query tensors are contiguous CUDA tensors of the kernels' types."""
    n = grid.keys.shape[0]
    check_cuda(name, grid.keys, grid.xyz, grid.origin_cell, *tensors)
    check_dtype(name, grid.keys, torch.int32, (n,))
    check_dtype(name, grid.xyz, torch.float32, (n, 3))
    check_dtype(name, grid.origin_cell, torch.int32, (3,))
    if n == 0:
        raise ValueError(f"{name}: empty grid")


def knn(
    grid: KnnGrid, queries: torch.Tensor, k: int, slots_per_cell: int = 8
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """For each query (Q,3): (dists (Q,k), points (Q,k,3), valid (Q,k)), the
    k nearest of the first `slots_per_cell` stored points of the 27 cells
    around it, ascending, ties to the lower candidate index; misses have
    dist +inf and valid False. Kernel 9k on CUDA (k <= 8), the plain version
    on CPU."""
    if queries.device.type == "cpu":
        return knn_ref(grid, queries, k, slots_per_cell)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn: k must be in [1, {MAX_K}], got {k}")
    if slots_per_cell < 1:
        raise ValueError(f"knn: slots_per_cell must be at least 1, got {slots_per_cell}")
    q = queries.shape[0]
    queries = queries.contiguous()
    check_grid("knn", grid, queries)
    check_dtype("knn", queries, torch.float32, (q, 3))
    dev = queries.device
    dists = torch.empty((q, k), dtype=torch.float32, device=dev)
    points = torch.empty((q, k, 3), dtype=torch.float32, device=dev)
    valid = torch.empty((q, k), dtype=torch.bool, device=dev)
    KNN_KERNEL.call(
        "lvs_knn", ptr(grid.keys), ptr(grid.xyz), grid.keys.shape[0], ptr(grid.origin_cell), grid.cell_size,
        ptr(queries), q, k, slots_per_cell, ptr(dists), ptr(points), ptr(valid),
    )
    KNN_KERNEL.launches += 1
    return dists, points, valid
