"""The port's LFA world-map tables and sorted k-NN grid (kernel 9's plain
twins on the CPU) against lv_slam_tpu.ops.knn: insert, crop and the
whole-table build are exact, slot for slot; the grid build is identical
(keys, point order, origin) and the k-NN results are identical (distances,
points, valid flags).

The features of the conftest `small_sequence` go into empty tables at the
true poses, scan after scan, as the LFA's maps grow. The reference's insert
runs under jit with the resolution a compiled-in constant, as in its LFA
step, so XLA multiplies by the float32 reciprocal of the resolution; the
port does the same (`ops.cells.inv_resolution`). The k-NN squared
distances are the fma chain XLA's CPU backend makes of the reference's
sum of squares, which the port rounds alike (`ops.linalg3.dot3_fma`): the
two agree bit for bit on every query here (no tie of near-equal candidates
swaps), so the tests demand identity."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lv_slam_tpu.config import LfaConfig as JLfa  # noqa: E402
from lv_slam_tpu.core import se3 as jse3  # noqa: E402
from lv_slam_tpu.core.cloud import PointCloud as JCloud  # noqa: E402
from lv_slam_tpu.lfa.features import extract_features  # noqa: E402
from lv_slam_tpu.ops import knn as jk  # noqa: E402
from lv_slam_tpu_torch.ops import knn as tk  # noqa: E402
from test_torch_kernels import load_chip_smoke  # noqa: E402

KW = dict(scan_line=32, edge_cap=2048, planar_cap=4096, map_edge_cap=8192, map_planar_cap=16384)
CS = load_chip_smoke()  # the case lists that chip_smoke.py also runs on the card


@pytest.fixture(scope="module")
def batches(small_sequence):
    """Per scan: (world-frame less-sharp points, mask, world less-flat, mask)."""
    scans, gt, _ = small_sequence
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt).astype(np.float32)
    cfg = JLfa(**KW)
    out = []
    for s, pose in zip(scans, gt_rel):
        f = extract_features(JCloud.from_numpy(s, cap=32768), cfg)
        t = jnp.asarray(pose)
        out.append(tuple(np.array(a) for a in (
            jse3.transform_points(t, f.less_sharp), f.less_sharp_mask,
            jse3.transform_points(t, f.less_flat), f.less_flat_mask,
        )))
    return out, gt_rel


def _insert_both(batches, n_buckets, res, col):
    """Four scans into empty tables; returns the JAX and port tables after each."""
    ins = jax.jit(lambda t, x, m: jk.insert_cell_table(t, x, m, res))
    jt, tt, out = jk.empty_cell_table(n_buckets, 6, 2.0), tk.empty_cell_table(n_buckets, 6, 2.0, "cpu"), []
    for b in batches[:4]:
        jt = ins(jt, jnp.asarray(b[col]), jnp.asarray(b[col + 1]))
        tk.insert_cell_table_(tt, torch.from_numpy(b[col]), torch.from_numpy(b[col + 1]), res)
        out.append((np.asarray(jt.table), tt.table.numpy().copy()))
    return out, jt, tt


@pytest.mark.parametrize("col,res,n_buckets", [(0, 0.4, 4096), (2, 0.8, 8192), (2, 0.8, 4096)])
def test_insert_matches_slot_for_slot(batches, col, res, n_buckets):
    """Edge and surf maps (and a crowded surf table, where full buckets drop
    points) equal the reference's after every scan, bit for bit."""
    steps, _, _ = _insert_both(batches[0], n_buckets, res, col)
    for want, got in steps:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    stored = (steps[-1][1].reshape(-1, 4)[:, 3] > 0.5).sum()
    assert stored > steps[0][1].reshape(-1, 4)[:, 3].sum() > 100


def _copy(t):
    return tk.CellTable(t.table.clone(), t.cell_size)


def test_crop_matches(batches):
    _, jt, tt = _insert_both(batches[0], 4096, 0.8, 2)
    center = batches[1][4][:3, 3]
    for radius in (5.0, 12.0, 150.0):
        want = np.asarray(jk.crop_cell_table(jt, jnp.asarray(center), radius).table)
        cropped = _copy(tt)
        tk.crop_cell_table_(cropped, torch.from_numpy(center.copy()), radius)
        got = cropped.table.numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (got.reshape(-1, 4)[:, 3] > 0.5).sum() > 0


@pytest.mark.parametrize("gate", ["open", "closed", "crop_interval 0"])
def test_crop_both_tables_matches(batches, gate):
    """The two-table crop (one kernel 9b launch on the card; here its twin,
    the two single-table crops on one gate) against JAX's
    `crop_cell_table` of each table: cropped where the gate is open or
    absent, unchanged where it is closed; the returned center is the crop's
    or the last one."""
    _, jedge, tedge = _insert_both(batches[0], 4096, 0.4, 0)
    _, jsurf, tsurf = _insert_both(batches[0], 4096, 0.8, 2)
    center = batches[1][4][:3, 3].copy()
    last = {"open": center + 30.0, "closed": center + 3.0, "crop_interval 0": None}[gate]
    interval = 0.0 if last is None else 10.0
    edge, surf = _copy(tedge), _copy(tsurf)
    lc = torch.from_numpy(last.astype(np.float32)) if last is not None else None
    out = tk.crop_cell_tables_(edge, surf, torch.from_numpy(center), 12.0, lc, interval)
    for got, jt, before in ((edge, jedge, tedge), (surf, jsurf, tsurf)):
        want = np.asarray(jk.crop_cell_table(jt, jnp.asarray(center), 12.0).table) if gate != "closed" else \
            before.table.numpy()
        np.testing.assert_array_equal(got.table.numpy().view(np.int32), want.view(np.int32))
        if gate != "closed":
            assert (got.table.numpy().reshape(-1, 4)[:, 3] > 0.5).sum() < (before.table.numpy().reshape(-1, 4)[:, 3]
                                                                            > 0.5).sum()
    np.testing.assert_array_equal(out.numpy(), last if gate == "closed" else center)


def test_cell_table_points_match(batches):
    _, jt, tt = _insert_both(batches[0], 4096, 0.8, 2)
    pj, mj = (np.asarray(a) for a in jk.cell_table_points(jt))
    pt, mt = (a.numpy() for a in tk.cell_table_points(tt))
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(pt, pj)
    assert mt.sum() > 100


def test_crop_gate_decided_on_the_device(batches):
    """With a last crop center the crop runs only once the center has moved
    more than the interval, and returns the new last center."""
    _, _, tt = _insert_both(batches[0], 4096, 0.8, 2)
    center = torch.tensor([1.0, 2.0, 0.0])
    before = tt.table.clone()
    near = center + torch.tensor([3.0, 0.0, 0.0])
    kept = tk.crop_cell_table_(tt, center, 5.0, last_center=near, interval=10.0)
    assert torch.equal(tt.table, before) and torch.equal(kept, near)
    far = center + torch.tensor([30.0, 0.0, 0.0])
    moved = tk.crop_cell_table_(tt, center, 5.0, last_center=far, interval=10.0)
    assert torch.equal(moved, center)
    want = tk.CellTable(before, 2.0)
    tk.crop_cell_table_(want, center, 5.0)
    assert torch.equal(tt.table, want.table)


def test_duplicate_voxels_keep_the_first_in_batch_order():
    """Rows with one (bucket, voxel) key keep the reference's stable order:
    the first in the batch is stored, and a stored voxel wins over a later
    batch."""
    pts = np.array([[0.30, 0.30, 0.30], [0.35, 0.31, 0.32], [0.31, 0.39, 0.30],
                    [5.0, 5.0, 5.0], [0.36, 0.33, 0.35]], np.float32)
    mask = np.ones(5, bool)
    jt = jax.jit(lambda t, x, m: jk.insert_cell_table(t, x, m, 0.4))(
        jk.empty_cell_table(4096, 6, 2.0), jnp.asarray(pts), jnp.asarray(mask))
    tt = tk.empty_cell_table(4096, 6, 2.0, "cpu")
    tk.insert_cell_table_(tt, torch.from_numpy(pts), torch.from_numpy(mask), 0.4)
    np.testing.assert_array_equal(tt.table.numpy(), np.asarray(jt.table))
    rows = tt.table.numpy().reshape(-1, 4)
    stored = rows[rows[:, 3] > 0.5, :3]
    assert len(stored) == 2 and any((stored == pts[0]).all(axis=1))
    again = _copy(tt)
    tk.insert_cell_table_(again, torch.from_numpy(pts[::-1].copy()), torch.from_numpy(mask), 0.4)
    assert torch.equal(again.table, tt.table)


@functools.partial(jax.jit, static_argnums=(2, 3))
def _reference_order(xyz, mask, n_buckets, res, cs):
    """The permutation of the reference insert's sort (`lv_slam_tpu/ops/knn.py`
    `insert_cell_table`: its keys, then `lax.sort` on (bucket, vx, vyz) with
    num_keys=3), the row index carried as the operand it sorts."""
    from lv_slam_tpu.ops.prefilter import _pack_yz

    vox = jnp.floor(xyz / res).astype(jnp.int32)
    cell = jnp.floor(xyz / cs).astype(jnp.int32)
    b = jnp.where(mask, jk._bucket(cell, n_buckets), jnp.int32(n_buckets))
    vx = jnp.where(mask, vox[:, 0], jnp.int32(2**30))
    vyz = _pack_yz(vox[:, 1], vox[:, 2])
    row = jnp.arange(xyz.shape[0], dtype=jnp.int32)
    return jax.lax.sort((b, vx, vyz, row), num_keys=3, is_stable=True)[3]


SORT_CASES = {
    # case: (seed, voxel span, masked share, buckets, one-word keys); the
    # masked rows at the sentinel and elsewhere span cy and cz's 15 bits
    "masked rows, some at the sentinel": (1, 50, 0.5, 4096, True),
    "equal voxels": (2, 3, 0.1, 4096, True),
    "equal buckets, different voxels": (3, 40, 0.1, 7, True),
    "negative coordinates": (4, 400, 0.1, 32768, False),
    "at the pack's +-16384 clamp": (5, 30, 0.1, 16384, True),
    "fields past 63 bits": (6, 30, 0.1, 16384, False),
}


@pytest.mark.parametrize("case", list(SORT_CASES))
def test_insert_sort_keys_order_rows_as_the_reference_sort(case):
    """Kernel 9a's sort keys (`insert_sort_keys`, which `insert_block` in
    `csrc/cell_table.cu` mirrors) order every row, masked ones too, as the
    reference's three-key `lax.sort` with ties in row order. Points sit 0.2-0.8
    of a voxel from its faces, so both sides floor them alike."""
    seed, span, masked, n_buckets, one_word = SORT_CASES[case]
    rng = np.random.default_rng(seed)
    n, res, cs = 3000, 0.4, 2.0
    vox = rng.integers(-span, span, (n, 3))
    if case.startswith("negative"):
        vox = -np.abs(vox) - 1
    if case.startswith("at the pack"):  # y and z at, inside and beyond the clamp
        edge = rng.choice([-20000, -16385, -16384, -16383, 16382, 16383, 16384, 20000], (n // 3, 2))
        vox[: n // 3, 1:] = edge
    if case.startswith("fields past"):  # vx over 2^21 voxels, y and z at the clamp
        vox[:, 0] = rng.integers(-(2**20), 2**20, n)
        vox[: n // 2, 1:] = rng.choice([-20000, 20000], (n // 2, 2))
    xyz = ((vox + rng.uniform(0.2, 0.8, (n, 3))) * res).astype(np.float32)
    mask = rng.random(n) >= masked
    xyz[~mask & (rng.random(n) < 0.5)] = 1.0e6  # the sentinel, as masked feature lanes carry it
    want = np.asarray(_reference_order(jnp.asarray(xyz), jnp.asarray(mask), n_buckets, res, jnp.float32(cs)))
    hi, lo, narrow = tk.insert_sort_keys(torch.from_numpy(xyz), torch.from_numpy(mask), n_buckets, res, cs)
    np.testing.assert_array_equal(np.lexsort((lo.numpy(), hi.numpy())), want)
    assert narrow == one_word
    assert len(np.unique(np.stack([hi.numpy(), lo.numpy()]), axis=1)[0]) == n  # every key distinct


def test_candidates_match(batches):
    _, jt, tt = _insert_both(batches[0], 4096, 0.8, 2)
    q = batches[0][4][2]
    pj, oj = (np.asarray(a) for a in jax.jit(jk.candidates_cell)(jt, jnp.asarray(q)))
    pt, ot = (a.numpy() for a in tk.candidates_cell(tt, torch.from_numpy(q)))
    np.testing.assert_array_equal(ot, oj)
    np.testing.assert_array_equal(pt[ot], pj[oj])
    assert ot.any()


def _jit_build_grid(xyz, mask):
    """The reference's grid build as its callers compile it: the 2 m cell a constant."""
    return jax.jit(functools.partial(jk.build_grid, cell_size=2.0))(jnp.asarray(xyz), jnp.asarray(mask))


def _grid_inputs(batches, case):
    """(xyz, mask) of scan 0's world-frame less-sharp features: as extracted
    (padded lanes at the end), only the valid lanes, or all lanes masked;
    "scattered": the valid lanes shuffled among masked ones, every fifth
    moved 2.1 km out along x (valid lanes past the 1024-cell extent, which
    key INT32_MAX and follow the sorted lanes in lane order, as the masked
    ones do); "span_past_2^31": the same shuffled lanes with 3e9 m added to
    or taken from x (cells 1.5e9 either side of the origin's: the span
    passes 2^31 - 1 cells, whose offset wraps negative in int32 and leaves
    the extent as in int64)."""
    xyz, mask = batches[0][0][0], batches[0][0][1]
    if case == "all_valid":
        return xyz[mask].copy(), np.ones(int(mask.sum()), bool)
    if case == "all_invalid":
        return xyz, np.zeros_like(mask)
    if case in ("scattered", "span_past_2^31"):
        rng = np.random.default_rng(7)
        order = rng.permutation(len(mask))
        xyz, mask = xyz[order].copy(), mask[order].copy()
        if case == "scattered":
            xyz[::5, 0] += np.float32(2100.0)
        else:
            xyz[:, 0] = np.where(np.arange(len(mask)) % 2 == 0, np.float32(-3.0e9), np.float32(3.0e9))
        return xyz, mask
    return xyz, mask


def _same(got, want, name):
    for field, a, b in zip(("keys", "xyz", "origin_cell"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{name}.{field}")


@pytest.mark.parametrize("case", ["padded", "all_valid", "all_invalid", "scattered", "span_past_2^31"])
def test_build_grid_matches(batches, case):
    """Keys, point order and origin identical: the origin is the minimum
    cell over valid lanes (0 with none), masked and out-of-extent lanes key
    INT32_MAX and sort last in lane order, equal keys keep input order."""
    xyz, mask = _grid_inputs(batches, case)
    want = _jit_build_grid(xyz, mask)
    got = tk.build_grid(torch.from_numpy(xyz), torch.from_numpy(mask), 2.0)
    _same(got, want, case)
    assert got.cell_size == float(want.cell_size) == 2.0
    keys = got.keys.numpy()
    n_in = int((keys != 2**31 - 1).sum())
    assert n_in <= int(mask.sum()) and (keys[n_in:] == 2**31 - 1).all()
    if case == "all_invalid":
        assert (got.origin_cell.numpy() == 0).all()
    if case in ("scattered", "span_past_2^31"):  # the tail: every dropped lane, in lane order
        lanes = np.flatnonzero(~mask | (np.floor(xyz[:, 0] / 2.0) - got.origin_cell.numpy()[0] >= 1024))
        assert len(lanes) == len(keys) - n_in > 0 and n_in > 0
        np.testing.assert_array_equal(got.xyz.numpy()[n_in:], xyz[lanes])


def _queries(batches, grid_xyz):
    """Scan 1's world-frame less-sharp features, a point far outside the
    grid's 2 km extent, a sentinel, and the last grid row itself (in an
    all-valid grid its cell run ends at the last row, so the clamped slots
    repeat it)."""
    q = batches[0][1][0][batches[0][1][1]]
    extra = np.array([[5000.0, 0.0, 0.0], [1e6, 1e6, 1e6]], np.float32)
    return np.concatenate([q, extra, grid_xyz[-1:]]).astype(np.float32)


@pytest.mark.parametrize("k", [2, 3, 5])
def test_knn_matches(batches, k):
    xyz, mask = _grid_inputs(batches, "all_valid")
    jgrid = _jit_build_grid(xyz, mask)
    grid = tk.build_grid(torch.from_numpy(xyz), torch.from_numpy(mask), 2.0)
    q = _queries(batches, np.asarray(jgrid.xyz))
    want = [np.asarray(a) for a in jax.jit(jk.knn, static_argnums=2)(jgrid, jnp.asarray(q), k)]
    got = [a.numpy() for a in tk.knn(grid, torch.from_numpy(q), k)]
    for name, a, b in zip(("dists", "points", "valid"), got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)
    dists, points, valid = got
    assert valid[:-3].any(axis=1).mean() > 0.5
    assert not valid[-3:-1].any() and np.isinf(dists[-3:-1]).all()  # out of the extent: misses
    # the last row's run ends at the last row: the clamp repeats it, both hit at distance 0
    assert valid[-1, :2].all() and (dists[-1, :2] == 0).all() and (points[-1, 0] == points[-1, 1]).all()


@functools.lru_cache(maxsize=1)
def _table_cases():
    return {name: rest for name, *rest in CS.table_cases()}


@pytest.mark.parametrize("case", [None, 1024, *CS.TABLE_CASE_NAMES])
def test_build_cell_table_matches_slot_for_slot(batches, case):
    """The world-frame surf features of scans 0-3 stacked as one map buffer
    with its padded lanes, at the default buckets and at 1024 (many
    overflow their 6 slots); then kernel 9c's edge cases
    (chip_smoke.table_cases, which the card runs against these twins): every
    row masked, 40 rows in one cell, 256 buckets (one digit pass) shared by
    many cells, 5001 rows, 2^15 and 2^18 buckets (three passes)."""
    if case is None or case == 1024:
        xyz = np.concatenate([b[2] for b in batches[0][:4]])
        mask = np.concatenate([b[3] for b in batches[0][:4]])
        n_buckets, slots = case, 6
    else:
        xyz, mask, n_buckets, slots = _table_cases()[case]
    build = functools.partial(jk.build_cell_table, cell_size=2.0, n_buckets=n_buckets, slots=slots)
    want = np.asarray(jax.jit(build)(jnp.asarray(xyz), jnp.asarray(mask)).table)
    got = tk.build_cell_table(torch.from_numpy(xyz), torch.from_numpy(mask), 2.0, n_buckets, slots)
    np.testing.assert_array_equal(got.table.numpy().view(np.int32), want.view(np.int32))
    stored = int((got.table.numpy().reshape(-1, 4)[:, 3] > 0.5).sum())
    if case == "every row masked":
        assert stored == 0 and not got.table.numpy().any()
        return
    assert 100 < stored <= int(mask.sum())
    if case in (1024, "40 rows in one cell", CS.TABLE_CASE_NAMES[2]):
        assert stored < int(mask.sum())  # full buckets dropped rows


@pytest.mark.parametrize("n_buckets,passes", [(1, 1), (256, 1), (257, 2), (1 << 16, 2), (1 << 18, 3)])
def test_table_passes(n_buckets, passes):
    """Kernel 9c's digit passes: the 8-bit digits of the largest bucket, B - 1, at least one."""
    assert tk.table_passes(n_buckets) == passes


def _same_knn(got, want, err_msg=""):
    for name, a, b in zip(("dists", "points", "valid"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{err_msg} {name}")


@pytest.mark.parametrize("k", [1, 5, 48])
def test_knn_cell_matches(batches, k):
    """The k nearest of the 8-cell probe on the surf map of scans 0-3, scan
    4's world-frame surf features as queries: distances, points (the
    invalid slots' too: the rows of the lowest-index invalid candidates)
    and valid flags identical; k = 48 = 8 x 6 takes every candidate."""
    _, jt, tt = _insert_both(batches[0], 4096, 0.8, 2)
    q = batches[0][4][2]
    want = jax.jit(jk.knn_cell, static_argnums=2)(jt, jnp.asarray(q), k)
    got = tk.knn_cell(tt, torch.from_numpy(q), k)
    _same_knn(got, want, f"k={k}")
    valid = got[2].numpy()
    assert valid[:, 0].mean() > 0.5
    if k == 48:
        assert (~valid).any()  # invalid slots compared too


def test_knn_cell_constructed_cases():
    """Points with negative cells and repeated points (equal distances:
    ties to the lower candidate index) in a crowded table (8 buckets: the
    probes of one query share buckets, the later one dropped) and in a
    sparse one (4096 buckets); queries near the points, in a negative cell,
    on a repeated point and far from every point (in the sparse table no
    valid candidate: the empty slots' rows returned)."""
    rng = np.random.default_rng(3)
    base = rng.uniform(-6.0, 6.0, (40, 3)).astype(np.float32)
    pts = np.concatenate([base, base[:10], base[:5]])
    near = base[:12] + rng.normal(0.0, 0.05, (12, 3)).astype(np.float32)
    q = np.concatenate([near, [[-3.3, -0.7, -5.1], base[0], base[3], [700.0, -300.0, 90.0]]]).astype(np.float32)
    out = {}
    for n_buckets in (8, 4096):
        build = functools.partial(jk.build_cell_table, cell_size=2.0, n_buckets=n_buckets, slots=6)
        jt = jax.jit(build)(jnp.asarray(pts), jnp.asarray(np.ones(len(pts), bool)))
        tt = tk.CellTable(torch.from_numpy(np.array(jt.table)), 2.0)
        for k in (1, 5, 48):
            want = jax.jit(jk.knn_cell, static_argnums=2)(jt, jnp.asarray(q), k)
            got = tk.knn_cell(tt, torch.from_numpy(q), k)
            _same_knn(got, want, f"{n_buckets} buckets, k={k}")
        out[n_buckets] = tt, [a.numpy() for a in got]
    # the cases happen: dropped probes, ties between valid slots, a negative
    # cell, a query without any valid candidate
    tt, (dists, points, valid) = out[8]
    _, ok = tk.candidates_cell(tt, torch.from_numpy(q))
    assert (ok.numpy().reshape(len(q), 8, 6).sum(axis=2) == 0).any()
    assert ((dists[:, 1:] == dists[:, :-1]) & valid[:, 1:]).any()
    assert (np.floor(q[12] / 2.0) < 0).all() and valid[12, 0]
    _, (dists, points, valid) = out[4096]
    assert not valid[-1].any() and np.isinf(dists[-1]).all()
    with pytest.raises(ValueError):
        tk.knn_cell(tt, torch.from_numpy(q), 49)


@functools.lru_cache(maxsize=1)
def _knn_cases():
    return {name: rest for name, *rest in CS.knn_cases()}


@pytest.mark.parametrize("case", CS.KNN_CASE_NAMES)
def test_knn_cases_against_jax(case):
    """Kernel 9k's edge cases (chip_smoke.knn_cases, which the card runs
    against these twins): the grid, `knn` at k = 1 and 8, the 2-point lines
    and the 3-point planes identical to the reference's, gates included
    (ties of equal distances, duplicated points, overflowing cells, the
    clamp at the last row, the extent's edges, masked tail rows, an empty
    grid, a sampled search past 8192 keys, d0^2 = 25 and norm = 1e-3)."""
    from lv_slam_tpu.lfa import registration as jr
    from lv_slam_tpu_torch.lfa import registration as tr

    pts, mask, q, qm = _knn_cases()[case]
    jgrid = _jit_build_grid(pts, mask)
    grid = tk.build_grid(torch.from_numpy(pts), torch.from_numpy(mask), 2.0)
    _same(grid, jgrid, case)
    for k in CS.KNN_CASE_KS:
        want = [np.asarray(a) for a in jax.jit(jk.knn, static_argnums=2)(jgrid, jnp.asarray(q), k)]
        got = [a.numpy() for a in tk.knn(grid, torch.from_numpy(q), k)]
        for name, a, b in zip(("dists", "points", "valid"), got, want):
            np.testing.assert_array_equal(a, b, err_msg=f"{case}: knn k={k} {name}")
    for kind in ("lines_from_2nn", "planes_from_3nn"):
        want = [np.asarray(a) for a in jax.jit(getattr(jr, kind))(jnp.asarray(q), jnp.asarray(qm), jgrid)]
        got = [a.numpy() for a in getattr(tr, kind)(torch.from_numpy(q), torch.from_numpy(qm), grid)]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=f"{case}: {kind}")
    if case.startswith("the gates"):  # the 5 m neighbour is turned away, 2 mm closer it is taken; 1e-3 norms fail
        lines = tr.lines_from_2nn(torch.from_numpy(q), torch.from_numpy(qm), grid)
        planes = tr.planes_from_3nn(torch.from_numpy(q), torch.from_numpy(qm), grid)
        assert lines.valid.tolist() == planes.valid.tolist() == [False, True, False, False]
