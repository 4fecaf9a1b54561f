"""The cell rule on coordinates that the reference flushes to zero.

XLA's CPU code (and the TPU) flushes subnormal inputs and results, so in
the reference a negative subnormal coordinate lies in cell 0, as does a
normal one whose product with a reciprocal below 1 is subnormal (x = -2e-38
at 4 m: -5e-39). The port forms every cell as floor(ftz(ftz(x) * inv)), or
floor(ftz(ftz(x) / d)) where the reference divides truly (`ops/cells.py`;
the kernels' `lvs::cell_floor`). Each case runs the port's plain twin and
the reference on the same raw points, `chip_smoke.TINY`'s coordinates
among them (subnormals of both signs, the least ones, +-2e-38, -0), laid
out by `chip_smoke._tiny_scene` so that every cell holding a tiny
coordinate holds normal ones on that axis too (the reference's sums flush
a subnormal addend; the port's do not, which no cell decides): the cells,
keys, tables, hit sets and decisions are identical, and the floats as each
module's own parity test holds them."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lv_slam_tpu.core.cloud import PointCloud as JCloud  # noqa: E402
from lv_slam_tpu.lfa import registration as jr  # noqa: E402
from lv_slam_tpu.ops import knn as jk, ndt_hash as jh, nn as jnn, prefilter as jpf  # noqa: E402
from lv_slam_tpu.ops.ndt import make_gauss_params as j_gauss  # noqa: E402
from lv_slam_tpu.ops.voxel_map import build_voxel_map as j_build, neighborhood_offsets as j_offsets  # noqa: E402
from lv_slam_tpu_torch.core.cloud import PointCloud as TCloud  # noqa: E402
from lv_slam_tpu_torch.lfa import registration as tr  # noqa: E402
from lv_slam_tpu_torch.ops import cells, knn as tk, ndt_hash as th, nn as tnn, prefilter as tpf  # noqa: E402
from lv_slam_tpu_torch.ops.ndt import make_gauss_params as t_gauss  # noqa: E402
from lv_slam_tpu_torch.ops.voxel_map import build_voxel_map as t_build, neighborhood_offsets as t_offsets  # noqa: E402
from lv_slam_tpu_torch.ops.voxel_map import leaf_eigen_ratio, probe_cells  # noqa: E402
from test_torch_kernels import load_chip_smoke  # noqa: E402

CS = load_chip_smoke()  # TINY and _tiny_scene, which chip_smoke.py's subnormal cases also use
NOISY_RATIO = CS.NOISY_RATIO


def _grid_of_tiny():
    """(n, 3) points whose coordinates run over TINY and a few normal
    values on every axis: each combination once."""
    vals = np.concatenate([CS.TINY, np.float32([0.3, -0.3, 5.5, -7.25])])
    return np.stack(np.meshgrid(vals, vals, vals, indexing="ij"), -1).reshape(-1, 3).astype(np.float32)


def _scene(res: float, n: int = 4096, seed: int = 0, gap: int = 1) -> np.ndarray:
    return CS._tiny_scene(np.random.default_rng(seed), n, res, gap=gap)


def _queries(pts: np.ndarray, seed: int, n: int = 600) -> np.ndarray:
    """Points near `pts`, a fifth of their coordinates from TINY."""
    rng = np.random.default_rng(seed)
    q = pts[rng.choice(len(pts), n, replace=False)] + rng.normal(0.0, 0.2, (n, 3))
    at = rng.random(q.shape) < 0.2
    q[at] = rng.choice(CS.TINY, int(at.sum()))
    return q.astype(np.float32)


def _clouds(pts: np.ndarray):
    mask = np.ones(len(pts), bool)
    return (JCloud(pts, np.zeros(len(pts), np.float32), mask),
            TCloud(torch.from_numpy(pts), torch.zeros(len(pts)), torch.from_numpy(mask)))


def _bits_equal(got: torch.Tensor, want, what: str) -> None:
    a, b = got.numpy(), np.asarray(want)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b, err_msg=what)


def check_cell_coords(res):
    """`cell_coords` (every key's front end) against XLA's floor(x / res),
    res a compiled-in constant (a reciprocal's product)."""
    pts = _grid_of_tiny()
    want = jax.jit(lambda p: jnp.floor(p / res).astype(jnp.int32))(jnp.asarray(pts))
    _bits_equal(cells.cell_coords(torch.from_numpy(pts), res), want, "cell_coords")


def check_probe_cells(res):
    """`probe_cells` (the LUT probes' true division) against XLA's
    floor(x / r), r an argument as the map's resolution array is."""
    pts = _grid_of_tiny()
    want = jax.jit(lambda p, r: jnp.floor(p / r).astype(jnp.int32))(jnp.asarray(pts), jnp.float32(res))
    _bits_equal(probe_cells(torch.from_numpy(pts), torch.zeros(3, dtype=torch.int32), res), want, "probe_cells")


def check_downsample(res):
    """The voxel downsample and the first-point dedup (K1's and K1b's
    keys): masks, points and intensities bit for bit."""
    pts = _scene(res)
    jc, tc = _clouds(pts)
    for j_fn, t_fn in ((functools.partial(jpf.voxel_downsample, resolution=res, out_cap=len(pts)),
                        lambda c: tpf.voxel_downsample(c, res, len(pts))),
                       (functools.partial(jpf.voxel_dedup_first, resolution=res, out_cap=len(pts)),
                        lambda c: tpf.voxel_dedup_first(c, res, len(pts)))):
        want, got = jax.jit(j_fn)(jc), t_fn(tc)
        for field in ("mask", "xyz", "intensity"):
            _bits_equal(getattr(got, field), getattr(want, field), field)


def check_voxel_map(res):
    """`build_voxel_map` (K3's twin): origin and the leaves' keys identical,
    validity identical but on leaves flat to rounding, means to 1e-5."""
    pts = _scene(res)
    jc, tc = _clouds(pts)
    want = jax.jit(functools.partial(j_build, resolution=res, leaf_cap=4096, lut_extent=256))(jc)
    got = t_build(tc, res, leaf_cap=4096, lut_extent=256)
    _bits_equal(got.origin_cell, want.origin_cell, "origin_cell")
    vj, vt = np.asarray(want.valid), got.valid.numpy()
    noisy = leaf_eigen_ratio(tc, res, 4096, 256).numpy() < NOISY_RATIO
    assert not ((vj != vt) & ~noisy).any()
    both = vj & vt
    assert both.sum() > 20
    np.testing.assert_array_equal(np.asarray(want.lut)[got.keys.numpy()[both]], np.flatnonzero(both))
    np.testing.assert_allclose(got.means.numpy()[both], np.asarray(want.means)[both], atol=1e-5, rtol=0)


def check_hash_probe(res):
    """The hash map's probe (K6's and K13's cells, `ndt_derivatives_hash`)
    on the reference's table, under the identity: score rtol 1e-4, gradient
    and Hessian atol 2e-5 of their largest entry."""
    pts = _scene(res)
    jc, _ = _clouds(pts)
    jmap = jh.to_hash(jax.jit(functools.partial(j_build, resolution=res, leaf_cap=4096, lut_extent=256))(jc))
    hm = th.HashVoxelMap(torch.from_numpy(np.array(jmap.table)), torch.from_numpy(np.array(jmap.origin_cell)), res,
                         jmap.extent, torch.from_numpy(np.array(jmap.n_dropped)))
    xs = _queries(pts, 1).T.copy()
    mask, eye = np.ones(xs.shape[1], bool), np.eye(4, dtype=np.float32)
    s1, g1, h1 = jax.jit(lambda x: jh.ndt_derivatives_hash(jmap, x, jnp.asarray(mask), jnp.asarray(eye), j_gauss(res),
                                                          j_offsets("DIRECT7"), True))(jnp.asarray(xs))
    s2, g2, h2 = th.ndt_derivatives_hash_ref(hm, torch.from_numpy(xs), torch.from_numpy(mask), torch.from_numpy(eye),
                                             t_gauss(res), t_offsets("DIRECT7", "cpu"), True)
    assert float(s1) > 0.0
    np.testing.assert_allclose(float(s2), float(s1), rtol=1e-4)
    g1, h1 = np.asarray(g1), np.asarray(h1)
    np.testing.assert_allclose(g2.numpy(), g1, rtol=0, atol=2e-5 * np.abs(g1).max())
    np.testing.assert_allclose(h2.numpy(), h1, rtol=0, atol=2e-5 * np.abs(h1).max())


def check_cell_table(res):
    """A cell table (the bucket of floor(x / 2 m)) slot for slot: built
    whole (`build_cell_table`, K9c's twin) where `res` is None, else
    inserted into an empty one with duplicates of a floor(x * (1 / res))
    voxel dropped (`insert_cell_table_`, K9a's twin). Then `knn_cell` (K9n's
    twin, the probe's floor((q - 1 m) / 2 m)) at k = 5: distances, points
    and flags identical."""
    pts = _scene(2.0)
    mask = np.ones(len(pts), bool)
    if res is None:
        build = functools.partial(jk.build_cell_table, cell_size=2.0, n_buckets=4096, slots=6)
        jt = jax.jit(build)(jnp.asarray(pts), jnp.asarray(mask))
        tt = tk.build_cell_table(torch.from_numpy(pts), torch.from_numpy(mask), 2.0, 4096, 6)
    else:
        jt = jax.jit(lambda tab, x, m: jk.insert_cell_table(tab, x, m, res))(
            jk.empty_cell_table(4096, 6, 2.0), jnp.asarray(pts), jnp.asarray(mask))
        tt = tk.empty_cell_table(4096, 6, 2.0, "cpu")
        tk.insert_cell_table_(tt, torch.from_numpy(pts), torch.from_numpy(mask), res)
    _bits_equal(tt.table, jt.table, "table")
    q = _queries(pts, 2)
    want = jax.jit(jk.knn_cell, static_argnums=2)(jt, jnp.asarray(q), 5)
    for name, a, b in zip(("dists", "points", "valid"), tk.knn_cell(tt, torch.from_numpy(q), 5), want):
        _bits_equal(a, b, name)


def check_grid(k):
    """`build_grid` (K9g's twin; floor(x * (1 / cell))) identical, `knn`
    (K9k's twin; the query's floor(q / cell)) at k identical, and the 5-NN
    fits' KnnGrid branch (K10g's twin) with identical decisions."""
    pts = _scene(2.0, gap=3)
    q = _queries(pts, 3)
    qm = np.ones(len(q), bool)
    jgrid = jax.jit(lambda x, m: jk.build_grid(x, m, 2.0))(jnp.asarray(pts), jnp.asarray(np.ones(len(pts), bool)))
    grid = tk.build_grid(torch.from_numpy(pts), torch.ones(len(pts), dtype=torch.bool), 2.0)
    for field in ("keys", "xyz", "origin_cell"):
        _bits_equal(getattr(grid, field), getattr(jgrid, field), field)
    want = jax.jit(jk.knn, static_argnums=2)(jgrid, jnp.asarray(q), k)
    for name, a, b in zip(("dists", "points", "valid"), tk.knn(grid, torch.from_numpy(q), k), want):
        _bits_equal(a, b, name)
    for j_fn, t_fn in ((jr.lines_from_fit, tr.lines_from_fit), (jr.planes_from_fit, tr.planes_from_fit)):
        want = jax.jit(j_fn)(jnp.asarray(q), jnp.asarray(qm), jgrid)
        got = t_fn(torch.from_numpy(q), torch.from_numpy(qm), grid)
        _bits_equal(got.valid, want.valid, "decisions")


def check_centroid_grid(res):
    """`build_centroid_grid` (K14's twin): keys, counts and origin
    identical, centroids to 1e-6 relative; `nn_sq_dists` (K14's probe, and
    K17's and K18's cells) with the same hit set, d2 to 1e-6 relative."""
    pts = _scene(res)
    jc, tc = _clouds(pts)
    want = jax.jit(functools.partial(jnn.build_centroid_grid, resolution=res, leaf_cap=8192))(jc)
    got = tnn.build_centroid_grid(tc, res, 8192)
    for field in ("keys", "counts", "origin_cell"):
        _bits_equal(getattr(got, field), getattr(want, field), field)
    valid = got.counts.numpy() > 0
    np.testing.assert_allclose(got.centroids.numpy()[valid], np.asarray(want.centroids)[valid], rtol=1e-6, atol=0)
    q = _queries(pts, 4)
    qm = np.ones(len(q), bool)
    d2_j = np.asarray(jax.jit(jnn.nn_sq_dists)(want, jnp.asarray(q), jnp.asarray(qm)))
    d2_t = tnn.nn_sq_dists(got, torch.from_numpy(q), torch.from_numpy(qm)).numpy()
    hit = np.isfinite(d2_j)
    assert hit.sum() > 100
    np.testing.assert_array_equal(np.isfinite(d2_t), hit)
    np.testing.assert_allclose(d2_t[hit], d2_j[hit], rtol=1e-6, atol=1e-12)


CASES = [
    *((f"cell_coords at {r} m", check_cell_coords, r) for r in (0.1, 1.0, 2.0, 4.0, 10.0)),
    *((f"probe_cells at {r} m", check_probe_cells, r) for r in (0.7, 1.0, 4.0, 10.0)),
    *((f"voxel downsample and dedup at {r} m", check_downsample, r) for r in (0.1, 2.0, 4.0)),
    *((f"build_voxel_map at {r} m", check_voxel_map, r) for r in (1.0, 4.0)),
    *((f"hash probe at {r} m", check_hash_probe, r) for r in (1.0, 4.0)),
    ("build_cell_table and knn_cell", check_cell_table, None),
    *((f"insert_cell_table_ at {r} m voxels and knn_cell", check_cell_table, r) for r in (0.4, 0.8)),
    *((f"build_grid, knn at k = {k} and the grid fits", check_grid, k) for k in (1, 8)),
    *((f"build_centroid_grid at {r} m", check_centroid_grid, r) for r in (0.25, 4.0)),
]


@pytest.mark.parametrize("name,check,arg", CASES, ids=[c[0] for c in CASES])
def test_cells_of_flushed_coordinates_match_jax(name, check, arg):
    check(arg)
