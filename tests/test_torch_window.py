"""The port's first-point voxel dedup (kernel 1b's plain twin) and the
backend's window programs (kernels 2's and 2r's) against `lv_slam_tpu.ops.
prefilter.voxel_dedup_first` and `lv_slam_tpu.utils.jit_cache`'s window
programs (CPU).

The dedup copies input points, so masks, lane order and kept points are
identical, bit for bit. The window programs move points first: the port
takes the same fma chain XLA makes of the reference's einsum on the CPU
(`se3.transform_points_fma`), so there too every lane is identical. The raw
group's distance band takes |p| as the reference's compiled norm rounds it
(`sqrt32(dot3_fma(p, p))`), so points within 4 ulps of either band edge are
kept or dropped alike, and its voxel centroids sum in the same order."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lv_slam_tpu.core.cloud import PointCloud as JCloud  # noqa: E402
from lv_slam_tpu.ops import prefilter as jpf  # noqa: E402
from lv_slam_tpu.utils import jit_cache  # noqa: E402
from lv_slam_tpu_torch.core.cloud import PointCloud as TCloud  # noqa: E402
from lv_slam_tpu_torch.ops import prefilter as tpf  # noqa: E402
from lv_slam_tpu_torch.pipeline import window  # noqa: E402


def _points(seed: int, n: int) -> np.ndarray:
    """(n, 4) points with duplicate-voxel clusters, points on 0.1 m cell
    faces and negative coordinates; intensity in column 3."""
    rng = np.random.default_rng(seed)
    far = rng.uniform(-60.0, 60.0, (n // 2, 3))
    m = n - n // 2
    centers = rng.uniform(-20.0, 20.0, (-(-m // 4), 3))
    near = np.repeat(centers, 4, axis=0)[:m] + rng.normal(0.0, 0.01, (m, 3))
    pts = np.concatenate([far, near])
    pts[::7] = np.round(pts[::7], 1)  # on cell faces
    inten = rng.uniform(0.0, 1.0, (n, 1))
    return np.concatenate([pts, inten], axis=1).astype(np.float32)[rng.permutation(n)]


def _chunk(n_scans: int, cap: int, seed: int = 3):
    """A filtered chunk as the odometry returns it: xyz (C, 3, cap)
    transposed, intensity and mask (C, cap), masked lanes at the sentinel."""
    rng = np.random.default_rng(seed)
    xyz, inten, mask = [], [], []
    for i in range(n_scans):
        c = JCloud.from_numpy(_points(seed + i, cap - 500), cap=cap)
        m = np.asarray(c.mask) & (rng.uniform(size=cap) > 0.1)
        xyz.append(np.where(m[:, None], np.asarray(c.xyz), 1e6).T)
        inten.append(np.asarray(c.intensity))
        mask.append(m)
    return np.stack(xyz).astype(np.float32), np.stack(inten), np.stack(mask)


def _rels(length: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    out = np.tile(np.eye(4, dtype=np.float32), (length, 1, 1))
    for i in range(length):
        yaw = rng.uniform(-0.3, 0.3)
        c, s = np.cos(yaw), np.sin(yaw)
        out[i, :3, :3] = [[c, -s, 0.01], [s, c, -0.02], [-0.01, 0.02, 1.0]]
        out[i, :3, 3] = rng.uniform(-3.0, 3.0, 3)
    return out


def _assert_identical(t: TCloud, j: JCloud):
    for a, b in zip(t, (j.xyz, j.intensity, j.mask)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _assert_bits(t: TCloud, j: JCloud):
    """Masks, lane order and every float bit identical."""
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    np.testing.assert_array_equal(t.xyz.numpy().view(np.int32), np.asarray(j.xyz).view(np.int32))
    np.testing.assert_array_equal(t.intensity.numpy().view(np.int32), np.asarray(j.intensity).view(np.int32))


def _chip_smoke():
    """chip_smoke.py as a module (it imports numpy only at the top): the
    edge cases that the card's checks run."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("_chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CHIP_SMOKE = _chip_smoke()


@pytest.fixture(scope="module")
def sort_cases():
    return {name: case for name, *case in CHIP_SMOKE.sort_cases()}


@pytest.fixture(scope="module")
def window_cases():
    return {name: case for name, *case in CHIP_SMOKE.window_cases()}


@pytest.fixture(scope="module")
def raw_window_cases():
    return {name: case for name, *case in CHIP_SMOKE.raw_window_cases()}


@pytest.mark.parametrize("cap,out_cap", [(32768, 32768), (32768, 8192), (16384, 65536)])
def test_voxel_dedup_first(cap, out_cap):
    """First point per voxel in key order, ties to the lower input index;
    min(cap, out_cap) lanes (the reference's slice)."""
    pts = _points(7, 20000)
    j_in = JCloud.from_numpy(pts, cap=cap)
    want = jax.jit(functools.partial(jpf.voxel_dedup_first, resolution=0.1, out_cap=out_cap))(j_in)
    got = tpf.voxel_dedup_first(TCloud.from_numpy(pts, cap=cap, device="cpu"), 0.1, out_cap)
    assert got.cap == min(cap, out_cap)
    _assert_identical(got, want)
    n_kept = int(got.mask.sum())
    assert 0 < n_kept < int(np.asarray(j_in.mask).sum())  # duplicates really dropped
    assert bool(got.mask[:n_kept].all())                   # front-compacted


@pytest.mark.parametrize("length,start,n_valid", [(1, 0, 1), (4, 2, 3), (8, 5, 8), (16, 0, 11)])
def test_window_group_filtered(length, start, n_valid):
    """A group of `length` rows from `start` (rows past the chunk clip to
    its last), padding rows masked by `valid`."""
    xyz, inten, mask = _chunk(12, 4096)
    rels = _rels(length, seed=length)
    valid = np.arange(length) < n_valid
    fn = jit_cache.window_group_filtered_fn(0.1, 32768, length)
    want = fn(jnp.asarray(xyz), jnp.asarray(inten), jnp.asarray(mask), jnp.int32(start),
              jnp.asarray(rels), jnp.asarray(valid))
    got = window.window_group_filtered(
        torch.from_numpy(xyz), torch.from_numpy(inten), torch.from_numpy(mask), start,
        torch.from_numpy(rels), torch.from_numpy(valid), 0.1, 32768,
    )
    assert got.cap == min(length * 4096, 32768)
    _assert_identical(got, want)


@pytest.mark.parametrize("name", CHIP_SMOKE.SORT_CASE_NAMES)
def test_voxel_dedup_first_edge_cases(sort_cases, name):
    """Kernel 1b's twin on kernel 1's edge cases (`chip_smoke.sort_cases`,
    which the card holds the kernel to bit for bit against this twin): equal
    to JAX bit for bit, masked lanes holding NaN and unmasked lanes at kx >=
    2^30 included; out_cap clipped to the lanes."""
    pts, mask, res, out_cap, _ = sort_cases[name]
    want = jax.jit(functools.partial(jpf.voxel_dedup_first, resolution=res, out_cap=out_cap))(
        JCloud(pts[:, :3], pts[:, 3], mask))
    got = tpf.voxel_dedup_first(
        TCloud(torch.from_numpy(pts[:, :3].copy()), torch.from_numpy(pts[:, 3].copy()), torch.from_numpy(mask)),
        res, out_cap)
    assert got.cap == min(len(pts), out_cap)
    _assert_bits(got, want)
    n_kept = int(got.mask.sum())
    assert bool(got.mask[:n_kept].all())  # front-compacted
    expected = {"every lane masked": 0, "one voxel holding every point": 1, "out_cap below the runs": out_cap}
    if name in expected:
        assert n_kept == expected[name]


@pytest.mark.parametrize("name", CHIP_SMOKE.WINDOW_CASE_NAMES)
def test_window_group_filtered_edge_cases(window_cases, name):
    """Kernel 2's twin on `chip_smoke.window_cases` (which the card holds the
    kernel to bit for bit against this twin): equal to JAX's
    `window_group_filtered_fn` bit for bit, for a group of one row and of
    16, rows clipped to the chunk, every row invalid, and points moved past
    the key's yz clip range."""
    xyz, inten, mask, start, rels, valid, res, out_cap = window_cases[name]
    want = jit_cache.window_group_filtered_fn(res, out_cap, len(rels))(
        jnp.asarray(xyz), jnp.asarray(inten), jnp.asarray(mask), jnp.int32(start), jnp.asarray(rels),
        jnp.asarray(valid))
    got = window.window_group_filtered(*(torch.from_numpy(a) for a in (xyz, inten, mask)), start,
                                       torch.from_numpy(rels), torch.from_numpy(valid), res, out_cap)
    assert got.cap == min(len(rels) * xyz.shape[2], out_cap)
    _assert_bits(got, want)
    n_kept = int(got.mask.sum())
    assert bool(got.mask[:n_kept].all())
    assert (n_kept == 0) == (name == "every row invalid")


def test_window_flush_and_merge():
    """The per-scan flush over a padded window, and the merge of partials."""
    xyz, inten, mask = _chunk(4, 4096, seed=11)
    mask[3] = False  # a padding part, as the backend pads to a power of two
    rels = _rels(4, seed=5)
    parts_j = [jnp.asarray(np.ascontiguousarray(x.T)) for x in xyz]
    want = jit_cache.window_flush_fn(0.1, 16384)(
        tuple(parts_j), tuple(jnp.asarray(i) for i in inten), tuple(jnp.asarray(m) for m in mask),
        jnp.asarray(rels),
    )
    got = window.window_flush(
        [torch.from_numpy(np.ascontiguousarray(x.T)) for x in xyz], [torch.from_numpy(i) for i in inten],
        [torch.from_numpy(m) for m in mask], torch.from_numpy(rels), 0.1, 16384,
    )
    _assert_identical(got, want)

    parts = [JCloud(p, jnp.asarray(i), jnp.asarray(m)) for p, i, m in zip(parts_j, inten, mask)]
    want = jit_cache.merge_partials_fn(0.1, 8192, 4)(
        tuple(p.xyz for p in parts), tuple(p.intensity for p in parts), tuple(p.mask for p in parts),
    )
    got = window.merge_partials(
        [TCloud(*(torch.from_numpy(np.asarray(a)) for a in (p.xyz, p.intensity, p.mask))) for p in parts],
        0.1, 8192,
    )
    _assert_identical(got, want)


def _raw_chunk(n_scans: int, cap: int, near: float, far: float, seed: int = 5):
    """A raw chunk (C, cap, 3): a quarter of each scan within 4 ulps of the
    near edge, a quarter within 4 ulps of the far edge, half on 0.1 m cell
    faces and clusters; some lanes masked."""
    rng = np.random.default_rng(seed)

    def shell(n, r):
        d = rng.normal(size=(n, 3))
        p = (d / np.linalg.norm(d, axis=1, keepdims=True) * r).astype(np.float32)
        for _ in range(4):
            s = rng.integers(-1, 2, p.shape)
            p = np.where(s > 0, np.nextafter(p, np.float32(np.inf)),
                         np.where(s < 0, np.nextafter(p, np.float32(-np.inf)), p))
        return p

    q = cap // 4
    xyz = np.stack([np.concatenate([shell(q, near), shell(q, far), _points(seed + i, cap - 2 * q)[:, :3]])
                    for i in range(n_scans)]).astype(np.float32)
    inten = rng.uniform(0.0, 1.0, (n_scans, cap)).astype(np.float32)
    mask = rng.uniform(size=(n_scans, cap)) > 0.05
    return xyz, inten, mask


@pytest.mark.parametrize("length,start,n_valid", [(1, 0, 1), (4, 2, 3), (8, 5, 8), (16, 0, 11)])
def test_window_group(length, start, n_valid):
    """`window_group_fn` (the raw chunk's group, kernel 2r's twin): the
    band's edges, cell faces, clipped rows and padding rows; every lane
    identical, the centroids bit for bit."""
    near, far = 0.5, 40.0
    xyz, inten, mask = _raw_chunk(12, 4096, near, far)
    rels = _rels(length, seed=length)
    valid = np.arange(length) < n_valid
    fn = jit_cache.window_group_fn(near, far, 0.1, 32768, length)
    want = fn(jnp.asarray(xyz), jnp.asarray(inten), jnp.asarray(mask), jnp.int32(start), jnp.asarray(rels),
              jnp.asarray(valid))
    got = window.window_group(
        torch.from_numpy(xyz), torch.from_numpy(inten), torch.from_numpy(mask), start, torch.from_numpy(rels),
        torch.from_numpy(valid), near, far, 0.1, 32768,
    )
    assert got.cap == 32768
    _assert_identical(got, want)
    assert 0 < int(got.mask.sum()) < int(mask.sum())


@pytest.mark.parametrize("name", CHIP_SMOKE.RAW_WINDOW_CASE_NAMES)
def test_window_group_edge_cases(raw_window_cases, name):
    """Kernel 2r's twin on `chip_smoke.raw_window_cases` (which the card
    holds the kernel to bit for bit against this twin): equal to JAX's
    `window_group_fn` bit for bit, for a group of one row into more rows
    than it has lanes and of 16, out_cap below the voxels (truncated), rows
    clipped to the chunk, every row invalid, points moved past the key's yz
    clip range, and lanes within 4 ulps of both band edges (masked lanes
    holding NaN)."""
    xyz, inten, mask, start, rels, valid, near, far, res, out_cap = raw_window_cases[name]
    want = jit_cache.window_group_fn(near, far, res, out_cap, len(rels))(
        jnp.asarray(xyz), jnp.asarray(inten), jnp.asarray(mask), jnp.int32(start), jnp.asarray(rels),
        jnp.asarray(valid))
    got = window.window_group(*(torch.from_numpy(a) for a in (xyz, inten, mask)), start, torch.from_numpy(rels),
                              torch.from_numpy(valid), near, far, res, out_cap)
    assert got.cap == out_cap
    _assert_bits(got, want)
    n_kept = int(got.mask.sum())
    assert bool(got.mask[:n_kept].all())  # front-compacted
    assert (n_kept == 0) == (name == "every row invalid")
    if name == "out_cap below the voxels":
        assert n_kept == out_cap
