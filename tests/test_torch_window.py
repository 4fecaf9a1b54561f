"""The port's first-point voxel dedup (kernel 1b's plain twin) and the
backend's window programs (kernel 2's) against `lv_slam_tpu.ops.prefilter.
voxel_dedup_first` and `lv_slam_tpu.utils.jit_cache`'s window programs (CPU).

The dedup copies input points, so masks, lane order and kept points are
identical, bit for bit. The window programs move points first: the port
takes the same fma chain XLA makes of the reference's einsum on the CPU
(`se3.transform_points_fma`), so there too every lane is identical."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
