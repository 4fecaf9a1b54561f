"""The port's LOAM feature extraction (kernel 8's plain twin on the CPU)
against lv_slam_tpu.lfa.features on the conftest `small_sequence`.

Tolerances. The range image is exact: validity and every winner identical
(measured on all six scans). Curvature: |dc| <= 2e-3 (|c| + 1e-2): XLA on
the CPU contracts `nbr_sum - 10 p` and the squared sums into FMAs, and the
reference moves its own curvature by up to 1.51e-3 (|c| + 1e-2) under
one-ulp input perturbations (16 perturbations, all six scans; the port is
off by at most 3.9e-4). The feature masks are identical (measured). At most
4 lanes per cloud hold another pick, or the same picks in another order,
where two cells of one sector have curvatures within rounding (measured: at
most 2 lanes; one-ulp perturbations of the reference move 131 less-sharp,
10 flat and 948 less-flat lanes by more than 1e-4 m).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lv_slam_tpu.config import LfaConfig as JLfa  # noqa: E402
from lv_slam_tpu.core.cloud import PointCloud as JCloud  # noqa: E402
from lv_slam_tpu.lfa import features as jf  # noqa: E402
from lv_slam_tpu_torch.config import LfaConfig as TLfa  # noqa: E402
from lv_slam_tpu_torch.core.cloud import PointCloud as TCloud  # noqa: E402
from lv_slam_tpu_torch.lfa import features as tf  # noqa: E402

CAP = 32768
JLFA_FIELDS = {f.name for f in dataclasses.fields(JLfa)}
KW = dict(scan_line=32, edge_cap=2048, planar_cap=4096, map_edge_cap=8192, map_planar_cap=16384)
CURV_RTOL = 2e-3
MAX_REORDERED = 4


@pytest.fixture(scope="module")
def clouds(small_sequence):
    scans, _, _ = small_sequence
    out = []
    for s in scans:
        j = JCloud.from_numpy(s, cap=CAP)
        t = TCloud(torch.from_numpy(np.array(j.xyz)), torch.from_numpy(np.array(j.intensity)),
                   torch.from_numpy(np.array(j.mask)))
        out.append((j, t))
    return out


@pytest.fixture(scope="module")
def jax_features(clouds):
    ext = jax.jit(lambda c: jf.extract_features(c, JLfa(**KW)))
    return [[np.asarray(a) for a in ext(j)] for j, _ in clouds]


def test_range_image_matches(clouds):
    project = jax.jit(lambda c: jf.compact_rows(*jf.project_range_image(c, n_rings=32)))
    for j, t in clouds:
        img_j, valid_j = (np.asarray(a) for a in project(j))
        img_t, valid_t = (a.numpy() for a in tf.compact_rows(*tf.project_range_image(t, n_rings=32)))
        np.testing.assert_array_equal(valid_t, valid_j)
        np.testing.assert_array_equal(img_t, img_j)  # the same winner in every cell


def test_curvature_matches(clouds):
    def curv(c):
        return jf.curvature(*jf.compact_rows(*jf.project_range_image(c, n_rings=32)))

    curv = jax.jit(curv)
    worst = 0.0
    for j, t in clouds:
        c_j, ok_j = (np.asarray(a) for a in curv(j))
        c_t, ok_t = (a.numpy() for a in tf.curvature(*tf.compact_rows(*tf.project_range_image(t, n_rings=32))))
        np.testing.assert_array_equal(ok_t, ok_j)
        assert np.isnan(c_t[~ok_t]).all()
        rel = np.abs(c_t[ok_t] - c_j[ok_j]) / (np.abs(c_j[ok_j]) + 1e-2)
        worst = max(worst, float(rel.max()))
    print(f"curvature: worst |dc| / (|c| + 1e-2) {worst:.3g} (tolerance {CURV_RTOL})")
    assert worst <= CURV_RTOL


def test_features_match(clouds, jax_features):
    cfg = TLfa(**KW)
    for (_, t), want in zip(clouds, jax_features):
        got = [a.numpy() for a in tf.extract_features(t, cfg)]
        assert [a.shape for a in got] == [a.shape for a in want]
        assert [a.shape[0] for a in got[::2]] == list(tf.feature_caps(cfg))
        for k, name in enumerate(tf.FeatureClouds._fields[::2]):
            pts_t, m_t = got[2 * k], got[2 * k + 1]
            pts_j, m_j = want[2 * k], want[2 * k + 1]
            np.testing.assert_array_equal(m_t, m_j, err_msg=name)
            assert (pts_t[~m_t] == 1e6).all(), name
            differ = (pts_t != pts_j).any(axis=1)
            assert int(differ.sum()) <= MAX_REORDERED, (name, int(differ.sum()))
            for p in pts_t[differ]:  # every other pick is a return of the scan
                assert (t.xyz.numpy() == p).all(axis=1).any(), name
        assert got[1].sum() > 20 and got[5].sum() > 100  # real sharp edges and flat surfs


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
def feature_cases():
    return {name: case for name, *case in CHIP_SMOKE.feature_cases()}


@pytest.mark.parametrize("name", CHIP_SMOKE.FEATURE_CASE_NAMES)
def test_feature_edge_cases(feature_cases, name):
    """Kernel 8's edge cases (`chip_smoke.feature_cases`, which the card
    holds the kernel to bit for bit against this twin) against JAX: masks
    identical; the tied, sparse and empty cases exact (binary coordinates,
    measured); in the two dense scans (every cell valid, 1 cm of range
    noise) hundreds of surf curvatures per sector lie within rounding of one
    another, so a lane of a cloud may hold another return of the scan where
    the reference itself moves that many lanes under a one-ulp perturbation
    of its input (at least MAX_REORDERED)."""
    from lv_slam_tpu_torch import kitti_flagship_config

    xyz, mask, kw = feature_cases[name]
    cfg = dataclasses.replace(kitti_flagship_config().lfa, **kw)
    jcfg = JLfa(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name in JLFA_FIELDS})
    t = TCloud.from_numpy(xyz, cap=CHIP_SMOKE.FEATURE_CAP, device="cpu")
    t.mask[: len(mask)] &= torch.from_numpy(mask)
    got = [a.numpy() for a in tf.extract_features(t, cfg)]
    ext = jax.jit(lambda c: jf.extract_features(c, jcfg))
    want = [np.asarray(a) for a in ext(JCloud(t.xyz.numpy(), t.intensity.numpy(), t.mask.numpy()))]
    assert [a.shape for a in got] == [a.shape for a in want]
    exact = name in ("tied scores", "fewer than k good picks", "empty scan")
    if not exact:
        nudged = np.nextafter(t.xyz.numpy(), np.float32(np.inf))
        spread = [np.asarray(a) for a in ext(JCloud(nudged, t.intensity.numpy(), t.mask.numpy()))]
    for k, field in enumerate(tf.FeatureClouds._fields[::2]):
        np.testing.assert_array_equal(got[2 * k + 1], want[2 * k + 1], err_msg=field)
        differ = (got[2 * k] != want[2 * k]).any(axis=1)
        allowed = 0 if exact else max(MAX_REORDERED, int((np.abs(spread[2 * k] - want[2 * k]) > 1e-4).any(axis=1).sum()))
        print(f"{name} {field}: {int(differ.sum())} lanes differ (allowed {allowed})")
        assert int(differ.sum()) <= allowed, (field, int(differ.sum()), allowed)
        for p in got[2 * k][differ]:  # every other pick is a return of the scan
            assert (t.xyz.numpy() == p).all(axis=1).any(), field
    counts = [int(m.sum()) for m in got[1::2]]
    if name == "empty scan":
        assert counts == [0, 0, 0, 0]
    if name == "fewer than k good picks":
        assert 0 < counts[3] < cfg.less_sharp_per_sector
    if name == "VLP-16, less-flat k 85":
        assert counts[3] > 32 * cfg.scan_line * cfg.n_sectors  # more than a warp's picks per sector


def test_sector_topk_breaks_ties_by_column():
    """Equal scores go to the lower column, as lax.top_k orders them."""
    c = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, 0.5]])
    ok = torch.ones_like(c, dtype=torch.bool)
    image = torch.arange(18, dtype=torch.float32).reshape(1, 6, 3)
    pts, good = tf._sector_topk(image, c, ok, 4, 1, largest=True)
    np.testing.assert_array_equal(pts[0, 0, :, 0].numpy(), [3.0, 6.0, 12.0, 9.0])
    assert good.all()
    _, jidx = jax.lax.top_k(jnp.asarray(c.numpy()), 4)
    np.testing.assert_array_equal(np.asarray(jidx)[0], [1, 2, 4, 3])
