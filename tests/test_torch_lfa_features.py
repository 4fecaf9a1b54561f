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
