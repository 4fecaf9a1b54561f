"""The port's counterpart of `tests/test_multi_loop.py`: the 160-scan VLP-16
double circle with drifting odometry fed raw, in chunks of 16, through
`GlobalGraph.add_scan_batch(..., filtered=False)` with an optimize after
each chunk, in both packages (each run once per module). The port must pass
the reference test's gates and give JAX's keyframes, loop pairs, counters
and keyframe errors (within EST_ATOL)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

from lv_slam_tpu.config import GraphConfig as JGraphCfg  # noqa: E402
from lv_slam_tpu.config import LoopDetectorConfig as JLoopCfg  # noqa: E402
from lv_slam_tpu.config import PrefilterConfig as JPrefilterCfg  # noqa: E402
from lv_slam_tpu.io import synthetic  # noqa: E402
from lv_slam_tpu.pipeline.backend import GlobalGraph as JGraph  # noqa: E402
from lv_slam_tpu_torch.config import GraphConfig, LoopDetectorConfig, PrefilterConfig  # noqa: E402
from lv_slam_tpu_torch.pipeline.backend import GlobalGraph  # noqa: E402
from test_torch_raw_backend import (  # noqa: E402
    CAP, EST_ATOL, _assert_same_run, _jax_stack, _port_stack, _run, _scans, _summary,
)


def _drifted_odometry(gt: np.ndarray, yaw_per_scan: float = 5e-4, scale: float = 1.004) -> np.ndarray:
    """`tests/test_multi_loop.py`'s drift model: a constant yaw bias and a
    forward-scale bias on every relative motion."""
    rels = np.einsum("nij,njk->nik", np.linalg.inv(gt[:-1]), gt[1:])
    c, s = np.cos(yaw_per_scan), np.sin(yaw_per_scan)
    bias = np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float64)
    odom = [np.eye(4)]
    for r in rels:
        r = r.astype(np.float64).copy()
        r[:3, 3] *= scale
        odom.append(odom[-1] @ (bias @ r))
    return np.stack(odom)


DOUBLE_N = 160
DOUBLE_GRAPH = dict(keyframe_cap=64, edge_cap=256, prior_cap=16, keyframe_delta_trans=3.0, solver_num_iterations=32)
DOUBLE_LOOP = dict(distance_thresh=15.0, accum_distance_thresh=60.0, min_edge_interval=20.0,
                   fitness_score_thresh=0.5, auto_train_vocab=False)


@pytest.fixture(scope="module")
def double_circle():
    gt = synthetic.circle_trajectory(DOUBLE_N, step=1.0, laps=2)
    scans = _scans(DOUBLE_N, 9, gt, synthetic.vlp16_rays(16, 600))
    gt_rel = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt).astype(np.float64)
    odom = _drifted_odometry(gt_rel)
    want = _summary(_run(
        JGraph(JGraphCfg(**DOUBLE_GRAPH), JLoopCfg(**DOUBLE_LOOP), keyframe_cloud_cap=16384,
               prefilter_cfg=JPrefilterCfg(raw_cap=CAP, out_cap=CAP)),
        scans, odom, 16, True, _jax_stack))
    return scans, gt_rel, odom, want


def test_double_circle_multi_loop(double_circle):
    """The port's counterpart of `tests/test_multi_loop.py::
    test_double_circle_multi_loop`: its gates (three or more loops spaced by
    the interval gate, more than twice as many candidates verified, the
    tail's error shrunk below 0.6 of the odometry's), and JAX's loops,
    counters and keyframe errors on the same feed."""
    scans, gt_rel, odom, want = double_circle
    backend = GlobalGraph(GraphConfig(**DOUBLE_GRAPH), LoopDetectorConfig(**DOUBLE_LOOP), keyframe_cloud_cap=16384,
                          prefilter_cfg=PrefilterConfig(raw_cap=CAP, out_cap=CAP), device="cpu")
    got = _summary(_run(backend, scans, odom, 16, True, _port_stack))
    assert len(got["loops"]) >= 3
    accums = sorted(got["accums"])
    assert all(b - a >= DOUBLE_LOOP["min_edge_interval"] - 1e-6 for a, b in zip(accums, accums[1:]))
    assert got["stats"]["verified"] > 2 * len(got["loops"])
    truth = np.stack([gt_rel[s][:3, 3] for s in got["seqs"]])
    err_odom = np.linalg.norm(got["odoms"][:, :3, 3] - truth, axis=1)
    err_est = np.linalg.norm(got["estimates"][:, :3, 3] - truth, axis=1)
    err_want = np.linalg.norm(want["estimates"][:, :3, 3] - truth, axis=1)
    tail = slice(len(err_odom) // 2, None)
    print(f"tail error: odometry {err_odom[tail].mean():.4f} m, port {err_est[tail].mean():.4f} m, JAX "
          f"{err_want[tail].mean():.4f} m")
    assert err_est[tail].mean() < 0.6 * err_odom[tail].mean()
    _assert_same_run(got, want)
    np.testing.assert_allclose(err_est, err_want, rtol=0, atol=EST_ATOL)
