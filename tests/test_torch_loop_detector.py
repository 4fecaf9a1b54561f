"""The port's loop detector (gates, ranking without descriptors, by BoW
vectors, through the inverted file and by raw descriptor matching, the
vocabulary's auto-training, the batched verification over kernel 13 and
kernel 14's plain twins, harvest) against `lv_slam_tpu.graph.loop_detector`
(CPU), on keyframes fed to both through `convert.keyframe_from_numpy`.

Gate and ranking decisions, scores, accept / reject and `stats` are equal. The
verified transforms and fitness are held to the reference's own rounding
spread: the largest change one-ulp noise on every cloud coordinate makes to
the reference's result (six perturbations), doubled, or 1e-5 where that is
smaller. The spread is wide: the maps of the new keyframe decide the
validity of near-planar leaves on float32 noise (test_torch_voxel_map), and
a leaf that flips moves the alignment by millimetres."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

import jax.numpy as jnp  # noqa: E402

from lv_slam_tpu.config import LoopDetectorConfig as JLoopCfg  # noqa: E402
from lv_slam_tpu.graph import bow as jbow  # noqa: E402
from lv_slam_tpu.core.cloud import PointCloud as JCloud  # noqa: E402
from lv_slam_tpu.graph.keyframe import KeyFrame as JKeyFrame  # noqa: E402
from lv_slam_tpu.graph.loop_detector import LoopDetector as JDetector  # noqa: E402
from lv_slam_tpu.io import synthetic  # noqa: E402
from lv_slam_tpu.ops.orb import OrbExtractor  # noqa: E402
from lv_slam_tpu_torch.config import LoopDetectorConfig  # noqa: E402
from lv_slam_tpu_torch.graph import bow  # noqa: E402
from lv_slam_tpu_torch.convert import keyframe_from_numpy  # noqa: E402
from lv_slam_tpu_torch.graph.loop_detector import LoopDetector  # noqa: E402

CAP = 16384
CFG = dict(distance_thresh=10.0, accum_distance_thresh=3.0, min_edge_interval=1.0, candidates_cap=3,
           max_guess_correction_trans=0.5)


def _yaw(a: float) -> np.ndarray:
    t = np.eye(4)
    t[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    return t


@pytest.fixture(scope="module")
def keyframes():
    """Four keyframes of a figure-8 drive: the last is the new one; the
    estimates of the others drift by 0.22 m, 0.64 m (past the test's 0.5 m
    guess gate) and 0.3 m."""
    scans, poses, _ = synthetic.make_sequence(4, seed=41, trajectory="figure8", step=1.0, n_rings=32,
                                              n_azimuth=450)
    poses = np.einsum("ij,njk->nik", np.linalg.inv(poses[0]), poses)
    drift = [np.eye(4), _yaw(0.02), _yaw(-0.01), np.eye(4)]
    drift[0][:3, 3] = [0.2, -0.1, 0.0]
    drift[2][:3, 3] = [0.0, 0.3, 0.0]
    drift[1][:3, 3] = [-0.6, 0.2, 0.1]
    kfs = []
    for i, (scan, pose) in enumerate(zip(scans, poses)):
        kfs.append(JKeyFrame(stamp=0.1 * i, seq=i, odom=pose, accum_distance=4.0 * i,
                             cloud=JCloud.from_numpy(scan, cap=CAP), node_id=i, estimate=pose @ drift[i]))
    return kfs


def _port(kfs):
    return [keyframe_from_numpy(k, "cpu") for k in kfs]


def test_candidates_and_ranking(keyframes):
    """The same candidates, order and scores, with and without the interval
    gate and the candidate cap in play."""
    for over in ({}, {"min_edge_interval": 100.0}, {"distance_thresh": 1.0}, {"candidates_cap": 1}):
        kw = {**CFG, **over}
        jd, td = JDetector(JLoopCfg(**kw)), LoopDetector(LoopDetectorConfig(**kw))
        new_j, new_t = keyframes[-1], _port(keyframes)[-1]
        cj = jd.find_candidates(keyframes[:-1], new_j)
        ct = td.find_candidates(_port(keyframes[:-1]), new_t)
        assert [k.seq for k in ct] == [k.seq for k in cj], over
        (rj, sj), (rt, st) = jd.rank_candidates(cj, new_j), td.rank_candidates(ct, new_t)
        assert [k.seq for k in rt] == [k.seq for k in rj] and st == sj, over


def _perturbed(kf, seed):
    rng = np.random.default_rng(seed)
    xyz = np.array(kf.cloud.xyz)
    step = rng.integers(-1, 2, xyz.shape)
    xyz = np.where(step > 0, np.nextafter(xyz, np.float32(np.inf)),
                   np.where(step < 0, np.nextafter(xyz, np.float32(-np.inf)), xyz))
    return dataclasses.replace(kf, cloud=JCloud(jnp.asarray(xyz), kf.cloud.intensity, kf.cloud.mask))


def test_dispatch_and_harvest(keyframes):
    """One batched verification of the new keyframe against its three
    candidates (padded to four): the same loop, the same stats, transforms
    and fitness within the reference's spread."""
    jd, td = JDetector(JLoopCfg(**CFG)), LoopDetector(LoopDetectorConfig(**CFG))
    new_j, cands_j = keyframes[-1], keyframes[:-1]
    cands_t = _port(cands_j)
    new_t = _port([new_j])[0]
    pj = jd.dispatch_one(cands_j, [1.0] * 3, new_j)
    pt = td.dispatch_one(cands_t, [1.0] * 3, new_t)
    assert tuple(pt.packed.shape) == tuple(pj.packed.shape) == (4, 17)
    want = np.asarray(pj.packed, np.float64)[:3]
    got = pt.packed.numpy().astype(np.float64)[:3]
    spread = np.zeros_like(want)
    for s in range(6):
        p = jd.dispatch_one([_perturbed(k, 10 * s + i) for i, k in enumerate(cands_j)], [1.0] * 3,
                            _perturbed(new_j, 10 * s + 9))
        spread = np.maximum(spread, np.abs(np.asarray(p.packed, np.float64)[:3] - want))
    tol = np.maximum(2.0 * spread, 1e-5)
    print(f"port vs reference {np.abs(got - want).max(axis=1)}, reference spread {spread.max(axis=1)}, fitness {want[:, 16]}")
    assert (np.abs(got - want) <= tol).all(), (np.abs(got - want), tol)

    loops_j, loops_t = jd.harvest([pj]), td.harvest([pt])
    assert [(lp.key1.seq, lp.key2.seq) for lp in loops_t] == [(lp.key1.seq, lp.key2.seq) for lp in loops_j]
    assert len(loops_t) == 1
    assert td.stats == jd.stats and td.stats["verified"] == 3
    assert sum(td.stats.values()) > 3  # the guess gate rejected the 0.64 m candidate
    assert td.last_edge_accum_distance == jd.last_edge_accum_distance
    # a packet the interval gate skips at harvest is dropped uncounted
    assert td.harvest([pt]) == [] and td.stats == jd.stats


@pytest.fixture(scope="module")
def described():
    """22 keyframes with ORB descriptors of camera images around a circle of
    world 21 (and empty clouds: ranking reads only descriptors); keyframe 3
    carries none."""
    world = synthetic.make_world(seed=21, n_buildings=100, n_poles=140)
    gt = synthetic.circle_trajectory(22, step=4.0, radius=14.0)
    orb = OrbExtractor(max_features=256)
    kfs = []
    for i, pose in enumerate(gt):
        desc, kpts = orb.detect_and_compute(synthetic.render_camera_image(world, pose, seed=21))
        kfs.append(JKeyFrame(stamp=0.1 * i, seq=i, odom=np.asarray(pose, np.float64), accum_distance=4.0 * i,
                             cloud=JCloud.from_numpy(np.zeros((1, 4), np.float32), cap=8),
                             descriptor=None if i == 3 else desc, keypoints=None if i == 3 else kpts, node_id=i))
    return kfs


def _rank_both(jd, td, kfs, n_cands):
    """Rank candidates 1 .. n_cands for keyframe 0 in both detectors."""
    port = _port(kfs)
    rj, sj = jd.rank_candidates(kfs[1:1 + n_cands], kfs[0])
    rt, st = td.rank_candidates(port[1:1 + n_cands], port[0])
    print(f"{n_cands} candidates ranked {[k.seq for k in rj]}, scores {np.round(sj, 4).tolist()}")
    assert [k.seq for k in rt] == [k.seq for k in rj] and st == sj
    assert td.stats == jd.stats
    return rj, sj


@pytest.mark.parametrize("n_cands", [8, 21])
def test_ranking_by_vocabulary(described, n_cands):
    """Direct vector scores (up to 16 candidates) and the inverted file (more),
    on a vocabulary each package trains from the same descriptors, the
    baseline-adjusted scale and the 0.04 gate."""
    sets = [k.descriptor for k in described if k.descriptor is not None]
    kw = dict(candidates_cap=8)
    jd = JDetector(JLoopCfg(**kw), vocabulary=jbow.Vocabulary.train(sets, n_words=128))
    td = LoopDetector(LoopDetectorConfig(**kw), vocabulary=bow.Vocabulary.train(sets, n_words=128))
    ranked, scores = _rank_both(jd, td, described, n_cands)
    assert ranked and min(scores) >= 0.04
    if n_cands > 16:
        assert td._indexed == jd._indexed == {k.seq for k in described[1:] if k.descriptor is not None}
    assert jd.stats["bow_rejected"] > 0  # the gate binds


def test_ranking_by_raw_descriptor_matching(described):
    """No vocabulary and no training: one batched mutual-best match of the
    new keyframe against every candidate (`match_scores_batch`)."""
    kw = dict(candidates_cap=8, auto_train_vocab=False)
    jd, td = JDetector(JLoopCfg(**kw)), LoopDetector(LoopDetectorConfig(**kw))
    td.maybe_train_vocabulary(_port(described))
    assert td.vocabulary is None
    ranked, scores = _rank_both(jd, td, described, 12)
    assert ranked and scores == sorted(scores, reverse=True)


def test_vocabulary_auto_training(described):
    """`maybe_train_vocabulary` trains once `vocab_min_keyframes` keyframes
    are described, drops the vectors cached before, and ranks by it after."""
    jd, td = JDetector(JLoopCfg(candidates_cap=8)), LoopDetector(LoopDetectorConfig(candidates_cap=8))
    port = _port(described)
    td.maybe_train_vocabulary(port[:10])  # keyframe 3 has no descriptor: 9 described
    jd.maybe_train_vocabulary(described[:10])
    assert td.vocabulary is None and jd.vocabulary is None
    port[0].bow_vector = np.ones(4)  # a stale cache
    td.maybe_train_vocabulary(port)
    jd.maybe_train_vocabulary(described)
    assert not hasattr(port[0], "bow_vector")
    for name in ("centers", "idf", "baseline"):
        np.testing.assert_array_equal(getattr(td.vocabulary, name), getattr(jd.vocabulary, name))
    (rj, sj), (rt, st) = jd.rank_candidates(described[1:13], described[0]), td.rank_candidates(port[1:13], port[0])
    assert [k.seq for k in rt] == [k.seq for k in rj] and st == sj and rt
    assert port[0].bow_vector.shape == (td.vocabulary.n_words,)
