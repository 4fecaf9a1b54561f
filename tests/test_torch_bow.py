"""The port's BoW vocabulary (`lv_slam_tpu_torch.graph.bow`, a host-numpy
copy) against `lv_slam_tpu.graph.bow`: training, vectors, scores, the
baseline adjustment, persistence, the DBoW3 importer and the inverted file
give identical results, and the port's vocabulary asset is the reference's."""

import gzip

import numpy as np
import pytest

pytest.importorskip("torch")

from lv_slam_tpu.graph import bow as jbow  # noqa: E402
from lv_slam_tpu.io import synthetic  # noqa: E402
from lv_slam_tpu.ops.orb import OrbExtractor  # noqa: E402
from lv_slam_tpu_torch.graph import bow  # noqa: E402


@pytest.fixture(scope="module")
def corpus():
    """ORB descriptor sets of 12 places of one world, 6 places seen twice."""
    world = synthetic.make_world(seed=21, n_buildings=100, n_poles=140)
    orb = OrbExtractor(max_features=256)
    out = []
    for x, y, yaw in ((0, 0, 0.0), (40, 25, 1.2), (-35, 20, 2.5), (25, -40, -0.8), (-45, -30, 0.4), (60, 5, 3.0)):
        for dx, dyaw in ((0.0, 0.0), (0.7, 0.05)):
            c, s = np.cos(yaw + dyaw), np.sin(yaw + dyaw)
            pose = np.eye(4)
            pose[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
            pose[:3, 3] = [x + dx, y, 1.6]
            out.append(orb.detect_and_compute(synthetic.render_camera_image(world, pose, seed=21))[0])
    return out


def _same(got, want):
    np.testing.assert_array_equal(got.centers, want.centers)
    np.testing.assert_array_equal(got.idf, want.idf)
    assert got.baseline == want.baseline


@pytest.mark.parametrize("n_words,iters", [(512, 10), (64, 3)])
def test_train_transform_score_adjust(corpus, n_words, iters):
    got = bow.Vocabulary.train(corpus, n_words=n_words, iters=iters)
    want = jbow.Vocabulary.train(corpus, n_words=n_words, iters=iters)
    _same(got, want)
    assert 0.0 < got.baseline < 0.5
    bits = [np.unpackbits(d, axis=1).astype(bool) for d in corpus[:3]]  # (K, 256) bool input too
    for d in corpus[:4] + bits + [np.zeros((0, 32), np.uint8)]:
        np.testing.assert_array_equal(got.transform(d), want.transform(d))
    for a, b in ((0, 1), (0, 2), (5, 4), (7, 7)):
        s = got.score(corpus[a], corpus[b])
        assert s == want.score(corpus[a], corpus[b])
        assert got.adjust(s) == want.adjust(s)


def test_save_load_both_ways(corpus, tmp_path):
    vocab = bow.Vocabulary.train(corpus, n_words=64, iters=3)
    vocab.save(str(tmp_path / "port.npz"))
    _same(bow.Vocabulary.load(str(tmp_path / "port.npz")), vocab)
    _same(jbow.Vocabulary.load(str(tmp_path / "port.npz")), vocab)
    ref = jbow.Vocabulary.train(corpus, n_words=64, iters=3)
    ref.save(str(tmp_path / "ref.npz"))
    _same(bow.Vocabulary.load(str(tmp_path / "ref.npz")), ref)
    np.savez(tmp_path / "old.npz", centers=vocab.centers, idf=vocab.idf)  # no baseline key
    assert bow.Vocabulary.load(str(tmp_path / "old.npz")).baseline == 0.0


def _dbow3_yml(nodes, words):
    """A minimal DBoW3 OpenCV-YAML vocabulary (as `tests/test_orb_bow.py` writes one)."""
    lines = ["%YAML:1.0", "---", "vocabulary:", "   k: 2", "   L: 1", "   scoringType: 0", "   weightingType: 0",
             "   nodes:"]
    for nid, parent, weight, desc in nodes:
        dstr = " ".join(str(int(b)) for b in desc)
        lines.append(f"      - {{ nodeId:{nid}, parentId:{parent}, weight:{weight},\n"
                     f"          descriptor:dbw3 0 32 {dstr}  }}")
    lines.append("   words:")
    for wid, nid in words:
        lines.append(f"      - {{ wordId:{wid}, nodeId:{nid} }}")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("suffix", [".yml", ".yml.gz"])
def test_load_dbow3(tmp_path, suffix):
    descs = np.random.default_rng(7).integers(0, 256, (4, 32), dtype=np.uint8)
    nodes = [(1, 0, "0.", descs[0]), (2, 1, "2.5", descs[0]), (3, 1, "0.5", descs[1]), (4, 1, "1.0", descs[2]),
             (5, 1, "0.", descs[3])]
    text = _dbow3_yml(nodes, [(0, 2), (1, 3), (2, 4), (3, 5)])
    path = str(tmp_path / f"vocab{suffix}")
    with (gzip.open(path, "wt") if suffix.endswith(".gz") else open(path, "w")) as f:
        f.write(text)
    got, want = bow.Vocabulary.load_dbow3(path), jbow.Vocabulary.load_dbow3(path)
    _same(got, want)
    np.testing.assert_allclose(got.idf, [2.5, 0.5, 1.0, 0.0])
    q = np.stack([descs[0], descs[0], descs[1]])
    np.testing.assert_array_equal(got.transform(q), want.transform(q))
    assert got.score(q, q) == want.score(q, q)
    with open(tmp_path / "bad.yml", "w") as f:
        f.write("%YAML:1.0\nvocabulary:\n")
    with pytest.raises(ValueError):
        bow.Vocabulary.load_dbow3(str(tmp_path / "bad.yml"))


def test_inverted_index_equals_direct_scores(corpus):
    vocab = bow.Vocabulary.train(corpus, n_words=256)
    vecs = [vocab.transform(d) for d in corpus]
    index, ref = bow.InvertedIndex(vocab.n_words), jbow.InvertedIndex(vocab.n_words)
    for i, v in enumerate(vecs[1:], start=1):
        index.add(i, v)
        ref.add(i, v)
    got = index.query(vecs[0])
    assert got == ref.query(vecs[0])
    for i in range(1, len(vecs)):
        assert abs(got.get(i, 0.0) - (1.0 - 0.5 * np.abs(vecs[0] - vecs[i]).sum())) < 1e-9, i
    sub = index.query(vecs[0], subset={1, 2})
    assert set(sub) <= {1, 2} and sub == ref.query(vecs[0], subset={1, 2})


def test_asset_is_the_reference_vocabulary():
    from pathlib import Path

    ref_path = Path(jbow.__file__).resolve().parents[1] / "assets" / "vocab_synthetic_512.npz"
    assert bow.VOCABULARY_ASSET.read_bytes() == ref_path.read_bytes()
    got, want = bow.Vocabulary.load(str(bow.VOCABULARY_ASSET)), jbow.Vocabulary.load(str(ref_path))
    _same(got, want)
    assert got.n_words == 512
