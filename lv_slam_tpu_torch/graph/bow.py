"""Bag-of-binary-words vocabulary: flat k-means and tf-idf L1 scoring, on
the host (port of `lv_slam_tpu.graph.bow`, a copy: the port imports
nothing of the JAX package).

DBoW3 (the reference's visual loop index, `loop_detector.hpp:51-71` loads
`config/vocab_larger.bin`) is a hierarchical k-means tree over ORB
descriptors with tf-idf-weighted L1 scoring, computed on the CPU. Here the
vocabulary is flat k-means over descriptor bits, with DBoW3's scoring kept
verbatim: normalized tf-idf vectors compared as
`s = 1 - 0.5 * |v1/|v1| - v2/|v2||_1` (its L1_NORM score, the same [0, 1]
scale and the same 0.04 accept gate).

Everything here is host numpy, as in the reference: BoW vectors are
loop-gating metadata read by host control flow, and the matmuls are small
(at most ~10k x W x 256). The card does ORB extraction (`ops/orb.py`,
kernel 12) and loop verification (`graph/loop_detector.py`).

`VOCABULARY_ASSET` is the shipped 512-word vocabulary, trained on synthetic
images (a byte copy of the reference's `assets/vocab_synthetic_512.npz`).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np

from lv_slam_tpu_torch.ops.orb import unpack_descriptors

VOCABULARY_ASSET = Path(__file__).resolve().parent.parent / "assets" / "vocab_synthetic_512.npz"


def _kmeans(bits: np.ndarray, init_centers: np.ndarray, iters: int) -> np.ndarray:
    """Lloyd iterations on {0,1}^256 descriptors with float centroids."""
    x = bits.astype(np.float32)
    centers = init_centers.astype(np.float32).copy()
    n_words = centers.shape[0]
    for _ in range(iters):
        c_sq = np.sum(centers * centers, axis=1)
        assign = np.argmin(c_sq[None, :] - 2.0 * (x @ centers.T), axis=1)
        counts = np.bincount(assign, minlength=n_words).astype(np.float32)
        sums = np.zeros_like(centers)
        np.add.at(sums, assign, x)
        nonempty = counts > 0
        centers[nonempty] = sums[nonempty] / counts[nonempty, None]
    return centers


def _assign_host(bits: np.ndarray, centers: np.ndarray, c_sq: np.ndarray) -> np.ndarray:
    """Nearest-word assignment; the |x|^2 row term is constant per
    descriptor and dropped (argmin-invariant)."""
    x = bits.astype(np.float32)
    d = c_sq[None, :] - 2.0 * (x @ centers.T)
    return np.argmin(d, axis=1)


class Vocabulary:
    def __init__(
        self,
        centers: np.ndarray,
        idf: Optional[np.ndarray] = None,
        baseline: float = 0.0,
    ):
        self.centers = np.asarray(centers, np.float32)  # (W, 256)
        self._c_sq = np.sum(self.centers * self.centers, axis=1)
        self.idf = np.ones(centers.shape[0]) if idf is None else np.asarray(idf)
        # expected L1 score of two unrelated images under this vocabulary:
        # DBoW3's ~100k-word vectors are near-orthogonal (baseline ~ 0), so
        # its absolute 0.04 gate works; a small auto-trained vocabulary gives
        # impostor scores of ~0.1-0.2, so scores are compared on the adjusted
        # scale (s - baseline) / (1 - baseline), the raw score at baseline 0
        self.baseline = float(baseline)

    def adjust(self, score) -> float:
        """Map a raw L1 score onto the baseline-adjusted [<=0, 1] scale."""
        b = self.baseline
        return float((score - b) / max(1.0 - b, 1e-9))

    @property
    def n_words(self) -> int:
        return self.centers.shape[0]

    @classmethod
    def train(
        cls,
        descriptor_sets: List[np.ndarray],
        n_words: int = 512,
        iters: int = 10,
        seed: int = 0,
    ) -> "Vocabulary":
        """descriptor_sets: list of (Ki, 32) uint8 (or (Ki, 256) bool) arrays."""
        bits = np.concatenate([_as_bits(d) for d in descriptor_sets], axis=0)
        rng = np.random.default_rng(seed)
        n_words = min(n_words, bits.shape[0])
        init = bits[rng.choice(bits.shape[0], n_words, replace=False)].astype(np.float32)
        centers = _kmeans(bits, init, iters)
        vocab = cls(centers)
        # idf from the training image frequency (DBoW3 TF_IDF weighting)
        df = np.zeros(n_words)
        for d in descriptor_sets:
            words = np.unique(_assign_host(_as_bits(d), vocab.centers, vocab._c_sq))
            df[words] += 1
        vocab.idf = np.log(len(descriptor_sets) / np.maximum(df, 1.0)) + 1e-3
        # impostor baseline: mean pairwise score of distinct training images
        vecs = [vocab.transform(d) for d in descriptor_sets]
        pairs = [(i, j) for i in range(len(vecs)) for j in range(i + 1, len(vecs))]
        if len(pairs) > 256:
            sel = rng.choice(len(pairs), 256, replace=False)
            pairs = [pairs[int(s)] for s in sel]
        if pairs:
            vocab.baseline = float(np.mean([
                1.0 - 0.5 * np.abs(vecs[i] - vecs[j]).sum() for i, j in pairs
            ]))
        return vocab

    def transform(self, descriptors: np.ndarray) -> np.ndarray:
        """-> L1-normalized tf-idf BoW vector (W,)."""
        bits = _as_bits(descriptors)
        if bits.shape[0] == 0:
            return np.zeros(self.n_words)
        words = _assign_host(bits, self.centers, self._c_sq)
        vec = np.bincount(words, minlength=self.n_words).astype(np.float64) * self.idf
        norm = np.abs(vec).sum()
        return vec / norm if norm > 0 else vec

    def score(self, desc_a: np.ndarray, desc_b: np.ndarray) -> float:
        """DBoW3 L1 score in [0, 1]."""
        va, vb = self.transform(desc_a), self.transform(desc_b)
        return float(1.0 - 0.5 * np.abs(va - vb).sum())

    @classmethod
    def load_dbow3(cls, path: str) -> "Vocabulary":
        """Import a DBoW3 OpenCV-YAML vocabulary (plain `.yml` or gzipped
        `.yml.gz`): each word (leaf node) becomes one center row, its 256-bit
        descriptor as floats, and its stored weight the word's idf. The flat
        argmin assigns the exact nearest word where DBoW3's tree descent is
        greedy; baseline stays 0.0 (a large real-image vocabulary gives
        near-orthogonal vectors)."""
        import gzip
        import re

        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            text = f.read()

        node_re = re.compile(
            r"nodeId:(\d+),\s*parentId:\d+,\s*weight:([0-9.eE+-]+),"
            r"\s*descriptor:dbw3 0 32 ((?:\d+\s*)+)\}",
            re.S,
        )
        desc_by_node: dict = {}
        weight_by_node: dict = {}
        for m in node_re.finditer(text):
            nid = int(m.group(1))
            weight_by_node[nid] = float(m.group(2))
            desc_by_node[nid] = np.frombuffer(
                bytes(int(b) for b in m.group(3).split()), np.uint8
            )
        word_re = re.compile(r"wordId:(\d+),\s*nodeId:(\d+)")
        words = sorted(
            ((int(w), int(n)) for w, n in word_re.findall(text)), key=lambda t: t[0]
        )
        if not words:
            raise ValueError(f"{path}: no words section — not a DBoW3 vocabulary")
        n_words = words[-1][0] + 1
        centers = np.zeros((n_words, 256), np.float32)
        idf = np.zeros(n_words)
        for wid, nid in words:
            centers[wid] = unpack_descriptors(desc_by_node[nid][None])[0]
            idf[wid] = weight_by_node[nid]
        return cls(centers, idf, baseline=0.0)

    # -- persistence ---------------------------------------------------------
    def save(self, path: str) -> None:
        np.savez_compressed(
            path, centers=np.asarray(self.centers), idf=self.idf,
            baseline=self.baseline,
        )

    @classmethod
    def load(cls, path: str) -> "Vocabulary":
        data = np.load(path)
        baseline = float(data["baseline"]) if "baseline" in data else 0.0
        return cls(data["centers"], data["idf"], baseline=baseline)


class InvertedIndex:
    """DBoW3-style inverted file over tf-idf vectors: word -> postings of
    (keyframe id, weight). For L1-normalized vectors the L1 score
    1 - 0.5*|va - vb|_1 equals the sum over shared words of
    0.5*(a_w + b_w - |a_w - b_w|), so a query reads only the posting lists
    of its own nonzero words (the reference's DBoW3 database,
    `loop_detector.hpp:231-240`)."""

    def __init__(self, n_words: int):
        self.n_words = n_words
        self.postings: List[dict] = [dict() for _ in range(n_words)]

    def add(self, kf_id: int, vec: np.ndarray) -> None:
        for w in np.nonzero(vec)[0]:
            self.postings[int(w)][kf_id] = float(vec[w])

    def query(self, vec: np.ndarray, subset: Optional[set] = None) -> dict:
        """-> {kf_id: L1 score}; `subset` restricts scoring to those ids."""
        scores: dict = {}
        for w in np.nonzero(vec)[0]:
            a = float(vec[w])
            for kf_id, b in self.postings[int(w)].items():
                if subset is not None and kf_id not in subset:
                    continue
                scores[kf_id] = scores.get(kf_id, 0.0) + 0.5 * (a + b - abs(a - b))
        return scores


def _as_bits(desc: np.ndarray) -> np.ndarray:
    desc = np.asarray(desc)
    if desc.dtype == np.uint8 and desc.shape[-1] == 32:
        return unpack_descriptors(desc)
    return desc.astype(bool)
