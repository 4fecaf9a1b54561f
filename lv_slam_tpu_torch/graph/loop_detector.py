"""Loop detection: geometric gates, ranking, batched NDT verification (port of
`lv_slam_tpu.graph.loop_detector`, `include/global_graph/loop_detector.hpp:
42-298`).

1. `find_candidates`: nothing while the new keyframe's travel is within
   `min_edge_interval` of the last accepted loop; otherwise every keyframe
   whose travel differs by more than `accum_distance_thresh` and whose
   estimated XY position lies within `distance_thresh`.
2. `rank_candidates`: without ORB descriptors every candidate scores 1.0 and
   the first `candidates_cap` are kept (the reference's non-BoW `matching()`
   fallback, the pure-lidar configuration). With descriptors, candidates are
   scored by BoW when a vocabulary exists (tf-idf vectors cached on the
   keyframes, host numpy; an inverted file past 16 candidates), otherwise by
   raw mutual-best descriptor matching (`ops/orb.match_scores_batch`, kernel
   12b), ranked, cut to `candidates_cap` and gated at `bow_score_thresh`.
   `maybe_train_vocabulary` trains one on the map's descriptors once
   `vocab_min_keyframes` keyframes carry them (`auto_train_vocab`).
3. `dispatch_one` runs the verification of one new keyframe against its
   candidates (kernel 13, `fused_verify`): NDT maps of the new keyframe at
   4, 2 and 1 m, a DIRECT7 unweighted align of all candidates at once per
   rung (8/8/16 Newton iterations; coarse rungs on every
   `cap // verify_coarse_points`-th lane), and the centroid-grid fitness.
   The packed (k, 17) result stays on the device; `harvest` reads it once,
   re-applies the `min_edge_interval` gate in order, rejects alignments
   that moved too far from the guess, and accepts the best fitness at or
   under `fitness_score_thresh`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from lv_slam_tpu_torch.config import LoopDetectorConfig
from lv_slam_tpu_torch.core.cloud import PointCloud
from lv_slam_tpu_torch.graph.bow import InvertedIndex, Vocabulary
from lv_slam_tpu_torch.graph.keyframe import KeyFrame
from lv_slam_tpu_torch.ops.ndt_hash import ndt_align_hash_table_batched, to_hash
from lv_slam_tpu_torch.ops.nn import build_centroid_grid, fitness_batch
from lv_slam_tpu_torch.ops.orb import match_scores_batch
from lv_slam_tpu_torch.ops.voxel_map import build_voxel_map


@dataclasses.dataclass
class Loop:
    key1: KeyFrame                 # the new keyframe
    key2: KeyFrame                 # the matched (older) keyframe
    relative_pose: np.ndarray      # maps key2's cloud into key1's frame
    fitness: float
    visual_score: float


@dataclasses.dataclass
class PendingVerification:
    """An in-flight verification: host metadata and the unread (k_pad, 17)
    device result (row = flattened 4x4 transform | fitness)."""

    new_kf: KeyFrame
    candidates: List[KeyFrame]
    scores: List[float]
    guesses: np.ndarray            # (k, 4, 4) float64 dispatch-time guesses
    packed: torch.Tensor           # (k_pad, 17), not yet read


def fused_verify(new_cloud: PointCloud, cands: PointCloud, guesses: torch.Tensor, resolutions,
                 iter_schedule, neighborhood: str, leaf_cap: int, lut_extent: int,
                 fitness_resolution: float, coarse_stride: int) -> torch.Tensor:
    """The reference's `_fused_verify_fn` program: every rung's map of the
    new keyframe, the candidates (xyz (k, N, 3), masks (k, N)) aligned
    together from (k, 4, 4) guesses, then their fitness; (k, 17)."""
    transforms = guesses
    n_rungs = len(resolutions)
    for ri, (r, iters) in enumerate(zip(resolutions, iter_schedule)):
        hmap = to_hash(build_voxel_map(new_cloud, r, leaf_cap=leaf_cap, lut_extent=lut_extent))
        s = coarse_stride if ri < n_rungs - 1 else 1
        sub = PointCloud(cands.xyz[:, ::s], cands.intensity[:, ::s], cands.mask[:, ::s])
        transforms, _, _ = ndt_align_hash_table_batched(
            hmap, sub, transforms, resolution=r, transformation_epsilon=0.01, max_iterations=iters,
            neighborhood=neighborhood, weighted=False,
        )
    grid = build_centroid_grid(new_cloud, fitness_resolution)
    fits = fitness_batch(grid, cands, transforms)
    k = transforms.shape[0]
    return torch.cat([transforms.reshape(k, 16), fits[:, None]], dim=1)


class LoopDetector:
    def __init__(self, cfg: Optional[LoopDetectorConfig] = None, vocabulary=None,
                 leaf_cap: int = 16384, lut_extent: int = 256):
        self.cfg = cfg or LoopDetectorConfig()
        self.vocabulary = vocabulary  # optional graph/bow.Vocabulary
        self._index = None            # lazy InvertedIndex over keyframes
        self._indexed: set = set()
        self.last_edge_accum_distance = 0.0
        # how many verified candidates each gate discarded (the reference's
        # loop pipeline drops these silently, `loop_detector.hpp:241-269`)
        self.stats = {"verified": 0, "bow_rejected": 0, "guess_rejected": 0, "fitness_rejected": 0}
        c = self.cfg
        self._resolutions = tuple(c.multiscale) + (c.ndt_resolution,)
        self._iter_schedule = (c.multiscale_max_iterations,) * len(c.multiscale) + (c.verify_max_iterations,)
        self._leaf_cap = leaf_cap
        self._lut_extent = lut_extent

    # -- gating (host) --------------------------------------------------------
    def find_candidates(self, keyframes: Sequence[KeyFrame], new_kf: KeyFrame) -> List[KeyFrame]:
        c = self.cfg
        if new_kf.accum_distance - self.last_edge_accum_distance < c.min_edge_interval:
            return []
        out = []
        new_pos = (new_kf.estimate if new_kf.estimate is not None else new_kf.odom)[:2, 3]
        for k in keyframes:
            if new_kf.accum_distance - k.accum_distance < c.accum_distance_thresh:
                continue
            pos = (k.estimate if k.estimate is not None else k.odom)[:2, 3]
            if np.linalg.norm(new_pos - pos) > c.distance_thresh:
                continue
            out.append(k)
        return out

    # -- ranking --------------------------------------------------------------
    def _bow_vector(self, kf: KeyFrame) -> np.ndarray:
        """tf-idf vector, computed once per keyframe and cached on it."""
        vec = getattr(kf, "bow_vector", None)
        if vec is None:
            vec = self.vocabulary.transform(kf.descriptor)
            kf.bow_vector = vec
        return vec

    def maybe_train_vocabulary(self, keyframes: Sequence[KeyFrame]) -> None:
        """BoW by default: lacking a shipped vocabulary, train one on the
        mapped sequence once enough described keyframes exist (the reference
        loads a pretrained DBoW3 one, `loop_detector.hpp:51-71`)."""
        c = self.cfg
        if self.vocabulary is not None or not c.auto_train_vocab:
            return
        described = [k.descriptor for k in keyframes if k.descriptor is not None and k.descriptor.shape[0] > 0]
        if len(described) < c.vocab_min_keyframes:
            return
        self.vocabulary = Vocabulary.train(described, n_words=c.vocab_words)
        for k in keyframes:  # drop vectors cached under no vocabulary
            if hasattr(k, "bow_vector"):
                del k.bow_vector
        self._index, self._indexed = None, set()

    def rank_candidates(self, candidates: List[KeyFrame], new_kf: KeyFrame):
        """(ranked candidates, scores), best first, cut to `candidates_cap`
        and gated at `bow_score_thresh`. Without descriptors every candidate
        scores 1.0 (ranking by recency, the reference's non-BoW fallback)."""
        if new_kf.descriptor is None or not any(c.descriptor is not None for c in candidates):
            cap = self.cfg.candidates_cap
            return candidates[:cap], [1.0] * min(len(candidates), cap)
        if self.vocabulary is not None:
            va = self._bow_vector(new_kf)
            if len(candidates) > 16:
                # large candidate sets: the inverted file, whose cost scales
                # with the query's posting lists, not the candidate count
                got = self._query_index(va, candidates)
                raw = [got.get(self._kf_key(c), 0.0) for c in candidates]
            else:
                raw = [
                    0.0 if c.descriptor is None
                    else float(1.0 - 0.5 * np.abs(va - self._bow_vector(c)).sum())
                    for c in candidates
                ]
            # baseline-adjusted scale (bow.Vocabulary.adjust; 0 for pretrained)
            scores = [max(0.0, self.vocabulary.adjust(s)) for s in raw]
        else:
            idx = [i for i, c in enumerate(candidates) if c.descriptor is not None]
            batch = match_scores_batch(
                new_kf.descriptor, [candidates[i].descriptor for i in idx], cap=self.cfg.descriptor_cap,
                device=new_kf.cloud.xyz.device,
            )
            scores = [0.0] * len(candidates)
            for j, i in enumerate(idx):
                scores[i] = float(batch[j])
        order = np.argsort(scores)[::-1][: self.cfg.candidates_cap]
        ranked = [candidates[i] for i in order]
        rscores = [scores[i] for i in order]
        # BoW accept gate (loop_detector.hpp:244)
        keep = [i for i, s in enumerate(rscores) if s >= self.cfg.bow_score_thresh]
        self.stats["bow_rejected"] += len(rscores) - len(keep)
        return [ranked[i] for i in keep], [rscores[i] for i in keep]

    @staticmethod
    def _kf_key(kf: KeyFrame):
        """Index key: `seq` is unique and stable per keyframe (an `id()` may
        be reused after garbage collection)."""
        return kf.seq

    def _query_index(self, query_vec: np.ndarray, candidates: List[KeyFrame]) -> dict:
        """Score candidates through the inverted file, indexing each
        keyframe's vector the first time it is a candidate."""
        if self._index is None:
            self._index = InvertedIndex(self.vocabulary.n_words)
        for c in candidates:
            key = self._kf_key(c)
            if c.descriptor is not None and key not in self._indexed:
                self._index.add(key, self._bow_vector(c))
                self._indexed.add(key)
        return self._index.query(query_vec, subset={self._kf_key(c) for c in candidates})

    # -- verification -----------------------------------------------------------
    def dispatch_one(self, candidates: List[KeyFrame], scores, new_kf: KeyFrame
                     ) -> Optional[PendingVerification]:
        """Launch the verification of one new keyframe; nothing is read back.
        The batch is padded to a power of two with repeats of candidate 0,
        which `harvest` slices off."""
        if not candidates:
            return None
        c = self.cfg
        candidates = candidates[: c.candidates_cap]
        scores = scores[: c.candidates_cap]
        k = len(candidates)
        k_pad = 1
        while k_pad < k:
            k_pad *= 2
        est_new = new_kf.estimate if new_kf.estimate is not None else new_kf.odom
        guesses = []
        for cand in candidates:
            est_cand = cand.estimate if cand.estimate is not None else cand.odom
            g = np.linalg.inv(est_new) @ est_cand
            g[2, 3] = 0.0  # z forced flat (loop_detector.hpp:251)
            guesses.append(g)
        pad = guesses + [guesses[0]] * (k_pad - k)
        cand_pad = candidates + [candidates[0]] * (k_pad - k)
        cands = PointCloud(
            torch.stack([cd.cloud.xyz for cd in cand_pad]),
            torch.stack([cd.cloud.intensity for cd in cand_pad]),
            torch.stack([cd.cloud.mask for cd in cand_pad]),
        )
        budget = int(c.verify_coarse_points)
        cap = int(cands.xyz.shape[1])
        stride = max(1, cap // budget) if budget > 0 else 1
        dev = new_kf.cloud.xyz.device
        guesses_t = torch.from_numpy(np.stack(pad).astype(np.float32))
        if dev.type == "cuda":  # a pinned, asynchronous copy: a pageable one waits for the stream
            guesses_t = guesses_t.pin_memory().to(dev, non_blocking=True)
        packed = fused_verify(
            new_kf.cloud, cands, guesses_t,
            self._resolutions, self._iter_schedule, c.ndt_neighborhood, self._leaf_cap, self._lut_extent,
            0.25, stride,
        )
        return PendingVerification(new_kf=new_kf, candidates=candidates, scores=list(scores),
                                   guesses=np.stack(guesses), packed=packed)

    def harvest(self, pending: Sequence[PendingVerification]) -> List[Loop]:
        """Read and gate in-flight verifications, one read each. The
        `min_edge_interval` gate is re-applied in order; a packet it skips
        is not counted in `stats`, as in the reference."""
        c = self.cfg
        loops: List[Loop] = []
        for p in pending:
            if p.new_kf.accum_distance - self.last_edge_accum_distance < c.min_edge_interval:
                continue
            packed = p.packed.cpu().numpy().astype(np.float64)  # the one read
            self.stats["verified"] += len(p.candidates)
            best = None
            for idx in range(len(p.candidates)):
                rel = packed[idx, :16].reshape(4, 4)
                fit = float(packed[idx, 16])
                corr = np.linalg.inv(p.guesses[idx]) @ rel
                corr_t = np.linalg.norm(corr[:3, 3])
                corr_r = np.arccos(np.clip((np.trace(corr[:3, :3]) - 1.0) / 2.0, -1.0, 1.0))
                if corr_t > c.max_guess_correction_trans or corr_r > c.max_guess_correction_rot:
                    self.stats["guess_rejected"] += 1
                    continue
                if fit > c.fitness_score_thresh:
                    self.stats["fitness_rejected"] += 1
                if fit <= c.fitness_score_thresh and (best is None or fit < best.fitness):
                    best = Loop(key1=p.new_kf, key2=p.candidates[idx], relative_pose=rel,
                                fitness=fit, visual_score=p.scores[idx])
            if best is not None:
                self.last_edge_accum_distance = p.new_kf.accum_distance
                loops.append(best)
        return loops

    def dispatch_verifications(self, keyframes: Sequence[KeyFrame], new_keyframes: Sequence[KeyFrame]
                               ) -> List[PendingVerification]:
        """Gate, rank and launch the verifications of new keyframes."""
        self.maybe_train_vocabulary(list(keyframes) + list(new_keyframes))
        pending = []
        for new_kf in new_keyframes:
            candidates = self.find_candidates(keyframes, new_kf)
            ranked, scores = self.rank_candidates(candidates, new_kf)
            p = self.dispatch_one(ranked, scores, new_kf)
            if p is not None:
                pending.append(p)
        return pending

    def verify(self, candidates: List[KeyFrame], scores, new_kf: KeyFrame) -> Optional[Loop]:
        """One keyframe's verification, dispatched and harvested at once."""
        p = self.dispatch_one(candidates, scores, new_kf)
        if p is None:
            return None
        got = self.harvest([p])
        return got[0] if got else None

    def detect(self, keyframes: Sequence[KeyFrame], new_keyframes: Sequence[KeyFrame]) -> List[Loop]:
        """The reference's synchronous `detect` (`loop_detector.hpp:79-93`)."""
        return self.harvest(self.dispatch_verifications(keyframes, new_keyframes))
