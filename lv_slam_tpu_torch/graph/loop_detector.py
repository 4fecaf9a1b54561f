"""Loop detection: geometric gates, ranking, batched NDT verification (port of
`lv_slam_tpu.graph.loop_detector`, `include/global_graph/loop_detector.hpp:
42-298`).

1. `find_candidates`: nothing while the new keyframe's travel is within
   `min_edge_interval` of the last accepted loop; otherwise every keyframe
   whose travel differs by more than `accum_distance_thresh` and whose
   estimated XY position lies within `distance_thresh`.
2. `rank_candidates`: without ORB descriptors every candidate scores 1.0 and
   the first `candidates_cap` are kept (the reference's non-BoW `matching()`
   fallback, the pure-lidar configuration). The descriptor and vocabulary
   branches come with the ORB slice and raise `NotImplementedError` here.
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
from lv_slam_tpu_torch.graph.keyframe import KeyFrame
from lv_slam_tpu_torch.ops.ndt_hash import ndt_align_hash_table_batched, to_hash
from lv_slam_tpu_torch.ops.nn import build_centroid_grid, fitness_batch
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
        if vocabulary is not None:
            raise NotImplementedError("BoW ranking comes with the ORB slice; run without a vocabulary")
        self.cfg = cfg or LoopDetectorConfig()
        self.vocabulary = None
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
    def maybe_train_vocabulary(self, keyframes: Sequence[KeyFrame]) -> None:
        """The reference trains a BoW vocabulary once enough keyframes carry
        ORB descriptors; without descriptors there is nothing to train."""
        if any(k.descriptor is not None for k in keyframes):
            raise NotImplementedError("ORB descriptors and BoW training come with the ORB slice")

    def rank_candidates(self, candidates: List[KeyFrame], new_kf: KeyFrame):
        """(the first `candidates_cap` candidates, score 1.0 each) when no
        keyframe carries a descriptor."""
        if new_kf.descriptor is None or not any(c.descriptor is not None for c in candidates):
            cap = self.cfg.candidates_cap
            return candidates[:cap], [1.0] * min(len(candidates), cap)
        raise NotImplementedError("descriptor ranking (match_scores_batch, BoW) comes with the ORB slice")

    def _query_index(self, query_vec, candidates):
        raise NotImplementedError("the BoW inverted index comes with the ORB slice")

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
        packed = fused_verify(
            new_kf.cloud, cands, torch.from_numpy(np.stack(pad).astype(np.float32)).to(dev),
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
