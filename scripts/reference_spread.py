#!/usr/bin/env python3
"""The JAX reference's own rounding spread, where the port's parity tests
hold the port to it (CPU; needs JAX):

    JAX_PLATFORMS=cpu python scripts/reference_spread.py eigh      # ~10 s
    JAX_PLATFORMS=cpu python scripts/reference_spread.py backend   # ~2 min

`eigh`: JAX's and the port's `eigh3x3` on matrices with an exactly repeated
eigenvalue pair (seeds 13-44, `tests/test_torch_voxel_map.py`'s generator):
the largest difference of a paired eigenvalue over lambda_max, and of the
isolated one over the test's 1e-5 tolerance.

`backend`: the reference's `GlobalGraph` with no images on
`tests/test_torch_backend.py`'s circle, per chunk and per scan, against the
same run with every filtered coordinate moved by at most one ulp (4
perturbations each): keyframes and loop pairs of each perturbed run, and,
where those stay, the largest move of a keyframe estimate.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(_ROOT), str(_ROOT / "tests")]


def eigh() -> None:
    import jax.numpy as jnp
    import torch

    from lv_slam_tpu.ops.linalg3 import eigh3x3 as j_eigh
    from lv_slam_tpu_torch.ops.linalg3 import eigh3x3 as t_eigh

    pair_worst = iso_worst = 0.0
    for seed in range(13, 45):
        rng = np.random.default_rng(seed)
        q, _ = np.linalg.qr(rng.normal(size=(256, 3, 3)))
        lam = rng.uniform(1e-3, 2.0, (256, 3))
        lam[:128, 1] = lam[:128, 0]
        lam[128:, 2] = lam[128:, 1]
        a = np.einsum("nij,nj,nkj->nik", q, lam, q).astype(np.float32)
        ej = np.asarray(j_eigh(jnp.asarray(a))[0])
        et = t_eigh(torch.from_numpy(a))[0].numpy()
        s = np.sort(lam, 1)
        low = np.isclose(s[:, 0], s[:, 1])
        n = np.arange(256)
        pair = np.where(low[:, None], [0, 1], [1, 2])
        iso = np.where(low, 2, 0)
        lmax = np.abs(ej).max(1)
        pair_worst = max(pair_worst, float((np.abs(et[n[:, None], pair] - ej[n[:, None], pair]).max(1) / lmax).max()))
        tol = 1e-5 * np.abs(ej[n, iso]) + 1e-6 * lmax
        iso_worst = max(iso_worst, float((np.abs(et[n, iso] - ej[n, iso]) / tol).max()))
    print(f"paired eigenvalues: largest |port - jax| / lambda_max {pair_worst:.3g} "
          f"(sqrt(eps_f32) = {np.sqrt(np.finfo(np.float32).eps):.3g}); isolated: {iso_worst:.3g} of the 1e-5 tolerance")


def backend() -> None:
    import test_torch_backend as t

    filt, odoms = t.circle.__wrapped__()

    def perturbed(seed):
        rng = np.random.default_rng(seed)
        out = []
        for xyz, inten, mask in filt:
            step = rng.integers(-1, 2, xyz.shape)
            moved = np.where(step > 0, np.nextafter(xyz, np.float32(np.inf)),
                             np.where(step < 0, np.nextafter(xyz, np.float32(-np.inf)), xyz))
            out.append((np.where(mask[:, None], moved, xyz).astype(np.float32), inten, mask))
        return out

    for per_scan in (False, True):
        base = t._jax(filt, odoms, per_scan)
        mode = "per scan" if per_scan else "per chunk"
        print(f"{mode}: keyframes {base['seqs']}, loops {base['loops']}")
        for seed in range(4):
            run = t._jax(perturbed(seed), odoms, per_scan)
            if run["seqs"] != base["seqs"] or run["loops"] != base["loops"]:
                print(f"  perturbation {seed}: keyframes {run['seqs']}, loops {run['loops']}")
                continue
            dt = np.linalg.norm(run["estimates"][:, :3, 3] - base["estimates"][:, :3, 3], axis=1).max()
            rot = np.abs(run["estimates"][:, :3, :3] - base["estimates"][:, :3, :3]).max()
            print(f"  perturbation {seed}: same keyframes and loops; estimates move by up to {dt:.4g} m, "
                  f"a rotation entry by {rot:.3g}")


if __name__ == "__main__":
    {"eigh": eigh, "backend": backend}[sys.argv[1]]()
